"""Published base images (port of modal_tpu/global_objects.py; reference:
py/modal_global_objects, scripts that pre-build the official
`debian_slim`/`micromamba` bases per builder version so user apps never pay
the base build).

`publish_base_images()` registers the active epoch's base images with the
control plane and makes a worker materialize each one by running a probe
function on it through the real path: afterwards every app using
`Image.debian_slim()` starts on a built, content-addressed venv instead of
building one inside its first cold start.
"""

from __future__ import annotations

import sys


def supported_python_versions(builder_version: str) -> list[str]:
    """The epoch's python minors that this host can materialize: the local
    backend builds venvs with the host interpreter, so only the matching
    minor is buildable (builder/base_images.json "python")."""
    from .builder import base_image_config

    host = f"{sys.version_info.major}.{sys.version_info.minor}"
    configured = base_image_config(builder_version).get("python") or [host]
    return [v for v in configured if v == host] or [host]


def publish_base_images(builder_version: str | None = None, client=None) -> list[str]:
    """Build (or reuse) each base image through the real path, a probe
    function scheduled onto a worker, and return the built image ids."""
    import os

    from .config import config

    builder_version = builder_version or config["image_builder_version"]
    # the epoch is resolved inside Image._load (env override > the
    # workspace default at ClientHello > config): an explicit version here
    # pins the env override, or only the pythons would follow it
    prev = os.environ.get("MODAL_TPU_IMAGE_BUILDER_VERSION")
    os.environ["MODAL_TPU_IMAGE_BUILDER_VERSION"] = builder_version
    try:
        return _publish(builder_version, client)
    finally:
        if prev is None:
            os.environ.pop("MODAL_TPU_IMAGE_BUILDER_VERSION", None)
        else:
            os.environ["MODAL_TPU_IMAGE_BUILDER_VERSION"] = prev


def _publish(builder_version: str, client) -> list[str]:
    from .app import App
    from .image import Image

    app = App("global-base-images")
    probes = []
    for version in supported_python_versions(builder_version):
        image = Image.debian_slim(python_version=version)

        def probe() -> str:
            import sys as _sys

            return f"{_sys.version_info.major}.{_sys.version_info.minor}"

        fn = app.function(serialized=True, image=image, name=f"probe_{version.replace('.', '_')}")(probe)
        probes.append((version, image, fn))
    image_ids = []
    with app.run(client=client):
        for version, image, fn in probes:
            reported = fn.remote()
            if reported != version:
                raise RuntimeError(f"base image python mismatch: wanted {version}, container reports {reported}")
            image_ids.append(image.object_id)
    return image_ids
