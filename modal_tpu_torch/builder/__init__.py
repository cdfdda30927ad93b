"""Image-builder version epochs (port of modal_tpu/builder/): the pinned
base-dependency set of each builder version (reference: py/modal/builder/,
its `2025.06.txt` requirement sets and `base-images.json`, read by the
remote builder).

An epoch pins the **torch stack** that a container built at that version
is guaranteed to see (torch, numpy, einops, cloudpickle, grpcio, protobuf,
...), plus per-epoch base-image defaults: the supported python minors and
the default CUDA env (`cuda_env`, where the JAX package has `tpu_env`). The
epoch is part of the image content hash, so bumping a pin inside an epoch
file, or moving to a new epoch, rebuilds every image; `RUN pip install
<bare-name>` lines are constrained to the epoch's pin, so builds are
reproducible across hosts. The pins of the newest epoch are the versions
installed on the card hosts: a bare name then resolves to what is already
there, and no build reaches for a package index.
"""

from __future__ import annotations

import hashlib
import json
import os
import re

_BUILDER_DIR = os.path.dirname(os.path.abspath(__file__))


class UnknownBuilderVersion(Exception):
    def __init__(self, version: str):
        super().__init__(f"unknown image builder version {version!r}; known: {', '.join(known_versions())}")


def known_versions() -> tuple[str, ...]:
    return tuple(name[:-4] for name in sorted(os.listdir(_BUILDER_DIR)) if name.endswith(".txt"))


def _epoch_path(version: str) -> str:
    if version not in known_versions():
        raise UnknownBuilderVersion(version)
    return os.path.join(_BUILDER_DIR, f"{version}.txt")


def load_requirements(version: str) -> dict[str, str]:
    """{package_name: full requirement line} for the epoch's pinned set."""
    pins: dict[str, str] = {}
    with open(_epoch_path(version)) as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            m = re.match(r"^([A-Za-z0-9_.-]+)", line)
            if m:
                pins[m.group(1).lower().replace("_", "-")] = line
    return pins


def base_image_config(version: str) -> dict:
    """Per-epoch base-image settings (python minors, default CUDA env)."""
    if version not in known_versions():
        raise UnknownBuilderVersion(version)
    with open(os.path.join(_BUILDER_DIR, "base_images.json")) as f:
        table = json.load(f)
    return {
        "python": table["python"].get(version, []),
        "cuda_env": table["cuda_env"].get(version, {}),
    }


def epoch_content_hash(version: str) -> str:
    """Hash of everything the epoch pins: part of the image content hash,
    so editing an epoch file invalidates the images built under it."""
    h = hashlib.sha256()
    with open(_epoch_path(version), "rb") as f:
        h.update(f.read())
    h.update(json.dumps(base_image_config(version), sort_keys=True).encode())
    return h.hexdigest()[:16]


def constrain_pip_install(cmd: str, version: str) -> str:
    """Rewrite `... -m pip install name [name2...]` so bare names carry the
    epoch's pin. Names the epoch does not pin, and specs with explicit
    constraints or flags, pass through untouched."""
    pins = load_requirements(version)
    m = re.match(r"^(.*?-m pip install\s+)(.*)$", cmd)
    if m is None:
        return cmd
    head, rest = m.groups()
    out = []
    for token in rest.split():
        if re.fullmatch(r"[A-Za-z0-9_.-]+", token):
            pin = pins.get(token.lower().replace("_", "-"))
            if pin is not None and " " not in pin:
                out.append(pin)
                continue
        out.append(token)
    return head + " ".join(out)
