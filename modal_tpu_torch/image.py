"""Image builder DSL: layered image definitions resolved server-side (port
of modal_tpu/image.py).

Reference: py/modal/_image.py — `_Image._from_args` + `_load` (ImageGetOrCreate
→ build wait, _image.py:578,625,426), `DockerfileSpec`, the chainable DSL
(`pip_install` _image.py:1668, `from_registry` _image.py:2372,
`from_dockerfile` _image.py:2652, `debian_slim` _image.py:2534,
`run_function` _image.py:2175), and builder-version pinning
(py/modal/builder/*.txt).

The JAX package's flagship preset builds libtpu + jax (`Image.tpu_base()`);
the port's builds the CUDA toolkit + torch (`Image.cuda_base()`): the
toolkit's `nvcc` builds the port's kernels in the container, and their
build dir is the image's cache. The worker builds each layer chain on first
use into a content-addressed venv (server/image_builder.py): a pip layer is
importable in the container, a failing RUN fails the call with
INIT_FAILURE and the build log's tail, and `prewarm` builds the kernels
into the image. The builder epoch of a layer (`modal_tpu_torch/builder/`)
is the env override `MODAL_TPU_IMAGE_BUILDER_VERSION`, else the workspace's
`image_builder_version` advertised at ClientHello, else the config's.
"""

from __future__ import annotations

import shlex
from typing import Any, Callable, Optional, Sequence, Union

from ._utils.async_utils import synchronize_api
from ._utils.grpc_utils import retry_transient_errors
from .config import config
from .exception import InvalidError, RemoteError
from .object import LoadContext, Resolver, _Object
from .builder import known_versions
from .proto import api_pb2
from .secret import _Secret

# Builder version epochs pin the base dependency set (reference
# py/modal/builder/{2023.12..2025.06}.txt pattern): the epoch files of
# modal_tpu_torch/builder/.
SUPPORTED_PYTHON_SERIES = ["3.10", "3.11", "3.12", "3.13"]
_BUILDER_VERSIONS = list(known_versions())


def _validate_python_version(version: Optional[str]) -> str:
    if version is None:
        import sys

        return f"{sys.version_info.major}.{sys.version_info.minor}"
    if version not in SUPPORTED_PYTHON_SERIES and not any(
        version.startswith(s + ".") for s in SUPPORTED_PYTHON_SERIES
    ):
        raise InvalidError(f"unsupported python version {version!r}; supported: {SUPPORTED_PYTHON_SERIES}")
    return version


def _flatten_str_args(function_name: str, arg_name: str, args: Sequence[Union[str, list[str]]]) -> list[str]:
    out: list[str] = []
    for arg in args:
        if isinstance(arg, str):
            out.append(arg)
        elif isinstance(arg, (list, tuple)):
            if not all(isinstance(x, str) for x in arg):
                raise InvalidError(f"{function_name}: {arg_name} must be strings or lists of strings")
            out.extend(arg)
        else:
            raise InvalidError(f"{function_name}: {arg_name} must be strings or lists of strings")
    return out


class _Image(_Object, type_prefix="im"):
    """A layered image definition. Each DSL call returns a new `_Image` whose
    loader depends on its base — the whole chain resolves to one
    ImageGetOrCreate per layer, deduplicated server-side by content hash."""

    _metadata: Optional[api_pb2.ImageMetadata] = None

    def _initialize_from_empty(self) -> None:
        self._metadata = None

    def _hydrate_metadata(self, metadata: Optional[Any]) -> None:
        if metadata is not None:
            assert isinstance(metadata, api_pb2.ImageMetadata)
            self._metadata = metadata

    def _get_metadata(self) -> Optional[bytes]:
        return self._metadata.SerializeToString() if self._metadata is not None else b""

    @classmethod
    def _deserialize_metadata(cls, metadata_bytes: bytes) -> Optional[Any]:
        return api_pb2.ImageMetadata.FromString(metadata_bytes) if metadata_bytes else None

    @staticmethod
    def _from_args(
        *,
        base_images: Optional[dict[str, "_Image"]] = None,
        dockerfile_commands: Optional[list[str]] = None,
        secrets: Optional[Sequence[_Secret]] = None,
        registry_ref: Optional[str] = None,
        build_function: Optional[Callable] = None,
        build_function_args: Optional[tuple] = None,
        force_build: bool = False,
        rep: str = "Image()",
    ) -> "_Image":
        base_images = base_images or {}
        secrets = list(secrets or [])
        dockerfile_commands = dockerfile_commands or []

        def _deps() -> list[_Object]:
            return [*base_images.values(), *secrets]

        async def _load(self: "_Image", resolver: Resolver, context: LoadContext, existing_object_id: Optional[str]):
            import os as _os

            # builder-version precedence: explicit env override > the
            # workspace default advertised at ClientHello (WorkspaceSettings)
            # > baked default — so `workspace set image_builder_version`
            # actually governs what clients build with
            if _os.environ.get("MODAL_TPU_IMAGE_BUILDER_VERSION"):
                builder_version = config["image_builder_version"]
            else:
                builder_version = context.client.image_builder_version or config["image_builder_version"]
            image = api_pb2.Image(
                dockerfile_commands=dockerfile_commands,
                base_image_registry_ref=registry_ref or "",
                secret_ids=[s.object_id for s in secrets],
                version=builder_version,
            )
            if base_images:
                # encode base image layer reference as FROM directive
                base = base_images["base"]
                image.dockerfile_commands.insert(0, f"FROM {base.object_id}")
            if build_function is not None:
                from .serialization import serialize

                image.build_function_serialized = serialize((build_function, build_function_args or ()))
            req = api_pb2.ImageGetOrCreateRequest(
                app_id=context.app_id or "",
                image=image,
                builder_version=builder_version,
                force_build=force_build or config["force_build"],
            )
            resp = await retry_transient_errors(context.client.stub.ImageGetOrCreate, req)
            image_id = resp.image_id
            metadata = resp.metadata
            if not metadata.image_builder_version:
                # build still running: join the build log stream until done
                # (reference _image_await_build_result, _image.py:435)
                last_entry_id = ""
                while True:
                    join = await retry_transient_errors(
                        context.client.stub.ImageJoinStreaming,
                        api_pb2.ImageJoinStreamingRequest(
                            image_id=image_id, timeout=55.0, last_entry_id=last_entry_id
                        ),
                    )
                    last_entry_id = join.entry_id or last_entry_id
                    if join.result.status == api_pb2.GENERIC_STATUS_FAILURE:
                        raise RemoteError(f"image build failed: {join.result.exception}")
                    if join.eof or join.result.status == api_pb2.GENERIC_STATUS_SUCCESS:
                        metadata = join.metadata
                        break
            self._hydrate(image_id, context.client, metadata)

        return _Image._from_loader(_load, rep, deps=_deps)

    # -- extension helper ---------------------------------------------------

    def _extend(self, dockerfile_commands: list[str], secrets: Sequence[_Secret] = (), rep: str = "") -> "_Image":
        return _Image._from_args(
            base_images={"base": self},
            dockerfile_commands=dockerfile_commands,
            secrets=secrets,
            rep=rep or f"{self._rep}.extend(...)",
        )

    # -- constructors -------------------------------------------------------

    @staticmethod
    def debian_slim(python_version: Optional[str] = None, force_build: bool = False) -> "_Image":
        """Debian slim base with the pinned python (reference _image.py:2534)."""
        version = _validate_python_version(python_version)
        # no tooling RUN layer here: the local worker backend materializes a
        # matching-python venv as this base (image_builder.py), so the layer
        # is pure FROM — keeps base images buildable without network egress
        return _Image._from_args(
            dockerfile_commands=[f"FROM python:{version}-slim-bookworm"],
            force_build=force_build,
            rep=f"Image.debian_slim({version!r})",
        )

    @staticmethod
    def from_registry(
        tag: str,
        *,
        secret: Optional[_Secret] = None,
        add_python: Optional[str] = None,
        force_build: bool = False,
    ) -> "_Image":
        """Use any registry image as base (reference _image.py:2372)."""
        commands = [f"FROM {tag}"]
        if add_python:
            _validate_python_version(add_python)
            commands.append(f"RUN uv python install {add_python}")
        return _Image._from_args(
            dockerfile_commands=commands,
            registry_ref=tag,
            secrets=[secret] if secret else [],
            force_build=force_build,
            rep=f"Image.from_registry({tag!r})",
        )

    @staticmethod
    def from_dockerfile(path: str, force_build: bool = False) -> "_Image":
        with open(path) as f:
            commands = f.read().splitlines()
        return _Image._from_args(
            dockerfile_commands=commands, force_build=force_build, rep=f"Image.from_dockerfile({path!r})"
        )

    @staticmethod
    def cuda_base(
        python_version: Optional[str] = None,
        torch_version: str = "",
        cuda_version: str = "12.4.1",
        force_build: bool = False,
    ) -> "_Image":
        """The flagship GPU image: the CUDA toolkit (its devel image, whose
        nvcc builds the port's kernels) + the pinned python + torch built
        for that CUDA, and the runtime env (the kernel build dir in the
        image's cache). This replaces the JAX package's libtpu + jax preset
        (`Image.tpu_base()`) as the 'batteries included' accelerator
        image."""
        version = _validate_python_version(python_version)
        pin = f"=={torch_version}" if torch_version else ""
        cu = "cu" + "".join(cuda_version.split(".")[:2])
        return _Image.from_registry(
            f"nvidia/cuda:{cuda_version}-devel-ubuntu22.04", add_python=version, force_build=force_build
        )._extend(
            [
                f"RUN uv pip install --system 'torch{pin}' --index-url https://download.pytorch.org/whl/{cu}",
                "ENV TORCH_EXTENSIONS_DIR=/cache/torch_extensions",
                "ENV CUDA_MODULE_LOADING=LAZY",
            ],
            rep=f"Image.cuda_base({python_version!r})",
        )

    # -- layer DSL ----------------------------------------------------------

    def pip_install(
        self,
        *packages: Union[str, list[str]],
        find_links: Optional[str] = None,
        index_url: Optional[str] = None,
        extra_index_url: Optional[str] = None,
        pre: bool = False,
        extra_options: str = "",
        secrets: Sequence[_Secret] = (),
        force_build: bool = False,
    ) -> "_Image":
        """Install pip packages (reference _image.py:1668)."""
        pkgs = _flatten_str_args("pip_install", "packages", packages)
        if not pkgs:
            return self
        flags = []
        if find_links:
            flags += ["-f", find_links]
        if index_url:
            flags += ["--index-url", index_url]
        if extra_index_url:
            flags += ["--extra-index-url", extra_index_url]
        if pre:
            flags += ["--pre"]
        if extra_options:
            flags += [extra_options]
        cmd = "RUN python -m pip install " + " ".join([shlex.quote(p) for p in sorted(pkgs)] + flags)
        return self._extend([cmd], secrets, rep=f"{self._rep}.pip_install(...)")

    def uv_pip_install(
        self,
        *packages: Union[str, list[str]],
        requirements: Optional[list[str]] = None,
        extra_options: str = "",
        secrets: Sequence[_Secret] = (),
        force_build: bool = False,
    ) -> "_Image":
        """uv-backed fast installer (reference _image.py:2027 uv_pip_install)."""
        pkgs = _flatten_str_args("uv_pip_install", "packages", packages)
        cmds = []
        if requirements:
            for r in requirements:
                cmds.append(f"RUN uv pip install --system -r {shlex.quote(r)}")
        if pkgs:
            cmds.append(
                "RUN uv pip install --system "
                + " ".join([shlex.quote(p) for p in sorted(pkgs)] + ([extra_options] if extra_options else []))
            )
        if not cmds:
            return self
        return self._extend(cmds, secrets, rep=f"{self._rep}.uv_pip_install(...)")

    def apt_install(self, *packages: Union[str, list[str]], force_build: bool = False) -> "_Image":
        pkgs = _flatten_str_args("apt_install", "packages", packages)
        if not pkgs:
            return self
        return self._extend(
            [
                "RUN apt-get update",
                "RUN apt-get install -y " + " ".join(shlex.quote(p) for p in pkgs),
            ],
            rep=f"{self._rep}.apt_install(...)",
        )

    def run_commands(self, *commands: Union[str, list[str]], secrets: Sequence[_Secret] = ()) -> "_Image":
        cmds = _flatten_str_args("run_commands", "commands", commands)
        if not cmds:
            return self
        return self._extend([f"RUN {c}" for c in cmds], secrets, rep=f"{self._rep}.run_commands(...)")

    def env(self, vars: dict[str, str]) -> "_Image":
        return self._extend(
            [f"ENV {k}={shlex.quote(str(v))}" for k, v in vars.items()], rep=f"{self._rep}.env(...)"
        )

    def workdir(self, path: str) -> "_Image":
        return self._extend([f"WORKDIR {path}"], rep=f"{self._rep}.workdir({path!r})")

    def entrypoint(self, entrypoint_commands: list[str]) -> "_Image":
        import json

        return self._extend([f"ENTRYPOINT {json.dumps(entrypoint_commands)}"], rep=f"{self._rep}.entrypoint(...)")

    def cmd(self, cmd: list[str]) -> "_Image":
        import json

        return self._extend([f"CMD {json.dumps(cmd)}"], rep=f"{self._rep}.cmd(...)")

    def add_local_file(self, local_path: str, remote_path: str, *, copy: bool = False) -> "_Image":
        """Attach a local file to the image (runtime-mounted by the local
        backend; COPY layer when copy=True)."""
        return self._extend([f"COPY {local_path} {remote_path}"], rep=f"{self._rep}.add_local_file(...)")

    def add_local_dir(self, local_path: str, remote_path: str, *, copy: bool = False) -> "_Image":
        return self._extend([f"COPY {local_path} {remote_path}"], rep=f"{self._rep}.add_local_dir(...)")

    def add_local_python_source(self, *modules: str, copy: bool = False) -> "_Image":
        return self._extend(
            [f"#MOUNT_PYTHON_SOURCE {m}" for m in modules], rep=f"{self._rep}.add_local_python_source(...)"
        )

    def run_function(
        self,
        raw_f: Callable,
        *,
        secrets: Sequence[_Secret] = (),
        args: tuple = (),
        kwargs: Optional[dict] = None,
        force_build: bool = False,
    ) -> "_Image":
        """Run a function at build time, snapshotting the result into the
        image (reference _image.py:2175) — the standard way to bake model
        weights into a GPU serving image."""
        return _Image._from_args(
            base_images={"base": self},
            dockerfile_commands=["#RUN_FUNCTION"],
            secrets=secrets,
            build_function=raw_f,
            build_function_args=(args, kwargs or {}),
            force_build=force_build,
            rep=f"{self._rep}.run_function({getattr(raw_f, '__name__', 'fn')!r})",
        )

    def prewarm(
        self,
        raw_f: Callable,
        *,
        secrets: Sequence[_Secret] = (),
        args: tuple = (),
        kwargs: Optional[dict] = None,
        force_build: bool = False,
    ) -> "_Image":
        """Kernel-build prewarm at image-build time: run `raw_f` during the
        build with the kernel build dir (`TORCH_EXTENSIONS_DIR`) pointed at
        `<rootfs>/cache/kernels` and recorded as image env, so every kernel
        the function's entry points build (nvcc) is built once at build time
        and every container of the image loads it from there; the libraries
        are also published to the fleet compile store. `raw_f` should build
        what the function launches: set `MODAL_TPU_AOT_LOWER` (e.g.
        ``"train,decode"``) and call `runtime.aot.maybe_aot_lower`. Its
        builds count as COMPILE_EVENTS{source="prewarm"}. Rides on
        `run_function`'s build machinery (server/image_builder.py)."""
        return _Image._from_args(
            base_images={"base": self},
            dockerfile_commands=["#PREWARM"],
            secrets=secrets,
            build_function=raw_f,
            build_function_args=(args, kwargs or {}),
            force_build=force_build,
            rep=f"{self._rep}.prewarm({getattr(raw_f, '__name__', 'fn')!r})",
        )

    def imports(self):
        """Context manager guarding imports that only exist inside the image
        (reference _image.py imports())."""
        import contextlib

        @contextlib.contextmanager
        def _cm():
            try:
                yield
            except ImportError as exc:
                from .config import logger

                logger.debug(f"deferred import error outside image: {exc}")

        return _cm()


Image = synchronize_api(_Image)
