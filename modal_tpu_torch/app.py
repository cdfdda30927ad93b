"""App: the blueprint of functions/classes and the decorator surface (port of
modal_tpu/app.py).

Reference: py/modal/app.py — `_App` (app.py:136), `@app.function` (app.py:778
with its full parameter surface), `@app.cls` (app.py:1035),
`@app.local_entrypoint` (app.py:703), `app.include` (app.py:1475), and
py/modal/runner.py for run/deploy (runner.py:364,585).

`gpu="H100"` (or "H100:8", with `mesh=` hints over the cards) replaces the
JAX package's `tpu=`. Decorating registers a function on the app and
contacts nothing: a container that imports the user's file runs its
`App(...)` and decorators, and `app.run()` creates the objects. A
function's `@batched`, `@concurrent` and web decorator parameters go into
its definition, and `schedule=` fires it from the control plane's cron loop.
`volumes=` (on the App, or a function, whose entries win) maps container
paths to Volumes and CloudBucketMounts, and `@clustered` makes a function a
gang. `runtime_debug=True` profiles each input with torch.profiler in the
container (runtime/container_entrypoint.py), and `proxy=` binds a
static-egress Proxy. `cloud=` rides the definition (`cloud_provider_str`),
which neither package's plane places by; `tpu=` is refused with
InvalidError.
"""

from __future__ import annotations

import typing
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Union

from ._utils.async_utils import synchronize_api
from ._utils.function_utils import FunctionInfo, check_valid_function
from .client import _Client
from .config import config, logger
from .exception import InvalidError
from .functions import _Function, _FunctionSpec
from .gpu_config import parse_gpu_config
from .image import _Image
from .partial_function import _PartialFunction, _PartialFunctionParams
from .proto import api_pb2
from .retries import Retries
from .schedule import Schedule, SchedulerPlacement
from .secret import _Secret

if typing.TYPE_CHECKING:
    from .cls import _Cls

_default_image: Optional[_Image] = None


def _get_default_image() -> _Image:
    global _default_image
    if _default_image is None:
        _default_image = _Image.debian_slim()
    return _default_image


TPU_REFUSAL = "tpu= asks for TPU chips, which the port does not place: ask for cards with gpu="


@dataclass
class _LocalEntrypoint:
    raw_f: Callable
    app: "_App"
    info: FunctionInfo

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.raw_f(*args, **kwargs)

    @property
    def name(self) -> str:
        return self.info.function_name


class _App:
    """An app: its functions, classes and local entrypoints, created on the
    control plane by `run()` or `deploy()`. `include_source` is accepted as
    the JAX package's App accepts it: a function's code travels serialized
    or is found again by its file path."""

    def __init__(
        self,
        name: Optional[str] = None,
        *,
        image: Optional[_Image] = None,
        secrets: Sequence[_Secret] = (),
        volumes: Optional[dict[str, Any]] = None,
        include_source: bool = True,
    ):
        if name is not None and not isinstance(name, str):
            raise InvalidError("app name must be a string")
        self._name = name
        self._description = name
        self._image = image
        self._secrets = list(secrets)
        self._volumes = dict(volumes or {})

        self._functions: dict[str, _Function] = {}
        self._classes: dict[str, "_Cls"] = {}
        self._local_entrypoints: dict[str, _LocalEntrypoint] = {}

        self._app_id: Optional[str] = None
        self._client: Optional[_Client] = None

    # -- properties ---------------------------------------------------------

    @property
    def name(self) -> Optional[str]:
        return self._name

    @property
    def description(self) -> Optional[str]:
        return self._description or self._name

    @property
    def app_id(self) -> Optional[str]:
        return self._app_id

    @property
    def is_interactive(self) -> bool:
        """Always False: no app runs attached to a terminal."""
        return False

    @property
    def image(self) -> Optional[_Image]:
        return self._image

    @image.setter
    def image(self, image: _Image) -> None:
        self._image = image

    @property
    def registered_functions(self) -> dict[str, _Function]:
        return dict(self._functions)

    @property
    def registered_classes(self) -> dict[str, Any]:
        return dict(self._classes)

    @property
    def registered_entrypoints(self) -> dict[str, _LocalEntrypoint]:
        return dict(self._local_entrypoints)

    def set_description(self, description: str) -> None:
        self._description = description

    # -- registration -------------------------------------------------------

    def _add_function(self, function: _Function, tag: Optional[str] = None) -> None:
        tag = tag or function.tag
        if tag in self._functions:
            logger.warning(f"overwriting existing function {tag!r} on app")
        self._functions[tag] = function

    def _add_class(self, tag: str, cls: "_Cls") -> None:
        self._classes[tag] = cls

    # -- decorators ---------------------------------------------------------

    def function(
        self,
        _warn_parentheses_missing: Any = None,
        *,
        image: Optional[_Image] = None,
        schedule: Optional[Schedule] = None,
        secrets: Sequence[_Secret] = (),
        volumes: Optional[dict[str, Any]] = None,
        mounts: Sequence[Any] = (),
        proxy: Optional[Any] = None,
        gpu: Optional[str] = None,
        mesh: Optional[dict[str, int]] = None,
        cpu: Optional[float] = None,
        memory: Optional[int] = None,
        ephemeral_disk: Optional[int] = None,
        serialized: bool = False,
        timeout: int = 300,
        startup_timeout: int = 300,
        retries: Optional[Union[int, Retries]] = None,
        min_containers: int = 0,
        max_containers: int = 0,
        buffer_containers: int = 0,
        scaledown_window: int = 60,
        target_ttft_ms: float = 0.0,
        target_tokens_per_replica: float = 0.0,
        cloud: Optional[str] = None,
        region: Optional[Union[str, Sequence[str]]] = None,
        scheduler_placement: Optional[SchedulerPlacement] = None,
        enable_memory_snapshot: bool = False,
        restrict_output: bool = False,
        is_generator: Optional[bool] = None,
        name: Optional[str] = None,
        i6pn: bool = False,
        runtime_debug: bool = False,
        payload_format: str = "pickle",
        experimental_options: Optional[dict[str, str]] = None,
        tpu: Optional[str] = None,
    ) -> Callable[[Union[Callable, _PartialFunction]], _Function]:
        """Register a function with this app (reference app.py:778).

        `gpu="H100"` asks for one card, `gpu="H100:8"` for eight of one host;
        `mesh={"data": 2, "fsdp": 4}` names the logical axes over them.
        """
        if _warn_parentheses_missing is not None:
            raise InvalidError("Did you forget parentheses? Use @app.function().")
        if payload_format not in ("pickle", "cbor"):
            raise InvalidError(f"payload_format must be 'pickle' or 'cbor', got {payload_format!r}")
        if tpu:
            raise InvalidError(TPU_REFUSAL)
        gpu_spec = parse_gpu_config(gpu, mesh)

        def wrapper(f: Union[Callable, _PartialFunction]) -> _Function:
            nonlocal is_generator
            params = _PartialFunctionParams()
            if isinstance(f, _PartialFunction):
                f.wrapped = True
                params = f.params
                raw_f = f.raw_f
            else:
                raw_f = f
            check_valid_function(raw_f)

            info = FunctionInfo(raw_f, serialized=serialized, name_override=name)
            placement = scheduler_placement or (SchedulerPlacement(region=region) if region else None)
            spec = _FunctionSpec(
                image=image or self._image or _get_default_image(),
                secrets=[*self._secrets, *secrets],
                volumes={**self._volumes, **(volumes or {})},
                mounts=list(mounts),
                proxy=proxy,
                cloud=cloud,
                gpu=gpu_spec,
                cpu=cpu,
                memory=memory,
                ephemeral_disk=ephemeral_disk,
                timeout=timeout,
                startup_timeout=startup_timeout,
                retries=retries,
                min_containers=min_containers,
                max_containers=max_containers,
                buffer_containers=buffer_containers,
                scaledown_window=scaledown_window,
                target_ttft_ms=target_ttft_ms,
                target_tokens_per_replica=target_tokens_per_replica,
                max_concurrent_inputs=params.max_concurrent_inputs or 0,
                target_concurrent_inputs=params.target_concurrent_inputs or 0,
                batch_max_size=params.batch_max_size or 0,
                batch_wait_ms=params.batch_wait_ms or 0,
                schedule=schedule,
                scheduler_placement=placement,
                enable_memory_snapshot=enable_memory_snapshot,
                restrict_output=restrict_output,
                payload_format=payload_format,
                experimental_options={
                    # runtime_debug rides experimental_options like the
                    # reference's perf knobs (api.proto:1863,1944): each
                    # input runs under torch.profiler and its trace lands in
                    # the task's dir (AppListProfiles)
                    **({"runtime_debug": "1"} if runtime_debug else {}),
                    **dict(experimental_options or {}),
                },
                cluster_size=params.cluster_size or 0,
                broadcast_inputs=params.broadcast_inputs,
                fabric_size=params.fabric_size or 0,
                i6pn=i6pn,
            )
            if is_generator is None:
                is_generator = params.is_generator
            function = _Function.from_local(
                info,
                self,
                spec,
                is_generator=is_generator,
                webhook_type=params.webhook_type or api_pb2.WEB_ENDPOINT_TYPE_UNSPECIFIED,
            )
            if params.web_method:
                spec.experimental_options["web_method"] = params.web_method
            if params.web_server_port:
                spec.experimental_options["web_server_port"] = str(params.web_server_port)
                spec.experimental_options["web_server_startup_timeout"] = str(
                    params.web_server_startup_timeout or 60.0
                )
            self._add_function(function)
            return function

        return wrapper

    def cls(
        self,
        _warn_parentheses_missing: Any = None,
        **kwargs: Any,
    ) -> Callable[[type], Any]:
        """Register a class with lifecycle hooks + methods (reference
        app.py:1035). Accepts the same kwargs as `function`."""
        if _warn_parentheses_missing is not None:
            raise InvalidError("Did you forget parentheses? Use @app.cls().")

        def wrapper(user_cls: type):
            from .cls import _Cls

            cls_obj = _Cls.from_local(user_cls, self, **kwargs)
            self._add_class(user_cls.__name__, cls_obj)
            return cls_obj

        return wrapper

    def local_entrypoint(
        self, _warn_parentheses_missing: Any = None, *, name: Optional[str] = None
    ) -> Callable[[Callable], _LocalEntrypoint]:
        """CLI entrypoint running locally inside an ephemeral app run
        (reference app.py:703)."""
        if _warn_parentheses_missing is not None:
            raise InvalidError("Did you forget parentheses? Use @app.local_entrypoint().")

        def wrapper(raw_f: Callable) -> _LocalEntrypoint:
            info = FunctionInfo(raw_f, name_override=name)
            entrypoint = _LocalEntrypoint(raw_f, self, info)
            self._local_entrypoints[info.function_name] = entrypoint
            return entrypoint

        return wrapper

    def include(self, other_app: "_App") -> "_App":
        """Merge another app's registrations (reference app.py:1475)."""
        for tag, fn in other_app._functions.items():
            self._add_function(fn, tag)
        for tag, cls in other_app._classes.items():
            self._add_class(tag, cls)
        return self

    # -- run/deploy ---------------------------------------------------------

    def run(
        self,
        *,
        client: Optional[_Client] = None,
        detach: bool = False,
        environment_name: Optional[str] = None,
    ):
        """Context manager: run this app ephemerally (reference app.run).
        Supports both `with app.run():` and `async with app.run():`. Without
        a client and a configured server, the first run boots the port's
        in-process LocalSupervisor (client.py)."""
        from .runner import _AppRun

        return _AppRun(self, client=client, detach=detach, environment_name=environment_name)

    async def deploy(
        self,
        *,
        name: Optional[str] = None,
        client: Optional[_Client] = None,
        environment_name: Optional[str] = None,
        tag: str = "",
    ) -> "_App":
        from .runner import _deploy_app

        await _deploy_app(self, name=name, client=client, environment_name=environment_name, tag=tag)
        return self

    @staticmethod
    async def lookup(name: str, *, client: Optional[_Client] = None, environment_name: Optional[str] = None) -> "_App":
        """Get or create a deployed app by name."""
        if client is None:
            client = await _Client.from_env()
        from ._utils.grpc_utils import retry_transient_errors
        from .proto import api_pb2

        resp = await retry_transient_errors(
            client.stub.AppGetOrCreate,
            api_pb2.AppGetOrCreateRequest(
                app_name=name,
                environment_name=environment_name or config["environment"],
                object_creation_type=api_pb2.OBJECT_CREATION_TYPE_CREATE_IF_MISSING,
            ),
        )
        app = _App(name)
        app._app_id = resp.app_id
        app._client = client
        return app

    def __repr__(self) -> str:
        return f"App({self._name or 'unnamed'})"


App = synchronize_api(_App)
