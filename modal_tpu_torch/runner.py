"""Run/deploy orchestration (port of modal_tpu/runner.py).

Reference: py/modal/runner.py — `_run_app` (runner.py:364), `_deploy_app`
(runner.py:585), `_create_all_objects` (runner.py:136), `_publish_app`
(runner.py:273), heartbeat loop (runner.py:61), disconnect
(_status_based_disconnect, runner.py:339).

`app.run()` without a client takes `_Client.from_env()`, which boots the
port's in-process LocalSupervisor when no server is configured (client.py).
"""

from __future__ import annotations

import asyncio
import contextlib
import typing
from typing import Any, AsyncGenerator, Optional

from ._utils.async_utils import TaskContext, synchronize_api
from ._utils.grpc_utils import retry_transient_errors
from .client import HEARTBEAT_INTERVAL, _Client
from .config import config, logger
from .exception import InvalidError
from . import _output
from .object import LoadContext, Resolver
from .proto import api_pb2

if typing.TYPE_CHECKING:
    from .app import _App


async def _heartbeat(client: _Client, app_id: str) -> None:
    request = api_pb2.AppHeartbeatRequest(app_id=app_id)
    await retry_transient_errors(client.stub.AppHeartbeat, request, attempt_timeout=HEARTBEAT_INTERVAL)


async def _create_all_objects(
    app: "_App",
    client: _Client,
    app_id: str,
    environment_name: str,
) -> tuple[dict[str, str], dict[str, str]]:
    """Load every function/class on the app in parallel through one Resolver
    (reference runner.py:136)."""
    resolver = Resolver()
    context = LoadContext(client=client, environment_name=environment_name, app_id=app_id)

    async def _load_fn(tag: str, obj: Any) -> None:
        await resolver.load(obj, context)

    functions_and_classes = list(app._functions.items()) + list(app._classes.items())
    await asyncio.gather(*[_load_fn(tag, obj) for tag, obj in functions_and_classes])

    function_ids = {tag: fn.object_id for tag, fn in app._functions.items()}
    class_ids = {tag: cls.object_id for tag, cls in app._classes.items()}
    return function_ids, class_ids


async def _publish_app(
    app: "_App",
    client: _Client,
    app_id: str,
    state: int,
    function_ids: dict[str, str],
    class_ids: dict[str, str],
    name: str = "",
    tag: str = "",
) -> str:
    req = api_pb2.AppPublishRequest(
        app_id=app_id,
        name=name,
        deployment_tag=tag,
        app_state=state,
        function_ids=function_ids,
        class_ids=class_ids,
    )
    resp = await retry_transient_errors(client.stub.AppPublish, req)
    for warning in resp.warnings:
        logger.warning(warning)
    return resp.url


async def _status_based_disconnect(client: _Client, app_id: str, exc_info: Optional[BaseException] = None) -> None:
    """AppClientDisconnect on exit (reference runner.py:339)."""
    try:
        await retry_transient_errors(
            client.stub.AppClientDisconnect,
            api_pb2.AppClientDisconnectRequest(app_id=app_id, source=api_pb2.APP_STOP_SOURCE_PYTHON_CLIENT),
            max_retries=2,
            total_timeout=10.0,
        )
    except Exception as exc:
        logger.warning(f"app disconnect failed: {exc}")


@contextlib.asynccontextmanager
async def _run_app(
    app: "_App",
    *,
    client: Optional[_Client] = None,
    detach: bool = False,
    environment_name: Optional[str] = None,
) -> AsyncGenerator["_App", None]:
    """Ephemeral app run: AppCreate → load objects → publish → heartbeats →
    user code → disconnect (reference _run_app, runner.py:364)."""
    if environment_name is None:
        environment_name = config["environment"]
    if client is None:
        client = await _Client.from_env()
    if app._app_id is not None:
        raise InvalidError("app is already running")

    app_state = api_pb2.APP_STATE_DETACHED if detach else api_pb2.APP_STATE_EPHEMERAL
    resp = await retry_transient_errors(
        client.stub.AppCreate,
        api_pb2.AppCreateRequest(
            description=app.description or "", app_state=app_state, environment_name=environment_name
        ),
    )
    app_id = resp.app_id
    app._app_id = app_id
    app._client = client
    logger.debug(f"created app {app_id}")
    _output.done(f"Initialized app {app_id} ({app.description or 'ephemeral'})")

    async with TaskContext(grace=config["logs_timeout"]) as tc:
        tc.infinite_loop(lambda: _heartbeat(client, app_id), sleep=HEARTBEAT_INTERVAL)
        try:
            _output.step("Creating objects...")
            function_ids, class_ids = await _create_all_objects(app, client, app_id, environment_name)
            for tag in function_ids:
                _output.done(f"Created function {tag}")
            for tag in class_ids:
                _output.done(f"Created class {tag}")
            await _publish_app(app, client, app_id, app_state, function_ids, class_ids)
            _output.done("App ready")
            yield app
        except BaseException as exc:
            await _status_based_disconnect(client, app_id, exc)
            app._app_id = None
            raise
    _output.step("Stopping app...")
    await _status_based_disconnect(client, app_id)
    app._app_id = None
    _output.done(f"App {app_id} stopped")
    logger.debug(f"app {app_id} disconnected")


async def _deploy_app(
    app: "_App",
    *,
    name: Optional[str] = None,
    client: Optional[_Client] = None,
    environment_name: Optional[str] = None,
    tag: str = "",
) -> str:
    """Durable deploy (reference _deploy_app, runner.py:585)."""
    name = name or app.name
    if not name:
        raise InvalidError("deploy needs a name: App('name') or deploy(name=...)")
    if environment_name is None:
        environment_name = config["environment"]
    if client is None:
        client = await _Client.from_env()

    resp = await retry_transient_errors(
        client.stub.AppGetOrCreate,
        api_pb2.AppGetOrCreateRequest(
            app_name=name,
            environment_name=environment_name,
            object_creation_type=api_pb2.OBJECT_CREATION_TYPE_CREATE_IF_MISSING,
        ),
    )
    app_id = resp.app_id
    app._app_id = app_id
    app._client = client

    async with TaskContext(grace=2.0) as tc:
        tc.infinite_loop(lambda: _heartbeat(client, app_id), sleep=HEARTBEAT_INTERVAL)
        _output.step(f"Deploying {name}...")
        function_ids, class_ids = await _create_all_objects(app, client, app_id, environment_name)
        for tag in list(function_ids) + list(class_ids):
            _output.done(f"Created {tag}")
        url = await _publish_app(
            app, client, app_id, api_pb2.APP_STATE_DEPLOYED, function_ids, class_ids, name=name, tag=tag
        )
    _output.done(f"Deployed app {name} ({app_id})")
    logger.info(f"deployed app {name} ({app_id})")
    return url


class _AppRun:
    """Context-manager handle for an app run, usable as both `with app.run():`
    and `async with app.run():` (the synchronize_api sugar generates the
    blocking surface from __aenter__/__aexit__)."""

    def __init__(
        self,
        app: "_App",
        *,
        client: Optional[_Client] = None,
        detach: bool = False,
        environment_name: Optional[str] = None,
    ):
        self._cm = _run_app(app, client=client, detach=detach, environment_name=environment_name)

    async def __aenter__(self) -> "_App":
        return await self._cm.__aenter__()

    async def __aexit__(self, *exc: Any) -> Any:
        return await self._cm.__aexit__(*exc)


AppRun = synchronize_api(_AppRun)
deploy_app = synchronize_api(_deploy_app)
