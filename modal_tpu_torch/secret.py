"""Secrets: named env-var bundles (port of modal_tpu/secret.py; reference
py/modal/secret.py `_Secret`). The control plane resolves a function's
secrets into its container's environment when it places the task."""

from __future__ import annotations

import os
from typing import Optional

from ._utils.async_utils import synchronize_api
from .client import _Client
from .exception import InvalidError
from .object import LoadContext, Resolver, _Object
from ._utils.grpc_utils import retry_transient_errors
from .proto import api_pb2


class _Secret(_Object, type_prefix="st"):
    """A bundle of environment variables injected into containers."""

    @staticmethod
    def from_dict(env_dict: dict[str, str] = {}) -> "_Secret":
        if not all(isinstance(k, str) and isinstance(v, (str, type(None))) for k, v in env_dict.items()):
            raise InvalidError("Secret.from_dict keys and values must be strings")

        async def _load(self: "_Secret", resolver: Resolver, context: LoadContext, existing_object_id: Optional[str]):
            req = api_pb2.SecretGetOrCreateRequest(
                object_creation_type=api_pb2.OBJECT_CREATION_TYPE_ANONYMOUS_OWNED_BY_APP,
                env_dict={k: v for k, v in env_dict.items() if v is not None},
                app_id=context.app_id or "",
                environment_name=context.environment_name,
            )
            resp = await retry_transient_errors(context.client.stub.SecretGetOrCreate, req)
            self._hydrate(resp.secret_id, context.client, None)

        return _Secret._from_loader(_load, "Secret.from_dict()")

    @staticmethod
    def from_local_environ(env_keys: list[str]) -> "_Secret":
        """Capture named variables from the local environment."""
        try:
            env_dict = {k: os.environ[k] for k in env_keys}
        except KeyError as exc:
            raise InvalidError(f"local environment variable {exc} is not set") from None
        return _Secret.from_dict(env_dict)

    @staticmethod
    def from_name(
        name: str,
        *,
        environment_name: Optional[str] = None,
        required_keys: list[str] = [],
    ) -> "_Secret":
        async def _load(self: "_Secret", resolver: Resolver, context: LoadContext, existing_object_id: Optional[str]):
            req = api_pb2.SecretGetOrCreateRequest(
                deployment_name=name,
                environment_name=environment_name or context.environment_name,
            )
            resp = await retry_transient_errors(context.client.stub.SecretGetOrCreate, req)
            self._hydrate(resp.secret_id, context.client, None)

        return _Secret._from_loader(_load, f"Secret.from_name({name!r})", hydrate_lazily=True)

    @staticmethod
    async def create_deployed(
        deployment_name: str,
        env_dict: dict[str, str],
        *,
        client: Optional[_Client] = None,
        environment_name: Optional[str] = None,
        overwrite: bool = True,
    ) -> str:
        if client is None:
            client = await _Client.from_env()
        req = api_pb2.SecretGetOrCreateRequest(
            deployment_name=deployment_name,
            env_dict=env_dict,
            environment_name=environment_name or "",
            object_creation_type=(
                api_pb2.OBJECT_CREATION_TYPE_CREATE_IF_MISSING
                if overwrite
                else api_pb2.OBJECT_CREATION_TYPE_CREATE_FAIL_IF_EXISTS
            ),
        )
        resp = await retry_transient_errors(client.stub.SecretGetOrCreate, req)
        return resp.secret_id


Secret = synchronize_api(_Secret)
