"""Mounts: packaging local files into containers (port of modal_tpu/mount.py).

Reference: py/modal/mount.py — `_Mount` (mount.py:290), `_MountDir`/
`_MountedPythonModule` entries (mount.py:137,231), content dedup via
MountPutFile sha256 (upload only what the server lacks).

Local-backend note: workers share the client's filesystem, so mounts
materialize only when a container runs on a remote host; the content store
is the same content-addressed block store volumes use.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path, PurePosixPath
from typing import Callable, Optional, Sequence, Union

from ._utils.async_utils import synchronize_api
from ._utils.grpc_utils import retry_transient_errors
from ._utils.hash_utils import get_sha256_hex
from .exception import InvalidError
from .object import LoadContext, Resolver, _Object
from .proto import api_pb2

# where a mount lands in the container when no remote path is given (the
# reference's default, py/modal/mount.py)
_REMOTE_ROOT = PurePosixPath("/root")


@dataclass
class _MountFile:
    local_path: Path
    remote_path: str

    def description(self) -> str:
        return str(self.local_path)


class _Mount(_Object, type_prefix="mo"):
    _entries: list[_MountFile]

    def _initialize_from_empty(self) -> None:
        self._entries = []

    @staticmethod
    def _from_entries(entries: list[_MountFile], rep: str) -> "_Mount":
        async def _load(self: "_Mount", resolver: Resolver, context: LoadContext, existing_object_id: Optional[str]):
            stub = context.client.stub
            files = []
            for entry in self._entries:
                with open(entry.local_path, "rb") as f:
                    data = f.read()
                sha = get_sha256_hex(data)
                # dedup: probe first (empty data = existence check), upload on miss
                probe = await retry_transient_errors(
                    stub.MountPutFile, api_pb2.MountPutFileRequest(sha256_hex=sha)
                )
                if not probe.exists:
                    await retry_transient_errors(
                        stub.MountPutFile, api_pb2.MountPutFileRequest(sha256_hex=sha, data=data)
                    )
                st = entry.local_path.stat()
                files.append(
                    api_pb2.MountFile(
                        filename=entry.remote_path, sha256_hex=sha, mode=st.st_mode & 0o7777, size=st.st_size
                    )
                )
            resp = await retry_transient_errors(
                stub.MountGetOrCreate,
                api_pb2.MountGetOrCreateRequest(
                    object_creation_type=api_pb2.OBJECT_CREATION_TYPE_ANONYMOUS_OWNED_BY_APP,
                    files=files,
                    app_id=context.app_id or "",
                    environment_name=context.environment_name,
                ),
            )
            self._hydrate(resp.mount_id, context.client, resp.handle_metadata)

        obj = _Mount._from_loader(_load, rep, hydrate_lazily=True)
        obj._entries = entries
        return obj

    @staticmethod
    def from_local_file(local_path: Union[str, Path], remote_path: Optional[str] = None) -> "_Mount":
        local = Path(local_path)
        if not local.is_file():
            raise InvalidError(f"{local_path} is not a file")
        remote = remote_path or str(_REMOTE_ROOT / local.name)
        return _Mount._from_entries(
            [_MountFile(local, remote.lstrip("/"))], f"Mount.from_local_file({local_path!r})"
        )

    @staticmethod
    def from_local_dir(
        local_path: Union[str, Path],
        *,
        remote_path: Optional[str] = None,
        condition: Optional[Callable[[str], bool]] = None,
        ignore: "Union[Sequence[str], Callable[[str], bool], None]" = None,
        recursive: bool = True,
    ) -> "_Mount":
        local = Path(local_path)
        if not local.is_dir():
            raise InvalidError(f"{local_path} is not a directory")
        if ignore is not None and condition is not None:
            raise InvalidError("pass either ignore or condition, not both")
        ignore_fn: Optional[Callable[[str], bool]] = None
        if ignore is not None:
            if callable(ignore):
                ignore_fn = ignore
            else:
                from .file_pattern_matcher import FilePatternMatcher

                if isinstance(ignore, str):
                    # a bare string would splat char-by-char ("*" alone
                    # silently excludes everything)
                    ignore = [ignore]
                ignore_fn = FilePatternMatcher(*ignore)
        remote = PurePosixPath(remote_path or str(_REMOTE_ROOT / local.name))
        entries = []
        it = local.rglob("*") if recursive else local.glob("*")
        for p in sorted(it):
            if not p.is_file():
                continue
            # ignore patterns match the path RELATIVE to the mounted dir
            if ignore_fn is not None and ignore_fn(str(p.relative_to(local))):
                continue
            if condition is not None and not condition(str(p)):
                continue
            rel = p.relative_to(local)
            entries.append(_MountFile(p, str(remote / PurePosixPath(*rel.parts)).lstrip("/")))
        return _Mount._from_entries(entries, f"Mount.from_local_dir({local_path!r})")

    @staticmethod
    def from_local_python_packages(*module_names: str) -> "_Mount":
        """Package importable modules (reference _MountedPythonModule,
        mount.py:231)."""
        import importlib.util

        entries: list[_MountFile] = []
        for name in module_names:
            spec = importlib.util.find_spec(name)
            if spec is None or spec.origin is None:
                raise InvalidError(f"can't find module {name}")
            origin = Path(spec.origin)
            if origin.name == "__init__.py":
                pkg_dir = origin.parent
                for p in sorted(pkg_dir.rglob("*.py")):
                    rel = p.relative_to(pkg_dir.parent)
                    entries.append(_MountFile(p, str(PurePosixPath("root") / PurePosixPath(*rel.parts))))
            else:
                entries.append(_MountFile(origin, f"root/{origin.name}"))
        return _Mount._from_entries(entries, f"Mount.from_local_python_packages{module_names!r}")


Mount = synchronize_api(_Mount)
