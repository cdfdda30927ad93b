"""Package logger, the settings of the SDK core and of the cold-start
runtime, the device rule every entry point follows, and the host-to-device
copy that does not wait for the stream.

Importing this module loads no torch: the client, the control plane, the
worker and a container's entrypoint all import it, and a container sends
its hello before torch is loaded. The two device functions import torch
when they are called.

Settings are the JAX package's (modal_tpu/config.py), under the same names
and defaults. Each is resolved at every read: the environment variable
``MODAL_TPU_<KEY>``, else the active profile's section of the TOML file
(``MODAL_TPU_CONFIG_PATH``, default ``~/.modal_tpu.toml``; the profile is
``MODAL_TPU_PROFILE`` or the section marked ``active = true``), else the
default. The command line's `token set`, `token new` and `profile
activate` write that file (`_store_user_config`,
`config_set_active_profile`).
"""

from __future__ import annotations

import logging
import os
import tomllib
from typing import TYPE_CHECKING, Any, Callable, NamedTuple, Optional, Union

if TYPE_CHECKING:
    import torch

logger = logging.getLogger("modal_tpu_torch")
if not logger.handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(logging.Formatter("[%(name)s] %(levelname)s %(message)s"))
    logger.addHandler(_handler)
    logger.setLevel(os.environ.get("MODAL_TPU_TORCH_LOGLEVEL", "WARNING").upper())
    logger.propagate = False


def user_config_path() -> str:
    return os.environ.get("MODAL_TPU_CONFIG_PATH") or os.path.expanduser("~/.modal_tpu.toml")


def _read_user_config() -> dict:
    path = user_config_path()
    if os.path.exists(path):
        with open(path, "rb") as f:
            return tomllib.load(f)
    return {}


def _active_profile(user_config: dict) -> str:
    if os.environ.get("MODAL_TPU_PROFILE"):
        return os.environ["MODAL_TPU_PROFILE"]
    for key, values in user_config.items():
        if isinstance(values, dict) and values.get("active", False) is True:
            return key
    return "default"


def config_profiles() -> list[str]:
    return list(_read_user_config().keys())


def config_set_active_profile(env: str) -> None:
    """Mark `env` the active profile of the TOML file (creating its section)."""
    user_config = _read_user_config()
    for values in user_config.values():
        values.pop("active", None)
    user_config.setdefault(env, {})["active"] = True
    _write_user_config(user_config)


def _write_user_config(new_config: dict) -> None:
    # tomllib has no writer: emit the subset the profiles use. Strings are
    # escaped (a token may hold quotes or backslashes; an unescaped write
    # would corrupt the file for every later read)
    def _esc(s: str) -> str:
        return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")

    lines = []
    for profile, values in new_config.items():
        lines.append(f"[{profile}]")
        for k, v in values.items():
            if isinstance(v, bool):
                lines.append(f"{k} = {'true' if v else 'false'}")
            elif isinstance(v, (int, float)):
                lines.append(f"{k} = {v}")
            else:
                lines.append(f'{k} = "{_esc(str(v))}"')
        lines.append("")
    with open(user_config_path(), "w") as f:
        f.write("\n".join(lines))


def _store_user_config(new_settings: dict, profile: Optional[str] = None) -> None:
    """Merge `new_settings` into `profile`'s section (default: the active one)."""
    user_config = _read_user_config()
    profile = profile or _active_profile(user_config)
    user_config.setdefault(profile, {}).update(**new_settings)
    _write_user_config(user_config)


class _Setting(NamedTuple):
    default: Any = None
    transform: Callable[[Any], Any] = lambda x: x


def _to_boolean(x: Any) -> bool:
    return str(x).lower() not in ("", "0", "false", "no", "none")


# the JAX package's settings (modal_tpu/config.py:89-160) that a module of
# the port reads: the client, the App layer, the control plane, the worker,
# the container runtime and the cold-start runtime; the others come with the
# module that reads them
_SETTINGS: dict[str, _Setting] = {
    "server_url": _Setting("grpc://127.0.0.1:9900"),
    # when the server_url is the default and nothing listens there, the
    # client boots an in-process LocalSupervisor (client.py)
    "auto_local_server": _Setting(True, _to_boolean),
    "token_id": _Setting(),
    "token_secret": _Setting(),
    "task_id": _Setting(),
    # a container heartbeats every heartbeat_interval / 3 seconds (io_manager)
    "heartbeat_interval": _Setting(15.0, float),
    # the App layer: the environment apps and objects are created in, the
    # grace `app.run()` gives its heartbeat loop at exit, and the image
    # builder version and force-build flag an Image definition carries
    "environment": _Setting(""),
    "logs_timeout": _Setting(10.0, float),
    "image_builder_version": _Setting("2026.07"),
    "force_build": _Setting(False, _to_boolean),
    # local state: the control plane's journal, blobs, task dirs and traces,
    # and snapshots under <state_dir>/snapshots. Not the JAX package's
    # ~/.modal_tpu_state: a plane that `app.run()` boots recovers the
    # journal it finds there, and must not replay the other package's apps
    "state_dir": _Setting(os.path.expanduser("~/.modal_tpu_torch_state")),
    # a worker's placement labels (matched against SchedulerPlacement)
    "worker_region": _Setting(""),
    "worker_zone": _Setting(""),
    "worker_spot": _Setting(False, _to_boolean),
    "worker_instance_type": _Setting(""),
    # per-module import tracing in containers (<task_dir>/imports.jsonl)
    "import_trace": _Setting(False, _to_boolean),
    # the warm pool (server/warm_pool.py): parked interpreters per worker for
    # the host-venv image (0 = off; the scheduler adds per-image pools from
    # min_containers / buffer_containers), the modules a parked interpreter
    # imports (comma-separated; JAX's default is "jax"), "1" to also prime
    # torch's CPU side while parked (warm_pool_preinit; never CUDA, whose
    # context would fix the cards before adoption pins them), and how long
    # an adoption waits for the interpreter's ack before the worker spawns
    # fresh
    "warm_pool": _Setting(0, int),
    "warm_pool_preimport": _Setting("torch"),
    "warm_pool_preinit": _Setting(False, _to_boolean),
    "warm_pool_ack_timeout": _Setting(10.0, float),
}


class Config:
    """`config[key]`: `MODAL_TPU_<KEY>` when set, else the active TOML
    profile's value, else the default; read at each access, so a process
    may point a setting elsewhere at run time."""

    def __getitem__(self, key: str) -> Any:
        s = _SETTINGS[key]
        env_var_key = "MODAL_TPU_" + key.upper()
        if env_var_key in os.environ:
            return s.transform(os.environ[env_var_key])
        user_config = _read_user_config()
        section = user_config.get(_active_profile(user_config), {})
        if key in section:
            return s.transform(section[key])
        return s.default

    def override_locally(self, key: str, value: str) -> None:
        """Point a setting elsewhere for this process and its children (a
        container adopts its task id this way)."""
        os.environ["MODAL_TPU_" + key.upper()] = value

    def to_dict(self) -> dict[str, Any]:
        return {key: self[key] for key in _SETTINGS}


config = Config()


# the interpreter's thread switch interval in the processes that hand every
# input between threads, where CPython's default 5 ms would stall each handoff
SWITCH_INTERVAL_S = 0.001


def tune_switch_interval() -> None:
    """Set SWITCH_INTERVAL_S in a process that hands every input between
    threads (the supervisor: caller and loop thread; a container: serving
    loop and main-thread executor)."""
    import sys

    sys.setswitchinterval(SWITCH_INTERVAL_S)


def torch_imported() -> bool:
    """Has this process finished importing torch? A module another thread
    is still importing is in `sys.modules` already, half built: code that
    only attaches to torch (telemetry, the fleet tier) must wait for the
    import to finish, not block on it or call into it."""
    import sys

    mod = sys.modules.get("torch")
    return mod is not None and not getattr(getattr(mod, "__spec__", None), "_initializing", False)


def resolve_device(device: Optional[Union[str, "torch.device"]] = None) -> "torch.device":
    """`None` means CUDA. A CUDA request without a usable card raises; the
    CPU is used only when the caller names it (the CPU tests do)."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())  # compares equal to tensors' .device
    return dev


def host_to_device(values, device: "torch.device", dtype: Optional["torch.dtype"] = None) -> "torch.Tensor":
    """A host array (numpy, list or CPU tensor) as a tensor on `device`. On
    CUDA the copy goes through pinned memory with `non_blocking=True`: a
    copy from pageable memory waits for every launch queued before it, which
    would put a host sync into code that must only queue work."""
    import torch

    t = torch.as_tensor(values, dtype=dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
