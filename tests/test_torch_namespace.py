"""The port's top-level names against the JAX package's: every name that
`import modal_tpu` binds (modules aside) and every name its `__getattr__`
serves resolves in `modal_tpu_torch`, under the one mapping of TPU names to
their GPU counterparts (`modal_tpu_torch.JAX_NAMES`); `__all__` and the star
import match under it; `config` is the `Config` object in both."""

import os
import subprocess
import sys
import textwrap
import types

import pytest

import modal_tpu
import modal_tpu_torch
from modal_tpu_torch import JAX_NAMES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fresh(code: str) -> str:
    """Run `code` in a fresh interpreter from the repo root; its stdout."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    env.update({"PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"})
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


# the names a fresh `import modal_tpu` binds, modules and dunders aside
_EAGER = sorted(
    eval(_fresh("""
        import types, modal_tpu
        print(sorted(n for n, v in vars(modal_tpu).items()
                     if not isinstance(v, types.ModuleType) and not (n.startswith("__") and n.endswith("__"))))
    """))
)
# and those its __getattr__ serves (the lazy half of __all__, and `serving`)
_LAZY = sorted({*modal_tpu.__all__, "serving"} - set(_EAGER))


def _port(name: str) -> str:
    return JAX_NAMES.get(name, name)


@pytest.mark.parametrize("name", _EAGER + [n for n in _LAZY if n not in _EAGER])
def test_every_top_level_name_of_the_jax_package_resolves_in_the_port(name):
    value = getattr(modal_tpu_torch, _port(name))
    jax_value = getattr(modal_tpu, name)
    assert isinstance(value, types.ModuleType) == isinstance(jax_value, types.ModuleType)
    assert callable(value) == callable(jax_value)
    if isinstance(jax_value, type):
        assert isinstance(value, type) and value.__name__ == _port(jax_value.__name__)


def test_the_mapping_names_only_tpu_names_with_a_gpu_counterpart():
    assert JAX_NAMES == {"TPUSliceSpec": "GPUSpec", "parse_tpu_config": "parse_gpu_config"}
    for jax_name, port_name in JAX_NAMES.items():
        assert hasattr(modal_tpu, jax_name) and not hasattr(modal_tpu_torch, jax_name)
        assert port_name in modal_tpu_torch.__all__


def test_all_is_the_jax_packages_under_the_mapping():
    assert modal_tpu_torch.__all__ == [_port(n) for n in modal_tpu.__all__]
    assert all(hasattr(modal_tpu_torch, n) for n in modal_tpu_torch.__all__)


def test_the_star_import_binds_every_name_of_the_jax_packages():
    got = eval(_fresh("""
        names = {}
        for package in ("modal_tpu", "modal_tpu_torch"):
            ns = {}
            exec(f"from {package} import *", ns)
            names[package] = sorted(set(ns) - {"__builtins__"})
        print(names)
    """))
    assert len(got["modal_tpu"]) == len(modal_tpu.__all__)
    assert sorted(_port(n) for n in got["modal_tpu"]) == got["modal_tpu_torch"]


def test_config_is_the_config_object_with_the_jax_packages_defaults():
    from modal_tpu.config import Config as JaxConfig
    from modal_tpu_torch.config import Config

    assert isinstance(modal_tpu_torch.config, Config) and isinstance(modal_tpu.config, JaxConfig)
    assert modal_tpu_torch.config["loglevel"] == modal_tpu.config["loglevel"]
    assert modal_tpu_torch.config["heartbeat_interval"] == modal_tpu.config["heartbeat_interval"]
    assert modal_tpu_torch.config["server_url"] == modal_tpu.config["server_url"]
    # importing the settings module (as every SDK module does) leaves the
    # package's `config` the object
    assert isinstance(sys.modules["modal_tpu_torch"].config, Config)


def test_config_stays_the_object_after_the_module_loads_in_a_fresh_interpreter():
    out = _fresh("""
        import sys
        import modal_tpu_torch
        assert "torch" not in sys.modules
        import modal_tpu_torch.client, modal_tpu_torch.app  # each imports the settings module
        from modal_tpu_torch.config import Config
        print(type(modal_tpu_torch.config).__name__, modal_tpu_torch.config["loglevel"],
              isinstance(modal_tpu_torch.config, Config), "torch" in sys.modules)
    """)
    assert out.split() == ["Config", "WARNING", "True", "False"]


def test_the_exceptions_are_the_ports_own():
    from modal_tpu_torch import exception

    assert modal_tpu_torch.NotFoundError is exception.NotFoundError
    assert modal_tpu_torch.Error is exception.Error
    assert issubclass(modal_tpu_torch.TimeoutError, TimeoutError)
    assert modal_tpu_torch.Client is sys.modules["modal_tpu_torch.client"].Client
