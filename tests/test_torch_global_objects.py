"""`modal_tpu_torch.global_objects` is the counterpart of the JAX side's
`modal_tpu_global_objects` shim: the same two names, with the same
signatures (the port's `publish_base_images` takes one more keyword,
`client`), and the same python versions for every builder epoch."""

import inspect

import pytest

import modal_tpu_global_objects
from modal_tpu_torch import global_objects

NAMES = modal_tpu_global_objects.__all__


def test_the_shim_names_the_two_functions():
    assert NAMES == ["publish_base_images", "supported_python_versions"]


# the port's one addition: the client to publish through (its tests pass a
# plane's; the JAX function takes the env client only)
PORT_ONLY = {"publish_base_images": ["client"], "supported_python_versions": []}


@pytest.mark.parametrize("name", NAMES)
def test_each_name_has_the_shims_signature(name):
    port = list(inspect.signature(getattr(global_objects, name)).parameters.values())
    jax = list(inspect.signature(getattr(modal_tpu_global_objects, name)).parameters.values())
    assert port[:len(jax)] == jax
    assert [p.name for p in port[len(jax):]] == PORT_ONLY[name]
    assert all(p.default is None for p in port[len(jax):])
    assert inspect.signature(getattr(global_objects, name)).return_annotation == inspect.signature(
        getattr(modal_tpu_global_objects, name)).return_annotation


@pytest.mark.parametrize("version", ["2026.04", "2026.07"])
def test_supported_python_versions_are_the_shims(version):
    assert global_objects.supported_python_versions(version) == modal_tpu_global_objects.supported_python_versions(
        version)
