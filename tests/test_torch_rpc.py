"""The port's RPC registry (`modal_tpu_torch/proto/rpc.py`) equals the JAX
package's (`modal_tpu/proto/rpc.py`): names, method paths (the service name
stays `modal.tpu.api.ModalTPU`: the path is the wire contract), arity, and
request and response message names; and a stub of either package builds one
multicallable per RPC."""

import pytest

from modal_tpu.proto import rpc as jrpc
from modal_tpu_torch.proto import rpc as trpc


def _table(registry):
    return [(name, m.path, m.arity.value, m.request_type.DESCRIPTOR.name, m.response_type.DESCRIPTOR.name)
            for name, m in registry.items()]


@pytest.mark.parametrize("attr", ["RPCS", "ROUTER_RPCS"])
def test_registry_equals_jax(attr):
    want, got = _table(getattr(jrpc, attr)), _table(getattr(trpc, attr))
    assert got == want and len(got) > 0
    for _name, _path, _arity, req, resp in got:  # the port's own message classes
        assert trpc.api_pb2.DESCRIPTOR.message_types_by_name[req].full_name.startswith("modal.gpu.api.")
        assert trpc.api_pb2.DESCRIPTOR.message_types_by_name[resp].full_name.startswith("modal.gpu.api.")


def test_service_names_and_overrides_equal_jax():
    assert (trpc.SERVICE_NAME, trpc.ROUTER_SERVICE_NAME) == (jrpc.SERVICE_NAME, jrpc.ROUTER_SERVICE_NAME)
    assert {k: (a, b, c.value) for k, (a, b, c) in trpc._OVERRIDES.items()} == {
        k: (a, b, c.value) for k, (a, b, c) in jrpc._OVERRIDES.items()}
    assert trpc.RPCS["ClientHello"].path == "/modal.tpu.api.ModalTPU/ClientHello"
    assert trpc.RPCS["WorkerPoll"].arity == trpc.Arity.UNARY_STREAM


def test_stub_builds_one_multicallable_per_rpc():
    class Channel:
        def __init__(self):
            self.made = []

        def _factory(self, kind):
            def make(path, request_serializer, response_deserializer):
                self.made.append((kind, path))
                return type("MultiCallable", (), {})()

            return make

        def __getattr__(self, kind):
            return self._factory(kind)

    ch = Channel()
    stub = trpc.ModalTPUStub(ch)
    assert sorted(ch.made) == sorted((m.arity.value, m.path) for m in trpc.RPCS.values())
    assert stub.ClientHello._breaker_scope.startswith("ch")
