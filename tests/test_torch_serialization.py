"""The port's payload serialization (`modal_tpu_torch/serialization.py`)
against the JAX package's (`modal_tpu/serialization.py`), on the CPU.

Closures, lambdas and local classes pickle by value; exceptions travel with
their remote traceback; hydrated object handles ride as persistent ids and
come back bound to the receiver's client. Torch tensors (fp32, bf16, int8)
above `OOB_MIN_BUFFER_BYTES` leave the pickle stream for raw frame
segments, those below stay in it, and both come back bit-equal (bytes
compared exactly). A numpy payload is byte for byte the same frame in
either package and deserializes equal in the other; CBOR payloads are the
same bytes. The `cuda` case stages a device tensor through pinned memory.
"""

import pickle

import numpy as np
import pytest
import torch

from modal_tpu import object as jobject
from modal_tpu import serialization as jser
from modal_tpu.exception import ExecutionError as JaxExecutionError
from modal_tpu.proto import api_pb2 as japi
from modal_tpu_torch import object as tobject
from modal_tpu_torch import serialization as tser
from modal_tpu_torch.exception import DeserializationError, ExecutionError
from modal_tpu_torch.proto import api_pb2 as tapi

# the largest in-band pickle stream a tensor-only payload may carry
STREAM_BOUND = 4096


def _stream_bytes(payload) -> int:
    """The pickle stream's length: the whole payload when nothing went out of
    band, else the frame header's pickle_len."""
    data = payload.join()
    if data[:4] != tser.OOB_MAGIC:
        return len(data)
    return tser._OOB_HEAD.unpack_from(data, 0)[2]


def test_closures_lambdas_and_local_classes_cross_both_ways():
    base = 7

    def closure(x):
        return x + base

    class Local:
        def __init__(self, v):
            self.v = v

        def get(self):
            return self.v * 2

    obj = {"lam": lambda x: x * 3, "clo": closure, "local": Local(4)}
    for ser, de in ((tser.serialize, tser.deserialize), (tser.serialize, jser.deserialize),
                    (jser.serialize, tser.deserialize)):
        back = de(ser(obj))
        assert back["lam"](2) == 6 and back["clo"](1) == 8 and back["local"].get() == 8


def _raise_deep():
    def inner():
        raise ValueError("bad input 42")

    inner()


def test_exceptions_travel_with_their_traceback_both_ways():
    try:
        _raise_deep()
    except ValueError as exc:
        caught = exc
    for ser, de in ((tser.serialize_exception, tser.deserialize_exception),
                    (tser.serialize_exception, jser.deserialize_exception),
                    (jser.serialize_exception, tser.deserialize_exception)):
        data, rep, tb_str, ser_tb = ser(caught)
        assert rep == "ValueError('bad input 42')" and "inner" in tb_str
        exc = de(data, rep, tb_str, None, ser_tb)
        assert type(exc) is ValueError and exc.args == ("bad input 42",)
        names = []
        tb = exc.__traceback__
        while tb is not None:
            names.append(tb.tb_frame.f_code.co_name)
            tb = tb.tb_next
        assert names[-2:] == ["_raise_deep", "inner"]
        assert "Remote traceback" in str(exc.__cause__) and "bad input 42" in str(exc.__cause__)
    assert caught.__traceback__ is not None  # the original keeps its frames


def test_an_unpicklable_exception_degrades_to_execution_error():
    import threading

    class Holding(Exception):
        def __init__(self):
            super().__init__("holding")
            self.lock = threading.Lock()

    data, rep, tb_str, ser_tb = tser.serialize_exception(Holding())
    exc = tser.deserialize_exception(data, rep, tb_str, None, ser_tb)
    assert isinstance(exc, ExecutionError) and "Holding" in str(exc)


class PortHandle(tobject._Object, type_prefix="zt"):
    @classmethod
    def _deserialize_metadata(cls, metadata_bytes):
        return metadata_bytes.decode()

    def _hydrate_metadata(self, metadata):
        self.note = metadata

    def _get_metadata(self):
        return self.note.encode() if self.note else None


class JaxHandle(jobject._Object, type_prefix="zt"):
    @classmethod
    def _deserialize_metadata(cls, metadata_bytes):
        return metadata_bytes.decode()

    def _hydrate_metadata(self, metadata):
        self.note = metadata

    def _get_metadata(self):
        return self.note.encode() if self.note else None


def test_hydrated_handles_ride_as_persistent_ids_in_both_packages():
    client = object()
    handle = PortHandle._new_hydrated("zt-123", None, "meta")
    back = tser.deserialize(tser.serialize({"h": handle, "n": 1}), client)
    assert type(back["h"]) is PortHandle and back["h"].object_id == "zt-123"
    assert back["h"].client is client and back["h"].note == "meta"
    # a JAX handle lands as the port's type of the same prefix, and back
    jhandle = JaxHandle._new_hydrated("zt-9", None, "jm")
    got = tser.deserialize(jser.serialize([jhandle]), client)[0]
    assert type(got) is PortHandle and (got.object_id, got.note) == ("zt-9", "jm")
    jgot = jser.deserialize(tser.serialize([handle]), client)[0]
    assert type(jgot) is JaxHandle and (jgot.object_id, jgot.note) == ("zt-123", "meta")
    unhydrated = PortHandle._from_loader(lambda *a: None, "PortHandle()")
    with pytest.raises(ExecutionError, match="hasn't been hydrated"):
        tser.serialize(unhydrated)
    with pytest.raises(JaxExecutionError):
        jser.serialize(JaxHandle._from_loader(lambda *a: None, "JaxHandle()"))
    with pytest.raises(DeserializationError, match="unknown object id prefix"):
        tser.deserialize(tser.serialize(PortHandle._new_hydrated("zt-1", None, None)).replace(b"zt-1", b"qq-1"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("numel", [1000, 3 * tser.OOB_MIN_BUFFER_BYTES + 5])
def test_cpu_tensors_round_trip_bit_equal(dtype, numel):
    gen = torch.Generator().manual_seed(numel)
    t = (torch.randn(numel, generator=gen) * 50).to(dtype)
    t = t[: numel - numel % 5].reshape(5, -1)
    payload = tser.serialize_payload({"t": t, "tag": "x"})
    data = payload.join()
    big = t.numel() * t.element_size() >= tser.OOB_MIN_BUFFER_BYTES
    assert (data[:4] == tser.OOB_MAGIC) is big
    assert _stream_bytes(payload) < (STREAM_BOUND if big else t.numel() * t.element_size() + STREAM_BOUND)
    for frame in (data, bytearray(data), memoryview(data)):
        back = tser.deserialize(frame)
        got = back["t"]
        assert type(got) is torch.Tensor and got.device.type == "cpu"
        assert got.dtype == dtype and got.shape == t.shape and back["tag"] == "x"
        assert torch.equal(got.view(-1).view(torch.uint8), t.reshape(-1).view(torch.uint8))
        got.add_(1)  # every rebuilt tensor may be written; the frame stays as it was
    assert tser.deserialize(data)["t"].equal(t)


def test_tensor_kinds_the_reducer_keeps():
    p = torch.nn.Parameter(torch.arange(6.0).reshape(2, 3))
    nc = torch.arange(12.0).reshape(3, 4).t()
    back = tser.deserialize(tser.serialize({"p": p, "nc": nc, "empty": torch.empty(0, 4, dtype=torch.bfloat16),
                                            "scalar": torch.tensor(2.5), "grad": torch.ones(3, requires_grad=True),
                                            "sparse": torch.eye(3).to_sparse()}))
    assert type(back["p"]) is torch.nn.Parameter and back["p"].requires_grad and torch.equal(back["p"], p)
    assert torch.equal(back["nc"], nc) and back["nc"].is_contiguous()
    assert back["empty"].shape == (0, 4) and back["empty"].dtype == torch.bfloat16
    assert back["scalar"].item() == 2.5 and back["scalar"].shape == ()
    assert back["grad"].requires_grad and back["grad"].is_leaf
    assert torch.equal(back["sparse"].to_dense(), torch.eye(3))


class _Tagged(torch.Tensor):
    """A user's tensor subclass: the reducer takes it as a plain tensor."""


def test_a_tensor_subclass_rides_out_of_band():
    """A subclass instance skips torch's own `__reduce_ex__` (which would put
    its storage in the pickle stream) and comes back a plain tensor, like a
    jax.Array subclass in the JAX package."""
    gen = torch.Generator().manual_seed(3)
    t = torch.randn(512, 257, generator=gen).to(torch.bfloat16)
    sub = t.as_subclass(_Tagged)
    payload = tser.serialize_payload({"sub": sub, "param_sub": torch.nn.Parameter(t.float()).as_subclass(_Tagged)})
    assert _stream_bytes(payload) < STREAM_BOUND
    back = tser.deserialize(payload.join())
    assert type(back["sub"]) is torch.Tensor and back["sub"].dtype == torch.bfloat16
    assert torch.equal(back["sub"].view(torch.int16), t.view(torch.int16))
    assert type(back["param_sub"]) is torch.Tensor and torch.equal(back["param_sub"], t.float())


def test_a_whole_dtensor_rides_as_its_local_piece_and_a_sharded_one_is_refused():
    """A DTensor on a one-rank mesh holds the whole tensor: it travels out of
    band as a plain tensor. One sharded over ranks is refused rather than
    gathered, since the gather is a collective every rank must join."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from modal_tpu_torch.parallel import mesh as tmesh

    full = torch.arange(64 * 1024, dtype=torch.float32).reshape(256, 256)
    tmesh.init_process_group("cpu")
    try:
        mesh = tmesh.build_mesh({})
        dt = DTensor.from_local(full.clone(), mesh, [Shard(0)] + [Replicate()] * (mesh.ndim - 1), run_check=False)
        payload = tser.serialize_payload(dt)
    finally:
        torch.distributed.destroy_process_group()
    assert _stream_bytes(payload) < STREAM_BOUND
    back = tser.deserialize(payload.join())
    assert type(back) is torch.Tensor and torch.equal(back, full)

    class Sharded:  # what _plain reads of a DTensor split over two ranks
        placements = (Shard(0),)
        device_mesh = type("Mesh", (), {"size": lambda self: 2})()

        def to_local(self):
            return full[:128]

    with pytest.raises(ExecutionError, match="full_tensor"):
        tser._plain(torch, Sharded())


def test_a_bf16_tensor_never_pickles_its_storage_in_band():
    """torch's own __reduce_ex__ copies storage into the stream; the reducer
    must take the tensor first."""
    t = torch.randn(512, 1024).to(torch.bfloat16)  # 1 MiB
    payload = tser.serialize_payload([t, t[::2]])
    assert _stream_bytes(payload) < STREAM_BOUND
    assert len([s for s in payload.segments if isinstance(s, memoryview)]) == 2
    assert len(pickle.dumps(t)) > t.numel() * 2  # what torch's reduction alone would put in-band


def _numpy_payload():
    rng = np.random.default_rng(0)
    return {"big": rng.standard_normal((300, 100)).astype(np.float32), "ids": np.arange(5000, dtype=np.int64),
            "small": np.ones(7, np.float16), "meta": ("x", 3)}


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_numpy_payloads_cross_both_ways(direction):
    obj = _numpy_payload()
    ser, de = (tser.serialize, jser.deserialize) if direction == "port_to_jax" else (jser.serialize, tser.deserialize)
    data = ser(obj)
    assert data[:4] == tser.OOB_MAGIC == jser.OOB_MAGIC
    back = de(data)
    assert back["meta"] == obj["meta"]
    for k in ("big", "ids", "small"):
        assert back[k].dtype == obj[k].dtype and np.array_equal(back[k], obj[k])


def test_numpy_frames_are_byte_equal():
    assert tser.serialize(_numpy_payload()) == jser.serialize(_numpy_payload())
    assert tser._OOB_HEAD.format == jser._OOB_HEAD.format
    assert (tser.OOB_MIN_BUFFER_BYTES, tser.OOB_ALIGN, tser.OOB_VERSION) == (
        jser.OOB_MIN_BUFFER_BYTES, jser.OOB_ALIGN, jser.OOB_VERSION)


def test_data_formats_match_jax():
    value = {"prompt": [1, 2, 3], "t": 0.5, "name": "llama", "raw": b"\x00\x01", "none": None}
    assert tapi.DATA_FORMAT_CBOR == japi.DATA_FORMAT_CBOR
    cbor = tser.serialize_data_format(value, tapi.DATA_FORMAT_CBOR)
    assert cbor == jser.serialize_data_format(value, japi.DATA_FORMAT_CBOR)
    assert tser.deserialize_data_format(memoryview(cbor), tapi.DATA_FORMAT_CBOR) == value
    done = tapi.GeneratorDone(items_total=3)
    raw = tser.serialize_data_format(done, tapi.DATA_FORMAT_GENERATOR_DONE)
    assert raw == jser.serialize_data_format(japi.GeneratorDone(items_total=3), japi.DATA_FORMAT_GENERATOR_DONE)
    assert tser.deserialize_data_format(raw, tapi.DATA_FORMAT_GENERATOR_DONE) == done
    pickled = tser.serialize_payload_data_format(value, tapi.DATA_FORMAT_PICKLE)
    assert tser.deserialize_data_format(pickled.join(), tapi.DATA_FORMAT_UNSPECIFIED) == value
    with pytest.raises(ExecutionError):
        tser.serialize_data_format(value, 999)


def test_garbage_raises_deserialization_error():
    with pytest.raises(DeserializationError):
        tser.deserialize(b"not a pickle")
    bad = bytearray(tser.serialize(np.zeros(100000, np.float32)))
    bad[4] = 9  # frame version
    with pytest.raises(DeserializationError, match="frame version"):
        tser.deserialize(bytes(bad))


@pytest.mark.cuda
def test_cuda_tensors_stage_through_pinned_memory(monkeypatch):
    """A device tensor (bf16, several staging chunks and a partial one) comes
    back a CPU tensor, bit-equal, its stream small: no device buffer and no
    storage in the pickle stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the staging path copies from device memory)")
    monkeypatch.setattr(tser, "STAGING_BYTES", 1 << 20)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t = torch.randn(1537, 1031, device="cuda", generator=gen).to(torch.bfloat16)
    small = torch.arange(10, device="cuda")
    payload = tser.serialize_payload({"t": t, "small": small, "view": t[:, 3], "sub": t.as_subclass(_Tagged)})
    assert _stream_bytes(payload) < STREAM_BOUND
    back = tser.deserialize(payload.join())
    assert back["t"].device.type == "cpu" and back["t"].dtype == torch.bfloat16
    assert torch.equal(back["t"].view(torch.int16), t.cpu().view(torch.int16))
    assert torch.equal(back["small"], small.cpu()) and torch.equal(back["view"], t[:, 3].cpu())
    assert type(back["sub"]) is torch.Tensor and torch.equal(back["sub"].view(torch.int16), t.cpu().view(torch.int16))
