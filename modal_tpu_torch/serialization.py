"""Serialization: cloudpickle with `_Object`-aware persistent IDs (port of
modal_tpu/serialization.py).

Reference: py/modal/_serialization.py: `Pickler`/`Unpickler` with persistent
ids for object handles (_serialization.py:37-73), `serialize_data_format`
(_serialization.py:365), exception/traceback pickling (_serialization.py:630).

Persistent IDs let user payloads close over live handles (Functions,
Volumes, Dicts...): the pickle stream stores ``(object_id, "_o",
metadata)`` and the receiving unpickler re-binds a hydrated handle against
its own client.

Tensors: a `torch.Tensor` of any class (`nn.Parameter`, a user subclass, a
DTensor whose local piece is the whole tensor) is reduced by this module,
before cloudpickle or torch's own `__reduce_ex__` see it, so a payload never
captures a device buffer and never copies tensor bytes into the pickle
stream. A CUDA tensor is first copied to host memory through the pinned
staging buffers of the snapshot runtime (`runtime.snapshot.Staging`, chunks
of `STAGING_BYTES`; the device-to-host copy of one chunk overlaps the host
copy of the one before), the way the JAX package moves a jax.Array
host-side with `np.asarray`. The tensor then travels as its raw bytes, a
flat `uint8` view (any dtype, bf16 included), with its dtype name and
shape, and comes back as a CPU `torch.Tensor` (an `nn.Parameter` stays
one) of the same dtype and shape; a Dict's or a Queue's value
(`keep_device=True`) comes back on the receiver's current card instead. A read-only buffer (a frame held in
`bytes`) is copied once on the way back, so every rebuilt tensor may be
written; a writable one (a `bytearray` frame) is used in place.

Zero-copy data plane (out-of-band serialization): pickle protocol 5 with a
``buffer_callback`` moves large contiguous buffers (tensors, numpy arrays,
numpy extension-dtype arrays) OUT of the pickle stream into raw frame
segments, so a 1 GB tensor serializes as a pickle stream of a few hundred
bytes plus a borrowed memoryview of its host copy. The framed wire format
(``OOB_MAGIC`` header + buffer table + pickle stream + 64-byte-aligned raw
segments) is byte for byte the JAX package's: payloads with no large
buffers stay plain pickle bytes, and ``deserialize`` sniffs the magic, so
either package reads the other's numpy payloads.
"""

from __future__ import annotations

import io
import pickle
import struct
import sys
import traceback as tb_module
from typing import Any, Optional, Union

import cloudpickle

from .config import logger
from .exception import DeserializationError, ExecutionError

# Payloads pickle with protocol 5 (PickleBuffer support).
OOB_PICKLE_PROTOCOL = 5
# Frame magic: first byte can never begin a valid pickle stream (pickle
# opcodes for PROTO frames start with b"\x80"), so sniffing is unambiguous.
OOB_MAGIC = b"MTP5"
OOB_VERSION = 1
# Buffers below this stay in-band: the frame overhead + extra segment isn't
# worth it for small arrays, and tiny payloads keep full legacy compat.
OOB_MIN_BUFFER_BYTES = 64 * 1024
# Raw segments are aligned so mmap-backed deserialization hands the dtype
# reconstructors aligned views (friendlier to vectorized loads + device DMA).
OOB_ALIGN = 64
# frame header: magic(4) version(1) pad(3) pickle_len(u64) n_buffers(u32)
_OOB_HEAD = struct.Struct("<4sB3xQI")
# the most bytes of each of the two pinned buffers a CUDA tensor is staged through
STAGING_BYTES = 64 << 20


class Payload:
    """A serialized payload as a list of buffer segments (bytes/memoryview).

    Large tensor buffers appear as *borrowed* memoryviews over the host
    arrays: nothing is copied until the payload hits a socket or is
    ``join()``-ed into contiguous bytes for an inline proto field."""

    __slots__ = ("segments", "nbytes")

    def __init__(self, segments: list):
        self.segments = segments
        self.nbytes = sum(len(s) for s in segments)

    def join(self) -> bytes:
        """Materialize as contiguous bytes (one copy: the inline-payload path)."""
        if len(self.segments) == 1:
            seg = self.segments[0]
            return seg if isinstance(seg, bytes) else bytes(seg)
        from .observability.catalog import DATAPLANE_COPY_BYTES

        DATAPLANE_COPY_BYTES.inc(self.nbytes, site="join")
        return b"".join(self.segments)

    def __len__(self) -> int:
        return self.nbytes


class Pickler(cloudpickle.Pickler):
    def __init__(self, buf: io.BytesIO, *, buffer_callback, keep_device: bool = False):
        super().__init__(buf, protocol=OOB_PICKLE_PROTOCOL, buffer_callback=buffer_callback)
        self._staging = None  # made at the first CUDA tensor, used by the rest
        self._keep_device = keep_device

    def persistent_id(self, obj: Any) -> Optional[tuple]:
        # no handle exists before the object model is imported, and the
        # snapshot path pickles without it (it needs grpc)
        object_mod = sys.modules.get(__package__ + ".object")
        if object_mod is not None and isinstance(obj, object_mod._Object):
            if obj._object_id is None:
                raise ExecutionError(f"Can't serialize object {obj} which hasn't been hydrated/created.")
            metadata = obj._get_metadata() or b""
            return (obj._object_id, "_o", metadata)
        return None

    def reducer_override(self, obj: Any) -> Any:
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(obj, torch.Tensor):
            return self._reduce_tensor(torch, obj)
        if "numpy" in sys.modules:
            import numpy as np

            # numpy's native protocol-5 out-of-band path only covers builtin
            # dtypes; extension-dtype arrays (ml_dtypes bfloat16/float8) fall
            # back to an in-band tobytes copy. Reduce them ourselves so they
            # ride out-of-band like every other array.
            if (
                isinstance(obj, np.ndarray)
                and obj.dtype.isbuiltin != 1  # 0/2: user/registered dtype
                and not obj.dtype.hasobject
                and obj.flags.c_contiguous
                and obj.nbytes >= OOB_MIN_BUFFER_BYTES
            ):
                # buffer-protocol export rejects extension dtypes; a flat
                # uint8 view shares the same memory and exports cleanly
                raw = obj.reshape(-1).view(np.uint8)
                return (_rebuild_ndarray, (pickle.PickleBuffer(raw), obj.dtype, obj.shape))
        return super().reducer_override(obj)

    def _reduce_tensor(self, torch: Any, obj: Any) -> Any:
        parameter = isinstance(obj, torch.nn.Parameter)
        t = _plain(torch, obj)
        if t.layout != torch.strided or t.is_quantized or t.is_nested or t.device.type == "meta":
            # no flat byte view: torch's own reduction, of a plain host tensor
            host = t if t.device.type in ("cpu", "meta") else t.cpu()
            return super().reducer_override(obj) if host is obj else (_identity, (host,))
        host = self._to_host(torch, t) if t.device.type != "cpu" else t.detach().contiguous()
        raw = host.reshape(-1).view(torch.uint8).numpy()
        dtype = str(t.dtype).removeprefix("torch.")
        args = (pickle.PickleBuffer(raw), dtype, tuple(t.shape), t.requires_grad, parameter)
        if self._keep_device and t.device.type == "cuda":
            return (_rebuild_tensor_on, (*args, "cuda"))
        return (_rebuild_tensor, args)

    def _to_host(self, torch: Any, t: Any) -> Any:
        """A device tensor's bytes in pageable host memory, streamed through
        the pinned staging buffers."""
        from .runtime.snapshot import Staging

        out = torch.empty(t.shape, dtype=t.dtype)
        dst = out.reshape(-1).view(torch.uint8)

        def put(off: int, chunk: Any) -> None:
            dst[off : off + chunk.size].copy_(torch.from_numpy(chunk))

        if self._staging is None:
            self._staging = Staging(STAGING_BYTES)
        self._staging.to_host(t.detach().contiguous().reshape(-1).view(torch.uint8), put)
        return out


def _plain(torch: Any, t: Any) -> Any:
    """`t` as a plain `torch.Tensor` over the same data: a subclass is
    viewed as its base class, a DTensor as its local piece when that piece
    is the whole tensor (replicated, or on a mesh of one rank); a sharded
    or partial one is refused, since gathering it is a collective every
    rank must join."""
    if type(t) in (torch.Tensor, torch.nn.Parameter):
        return t
    if hasattr(t, "to_local") and hasattr(t, "placements"):
        if t.device_mesh.size() > 1 and not all(p.is_replicate() for p in t.placements):
            raise ExecutionError(
                f"can't serialize a DTensor placed as {t.placements}: pass its full_tensor() or to_local()"
            )
        return _plain(torch, t.to_local())
    return t.as_subclass(torch.Tensor)


def _identity(obj: Any) -> Any:
    return obj


def _rebuild_tensor(buffer: Any, dtype: str, shape: tuple, requires_grad: bool, parameter: bool) -> Any:
    import torch

    view = memoryview(buffer)
    dt = getattr(torch, dtype)
    if view.nbytes == 0:
        t = torch.empty(shape, dtype=dt)
    else:
        # a tensor may be written: read-only memory is copied once
        flat = torch.frombuffer(bytearray(view) if view.readonly else view, dtype=torch.uint8)
        t = flat.view(dt).reshape(shape)
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad) if requires_grad else t


def _rebuild_tensor_on(buffer: Any, dtype: str, shape: tuple, requires_grad: bool, parameter: bool,
                       device: str) -> Any:
    """A tensor that left a card, back on this process's current card (a
    Dict's or a Queue's value: ROADMAP Queue C 10's rule for snapshots). A
    process without a card cannot take it and raises."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise DeserializationError("the value holds a CUDA tensor and this process has no CUDA device")
    t = _rebuild_tensor(buffer, dtype, shape, False, False).to(torch.device(device, torch.cuda.current_device()))
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad) if requires_grad else t


def _rebuild_ndarray(buffer, dtype, shape):
    import numpy as np

    return np.frombuffer(buffer, dtype=dtype).reshape(shape)


class Unpickler(pickle.Unpickler):
    def __init__(self, client, buf: io.BytesIO, *, buffers=None):
        super().__init__(buf, buffers=buffers)
        self.client = client

    def persistent_load(self, pid: tuple) -> Any:
        from .object import _Object

        object_id, flag, metadata = pid
        if flag == "_o":
            return _Object._new_hydrated_from_pickle(object_id, self.client, metadata)
        raise DeserializationError(f"unknown persistent id flag {flag!r}")


def serialize_payload(obj: Any, keep_device: bool = False) -> Payload:
    """Serialize to a segment list, keeping large buffers out-of-band.

    Pickles at protocol 5 with a buffer callback: contiguous buffers ≥
    ``OOB_MIN_BUFFER_BYTES`` become borrowed memoryview segments in the
    frame's buffer table; smaller ones are folded back into the pickle
    stream. When nothing goes out-of-band the result is a single plain
    protocol-5 pickle segment: no frame, fully legacy-compatible. With
    `keep_device` a CUDA tensor comes back on the receiver's current card
    instead of the CPU (Dict and Queue values)."""
    oob: list[memoryview] = []

    def _buffer_cb(pb: pickle.PickleBuffer):
        try:
            view = pb.raw()
        except BufferError:  # non-contiguous exotic buffer: keep in-band
            return True
        if view.nbytes < OOB_MIN_BUFFER_BYTES:
            return True  # keep in-band
        oob.append(view)
        return False

    buf = io.BytesIO()
    Pickler(buf, buffer_callback=_buffer_cb, keep_device=keep_device).dump(obj)
    stream = buf.getvalue()
    if not oob:
        return Payload([stream])

    from .observability.catalog import SERIALIZED_BYTES

    head = _OOB_HEAD.pack(OOB_MAGIC, OOB_VERSION, len(stream), len(oob))
    table = struct.pack(f"<{len(oob)}Q", *(v.nbytes for v in oob))
    segments: list = [head + table, stream]
    offset = len(head) + len(table) + len(stream)
    for view in oob:
        pad = -offset % OOB_ALIGN
        if pad:
            segments.append(b"\x00" * pad)
            offset += pad
        segments.append(view)
        offset += view.nbytes
    SERIALIZED_BYTES.inc(sum(v.nbytes for v in oob), placement="oob")
    SERIALIZED_BYTES.inc(len(stream), placement="inband")
    return Payload(segments)


def serialize(obj: Any, keep_device: bool = False) -> bytes:
    """Contiguous-bytes convenience over ``serialize_payload`` (one join)."""
    return serialize_payload(obj, keep_device).join()


def _parse_oob_frame(view: memoryview) -> tuple[memoryview, list[memoryview]]:
    """(pickle stream view, out-of-band buffer views): all zero-copy slices
    of the input buffer (bytes, bytearray, or mmap-backed view alike)."""
    magic, version, pickle_len, n_buffers = _OOB_HEAD.unpack_from(view, 0)
    if version != OOB_VERSION:
        raise DeserializationError(f"unsupported out-of-band frame version {version}")
    table_off = _OOB_HEAD.size
    lengths = struct.unpack_from(f"<{n_buffers}Q", view, table_off)
    offset = table_off + 8 * n_buffers
    stream = view[offset : offset + pickle_len]
    offset += pickle_len
    buffers: list[memoryview] = []
    for n in lengths:
        offset += -offset % OOB_ALIGN
        buffers.append(view[offset : offset + n])
        offset += n
    return stream, buffers


def deserialize(s: Union[bytes, bytearray, memoryview], client: Any = None) -> Any:
    try:
        view = s if isinstance(s, memoryview) else memoryview(s)
        if view.nbytes >= _OOB_HEAD.size and bytes(view[:4]) == OOB_MAGIC:
            stream, buffers = _parse_oob_frame(view)
            # the pickle stream is small (buffers ride out-of-band); the
            # BytesIO copy here is bytes-of-metadata, not tensor data
            return Unpickler(client, io.BytesIO(stream), buffers=buffers).load()
        return Unpickler(client, io.BytesIO(view)).load()
    except DeserializationError:
        raise
    except Exception as exc:
        raise DeserializationError(
            f"Deserialization failed ({type(exc).__name__}: {exc}) — this usually means module versions differ "
            "between the client and the container image."
        ) from exc


def serialize_payload_data_format(obj: Any, data_format: int) -> Payload:
    """Like serialize_data_format but returns a Payload: pickle payloads keep
    large tensors as zero-copy out-of-band segments; the other formats wrap
    their contiguous encoding in a single-segment Payload."""
    from .proto import api_pb2

    if data_format in (api_pb2.DATA_FORMAT_PICKLE, api_pb2.DATA_FORMAT_UNSPECIFIED):
        return serialize_payload(obj)
    return Payload([serialize_data_format(obj, data_format)])


def serialize_data_format(obj: Any, data_format: int) -> bytes:
    from .proto import api_pb2

    if data_format == api_pb2.DATA_FORMAT_PICKLE:
        return serialize(obj)
    elif data_format == api_pb2.DATA_FORMAT_CBOR:
        from ._utils import cbor

        return cbor.dumps(obj)
    elif data_format == api_pb2.DATA_FORMAT_MSGPACK:
        import msgpack

        return msgpack.packb(obj, use_bin_type=True)
    elif data_format == api_pb2.DATA_FORMAT_GENERATOR_DONE:
        assert isinstance(obj, api_pb2.GeneratorDone)
        return obj.SerializeToString()
    else:
        raise ExecutionError(f"can't serialize data format {data_format}")


def deserialize_data_format(
    s: Union[bytes, bytearray, memoryview], data_format: int, client: Any = None
) -> Any:
    from .proto import api_pb2

    if data_format in (api_pb2.DATA_FORMAT_PICKLE, api_pb2.DATA_FORMAT_UNSPECIFIED):
        return deserialize(s, client)
    # spilled blob downloads arrive as mmap-backed memoryviews; the non-pickle
    # codecs want contiguous bytes
    if not isinstance(s, bytes):
        from .observability.catalog import DATAPLANE_COPY_BYTES

        DATAPLANE_COPY_BYTES.inc(len(s), site="legacy")
        s = bytes(s)
    if data_format == api_pb2.DATA_FORMAT_CBOR:
        from ._utils import cbor

        return cbor.loads(s)
    elif data_format == api_pb2.DATA_FORMAT_MSGPACK:
        import msgpack

        return msgpack.unpackb(s, raw=False)
    elif data_format == api_pb2.DATA_FORMAT_GENERATOR_DONE:
        return api_pb2.GeneratorDone.FromString(s)
    else:
        raise ExecutionError(f"can't deserialize data format {data_format}")


# ---------------------------------------------------------------------------
# Exceptions over the wire
# ---------------------------------------------------------------------------


def serialize_exception(exc: BaseException) -> tuple[bytes, str, str, bytes]:
    """Returns (pickled_exception, repr, traceback_string, serialized_tb).
    Falls back to a generic ExecutionError when the exception itself doesn't
    pickle; serialized_tb (frame summaries for client-side rehydration,
    reference _traceback.py/tblib) is captured independently so a
    non-picklable exception still ships its full remote stack."""
    from ._utils.traceback_utils import serialize_traceback

    tb_str = "".join(tb_module.format_exception(type(exc), exc, exc.__traceback__))
    serialized_tb = serialize_traceback(exc.__traceback__)
    try:
        # Strip traceback/frames (often unpicklable) but keep the exception.
        # Strip on a shallow copy: with_traceback mutates in place and the
        # caller may still re-raise/log the original.
        import copy as _copy

        try:
            exc_copy = _copy.copy(exc)
        except Exception:
            exc_copy = exc
        data = serialize(exc_copy.with_traceback(None))
    except Exception as ser_exc:
        logger.debug(f"exception {exc!r} failed to serialize: {ser_exc}")
        data = serialize(ExecutionError(repr(exc)))
    return data, repr(exc), tb_str, serialized_tb


def deserialize_exception(
    data: bytes, exc_repr: str, tb_str: str, client: Any = None, serialized_tb: bytes = b""
) -> BaseException:
    from ._utils.traceback_utils import deserialize_traceback

    try:
        exc = deserialize(data, client)
        if not isinstance(exc, BaseException):
            exc = ExecutionError(exc_repr)
    except Exception:
        exc = ExecutionError(f"{exc_repr} (original exception could not be deserialized)")
    # Rehydrate the remote stack onto the exception so `raise` shows the user
    # function's frames (file/line/function, with source when shared), not
    # just our invocation machinery's.
    remote_tb = deserialize_traceback(serialized_tb)
    if remote_tb is not None:
        exc = exc.with_traceback(remote_tb)
    if tb_str:
        exc.__cause__ = RemoteTraceback(tb_str)
    return exc


class RemoteTraceback(Exception):
    """Carries the remote traceback text so it shows as the exception cause
    (lightweight alternative to the reference's tblib rehydration,
    _traceback.py)."""

    def __init__(self, tb: str):
        self.tb = tb

    def __str__(self) -> str:
        return "\n\nRemote traceback:\n" + self.tb
