"""Minimal CBOR (RFC 8949) codec for cross-language payloads (the port's copy
of modal_tpu/_utils/cbor.py: the same bytes for the same values).

Reference behavior: py/modal/_serialization.py:359 — non-Python SDKs (Go/JS)
exchange function arguments/results as CBOR, and the Python container
decodes/encodes them so one deployed function serves every SDK. The reference
uses the `cbor2` package; this is an independent pure-Python
implementation of the subset the wire format needs:

  encode: None, bool, int (64-bit signed range + bignum tags 2/3), float
          (float64), bytes, str, list/tuple, dict
  decode: all of the above plus half/single-precision floats and indefinite-
          length strings/arrays/maps (other SDKs may stream-encode)

Deterministic-enough encoding: definite lengths, shortest-form integer heads
(RFC 8949 §4.2.1 core requirements), float64 for all floats.
"""

from __future__ import annotations

import math
import struct
from io import BytesIO
from typing import Any

_MT_UINT = 0
_MT_NEGINT = 1
_MT_BYTES = 2
_MT_TEXT = 3
_MT_ARRAY = 4
_MT_MAP = 5
_MT_TAG = 6
_MT_SIMPLE = 7

_BREAK = object()


class CBORError(ValueError):
    pass


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def _encode_head(out: BytesIO, major: int, arg: int) -> None:
    mt = major << 5
    if arg < 24:
        out.write(bytes([mt | arg]))
    elif arg < 0x100:
        out.write(bytes([mt | 24, arg]))
    elif arg < 0x10000:
        out.write(bytes([mt | 25]) + struct.pack(">H", arg))
    elif arg < 0x100000000:
        out.write(bytes([mt | 26]) + struct.pack(">I", arg))
    elif arg < 0x10000000000000000:
        out.write(bytes([mt | 27]) + struct.pack(">Q", arg))
    else:
        raise CBORError(f"head argument out of range: {arg}")


def _encode_one(out: BytesIO, obj: Any) -> None:
    if obj is None:
        out.write(b"\xf6")
    elif obj is True:
        out.write(b"\xf5")
    elif obj is False:
        out.write(b"\xf4")
    elif isinstance(obj, int):
        if obj >= 0:
            if obj < 1 << 64:
                _encode_head(out, _MT_UINT, obj)
            else:  # bignum, tag 2
                _encode_head(out, _MT_TAG, 2)
                _encode_one(out, obj.to_bytes((obj.bit_length() + 7) // 8, "big"))
        else:
            n = -1 - obj
            if n < 1 << 64:
                _encode_head(out, _MT_NEGINT, n)
            else:  # negative bignum, tag 3
                _encode_head(out, _MT_TAG, 3)
                _encode_one(out, n.to_bytes((n.bit_length() + 7) // 8, "big"))
    elif isinstance(obj, float):
        out.write(b"\xfb" + struct.pack(">d", obj))
    elif isinstance(obj, bytes):
        _encode_head(out, _MT_BYTES, len(obj))
        out.write(obj)
    elif isinstance(obj, bytearray):
        _encode_one(out, bytes(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _encode_head(out, _MT_TEXT, len(raw))
        out.write(raw)
    elif isinstance(obj, (list, tuple)):
        _encode_head(out, _MT_ARRAY, len(obj))
        for item in obj:
            _encode_one(out, item)
    elif isinstance(obj, dict):
        _encode_head(out, _MT_MAP, len(obj))
        for k, v in obj.items():
            _encode_one(out, k)
            _encode_one(out, v)
    else:
        raise CBORError(
            f"type {type(obj).__name__} is not CBOR-encodable (cross-language payloads "
            "carry JSON-like data; use pickle format for rich Python objects)"
        )


def dumps(obj: Any) -> bytes:
    out = BytesIO()
    _encode_one(out, obj)
    return out.getvalue()


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


class _Decoder:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _read(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise CBORError("truncated CBOR input")
        chunk = self.data[self.pos : self.pos + n]
        self.pos += n
        return chunk

    def _read_arg(self, info: int) -> int | None:
        if info < 24:
            return info
        if info == 24:
            return self._read(1)[0]
        if info == 25:
            return struct.unpack(">H", self._read(2))[0]
        if info == 26:
            return struct.unpack(">I", self._read(4))[0]
        if info == 27:
            return struct.unpack(">Q", self._read(8))[0]
        if info == 31:
            return None  # indefinite length
        raise CBORError(f"reserved additional-info value {info}")

    def decode_one(self) -> Any:
        ib = self._read(1)[0]
        major, info = ib >> 5, ib & 0x1F
        if major == _MT_UINT:
            arg = self._read_arg(info)
            if arg is None:
                raise CBORError("indefinite-length integer")
            return arg
        if major == _MT_NEGINT:
            arg = self._read_arg(info)
            if arg is None:
                raise CBORError("indefinite-length integer")
            return -1 - arg
        if major == _MT_BYTES:
            return self._decode_string(info, text=False)
        if major == _MT_TEXT:
            return self._decode_string(info, text=True)
        if major == _MT_ARRAY:
            arg = self._read_arg(info)
            if arg is None:
                items = []
                while True:
                    item = self._decode_maybe_break()
                    if item is _BREAK:
                        return items
                    items.append(item)
            return [self.decode_one() for _ in range(arg)]
        if major == _MT_MAP:
            arg = self._read_arg(info)
            out: dict = {}
            if arg is None:
                while True:
                    k = self._decode_maybe_break()
                    if k is _BREAK:
                        return out
                    out[k] = self.decode_one()
                return out
            for _ in range(arg):
                k = self.decode_one()
                out[k] = self.decode_one()
            return out
        if major == _MT_TAG:
            tag = self._read_arg(info)
            value = self.decode_one()
            if tag == 2 and isinstance(value, bytes):  # bignum
                return int.from_bytes(value, "big")
            if tag == 3 and isinstance(value, bytes):
                return -1 - int.from_bytes(value, "big")
            return value  # unknown tags: surface the inner value
        # simple / float
        if info == 20:
            return False
        if info == 21:
            return True
        if info == 22 or info == 23:  # null / undefined
            return None
        if info == 25:
            return struct.unpack(">e", self._read(2))[0]
        if info == 26:
            return struct.unpack(">f", self._read(4))[0]
        if info == 27:
            return struct.unpack(">d", self._read(8))[0]
        if info == 31:
            return _BREAK
        if info < 24 or info == 24:
            arg = self._read_arg(info) if info == 24 else info
            return arg  # unassigned simple value: surface the number
        raise CBORError(f"unsupported simple/float encoding {info}")

    def _decode_maybe_break(self) -> Any:
        return self.decode_one()

    def _decode_string(self, info: int, text: bool) -> Any:
        arg = self._read_arg(info)
        if arg is not None:
            raw = self._read(arg)
            return raw.decode("utf-8") if text else raw
        # indefinite: concatenation of definite chunks until break
        parts = []
        while True:
            ib = self._read(1)[0]
            if ib == 0xFF:
                break
            major, chunk_info = ib >> 5, ib & 0x1F
            if major != (_MT_TEXT if text else _MT_BYTES):
                raise CBORError("mixed chunk types in indefinite string")
            n = self._read_arg(chunk_info)
            if n is None:
                raise CBORError("nested indefinite string chunk")
            parts.append(self._read(n))
        raw = b"".join(parts)
        return raw.decode("utf-8") if text else raw


def loads(data: bytes) -> Any:
    dec = _Decoder(data)
    value = dec.decode_one()
    if value is _BREAK:
        raise CBORError("unexpected break code")
    if dec.pos != len(dec.data):
        raise CBORError(f"{len(dec.data) - dec.pos} trailing bytes after CBOR item")
    if isinstance(value, float) and math.isnan(value):
        return value
    return value
