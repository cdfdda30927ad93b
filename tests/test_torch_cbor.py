"""The port's CBOR codec (`modal_tpu_torch/_utils/cbor.py`) against the JAX
package's (`modal_tpu/_utils/cbor.py`): the RFC 8949 Appendix A vectors
that `tests/test_cbor.py` pins, and seeded random structures, encoded to
the same bytes (compared exactly) and decoded to the same values."""

import math

import numpy as np
import pytest

from modal_tpu._utils import cbor as jcbor
from modal_tpu_torch._utils import cbor as tcbor
from tests.test_cbor import RFC_VECTORS


@pytest.mark.parametrize("value,hex_bytes", RFC_VECTORS)
def test_rfc8949_appendix_a_vectors(value, hex_bytes):
    assert tcbor.dumps(value).hex() == hex_bytes
    assert tcbor.loads(bytes.fromhex(hex_bytes)) == value


def test_half_single_indefinite_and_bignum_decode_like_jax():
    for hex_bytes in ("f93e00", "fa47c35000", "f97c00", "9f018202039f0405ffff", "bf61610161629f0203ffff",
                      "7f657374726561646d696e67ff", "c249010000000000000000", "c349010000000000000000"):
        want = jcbor.loads(bytes.fromhex(hex_bytes))
        assert tcbor.loads(bytes.fromhex(hex_bytes)) == want
    assert math.isnan(tcbor.loads(bytes.fromhex("f97e00")))


def _random_value(rng, depth=0):
    kind = rng.integers(0, 10 if depth < 3 else 7)
    if kind == 0:
        return None
    if kind == 1:
        return bool(rng.integers(0, 2))
    if kind == 2:  # ints across every head width, bignums included
        return int(rng.integers(-(2**62), 2**62)) * int(rng.choice([1, 1 << 8, 1 << 40]))
    if kind == 3:
        return float(rng.standard_normal() * 10.0 ** int(rng.integers(-5, 6)))
    if kind == 4:
        return rng.bytes(int(rng.integers(0, 300)))
    if kind == 5:
        return "".join(chr(int(c)) for c in rng.integers(32, 0x3000, size=int(rng.integers(0, 40))))
    if kind == 6:
        return int(rng.integers(0, 30))
    if kind in (7, 8):
        return [_random_value(rng, depth + 1) for _ in range(int(rng.integers(0, 6)))]
    return {f"k{int(rng.integers(0, 1000))}": _random_value(rng, depth + 1) for _ in range(int(rng.integers(0, 6)))}


@pytest.mark.parametrize("seed", range(4))
def test_seeded_random_structures_encode_byte_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        value = _random_value(rng)
        data = tcbor.dumps(value)
        assert data == jcbor.dumps(value)
        assert tcbor.loads(data) == jcbor.loads(data) == value


def test_errors_match_jax():
    for bad in (object(), {1, 2}):
        with pytest.raises(tcbor.CBORError):
            tcbor.dumps(bad)
    for hex_bytes in ("1a0000", "0000", "ff"):
        with pytest.raises(jcbor.CBORError):
            jcbor.loads(bytes.fromhex(hex_bytes))
        with pytest.raises(tcbor.CBORError):
            tcbor.loads(bytes.fromhex(hex_bytes))
