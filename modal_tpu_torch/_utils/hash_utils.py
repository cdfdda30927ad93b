"""Hashing helpers for blob, mount and volume content addressing (port of
modal_tpu/_utils/hash_utils.py; reference py/modal/_utils/hash_utils.py):
sha256 base64/hex digests and chunked block hashing. The JAX package's
optional native multithreaded block hasher (`MODAL_TPU_NATIVE_HASH=1`) is
not ported: hashlib gives the same digests.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
from typing import BinaryIO, Union

HASH_CHUNK_SIZE = 65536
# Volume v2 block size: 8 MiB content-addressed blocks (reference volume v2
# uses fixed-size blocks for dedup + parallel transfer).
BLOCK_SIZE = 8 * 1024 * 1024


def _update(hashers, data: Union[bytes, BinaryIO, list, tuple]) -> int:
    total = 0
    if isinstance(data, (bytes, bytearray, memoryview)):
        for h in hashers:
            h.update(data)
        return len(data)
    if isinstance(data, (list, tuple)):
        # payload segments (serialization.Payload.segments): hash in place,
        # no join, no copy; memoryview segments feed the hasher directly
        for seg in data:
            for h in hashers:
                h.update(seg)
            total += len(seg)
        return total
    assert data.seekable()
    pos = data.tell()
    while True:
        chunk = data.read(HASH_CHUNK_SIZE)
        if not chunk:
            break
        total += len(chunk)
        for h in hashers:
            h.update(chunk)
    data.seek(pos)
    return total


def get_sha256_hex(data: Union[bytes, BinaryIO]) -> str:
    h = hashlib.sha256()
    _update([h], data)
    return h.hexdigest()


def get_sha256_base64(data: Union[bytes, BinaryIO]) -> str:
    h = hashlib.sha256()
    _update([h], data)
    return base64.b64encode(h.digest()).decode("ascii")


def get_md5_base64(data: Union[bytes, BinaryIO]) -> str:
    h = hashlib.md5()
    _update([h], data)
    return base64.b64encode(h.digest()).decode("ascii")


@dataclasses.dataclass
class UploadHashes:
    sha256_hex: str
    sha256_base64: str
    content_length: int


def get_upload_hashes(data: Union[bytes, BinaryIO]) -> UploadHashes:
    sha = hashlib.sha256()
    length = _update([sha], data)
    digest = sha.digest()
    return UploadHashes(
        sha256_hex=digest.hex(),
        sha256_base64=base64.b64encode(digest).decode("ascii"),
        content_length=length,
    )


def iter_file_blocks(data: BinaryIO, block_size: int = BLOCK_SIZE):
    """Yield (index, offset, block_bytes) for volume v2 content addressing."""
    idx = 0
    while True:
        offset = data.tell()
        block = data.read(block_size)
        if not block:
            return
        yield idx, offset, block
        idx += 1


def get_blocks_sha256(data: bytes, block_size: int = BLOCK_SIZE) -> list[str]:
    """Per-block sha256 hex digests (empty data is one empty block)."""
    n_blocks = 1 if not data else (len(data) + block_size - 1) // block_size
    return [hashlib.sha256(data[i * block_size : (i + 1) * block_size]).hexdigest() for i in range(n_blocks)]


def get_file_blocks_sha256(path, block_size: int = BLOCK_SIZE) -> list[str]:
    """Per-block sha256 hex digests of a file on disk, read block by block
    (constant memory)."""
    shas: list[str] = []
    with open(path, "rb") as f:
        while True:
            block = f.read(block_size)
            if not block and shas:
                break
            shas.append(hashlib.sha256(block).hexdigest())
            if len(block) < block_size:
                break
    return shas
