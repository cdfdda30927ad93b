"""Real-weights path: HF-convention safetensors checkpoints ⇄ Llama params,
streamed to the device (port of modal_tpu/models/weights.py).

- A minimal safetensors reader/writer (8-byte little-endian header length,
  the JSON header, then the raw buffers), hand-rolled so the reader works
  over ranged reads (one tensor's bytes out of a multi-GiB shard) and so bf16
  travels as raw bytes: `torch.frombuffer` reads them, a byte view of the
  CPU tensor writes them. The files are byte-for-byte the JAX package's.
- The HF Llama key map (`model.layers.N.self_attn.q_proj.weight` ⇄ the
  stacked `layers/wq`), so Meta-Llama-3 checkpoints load unmodified.
- `export_checkpoint`: the same shards, names, index and metadata as the JAX
  package's export, one tensor on the host at a time.
- `load_params`: ranged reads of one tensor at a time, `PREFETCH` ahead on a
  thread pool; each tensor is transposed and cast on the host straight into
  pinned memory and copied to the device with `non_blocking=True`, into the
  stacked buffer at its layer index (or, with `layout="per_layer"`, into the
  training layout). Host peak is about `PREFETCH` tensors (each read buffer
  and its pinned copy), never the model.

MoE configs write each expert's matrices as their own tensors
(`model.layers.N.block_sparse_moe.experts.E.w_in.weight`), as the JAX
exporter does, and load them stacked per layer. Sources: a local directory
(`LocalSource`) or a prefix of a Volume (`VolumeSource`, `(volume,
prefix)`): a ranged read moves only the content blocks a tensor overlaps,
and lands them in the tensor's host buffer (`read_file_range_into`; a
client beside the store preads the block files in place). `export_checkpoint`
writes to either. `shardings=` places the loaded params on a mesh.
"""

from __future__ import annotations

import asyncio
import json
import os
import struct
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Any, Callable, Optional, Union

import torch

from ..config import resolve_device
from .llama import LlamaConfig, init_params_abstract
from .quant import is_quantized

# safetensors dtype tag <-> torch dtype
_ST_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_TORCH_TO_ST = {v: k for k, v in _ST_DTYPES.items()}

INDEX_FILE = "model.safetensors.index.json"
SINGLE_FILE = "model.safetensors"
DEFAULT_SHARD_BYTES = 4 * 1024**3

# Tensors read ahead of the one being placed on the device: the host peak
# is PREFETCH tensors, and the reads overlap the host-to-device copies
PREFETCH = 2


def _nbytes(shape: tuple, dtype: torch.dtype) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * torch.empty((), dtype=dtype).element_size()


def _raw_bytes(t: torch.Tensor):
    """A CPU tensor's bytes as a writable buffer view (no copy when it is
    contiguous)."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().data


# ---------------------------------------------------------------------------
# Minimal safetensors codec
# ---------------------------------------------------------------------------


def build_safetensors(tensors: dict[str, torch.Tensor], out_path: str, metadata: Optional[dict] = None) -> dict:
    """Write a .safetensors file from CPU tensors; returns the header dict."""
    entries = [(name, tuple(t.shape), t.dtype, partial(lambda a: a, t)) for name, t in tensors.items()]
    return build_safetensors_streaming(entries, out_path, metadata)


def build_safetensors_streaming(
    entries: list[tuple[str, tuple, torch.dtype, Callable[[], torch.Tensor]]],
    out_path: str,
    metadata: Optional[dict] = None,
) -> dict:
    """Write a .safetensors file fetching ONE tensor at a time: the header
    (offsets) comes from (shape, dtype) alone, so host memory never holds
    more than the tensor being written. `entries` is
    [(name, shape, dtype, fetch)], `fetch()` returning a CPU tensor."""
    header: dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {k: str(v) for k, v in metadata.items()}
    offset = 0
    for name, shape, dtype, _ in entries:
        nbytes = _nbytes(tuple(shape) or (1,), dtype)
        header[name] = {
            "dtype": _TORCH_TO_ST[dtype],
            "shape": list(shape),
            "data_offsets": [offset, offset + nbytes],
        }
        offset += nbytes
    hdr = json.dumps(header, separators=(",", ":")).encode()
    with open(out_path, "wb") as f:
        f.write(struct.pack("<Q", len(hdr)))
        f.write(hdr)
        for name, shape, dtype, fetch in entries:
            t = fetch()
            if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device.type != "cpu":
                raise ValueError(
                    f"tensor {name!r}: fetched {tuple(t.shape)}/{t.dtype} on {t.device}, "
                    f"planned {tuple(shape)}/{dtype} on the CPU"
                )
            f.write(_raw_bytes(t))
            del t
    return header


def parse_safetensors_header(raw_prefix: bytes) -> tuple[dict, int]:
    """(header dict, data_start offset) from the first bytes of a file.
    `raw_prefix` must contain at least 8 + header_len bytes."""
    (hdr_len,) = struct.unpack("<Q", raw_prefix[:8])
    header = json.loads(raw_prefix[8 : 8 + hdr_len])
    return header, 8 + hdr_len


# ---------------------------------------------------------------------------
# Tensor sources: a local directory, with ranged reads
# ---------------------------------------------------------------------------


class LocalSource:
    """Ranged reads from the files of a local directory. The JAX package's
    sources are coroutines on its synchronizer loop; the port reads on the
    loader's thread pool, so these block."""

    def __init__(self, root: str):
        self.root = root

    def read(self, file: str, offset: int, length: int) -> bytes:
        with open(os.path.join(self.root, file), "rb") as f:
            f.seek(offset)
            return f.read(length)

    def read_into(self, file: str, offset: int, length: int, buf) -> int:
        """Fill a caller-provided writable buffer (no intermediate bytes).
        `length` is in bytes: the view is cast to bytes first."""
        with open(os.path.join(self.root, file), "rb") as f:
            f.seek(offset)
            return f.readinto(memoryview(buf).cast("B")[:length])

    def read_all(self, file: str) -> bytes:
        with open(os.path.join(self.root, file), "rb") as f:
            return f.read()

    def exists(self, file: str) -> bool:
        return os.path.exists(os.path.join(self.root, file))

    def __repr__(self) -> str:
        return f"LocalSource({self.root!r})"


class VolumeSource:
    """Ranged reads against a Volume path prefix: only the content blocks
    overlapping the requested range travel. Blocking, like LocalSource (the
    loader's pool threads call it; the Volume's methods run on the SDK's
    loop)."""

    def __init__(self, volume: Any, prefix: str = ""):
        self.volume = volume
        self.prefix = prefix.strip("/")

    def _path(self, file: str) -> str:
        return f"{self.prefix}/{file}" if self.prefix else file

    def read(self, file: str, offset: int, length: int) -> bytes:
        return self.volume.read_file_range(self._path(file), offset, length)

    def read_into(self, file: str, offset: int, length: int, buf) -> int:
        """The blocks land concurrently at their final positions inside
        `buf` (`read_file_range_into`): no intermediate bytes, no join.
        `length` is in bytes."""
        return self.volume.read_file_range_into(self._path(file), offset, length, memoryview(buf).cast("B"))

    def read_all(self, file: str) -> bytes:
        import io

        buf = io.BytesIO()
        self.volume.read_file_into(self._path(file), buf)
        return buf.getvalue()

    def exists(self, file: str) -> bool:
        from ..exception import NotFoundError

        try:
            self.read(file, 0, 0)  # a length-0 read stats the file, fetching nothing
            return True
        except NotFoundError:
            return False

    def __repr__(self) -> str:
        return f"VolumeSource({self.volume.object_id!r}, {self.prefix!r})"


def _as_source(source: Any) -> Any:
    if isinstance(source, str):
        return LocalSource(source)
    if isinstance(source, tuple):
        return VolumeSource(source[0], source[1])
    if hasattr(source, "read_file_range") or hasattr(source, "read_file_into"):
        return VolumeSource(source)
    return source


# ---------------------------------------------------------------------------
# HF Llama key mapping
# ---------------------------------------------------------------------------
# HF nn.Linear stores [out_features, in_features]; the port's matmuls are
# x @ w with w [in, out], so every projection transposes. Embedding rows match.

_TOP_MAP = {
    "embed": ("model.embed_tokens.weight", False),
    "final_norm": ("model.norm.weight", False),
    "lm_head": ("lm_head.weight", True),
}
_ATTN_MAP = {
    "attn_norm": ("input_layernorm.weight", False),
    "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
    "mlp_norm": ("post_attention_layernorm.weight", False),
}
_LAYER_MAP = {
    **_ATTN_MAP,
    "w_gate": ("mlp.gate_proj.weight", True),
    "w_up": ("mlp.up_proj.weight", True),
    "w_down": ("mlp.down_proj.weight", True),
}
# MoE layers (Mixtral-style names: block_sparse_moe.gate + per-expert
# tensors). The switch FFN has two expert matmuls (w_in / w_out); each
# expert's matrix is its own HF-convention [out, in] tensor, so one shard
# never holds a layer's whole expert stack.
_MOE_LAYER_MAP = {
    **_ATTN_MAP,
    "router": ("block_sparse_moe.gate.weight", True),
}
_EXPERT_MAP = {
    "w_in": ("w_in.weight", True),
    "w_out": ("w_out.weight", True),
}


def layer_map(cfg: Optional[LlamaConfig] = None) -> dict:
    """Per-layer (non-expert) tensor map for this config's FFN flavor."""
    return _MOE_LAYER_MAP if cfg is not None and getattr(cfg, "is_moe", False) else _LAYER_MAP


def _expert_params(cfg: LlamaConfig) -> dict:
    return _EXPERT_MAP if getattr(cfg, "is_moe", False) else {}


def hf_key(
    param: str, layer: Optional[int] = None, expert: Optional[int] = None, cfg: Optional[LlamaConfig] = None
) -> tuple[str, bool]:
    """(HF tensor name, needs_transpose) for one of the port's param names."""
    if layer is None:
        return _TOP_MAP[param]
    if expert is not None:
        suffix, t = _EXPERT_MAP[param]
        return f"model.layers.{layer}.block_sparse_moe.experts.{expert}.{suffix}", t
    suffix, t = layer_map(cfg)[param]
    return f"model.layers.{layer}.{suffix}", t


# ---------------------------------------------------------------------------
# Export: params tree -> sharded safetensors (+ index) on disk
# ---------------------------------------------------------------------------


def _is_checkpoint_file(name: str) -> bool:
    return name == INDEX_FILE or name == SINGLE_FILE or (
        name.startswith("model-") and name.endswith(".safetensors")
    )


def _remove_stale_checkpoint(dest: Union[str, tuple]) -> None:
    """A prior export at the same destination may have left an index/shard
    layout the new one won't overwrite (sharded -> single-file); the loader
    prefers INDEX_FILE, so stale files would win. Remove every checkpoint
    file before writing."""
    if isinstance(dest, str):
        for name in os.listdir(dest):
            if _is_checkpoint_file(name):
                os.unlink(os.path.join(dest, name))
        return
    volume, prefix = dest
    for entry in volume.listdir(prefix.strip("/"), recursive=False):
        if _is_checkpoint_file(entry.path.rsplit("/", 1)[-1]):
            volume.remove_file(entry.path)


def _host_copy(t: torch.Tensor, transpose: bool) -> torch.Tensor:
    """One tensor on the host, in HF's layout (the transpose runs where the
    tensor lives, before the copy)."""
    return (t.T if transpose else t).contiguous().cpu()


def export_checkpoint(
    params: dict,
    cfg: LlamaConfig,
    dest: Union[str, tuple],
    *,
    max_shard_bytes: int = DEFAULT_SHARD_BYTES,
) -> dict:
    """Write `params` (the stacked tree) as an HF-convention sharded
    safetensors checkpoint in the local directory `dest`, or under a prefix
    of a Volume (`dest = (volume, prefix)`, committed at the end): the JAX
    package's files, shard names, index JSON and metadata. Host memory holds
    at most one tensor at a time; a shard bound for a Volume is staged in a
    temporary file first. Returns the index dict."""
    if any(is_quantized(v) for v in [params["embed"], params["lm_head"], *params["layers"].values()]):
        raise ValueError("export_checkpoint takes bf16/fp32 params; quantize after loading")
    lmap = layer_map(cfg)
    # (hf_name, shape, dtype, fetch, nbytes) in a fixed order; fetch is lazy,
    # and the shard plan needs only the shapes
    entries: list[tuple[str, tuple, torch.dtype, Callable[[], torch.Tensor], int]] = []
    for our, (name, t) in _TOP_MAP.items():
        leaf = params[our]
        shape = tuple(reversed(leaf.shape)) if t else tuple(leaf.shape)
        entries.append((name, shape, leaf.dtype, partial(_host_copy, leaf, t), _nbytes(shape or (1,), leaf.dtype)))
    for i in range(cfg.n_layers):
        for our, (suffix, t) in lmap.items():
            leaf = params["layers"][our]
            shape = tuple(reversed(leaf.shape[1:])) if t else tuple(leaf.shape[1:])
            entries.append(
                (f"model.layers.{i}.{suffix}", shape, leaf.dtype, partial(_host_copy, leaf[i], t),
                 _nbytes(shape, leaf.dtype))
            )
        for our, (_suffix, t) in _expert_params(cfg).items():
            leaf = params["layers"][our]  # [L, E, in, out]
            shape = tuple(reversed(leaf.shape[2:])) if t else tuple(leaf.shape[2:])
            for e in range(cfg.n_experts):
                entries.append(
                    (hf_key(our, i, expert=e)[0], shape, leaf.dtype, partial(_host_copy, leaf[i, e], t),
                     _nbytes(shape, leaf.dtype))
                )

    if isinstance(dest, str):
        os.makedirs(dest, exist_ok=True)
    _remove_stale_checkpoint(dest)
    shard_members: list[list] = [[]]
    current_bytes = total_bytes = 0
    for entry in entries:
        nb = entry[4]
        if current_bytes + nb > max_shard_bytes and shard_members[-1]:
            shard_members.append([])
            current_bytes = 0
        shard_members[-1].append(entry)
        current_bytes += nb
        total_bytes += nb

    weight_map: dict[str, str] = {}
    n_shards = len(shard_members)
    for si, members in enumerate(shard_members):
        shard_name = SINGLE_FILE if n_shards == 1 else f"model-{si + 1:05d}-of-{n_shards:05d}.safetensors"
        _write_shard(dest, shard_name, [(name, shape, dt, fetch) for name, shape, dt, fetch, _ in members])
        for member in members:
            weight_map[member[0]] = shard_name

    index = {"metadata": {"total_size": total_bytes}, "weight_map": weight_map}
    if n_shards > 1:
        blob = json.dumps(index, indent=0).encode()
        if isinstance(dest, str):
            with open(os.path.join(dest, INDEX_FILE), "wb") as f:
                f.write(blob)
        else:
            with dest[0].batch_upload(force=True) as batch:
                batch.put_data(blob, f"{dest[1].strip('/')}/{INDEX_FILE}")
    if not isinstance(dest, str):
        dest[0].commit()
    return index


def _write_shard(dest: Union[str, tuple], shard_name: str, entries: list) -> None:
    """One shard file, streamed one tensor at a time: into the directory,
    or through a temporary file onto the Volume."""
    if isinstance(dest, str):
        build_safetensors_streaming(entries, os.path.join(dest, shard_name), {"format": "modal_tpu"})
        return
    import tempfile

    volume, prefix = dest
    fd, tmp = tempfile.mkstemp(suffix=".safetensors")
    os.close(fd)
    try:
        build_safetensors_streaming(entries, tmp, {"format": "modal_tpu"})
        with volume.batch_upload(force=True) as batch:
            batch.put_file(tmp, f"{prefix.strip('/')}/{shard_name}")
    finally:
        os.unlink(tmp)


# ---------------------------------------------------------------------------
# Streaming load: checkpoint -> device params
# ---------------------------------------------------------------------------


class _CheckpointIndex:
    """tensor name -> (file, dtype, shape, absolute byte range)."""

    def __init__(self) -> None:
        self.tensors: dict[str, tuple[str, torch.dtype, tuple, int, int]] = {}

    @staticmethod
    def build(src: Any) -> "_CheckpointIndex":
        idx = _CheckpointIndex()
        if src.exists(INDEX_FILE):
            index = json.loads(src.read_all(INDEX_FILE))
            files = sorted(set(index["weight_map"].values()))
        elif src.exists(SINGLE_FILE):
            files = [SINGLE_FILE]
        else:
            raise FileNotFoundError(f"no {SINGLE_FILE} or {INDEX_FILE} in checkpoint source {src!r}")
        for file in files:
            # two reads: 8 bytes give the header length, so a probe never
            # over-fetches
            (hdr_len,) = struct.unpack("<Q", src.read(file, 0, 8))
            header, data_start = parse_safetensors_header(src.read(file, 0, 8 + hdr_len))
            for name, meta in header.items():
                if name == "__metadata__":
                    continue
                a, b = meta["data_offsets"]
                idx.tensors[name] = (
                    file, _ST_DTYPES[meta["dtype"]], tuple(meta["shape"]), data_start + a, data_start + b,
                )
        return idx

    def total_bytes(self) -> int:
        return sum(b - a for (_f, _d, _s, a, b) in self.tensors.values())


def _fetch_tensor(src: Any, idx: _CheckpointIndex, name: str) -> torch.Tensor:
    """One tensor's bytes by a ranged read into a fresh host buffer, viewed
    as a CPU tensor of its dtype and shape (no copy)."""
    from ..observability.catalog import WEIGHTS_LOADED_BYTES

    file, dtype, shape, a, b = idx.tensors[name]
    n = b - a
    buf = bytearray(n)
    got = src.read_into(file, a, n, buf)
    if got != n:
        raise IOError(f"short read for tensor {name!r}: {got} of {n} bytes")
    WEIGHTS_LOADED_BYTES.inc(n)
    if n == 0:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(buf, dtype=dtype).reshape(shape)


def _record_load_metrics(idx: _CheckpointIndex, elapsed_s: float) -> None:
    """Throughput and peak-RSS gauges after a load."""
    from ..observability.catalog import WEIGHTS_LOAD_GBPS, observe_peak_rss

    total = idx.total_bytes()
    if elapsed_s > 0 and total:
        WEIGHTS_LOAD_GBPS.set(total / elapsed_s / 1e9)
    observe_peak_rss()


class _LoadPlan:
    """The device half of the load: job order, buffer allocation (shapes
    from the checkpoint index, held against `init_params_abstract`), the
    host-side transpose and cast into pinned memory, and the placement."""

    def __init__(self, idx: _CheckpointIndex, cfg: LlamaConfig, dtype: Optional[torch.dtype],
                 device: torch.device, layout: str):
        self.idx = idx
        self.cfg = cfg
        self.device = device
        self.target_dtype = dtype or cfg.dtype
        self.per_layer = layout == "per_layer"
        self.abstract = init_params_abstract(cfg)
        self.params: dict = {}
        self.top_jobs = list(_TOP_MAP)
        # an expert stack is one job per layer: its experts' tensors are
        # fetched and stacked on the host
        self.experts = _expert_params(cfg)
        lmap = {**layer_map(cfg), **self.experts}
        self.layer_jobs = [(our, t, i) for our, (_s, t) in lmap.items() for i in range(cfg.n_layers)]
        self.layers: Any = [{} for _ in range(cfg.n_layers)] if self.per_layer else {}
        if not self.per_layer:
            for our, (_suffix, t) in lmap.items():
                expert = 0 if our in self.experts else None
                _f, _d, shape0, _a, _b = idx.tensors[hf_key(our, 0, expert=expert, cfg=cfg)[0]]
                layer_shape = tuple(reversed(shape0)) if t else shape0
                if expert is not None:
                    layer_shape = (cfg.n_experts, *layer_shape)
                self._check_shape(f"layers/{our}", (cfg.n_layers, *layer_shape), self.abstract["layers"][our])
                self.layers[our] = torch.empty((cfg.n_layers, *layer_shape), dtype=self.target_dtype, device=device)

    @staticmethod
    def _check_shape(path: str, shape: tuple, spec: torch.Tensor) -> None:
        if tuple(shape) != tuple(spec.shape):
            raise ValueError(f"checkpoint tensor {path}: shape {tuple(shape)}, the config wants {tuple(spec.shape)}")

    def cast(self, arrs: list[torch.Tensor], transpose: bool) -> torch.Tensor:
        """The tensors transposed, cast and stacked on the host, written once
        into pinned memory when they go to a card; one tensor is not
        stacked."""
        srcs = [a.T if transpose else a for a in arrs]
        shape = srcs[0].shape if len(srcs) == 1 else (len(srcs), *srcs[0].shape)
        out = torch.empty(shape, dtype=self.target_dtype, pin_memory=self.device.type == "cuda")
        for j, src in enumerate(srcs):
            (out if len(srcs) == 1 else out[j]).copy_(src)
        return out

    def fetch_top(self, src: Any, our: str) -> torch.Tensor:
        name, transpose = _TOP_MAP[our]
        if name not in self.idx.tensors and our == "lm_head":
            # tied embeddings (Llama-3.2 1B/3B style): lm_head = embed.T
            return self.cast([_fetch_tensor(src, self.idx, _TOP_MAP["embed"][0])], True)
        return self.cast([_fetch_tensor(src, self.idx, name)], transpose)

    def fetch_layer(self, src: Any, our: str, transpose: bool, i: int) -> torch.Tensor:
        if our in self.experts:
            names = [hf_key(our, i, expert=e)[0] for e in range(self.cfg.n_experts)]
        else:
            names = [hf_key(our, i, cfg=self.cfg)[0]]
        return self.cast([_fetch_tensor(src, self.idx, n) for n in names], transpose)

    def place_top(self, our: str, host: torch.Tensor) -> None:
        self._check_shape(our, tuple(host.shape), self.abstract[our])
        self.params[our] = host.to(self.device, non_blocking=True)

    def place_layer(self, our: str, i: int, host: torch.Tensor) -> None:
        if self.per_layer:
            self._check_shape(f"layers/{our}", tuple(host.shape), self.abstract["layers"][our][i])
            self.layers[i][our] = host.to(self.device, non_blocking=True)
        else:
            self.layers[our][i].copy_(host, non_blocking=True)

    def finish(self) -> dict:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {"embed": self.params["embed"], "layers": self.layers,
                "final_norm": self.params["final_norm"], "lm_head": self.params["lm_head"]}


def load_params(
    source: Any,
    cfg: LlamaConfig,
    *,
    shardings: Optional[dict] = None,
    mesh: Any = None,
    dtype: Optional[torch.dtype] = None,
    device=None,
    layout: str = "stacked",
) -> dict:
    """Stream an HF-convention Llama checkpoint into the port's param tree
    on `device` (CUDA unless the caller names the CPU).

    `source`: a local directory path, a `(volume, prefix)` pair, or a
    source object with `read`, `read_into`, `read_all` and `exists`. `layout`: "stacked" (`{key:
    [n_layers, ...]}`, what serving and `forward` take) or "per_layer" (the
    training layout, a list of per-layer dicts, as `convert.unstack_layers`
    gives, made without a stacked copy). `shardings` (a placement tree of
    the stacked layout, as `parallel.sharding.param_shardings` gives, with
    its DeviceMesh as `mesh`) returns every leaf as a DTensor holding this
    rank's piece: the whole tensor is loaded, then cut (a sharded train
    state regrids through `checkpoint.VolumeCheckpointer`).
    `dtype` casts (default `cfg.dtype`). Returns when every tensor is on the
    device."""
    if shardings is not None and (mesh is None or layout != "stacked"):
        raise ValueError("shardings= needs its mesh= and the stacked layout")
    if layout not in ("stacked", "per_layer"):
        raise ValueError(f"layout must be 'stacked' or 'per_layer', got {layout!r}")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    src = _as_source(source)
    idx = _CheckpointIndex.build(src)
    plan = _LoadPlan(idx, cfg, dtype, dev, layout)
    jobs = [(plan.place_top, (our,), partial(plan.fetch_top, src, our)) for our in plan.top_jobs]
    jobs += [(plan.place_layer, (our, i), partial(plan.fetch_layer, src, our, t, i)) for our, t, i in plan.layer_jobs]
    pending: deque = deque()
    with ThreadPoolExecutor(max_workers=PREFETCH, thread_name_prefix="weights-load") as pool:
        for place, args, fetch in jobs:
            pending.append((place, args, pool.submit(fetch)))
            if len(pending) >= PREFETCH:
                place_, args_, fut = pending.popleft()
                place_(*args_, fut.result())
        while pending:
            place_, args_, fut = pending.popleft()
            place_(*args_, fut.result())
    params = plan.finish()
    _record_load_metrics(idx, time.perf_counter() - t0)
    if shardings is not None:
        from ..parallel.sharding import place

        params = place(mesh, params, shardings)
    return params


async def load_params_async(
    source: Any,
    cfg: LlamaConfig,
    *,
    shardings: Optional[dict] = None,
    mesh: Any = None,
    dtype: Optional[torch.dtype] = None,
    device=None,
    layout: str = "stacked",
) -> dict:
    """`load_params` for an async caller, such as an async `@enter`: the
    same load on a worker thread, so the caller's loop (a container's
    heartbeat, its RPCs) runs on while the reads and the copies to the
    device go on. The reads are blocking calls on the load's own threads,
    so the coroutine wraps the blocking load, where the JAX package's
    blocking load and its coroutine share one plan."""
    return await asyncio.to_thread(
        load_params, source, cfg, shardings=shardings, mesh=mesh, dtype=dtype, device=device, layout=layout
    )
