"""PyTorch / CUDA port of modal_tpu's serving and training paths, for NVIDIA
Hopper (H100).

The JAX package `modal_tpu` stays the reference; this package imports
nothing from it (nor `jax`). Layout mirrors the JAX package's file names so
each module's counterpart is easy to find:

- `models/`: Llama forward (`llama.py`), int8 weights (`quant.py`), the
  paged KV cache and its CUDA-graph decode step (`paged_kv.py`), sampling
  and generation (`sampling.py`), safetensors checkpoints (`weights.py`)
  and the JAX param-tree converter (`convert.py`);
- `ops/`: the hand-written CUDA kernels' Python wrappers, each beside its
  plain PyTorch version (`paged_attention.py`, `attention.py`), and the
  kernel builder (`_build.py`); sources live in `csrc/`;
- `serving/`: the continuous-batching engine and its ASGI surface;
- `parallel/`: the train step on one card or over a named mesh (FSDP, TP,
  expert-parallel MoE, GPipe, ring attention) of gloo or NCCL ranks;
- `runtime/`: the container runtime: the entrypoint a worker spawns, its
  input loop and user code, and the cold start it calls: warm-state
  snapshots to and from the card (`snapshot.py`), the fleet compile cache
  under the kernel builds (`compile_client.py`), import tracing
  (`telemetry.py`) and the env-gated warm-up of the entry points (`aot.py`);
- `server/`: the control plane of the function path on one host: state,
  scheduler (GPU placement), RPC handlers, blob server, worker and
  `LocalSupervisor` (`python -m modal_tpu_torch.server`), and the fleet
  compile-cache store (`compile_cache.py`);
- `observability/`: serving, device, compile and client metrics, spans,
  and the heartbeat report;
- the SDK core, imported on demand: the wire contract (`proto/`), the
  client (`client.py`), object handles (`object.py`), payloads
  (`serialization.py`), `gpu=` (`gpu_config.py`), method and lifecycle
  decorators (`partial_function.py`), `config.py`'s settings,
  `exception.py`, `retries.py`, `_logs.py`, `_output.py` and `_utils/`.

Entry points run on CUDA unless the caller passes `device="cpu"`.

Importing the package imports nothing else (not torch, grpc or protobuf):
a boot traces its imports with `runtime.telemetry` before anything heavy
loads.
"""

__all__ = ["logger", "resolve_device"]


def __getattr__(name: str):
    if name in __all__:
        from . import config

        return getattr(config, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
