"""PyTorch / CUDA port of modal_tpu's serving path, for NVIDIA Hopper (H100).

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
- `parallel/`: the one-card train step;
- `runtime/`: the env-gated warm-up of the entry points (`aot.py`);
- `observability/`: the serving metrics and spans the engine emits.

Entry points run on CUDA unless the caller passes `device="cpu"`.
"""

from .config import logger, resolve_device

__all__ = ["logger", "resolve_device"]
