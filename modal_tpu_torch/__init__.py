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
- `serving/`: the continuous-batching engine and its ASGI surface,
  `llm_service` (a deployable `@app.cls` web endpoint), the fleet router
  and the hot reload (`serve_app`);
- `parallel/`: the train step on one card or over a named mesh (FSDP, TP,
  expert-parallel MoE, GPipe, ring attention) of gloo or NCCL ranks;
- `runtime/`: the container runtime: the entrypoint a worker spawns, its
  input loop and user code, and the cold start it calls: warm-state
  snapshots to and from the card (`snapshot.py`), the fleet compile cache
  under the kernel builds (`compile_client.py`), import tracing
  (`telemetry.py`) and the env-gated warm-up of the entry points (`aot.py`);
- `server/`: the control plane of the function path on one host: state,
  its write-ahead journal and crash recovery (`journal.py`), scheduler (GPU
  placement), RPC handlers, blob server, worker and `LocalSupervisor`
  (`python -m modal_tpu_torch.server`), and the fleet compile-cache store
  (`compile_cache.py`);
- `observability/`: serving, device, compile and client metrics, spans,
  and the heartbeat report;
- the App layer: `App` (`app.py`) with `@app.function(gpu=...)` and
  `@app.cls(gpu=...)`, `Function`/`FunctionCall` (`functions.py`), `.map`
  and its siblings (`parallel_map.py`), `Cls`/`Obj`/`parameter` (`cls.py`),
  `Image`, `Mount`, `Secret`, `Cron`/`Period`, and `app.run()` /
  `app.deploy()` (`runner.py`);
- storage and gangs: `Volume` (`volume.py`), the Volume checkpointer
  (`checkpoint.py`), `NetworkFileSystem`, `CloudBucketMount`, and
  `@clustered` with `get_cluster_info` (`runtime/clustered.py`);
- sandboxes: `Sandbox.create(..., gpu=...)`, `exec` into one
  (`ContainerProcess`), its files (`SandboxFS`), tunnels (`Tunnel`,
  `forward`), snapshots (`SandboxSnapshot`) and readiness `Probe`s;
- the SDK's objects: `Dict` (`dict.py`), `Queue` (`queue.py`), `Proxy`
  (`proxy.py`), `Environment` (`environments.py`) and `Workspace`
  (`workspace.py`); the image builder's epochs live in `builder/`;
- the SDK core, imported on demand: the wire contract (`proto/`), the
  client (`client.py`), object handles (`object.py`), payloads
  (`serialization.py`), `gpu=` (`gpu_config.py`), method and lifecycle
  decorators, `@batched`, `@concurrent` and the web decorators
  (`partial_function.py`), `config.py`'s settings,
  `exception.py`, `retries.py`, `_logs.py`, `_output.py` and `_utils/`
  (the local fast path, `local_transport.py`, among them).

Entry points run on CUDA unless the caller passes `device="cpu"`.

Importing the package imports nothing else (not torch, grpc or protobuf):
a boot traces its imports with `runtime.telemetry` before anything heavy
loads. Each public name below loads its module on first access.
"""

# public name -> the module that defines it
_EXPORTS = {
    "logger": "config",
    "resolve_device": "config",
    "App": "app",
    "Function": "functions",
    "FunctionCall": "functions",
    "Cls": "cls",
    "Obj": "cls",
    "parameter": "cls",
    "Image": "image",
    "Mount": "mount",
    "Secret": "secret",
    "Retries": "retries",
    "Cron": "schedule",
    "Period": "schedule",
    "SchedulerPlacement": "schedule",
    "enable_output": "_output",
    "method": "partial_function",
    "enter": "partial_function",
    "exit": "partial_function",
    "batched": "partial_function",
    "concurrent": "partial_function",
    "web_endpoint": "partial_function",
    "fastapi_endpoint": "partial_function",
    "web_server": "partial_function",
    "asgi_app": "partial_function",
    "wsgi_app": "partial_function",
    "current_function_call_id": "runtime.execution_context",
    "current_input_id": "runtime.execution_context",
    "is_local": "runtime.execution_context",
    "resume_token": "runtime.execution_context",
    "set_resume_token": "runtime.execution_context",
    "Sandbox": "sandbox",
    "Probe": "sandbox",
    "Tunnel": "sandbox",
    "SandboxSnapshot": "snapshot",
    "ContainerProcess": "container_process",
    "SandboxFS": "sandbox_fs",
    "forward": "tunnel",
    "Volume": "volume",
    "NetworkFileSystem": "network_file_system",
    "CloudBucketMount": "cloud_bucket_mount",
    "clustered": "partial_function",
    "ClusterInfo": "runtime.clustered",
    "get_cluster_info": "runtime.clustered",
    "get_fabric_peers": "runtime.clustered",
    "Dict": "dict",
    "Queue": "queue",
    "Proxy": "proxy",
    "Environment": "environments",
    "Workspace": "workspace",
}

__all__ = [*_EXPORTS, "serving"]


def __getattr__(name: str):
    import importlib

    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    if name == "serving":
        # the serving tier: modal_tpu_torch.serving.llm_service /
        # ServingEngine / serving_asgi_app (torch loads lazily inside).
        # importlib, not `from . import`: the fromlist path re-enters this
        # __getattr__ before sys.modules is populated and recurses
        return importlib.import_module(".serving", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
