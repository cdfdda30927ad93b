"""Container runtime of the port, in the order a container boot calls it
(modal_tpu/runtime/container_entrypoint.py:505-545):

- `container_entrypoint.py`: the process a worker spawns
  (`python -m modal_tpu_torch.runtime.container_entrypoint`): the boot
  order below, then the input loop;
- `telemetry.py`: import tracing, installed before anything heavy loads;
- `user_code.py`: the serialized (or importable) function or class, its
  methods and its lifecycle hooks;
- `compile_client.py`: the fleet compile-cache tier under the kernel builds
  (`install_fleet_cache`), with `observability.device_telemetry`'s compile
  hooks;
- `snapshot.py`: warm-state snapshots; `restore_snapshot` streams a saved
  instance's state from disk to the card, else the boot builds it and
  `save_snapshot` writes it;
- `aot.py`: the env-gated warm-up of the entry points (kernel builds; the
  decode graph is captured by the engine);
- `io_manager.py`: heartbeats, input claims, outputs and the blob store;
  `main_thread_exec.py`: sync user code on the main thread, cancellable by
  SIGUSR1; `execution_context.py`: the current input.

Importing this package imports none of them (nor torch).
"""
