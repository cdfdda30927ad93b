"""Container runtime of the port, in the order a container boot calls it
(modal_tpu/runtime/container_entrypoint.py:505-545):

- `telemetry.py`: import tracing, installed before anything heavy loads;
- `compile_client.py`: the fleet compile-cache tier under the kernel builds
  (`install_fleet_cache`), with `observability.device_telemetry`'s compile
  hooks;
- `snapshot.py`: warm-state snapshots; `restore_snapshot` streams a saved
  instance's state from disk to the card, else the boot builds it and
  `save_snapshot` writes it;
- `aot.py`: the env-gated warm-up of the entry points (kernel builds; the
  decode graph is captured by the engine).

Importing this package imports none of them (nor torch).
"""
