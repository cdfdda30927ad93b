"""Container runtime of the port: `aot.py`, the env-gated warm-up of the
entry points (kernel builds; the decode graph is captured by the engine)."""
