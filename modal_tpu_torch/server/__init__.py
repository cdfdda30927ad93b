"""The port's control plane of the function path on one host (state,
scheduler, RPC handlers, blob server, worker, `LocalSupervisor`;
`python -m modal_tpu_torch.server`), and the fleet compile-cache store
(`compile_cache.py`, which needs neither gRPC nor protobuf). Importing this
package imports none of them."""
