"""Rank bodies for the port's multi-rank parity tests (not collected: no
`test_` prefix). Each runs in a process spawned by
`modal_tpu_torch.parallel.mesh.spawn` (gloo, the CPU), reads the inputs the
test wrote with `torch.save` (numpy arrays made from a seed, and the JAX
package's params), runs every check of its file on the port, and rank 0
writes what it found. Imports torch and the port only: the JAX references
are computed in the test process."""

from __future__ import annotations

import torch
import torch.distributed as dist

from modal_tpu_torch.models import llama as tllama
from modal_tpu_torch.models.convert import params_from_jax
from modal_tpu_torch.parallel import mesh as tmesh
from modal_tpu_torch.parallel.sharding import gather_train_params, local_grads, param_specs, shard_train_params
from modal_tpu_torch.parallel.spmd import SpmdPlan


def _cfg(name: str):
    return tllama.get_config(name, dtype=torch.float32)


def _seq_shard(x: torch.Tensor, plan: SpmdPlan) -> torch.Tensor:
    n, me = plan.sizes["seq"], plan.coords["seq"]
    s = x.shape[1] // n
    return x[:, me * s : (me + 1) * s].clone().requires_grad_(True)


def _gather_seq(x: torch.Tensor, plan: SpmdPlan) -> torch.Tensor:
    g = plan.group("seq")
    if g is None:
        return x.detach()
    parts = [torch.empty_like(x) for _ in range(plan.sizes["seq"])]
    dist.all_gather(parts, x.detach().contiguous(), group=g)
    return torch.cat(parts, dim=1)


def _ring(inputs: dict) -> dict:
    from modal_tpu_torch.parallel.ring_attention import ring_attention

    out = {}
    for n in (2, 4, 8):
        mesh = tmesh.build_mesh({"seq": n})
        plan = SpmdPlan(mesh)
        q, k, v = (_seq_shard(torch.from_numpy(inputs["ring_qkv"][i]), plan) for i in range(3))
        o = ring_attention(q, k, v, plan)
        (o**2).sum().backward()
        out[n] = {"out": _gather_seq(o, plan), "grads": [_gather_seq(t.grad, plan) for t in (q, k, v)]}
    mesh = tmesh.build_mesh({"seq": 8})
    plan = SpmdPlan(mesh)
    with torch.no_grad():
        q, k, v = (_seq_shard(torch.from_numpy(inputs["ring_long"][i]), plan) for i in range(3))
        out["long"] = _gather_seq(ring_attention(q, k, v, plan), plan)
    return out


def _mesh_rules() -> dict:
    from modal_tpu_torch.parallel.sharding import logical_batch_size

    m = tmesh.build_mesh({"model": 2})
    out = {"remainder": tmesh.axis_sizes(m), "logical_batch": logical_batch_size(m, 3),
           "slice": tmesh.axis_sizes(tmesh.mesh_from_slice_info(2, 4))}
    try:
        tmesh.single_device_mesh()
        out["single"] = "built"
    except ValueError as e:
        out["single"] = f"ValueError: {e}"
    for axes in ({"model": 3}, {"bogus": 2}):
        try:
            tmesh.build_mesh(axes)
            out[str(axes)] = "built"
        except ValueError as e:
            out[str(axes)] = f"ValueError: {e}"
    return out


def _seq_loss(inputs: dict) -> float:
    from modal_tpu_torch.parallel.ring_attention import make_ring_attention_impl
    from modal_tpu_torch.parallel.train import loss_fn

    cfg = _cfg("debug-1l")
    mesh = tmesh.build_mesh({"seq": 4})
    plan = SpmdPlan(mesh)
    params = shard_train_params(mesh, params_from_jax(inputs["params"]["debug-1l"], "cpu"), param_specs(cfg))
    tokens = plan.local_tokens(torch.from_numpy(inputs["seq_tokens"]).long())
    with torch.no_grad():
        return float(loss_fn(params, cfg, tokens, False, make_ring_attention_impl(plan), plan))


def _pipeline(inputs: dict) -> dict:
    from modal_tpu_torch.parallel.pipeline import pipeline_demo, pipeline_loss
    from modal_tpu_torch.parallel.sharding import pipeline_param_specs
    from modal_tpu_torch.parallel.train import loss_fn, tree_leaves

    cfg = _cfg("tiny")
    mesh = tmesh.build_mesh({"pipe": 2})
    plan = SpmdPlan(mesh, pipelined=True)
    full = params_from_jax(inputs["params"]["tiny"], "cpu")
    params = shard_train_params(mesh, full, pipeline_param_specs(cfg))
    for p in tree_leaves(params):
        p._local_tensor.requires_grad_(True)
    tokens = torch.from_numpy(inputs["pipe_tokens"]).long()
    loss = pipeline_loss(params, cfg, plan.local_tokens(tokens), plan, num_microbatches=4)
    loss.backward()
    grads = local_grads(params)
    plain = loss_fn(full, cfg, tokens, False)
    demo = pipeline_demo("tiny", n_stages=2, num_microbatches=4, batch=16, seq_len=64, device="cpu")
    return {"loss": float(loss), "plain": float(plain), "grads": gather_train_params(mesh, grads), "demo": demo}


def _sharded_steps(inputs: dict) -> dict:
    from modal_tpu_torch.parallel.train import TrainConfig, create_sharded_state, mirror_opt_shardings
    from modal_tpu_torch.parallel.train import train_state_shardings

    out = {}
    for name, axes in inputs["sharded_cases"]:
        cfg = _cfg(name)
        mesh = tmesh.build_mesh(axes, model_cfg=cfg)
        tc = TrainConfig(warmup_steps=1, total_steps=10)
        state, step, tok_pls = create_sharded_state(mesh, cfg, tc, params=params_from_jax(inputs["params"][name], "cpu"))
        tokens = torch.from_numpy(inputs["train_tokens"]).long()
        metrics = []
        for _ in range(2):
            state, m = step(state, tokens)
            metrics.append({k: float(v) for k, v in m.items()})
        shardings = train_state_shardings(state)
        out[f"{name} {axes}"] = {
            "metrics": metrics,
            "params": gather_train_params(mesh, state.params),
            "mirrored": shardings["opt"] == mirror_opt_shardings(state.params)
            and shardings["opt"]["exp_avg"] == shardings["params"],
            "sharded_leaves": sum(any(not p.is_replicate() for p in pls) for pls in _flat(shardings["params"])),
            "token_placements": [str(p) for p in tok_pls],
        }
    return out


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat(v)]
    return [] if tree is None else [tree]


def _train_demo() -> dict:
    from modal_tpu_torch.parallel.train import train_demo

    return train_demo("debug-1l", {"fsdp": 2, "seq": 4}, steps=2, seq_len=64, device="cpu")


def parallel_rank(rank: int, world: int, in_path: str, out_path: str) -> None:
    """Every multi-rank check of tests/test_torch_parallel.py, world 8."""
    inputs = torch.load(in_path, weights_only=False)
    results = {
        "mesh": _mesh_rules(),
        "ring": _ring(inputs),
        "seq_loss": _seq_loss(inputs),
        "pipeline": _pipeline(inputs),
        "sharded": _sharded_steps(inputs),
        "train_demo": _train_demo(),
    }
    if rank == 0:
        torch.save(results, out_path)


def moe_rank(rank: int, world: int, in_path: str, out_path: str) -> None:
    """The sharded MoE FFN of tests/test_torch_moe.py on {"expert": 4,
    "fsdp": 2}: this rank's [B_l, S, D] block in, the all-gathered y out."""
    from modal_tpu_torch.parallel.moe import moe_layer
    from modal_tpu_torch.parallel.sharding import distribute, placements

    inputs = torch.load(in_path, weights_only=False)
    cfg = tllama.get_config("tiny-moe", dtype=torch.float32, capacity_factor=inputs["capacity_factor"])
    mesh = tmesh.build_mesh({"expert": 4, "fsdp": 2})
    plan = SpmdPlan(mesh)
    specs = {"router": (None, None), "w_in": ("expert", "fsdp", None), "w_out": ("expert", None, "fsdp")}
    layer = {k: distribute(torch.from_numpy(v), mesh, placements(mesh, specs[k])) for k, v in inputs["moe"].items()}
    local = plan.localize_layer(layer)
    x = torch.from_numpy(inputs["x"])  # [B, S, D]
    b = x.shape[0] // plan.sizes["fsdp"]
    xl = x[plan.coords["fsdp"] * b : (plan.coords["fsdp"] + 1) * b]
    y, aux, dropped = moe_layer(xl, local, cfg, torch.nn.functional.silu, plan)
    parts = [torch.empty_like(y) for _ in range(plan.sizes["fsdp"])]
    dist.all_gather(parts, y.detach().contiguous(), group=plan.group("fsdp"))
    # the checkpoint the test exported, loaded straight onto the mesh
    from modal_tpu_torch.models.weights import load_params
    from modal_tpu_torch.parallel.sharding import full_tensor, param_shardings, shard_params

    mcfg = tllama.get_config("tiny-moe", dtype=torch.float32)
    loaded = load_params(inputs["ckpt"], mcfg, shardings=param_shardings(mesh, mcfg), mesh=mesh, device="cpu")
    want = params_from_jax(inputs["ckpt_params"], "cpu")
    placed = shard_params(mesh, mcfg, want)
    pairs = [(loaded[k], want[k], placed[k]) for k in ("embed", "final_norm", "lm_head")]
    pairs += [(loaded["layers"][k], want["layers"][k], placed["layers"][k]) for k in want["layers"]]
    load = {"equal": all(torch.equal(full_tensor(a), b) and a.placements == c.placements
                         and torch.equal(a.to_local(), c.to_local()) for a, b, c in pairs),
            "sharded": sum(a.to_local().numel() < b.numel() for a, b, _c in pairs), "leaves": len(pairs)}
    if rank == 0:
        torch.save({"y": torch.cat(parts), "aux": float(aux), "dropped": float(dropped), "load": load}, out_path)
