"""The plain reference against the program at the `tiny` size, in float32
on the CPU: the forward's logits, the loss and every leaf's gradient, and
AdamW as the configuration keeps it against torch's."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmark import models, weights
from benchmark.reference.llama import AdamW, Model, leaf, leaf_paths
from benchmark.tests.tiny import TINY, TINY_MHA


def tiny_model(raw: dict, dtype: str = "float32") -> models.Model:
    fields = {f.name for f in dataclasses.fields(models.Model)}
    return models.Model(**{k: v for k, v in {**raw, "torch_dtype": dtype}.items() if k in fields})


def program_params(m: models.Model, w: dict) -> dict:
    return {"embed": w["embed"], "final_norm": w["final_norm"], "lm_head": w["lm_head"],
            "layers": dict(w["layers"])}


@pytest.mark.parametrize("raw", [TINY, TINY_MHA], ids=["gqa", "mha"])
def test_forward_matches_the_program(raw):
    from modal_tpu_torch.models.llama import forward

    m = tiny_model(raw)
    w = weights.make(m, 7, "cpu")
    tokens = torch.randint(0, m.vocab_size, (1, 48), generator=torch.Generator().manual_seed(1))
    want, _ = forward(program_params(m, w), models.llama_config(m), tokens, attn_impl=None)
    got = Model(m, w).logits([tokens[0].tolist()], [list(range(48))])[0]
    assert torch.allclose(got, want[0], atol=2e-5, rtol=1e-4)


def test_loss_and_gradients_match_autograd_through_the_program():
    from modal_tpu_torch.parallel.train import loss_fn
    from modal_tpu_torch.models.convert import unstack_layers

    m = tiny_model(TINY)
    w = weights.make(m, 3, "cpu")
    params = unstack_layers(program_params(m, {k: (v.clone() if torch.is_tensor(v) else
                                                   {kk: vv.clone() for kk, vv in v.items()})
                                               for k, v in w.items()}))
    for p in [params["embed"], params["final_norm"], params["lm_head"]] + [
            t for layer in params["layers"] for t in layer.values()]:
        p.requires_grad_(True)
    row = torch.randint(0, m.vocab_size, (1, 64), generator=torch.Generator().manual_seed(2))
    loss = loss_fn(params, models.llama_config(m), row, remat=False)
    loss.backward()
    grads = {}
    ref_loss = Model(m, w).loss_and_grads(row[0], lambda path, g: grads.__setitem__(path, g))
    assert abs(ref_loss - float(loss.detach())) < 1e-5
    for path in leaf_paths(w):
        prog = params["layers"][path[2]][path[1]] if path[0] == "layers" else params[path[0]]
        assert torch.allclose(grads[path], prog.grad, atol=1e-6, rtol=1e-4), path


def test_adamw_matches_torch_in_float32():
    m = tiny_model(TINY)
    w = weights.make(m, 4, "cpu")
    mine = {k: (v.clone() if torch.is_tensor(v) else {kk: vv.clone() for kk, vv in v.items()}) for k, v in w.items()}
    paths = leaf_paths(w)
    torch_params = [leaf(w, p).clone().requires_grad_(True) for p in paths]
    opt = torch.optim.AdamW(torch_params, lr=3e-4, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1, foreach=False)
    ref = AdamW(mine, lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip=1e9)
    gen = torch.Generator().manual_seed(5)
    for _ in range(3):
        grads = {p: torch.randn(leaf(w, p).shape, generator=gen) for p in paths}
        for p, t in zip(paths, torch_params):
            t.grad = grads[p].clone()
        opt.step()
        ref.step(grads, sq_norm=sum(float(g.square().sum()) for g in grads.values()))
    for p, t in zip(paths, torch_params):
        assert torch.allclose(leaf(mine, p), t.detach(), atol=1e-7, rtol=1e-6), p


def test_float8_control_departs_and_bf16_witness_stays_close():
    m = tiny_model(TINY, "bfloat16")
    w = weights.make(m, 9, "cpu")
    seq = torch.randint(0, m.vocab_size, (96,), generator=torch.Generator().manual_seed(3)).tolist()
    pos = list(range(96))
    exact = Model(m, w).logits([seq], [pos])[0]
    low = Model(m, w, precision="fp8").logits([seq], [pos])[0]
    mid = Model(m, w, precision="bf16").logits([seq], [pos])[0]
    assert (low - exact).abs().max() > 4 * (mid - exact).abs().max() > 0
