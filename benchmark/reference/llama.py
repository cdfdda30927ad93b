"""Plain float32 reference of the decoder that both configurations share:
RMSNorm, rotary position embedding with a configurable base, grouped-query
attention with head_dim = hidden_size / num_attention_heads, a SwiGLU
feed-forward block, untied input embedding and output head.

It reads the weights as the benchmark made them (a dict of stacked bf16
tensors, `benchmark.weights`) and upcasts one layer at a time, so the
whole model never exists in float32 at once. Attention is full and causal
over the whole sequence: no cache, no pages, no batching of requests.
TF32 is switched off while it runs.

Departures from the published description, each on purpose:
- no tokenizer, no BOS token and no chat template: sequences are seeded ids;
- `matmul` can round both operands to float8 (e4m3, one scale per
  tensor, and the backward's incoming gradient to e5m2) as a float8 GEMM
  would, the control of `benchmark.check`, or to
  bfloat16 before it and its result after it, a witness in the served
  precision; neither is the reference itself.

Imports torch alone: nothing of the program under test.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def strict_fp32() -> Iterator[None]:
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _round_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`x` rounded to a float8 type with one scale for the tensor, back in
    float32."""
    scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8Operand(torch.autograd.Function):
    """Forward: an operand rounded to e4m3. Backward: the gradient passes."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Gradient(torch.autograd.Function):
    """Forward: the product passes. Backward: its gradient, the operand of
    the backward's products, rounded to e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2)


def fp8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A product computed as a float8 GEMM computes it: both operands in
    e4m3 with one scale each, and in the backward the incoming gradient in
    e5m2; accumulation in float32."""
    return _Fp8Gradient.apply(_Fp8Operand.apply(x) @ _Fp8Operand.apply(w))


class Model:
    """The reference over one set of weights. `model` is the configuration
    (`benchmark.models.Model`), `weights` the stacked bf16 tensors;
    `precision` is "fp32" (the reference), "fp8" (every product's operands
    rounded to float8: the control) or "bf16" (operands and results of
    every product rounded to bfloat16: a witness)."""

    def __init__(self, model, weights: dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.m = model
        self.w = weights
        self.precision = precision

    # -- pieces ---------------------------------------------------------------

    def matmul(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            return fp8_matmul(x, w)
        if self.precision == "bf16":
            return (x.bfloat16() @ w.bfloat16()).float()
        return x @ w

    def layer(self, i: int, requires_grad: bool = False) -> dict:
        """Layer `i`'s weights in float32 (leaves that require grad when
        asked)."""
        out = {}
        for key, stacked in self.w["layers"].items():
            t = stacked[i].to(torch.float32, copy=True)
            out[key] = t.requires_grad_(True) if requires_grad else t
        return out

    def rms_norm(self, x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.m.rms_norm_eps) * gain

    def rope(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """x [S, H, hd]: each head's two halves rotated by position · base^(-2j/hd)."""
        hd = x.shape[-1]
        inv = 1.0 / (self.m.rope_theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd))
        ang = (positions.double()[:, None] * inv[None, :]).float()
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., : hd // 2], x[..., hd // 2 :]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Causal softmax attention, q [S, H, hd], k and v [S, KV, hd]; each
        group of H / KV query heads reads one KV head. Heads go in blocks
        so that the [heads, S, S] scores stay small."""
        s, h, hd = q.shape
        rep = h // k.shape[1]
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        outs = []
        block = max(1, min(h, (1 << 28) // (s * s)))
        for h0 in range(0, h, block):
            heads = torch.arange(h0, min(h, h0 + block), device=q.device)
            qb = q[:, heads].transpose(0, 1)  # [hb, S, hd]
            kb = k[:, heads // rep].transpose(0, 1)
            vb = v[:, heads // rep].transpose(0, 1)
            scores = self.matmul(qb, kb.transpose(1, 2)) / math.sqrt(hd)
            probs = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
            outs.append(self.matmul(probs, vb).transpose(0, 1))
        return torch.cat(outs, dim=1)  # [S, H, hd]

    def block(self, x: torch.Tensor, lw: dict, positions: torch.Tensor) -> torch.Tensor:
        """One decoder layer over x [S, D]."""
        m = self.m
        hd = m.hidden_size // m.num_attention_heads
        h = self.rms_norm(x, lw["attn_norm"])
        q = self.matmul(h, lw["wq"]).reshape(-1, m.num_attention_heads, hd)
        k = self.matmul(h, lw["wk"]).reshape(-1, m.num_key_value_heads, hd)
        v = self.matmul(h, lw["wv"]).reshape(-1, m.num_key_value_heads, hd)
        att = self.attention(self.rope(q, positions), self.rope(k, positions), v)
        x = x + self.matmul(att.reshape(x.shape[0], -1), lw["wo"])
        h = self.rms_norm(x, lw["mlp_norm"])
        gate = self.matmul(h, lw["w_gate"])
        return x + self.matmul(torch.nn.functional.silu(gate) * self.matmul(h, lw["w_up"]), lw["w_down"])

    def head(self, x: torch.Tensor) -> torch.Tensor:
        return self.matmul(self.rms_norm(x, self.w["final_norm"].float()), self.w["lm_head"].float())

    # -- serving: logits of given positions -----------------------------------

    @torch.no_grad()
    def logits(self, sequences: list[list[int]], positions: list[list[int]]) -> list[torch.Tensor]:
        """For each sequence of ids, the float32 logits [len(pos), V] that
        follow each of its positions in `positions`. The layers run outer,
        the sequences inner, so each layer is upcast once."""
        dev = self.w["embed"].device
        with strict_fp32():
            xs = [self.w["embed"][torch.as_tensor(s, device=dev)].float() for s in sequences]
            pos = [torch.arange(len(s), device=dev) for s in sequences]
            for i in range(self.m.num_hidden_layers):
                lw = self.layer(i)
                xs = [self.block(x, lw, p) for x, p in zip(xs, pos)]
                del lw
            return [self.head(x[torch.as_tensor(ps, device=dev)]) for x, ps in zip(xs, positions)]

    # -- training: loss and gradients -----------------------------------------

    def loss_and_grads(self, tokens: torch.Tensor, on_grad) -> float:
        """Next-token cross-entropy of one row `tokens` [S], mean over its
        S − 1 predicted positions, and its gradient. Each leaf's float32
        gradient goes to `on_grad(path, grad)` as soon as it is known
        (paths: ("embed",), ("lm_head",), ("final_norm",), ("layers", key,
        i)); the backward runs one layer at a time from the layers' saved
        inputs, so only one layer's graph lives at once. Returns the loss."""
        m = self.m
        dev = tokens.device
        positions = torch.arange(tokens.shape[0], device=dev)
        with strict_fp32():
            embed = self.w["embed"].to(torch.float32, copy=True).requires_grad_(True)
            x0 = embed[tokens]
            inputs = []
            x = x0.detach()
            with torch.no_grad():
                for i in range(m.num_hidden_layers):
                    inputs.append(x)
                    x = self.block(x, self.layer(i), positions)
            x = x.requires_grad_(True)
            gain = self.w["final_norm"].to(torch.float32, copy=True).requires_grad_(True)
            head = self.w["lm_head"].to(torch.float32, copy=True).requires_grad_(True)
            logits = self.matmul(self.rms_norm(x, gain), head)
            loss = torch.nn.functional.cross_entropy(logits[:-1], tokens[1:].long())
            d_x, d_gain, d_head = torch.autograd.grad(loss, (x, gain, head))
            on_grad(("final_norm",), d_gain)
            on_grad(("lm_head",), d_head)
            del logits, d_gain, d_head, head
            for i in reversed(range(m.num_hidden_layers)):
                lw = self.layer(i, requires_grad=True)
                xin = inputs.pop().requires_grad_(True)
                out = self.block(xin, lw, positions)
                keys = sorted(lw)
                grads = torch.autograd.grad(out, [xin] + [lw[k] for k in keys], d_x)
                d_x = grads[0]
                for key, g in zip(keys, grads[1:]):
                    on_grad(("layers", key, i), g)
                del lw, xin, out, grads
            (d_embed,) = torch.autograd.grad(x0, embed, d_x)
            on_grad(("embed",), d_embed)
            return float(loss.detach())


def leaf(weights: dict, path: tuple) -> torch.Tensor:
    """The stored tensor at `path` (a layer's slice of its stacked key)."""
    if path[0] == "layers":
        return weights["layers"][path[1]][path[2]]
    return weights[path[0]]


def leaf_paths(weights: dict) -> list[tuple]:
    paths = [("embed",), ("final_norm",), ("lm_head",)]
    for key in sorted(weights["layers"]):
        paths += [("layers", key, i) for i in range(weights["layers"][key].shape[0])]
    return paths


class AdamW:
    """AdamW as the configuration keeps it: params, gradients and both
    moments stored in the params' dtype, every update computed in float32
    (decoupled weight decay, bias-corrected moments), after a clip of the
    whole gradient to a global norm."""

    def __init__(self, weights: dict, lr: float, b1: float, b2: float, eps: float, weight_decay: float,
                 clip: float):
        self.w = weights
        self.lr, self.b1, self.b2, self.eps, self.wd, self.clip = lr, b1, b2, eps, weight_decay, clip
        self.m: dict = {}
        self.v: dict = {}
        self.t = 0

    def step(self, grads: dict, sq_norm: float, lr: Optional[float] = None) -> None:
        """One update from `grads` (path -> stored-dtype gradient) whose
        float32 squared norms sum to `sq_norm`."""
        self.t += 1
        lr = self.lr if lr is None else lr
        norm = math.sqrt(sq_norm)
        scale = 1.0 if norm < self.clip else self.clip / norm
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for path, g_stored in grads.items():
            p = leaf(self.w, path)
            g = g_stored.float() * scale
            m = self.m.get(path)
            v = self.v.get(path)
            m = (1 - self.b1) * g if m is None else self.b1 * m.float() + (1 - self.b1) * g
            v = (1 - self.b2) * g * g if v is None else self.b2 * v.float() + (1 - self.b2) * g * g
            p32 = p.float() * (1.0 - lr * self.wd)
            p32 = p32 - lr * (m / c1) / ((v / c2).sqrt() + self.eps)
            p.copy_(p32.to(p.dtype))
            self.m[path] = m.to(p.dtype)
            self.v[path] = v.to(p.dtype)
