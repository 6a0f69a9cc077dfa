"""Plain PyTorch reference of BERT's masked LM as the port trains it, in float32.

Written from the architecture's equations, as the configuration file
describes the variant under test: pre-LN blocks (LayerNorm with the file's
epsilon), learned positions, tanh-approximated GELU, biased dense layers,
full attention, and the masked-LM cross entropy over the masked positions
after the MLM transform (dense, GELU, LayerNorm) and a bias-free untied
decoder.

Parameters are a flat dict of float32 tensors whose names follow the
program's state dict, so the benchmark can hand one set of weights to both
sides. Attention runs in blocks of rows or heads under a hand-written
backward (`BlockAttention`), so a block never keeps more than
ATTN_BLOCK_ELEMENTS probabilities. `precision="fp8"` is the control: every matrix product's
operands rounded to float8 (e4m3 forward, e5m2 for the gradients flowing
back), the step below the bfloat16 the configuration states.

This module is the family "bert_mlm" (a configuration's `family`): the
harness finds it by that name and reads EMBED, param_spec, make_batch,
loss_and_grads and step_flops.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmarks import flops
from benchmarks.reference import lowp

# The most score elements (heads x T x T) one block of attention holds.
ATTN_BLOCK_ELEMENTS = 1 << 28
# The token embedding, whose rows the comparison reads one by one.
EMBED = "trunk.embed.weight"


def param_spec(arch: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, init) of every parameter, in the program's order; init is
    "matrix" or "embed" (a normal draw), "one" or "zero"."""
    h, v, f = arch["hidden"], arch["vocab"], arch["hidden"] * arch["mlp_ratio"]

    def dense(name, n_out, n_in):
        return [(f"{name}.weight", (n_out, n_in), "matrix"), (f"{name}.bias", (n_out,), "zero")]

    def norm(name):
        return [(f"{name}.weight", (h,), "one"), (f"{name}.bias", (h,), "zero")]

    spec = [(EMBED, (v, h), "embed"), ("trunk.pos_embed.weight", (arch["max_len"], h), "embed")]
    for i in range(arch["layers"]):
        pre = f"trunk.layers.{i}"
        spec += norm(f"{pre}.ln1")
        for proj in ("query", "key", "value", "attn_out"):
            spec += dense(f"{pre}.attn.{proj}", h, h)
        spec += norm(f"{pre}.ln2") + dense(f"{pre}.mlp_in", f, h) + dense(f"{pre}.mlp_out", h, f)
    spec += norm("trunk.ln_f") + dense("mlm_transform", h, h) + norm("mlm_ln")
    spec.append(("lm_head.weight", (v, h), "matrix"))
    return spec


def make_batch(arch: dict, shape: dict, g: torch.Generator) -> dict:
    """The trainer's synthetic MLM batch from generator `g`: uniform targets,
    then a uniform draw a position, masked below the mask rate, the masked
    inputs replaced by the mask token."""
    size = (shape["batch"], shape["seq"])
    tgt = torch.randint(0, arch["vocab"], size, generator=g, device=g.device)
    mask = (torch.rand(size, generator=g, device=g.device) < arch["mask_rate"]).float()
    return {"tokens": torch.where(mask.bool(), arch["mask_token"], tgt), "targets": tgt,
            "mask": mask}


def step_flops(shape: dict) -> float:
    """Model FLOPs of one training step at the cell's shape."""
    return flops.bert_flops_per_step(shape["batch"], shape["seq"], shape["layers"],
                                     shape["hidden"], shape["vocab"], shape["mlp_ratio"])


class BlockAttention(torch.autograd.Function):
    """softmax(q k^T / sqrt(D)) v on [B, H, T, D], computed over blocks of
    (rows, heads) with the probabilities recomputed in the backward (the
    equations of exact attention, not an approximation)."""

    @staticmethod
    def forward(ctx, q, k, v):
        b, h, t, d = q.shape
        scale = 1.0 / math.sqrt(d)
        o = torch.empty_like(q)
        lse = torch.empty(b, h, t, dtype=q.dtype, device=q.device)
        for r, hs in _blocks(b, h, t):
            s = torch.matmul(q[r, hs], k[r, hs].transpose(-1, -2)).mul_(scale)
            lse[r, hs] = torch.logsumexp(s, dim=-1)
            p = s.sub_(lse[r, hs, :, None]).exp_()
            o[r, hs] = torch.matmul(p, v[r, hs])
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        b, h, t, d = q.shape
        scale = 1.0 / math.sqrt(d)
        delta = (do * o).sum(-1)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        for r, hs in _blocks(b, h, t):
            s = torch.matmul(q[r, hs], k[r, hs].transpose(-1, -2)).mul_(scale)
            p = s.sub_(lse[r, hs, :, None]).exp_()
            dv[r, hs] = torch.matmul(p.transpose(-1, -2), do[r, hs])
            ds = torch.matmul(do[r, hs], v[r, hs].transpose(-1, -2))
            ds.sub_(delta[r, hs, :, None]).mul_(p).mul_(scale)
            del p
            dq[r, hs] = torch.matmul(ds, k[r, hs])
            dk[r, hs] = torch.matmul(ds.transpose(-1, -2), q[r, hs])
        return dq, dk, dv


def _blocks(b: int, h: int, t: int):
    """(rows, heads) slices of at most ATTN_BLOCK_ELEMENTS scores each: whole
    rows where one row's heads fit, else heads of one row."""
    heads = ATTN_BLOCK_ELEMENTS // (t * t)
    if heads >= h:
        rows = heads // h
        for r0 in range(0, b, rows):
            yield slice(r0, min(b, r0 + rows)), slice(0, h)
        return
    for r in range(b):
        for h0 in range(0, h, max(1, heads)):
            yield slice(r, r + 1), slice(h0, min(h, h0 + max(1, heads)))


def _layer_norm(x, p, name, eps):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps)


def _dense(x, p, name, precision):
    w, b = p[f"{name}.weight"], p.get(f"{name}.bias")
    if precision == "fp8":
        return lowp.fp8_linear(x, w, b)
    y = torch.matmul(x, w.t())
    return y if b is None else y + b


def hidden_states(p: dict, tokens: torch.Tensor, arch: dict,
                  precision: str = "f32") -> torch.Tensor:
    """The trunk's final (post-LayerNorm) hidden states [B, T, hidden]."""
    b, t = tokens.shape
    heads, eps = arch["heads"], arch["ln_eps"]
    x = p[EMBED][tokens] + p["trunk.pos_embed.weight"][:t][None]
    for i in range(arch["layers"]):
        pre = f"trunk.layers.{i}"
        y = _layer_norm(x, p, f"{pre}.ln1", eps)

        def heads_of(name):
            a = _dense(y, p, f"{pre}.attn.{name}", precision)
            a = a.view(b, t, heads, -1).transpose(1, 2)
            return lowp.round_e4m3(a) if precision == "fp8" else a

        o = BlockAttention.apply(heads_of("query"), heads_of("key"), heads_of("value"))
        x = x + _dense(o.transpose(1, 2).reshape(b, t, -1), p, f"{pre}.attn.attn_out",
                       precision)
        y = _layer_norm(x, p, f"{pre}.ln2", eps)
        y = F.gelu(_dense(y, p, f"{pre}.mlp_in", precision), approximate="tanh")
        x = x + _dense(y, p, f"{pre}.mlp_out", precision)
    return _layer_norm(x, p, "trunk.ln_f", eps)


def loss_sum(p: dict, batch: dict, arch: dict, precision: str = "f32") -> torch.Tensor:
    """The sum of the masked positions' losses of `batch`'s rows (the caller
    divides by the whole batch's count of masked positions)."""
    h = hidden_states(p, batch["tokens"], arch, precision)
    y = F.gelu(_dense(h, p, "mlm_transform", precision), approximate="tanh")
    y = _layer_norm(y, p, "mlm_ln", arch["ln_eps"])
    logp = F.log_softmax(_dense(y, p, "lm_head", precision), dim=-1)
    nll = -logp.gather(-1, batch["targets"][..., None])[..., 0]
    return (nll * batch["mask"]).sum()


def loss_and_grads(p: dict, batch: dict, arch: dict, rows: int,
                   precision: str = "f32") -> tuple[float, dict]:
    """(mean loss, {name: gradient}) over the whole batch, `rows` rows at a
    time, each block's gradients added in float32."""
    names = list(p)
    leaves = [p[n] for n in names]
    n_rows = batch["tokens"].shape[0]
    denom = float(max(batch["mask"].sum().item(), 1.0))
    total, grads = 0.0, None
    for r0 in range(0, n_rows, rows):
        part = {k: v[r0:r0 + rows] for k, v in batch.items()}
        with torch.enable_grad():
            live = [t.detach().requires_grad_(True) for t in leaves]
            loss = loss_sum(dict(zip(names, live)), part, arch, precision) / denom
            g = torch.autograd.grad(loss, live)
        total += loss.item()
        grads = list(g) if grads is None else [a.add_(b) for a, b in zip(grads, g)]
    return total, dict(zip(names, grads))
