"""Pipeline parallelism: counterpart of tf_operator_tpu/parallel/pipeline.py.

A GPipe schedule over the `pp` process group. The layers are cut into S
stages whose parameters are stacked on a leading axis (every rank holds the
stack; pp rank s runs slice s). M microbatches flow through the S stages
in M + S - 1 ticks: at tick t, stage s runs microbatch t - s when there is
one, stage 0 on its slice of the input and stage s > 0 on the activation
that stage s - 1 sent it at tick t - 1 (a point-to-point hop; under gloo a
CUDA tensor goes through a pinned host buffer, collectives.send/recv). A
rank idles through the ticks where it has no microbatch: the bubble,
(S - 1) / (M + S - 1) of the schedule. The last stage's outputs reach every
pp rank by one all-reduce (JAX's psum of the masked outputs), so every rank
computes the same loss from them.

The backward needs no schedule of its own: each hop is an autograd
Function whose backward sends the activation's gradient back to the stage
that sent it (tagged by microbatch), and autograd runs the microbatches'
backwards in the reverse order on every rank. Each rank's gradient is its
part of the global one: its stage's slice of the stack, and, on stage 0,
the input's; `reduce_grads` sums the stage stack and the input side over
pp (and the data axes), where JAX's global arrays hold them summed.

Over the data axes (dp, fsdp) each pp rank runs its rows of every
microbatch, and the output is all-gathered back over them.

`make_pipelined_lm` is the causal LM over this schedule: the embeddings
and the head outside it, replicated, and the stacked transformer `Block`s
inside it, so K1-K3 run in every stage. As in the JAX package, no trainer
path calls it.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from tf_operator_tpu_torch.parallel import collectives
from tf_operator_tpu_torch.parallel import mesh as mesh_lib

StageFn = Callable[[dict, torch.Tensor], torch.Tensor]
# stage_fn(stage_params, h) -> h, the same activation shape in and out.
BATCH_AXES = ("dp", "fsdp")


def stack_stage_params(init_fn: Callable[[torch.Generator | None], dict],
                       generator: torch.Generator | None, num_stages: int) -> dict:
    """S stage parameter dicts from init_fn(generator), drawn one after
    another, stacked on a leading axis."""
    stages = [init_fn(generator) for _ in range(num_stages)]
    return {k: torch.stack([s[k] for s in stages]) for k in stages[0]}


def pipeline_size(mesh: mesh_lib.Mesh | None, pp_axis: str = "pp") -> int:
    return 1 if mesh is None else mesh_lib.axis_size(mesh, pp_axis)


class _Send(torch.autograd.Function):
    """The sending end of a hop: a zero scalar tied to the activation,
    whose backward receives the activation's gradient from `dst`."""

    @staticmethod
    def forward(ctx, x, dst, group, tag):
        ctx.like, ctx.peer = (x.shape, x.dtype, x.device), (dst, group, tag)
        collectives.send(x, dst, group, tag)
        return x.new_zeros((), dtype=torch.float32)

    @staticmethod
    def backward(ctx, _):
        return collectives.recv(*ctx.like, *ctx.peer), None, None, None


class _Recv(torch.autograd.Function):
    """The receiving end of a hop, whose backward sends the gradient back
    to `src`."""

    @staticmethod
    def forward(ctx, anchor, like, src, group, tag):
        ctx.peer = (src, group, tag)
        return collectives.recv(like.shape, like.dtype, like.device, src, group, tag)

    @staticmethod
    def backward(ctx, g):
        src, group, tag = ctx.peer
        collectives.send(g, src, group, tag)
        return None, None, None, None, None


def pipeline_apply(stage_fn: StageFn, stacked_params: dict, x: torch.Tensor,
                   mesh: mesh_lib.Mesh | None, num_microbatches: int,
                   pp_axis: str = "pp", batch_axes: tuple[str, ...] = BATCH_AXES,
                   remat: bool = False) -> torch.Tensor:
    """x [B, ...] through the S stacked stages; returns the same shape,
    the same on every rank. stacked_params: {name: tensor [S, ...]} with S
    the mesh's pp size. B must divide by num_microbatches, and each
    microbatch by the data-parallel size. Without a pp axis of size > 1 the
    stages run one after another."""
    if remat:
        from torch.utils.checkpoint import checkpoint

        inner = stage_fn

        def stage_fn(p, h):
            return checkpoint(inner, p, h, use_reentrant=False)

    n_stages = next(iter(stacked_params.values())).shape[0]

    def stage(i: int, h: torch.Tensor) -> torch.Tensor:
        return stage_fn({k: v[i] for k, v in stacked_params.items()}, h)

    pp = pipeline_size(mesh, pp_axis)
    if pp == 1:
        for i in range(n_stages):
            x = stage(i, x)
        return x
    m, b = num_microbatches, x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by microbatches {m}")
    if n_stages != pp:
        raise ValueError(f"stacked_params has {n_stages} stages but mesh axis '{pp_axis}' "
                         f"has {pp} devices; they must match (each pp rank runs exactly "
                         f"one stage)")
    axes = tuple(a for a in batch_axes if a in mesh.axis_names)
    dp = mesh.size(*axes)
    if (b // m) % dp:
        raise ValueError(f"microbatch size {b // m} not divisible by data-parallel size "
                         f"{dp} (batch {b}, {m} microbatches)")
    group, s = mesh.group(pp_axis), mesh.coord(pp_axis)
    xs = x.reshape((m, b // m) + x.shape[1:])
    if dp > 1:
        xs = collectives.local_slice(xs, 1, mesh.index(*axes), dp)
    outputs: list = [None] * m
    tokens = []
    like = xs[0].detach()
    # A received activation must require grad whatever x does, or its
    # backward (the send of its gradient back) would never run.
    anchor = torch.empty(0, requires_grad=True)
    # This rank's share of the schedule; it idles through the other ticks.
    mine = [mb for tick in gpipe_schedule(pp, m) for stage_i, mb in tick if stage_i == s]
    for mb in mine:
        h = xs[mb] if s == 0 else _Recv.apply(anchor, like, s - 1, group, mb)
        out = stage(s, h)
        if s < pp - 1:
            tokens.append(_Send.apply(out, s + 1, group, mb))
        else:
            outputs[mb] = out
    if s == pp - 1:
        full = torch.stack(outputs)
    else:
        full = torch.zeros(xs.shape[:2] + like.shape[1:], dtype=like.dtype, device=x.device)
    full = collectives.reduce_from(full, group)
    if tokens:
        # Ties the hops into this rank's graph: their backwards receive the
        # activations' gradients.
        full = full + torch.stack(tokens).sum().to(full.dtype)
    if dp > 1:
        full = collectives.gather_from(full, 1, mesh.group(*axes))
    return full.reshape(x.shape[:1] + full.shape[2:])


def gpipe_schedule(num_stages: int, num_microbatches: int) -> list[list[tuple[int, int]]]:
    """GPipe's M + S - 1 ticks, each the (stage, microbatch) pairs it runs:
    stage s runs microbatch t - s at tick t."""
    return [[(s, t - s) for s in range(num_stages) if 0 <= t - s < num_microbatches]
            for t in range(num_microbatches + num_stages - 1)]


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """The schedule's idle share, (S - 1) / (M + S - 1): the (stage, tick)
    cells gpipe_schedule leaves empty."""
    ticks = gpipe_schedule(num_stages, num_microbatches)
    return 1.0 - sum(len(t) for t in ticks) / (num_stages * len(ticks))


class _StageBlocks(nn.Module):
    """One stage's blocks, block_0 .. block_{n-1}: the JAX StageBlocks."""

    def __init__(self, cfg, n: int, attn_fn, device=None):
        super().__init__()
        from tf_operator_tpu_torch.models.transformer import Block

        for i in range(n):
            self.add_module(f"block_{i}", Block(cfg, attn_fn, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.children():
            x = block(x)
        return x


class PipelinedLM(nn.Module):
    """The pipelined causal LM: embed and pos_embed, `stages` (every
    parameter of a stage's blocks stacked on a leading S axis, under the
    block's own names), ln_f and lm_head. forward(tokens) -> f32 logits."""

    def __init__(self, cfg, mesh, num_microbatches: int, remat: bool = False,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        from tf_operator_tpu_torch.models import transformer as tfm
        from tf_operator_tpu_torch.parallel.ring_attention import make_attention_fn

        n_stages = pipeline_size(mesh)
        if cfg.num_layers % n_stages:
            raise ValueError(f"{cfg.num_layers} layers not divisible into {n_stages} stages")
        self.cfg, self.mesh = cfg, mesh
        self.num_microbatches, self.remat = num_microbatches, remat
        per_stage = cfg.num_layers // n_stages
        attn = make_attention_fn(None, causal=True)
        self.embed = tfm.Embed(cfg.vocab_size, cfg.hidden, cfg.dtype, device=device)
        self.pos_embed = tfm.Embed(cfg.max_len, cfg.hidden, cfg.dtype, device=device)
        self.ln_f = tfm.LayerNorm(cfg.hidden, cfg.dtype, device=device)
        self.lm_head = tfm.Dense(cfg.hidden, cfg.vocab_size, cfg.dtype, bias=False,
                                 device=device)
        tfm.init_flax_like(self, generator)

        def init_stage(gen):
            stage = _StageBlocks(cfg, per_stage, attn, device=device)
            tfm.init_flax_like(stage, gen)
            return {k: v.detach() for k, v in stage.named_parameters()}

        stacked = stack_stage_params(init_stage, generator, n_stages)
        # The stage's own modules, each parameter replaced by its stack; a
        # stage runs them functionally on its slice (stage_fn).
        self.stages = _StageBlocks(cfg, per_stage, attn, device="meta")
        modules = dict(self.stages.named_modules())
        for name, value in stacked.items():
            mod, _, leaf = name.rpartition(".")
            modules[mod].register_parameter(leaf, nn.Parameter(value))

    def stage_fn(self, params: dict, h: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(self.stages, params, (h,))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        from tf_operator_tpu_torch.models.transformer import tp_input

        pos = torch.arange(tokens.shape[1], device=tokens.device)
        h = self.embed(tokens) + self.pos_embed(pos)[None]
        h = pipeline_apply(self.stage_fn, dict(self.stages.named_parameters()), h, self.mesh,
                           self.num_microbatches, remat=self.remat)
        h = self.ln_f(h)
        return self.lm_head(tp_input(h, self.lm_head)).float()

    def reduce_grads(self) -> None:
        """Complete each rank's gradients to the global ones: the stage
        stack (each pp rank filled its slice) and the embeddings (stage 0
        only) summed over pp, and over the data axes, whose ranks ran their
        own rows; the head's are every rank's alike."""
        if pipeline_size(self.mesh) == 1:
            return
        axes = tuple(a for a in BATCH_AXES if a in self.mesh.axis_names)
        params = [self.embed.weight, self.pos_embed.weight, *self.stages.parameters()]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        for group in (self.mesh.group("pp"), self.mesh.group(*axes)):
            grads = collectives.all_reduce_flat(grads, group)
        for p, g in zip(params, grads):
            p.grad = g


def make_pipelined_lm(cfg, mesh, num_microbatches: int, remat: bool = False, device=None,
                      generator: torch.Generator | None = None):
    """(model, loss_fn): the pipelined causal LM over `cfg`
    (models.transformer.TransformerConfig) and loss_fn(model, batch), the
    next-token loss of batch["tokens"], the trainer's signature."""
    from tf_operator_tpu_torch.models.transformer import lm_loss

    model = PipelinedLM(cfg, mesh, num_microbatches, remat, device, generator)

    def loss_fn(model, batch):
        return lm_loss(model(batch["tokens"]), batch["tokens"])

    return model, loss_fn


def pipeline_rules(tp: bool = False):
    """The JAX rule table for the pipelined LM's parameters (flax paths,
    as sharding_rules reads every table): the stage stacks on pp, the rest
    replicated; with tp the stage kernels' matmul dimensions over tp too
    (stacked-leading-dim variants of TRANSFORMER_TP_RULES). The port's
    trainer does not run the pipelined LM (as in the JAX package)."""
    rules = []
    if tp:
        rules += [
            (r".*stages/.*(query|key|value|qkv)/kernel$", ("pp", None, "tp")),
            (r".*stages/.*attn_out/kernel$", ("pp", "tp", None)),
            (r".*stages/.*mlp_in/kernel$", ("pp", None, "tp")),
            (r".*stages/.*mlp_out/kernel$", ("pp", "tp", None)),
            (r".*embed/embedding$", ("tp", None)),
            (r".*lm_head/kernel$", (None, "tp")),
        ]
    return rules + [(r".*stages/.*", ("pp",)), (r".*", ())]


def _map_tree(tree, fn):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(np.asarray(tree))


def params_from_flax(tree) -> dict[str, torch.Tensor]:
    """PipelinedLM's state_dict from the JAX make_pipelined_lm params
    ({"embed", "stages" stacked on S, "head"}) as nested dicts of numpy
    arrays, through models/transformer.py's per-leaf converter (a stacked
    kernel [S, in, out] becomes [S, out, in])."""
    from tf_operator_tpu_torch.models.transformer import params_from_flax as convert

    out = {**convert(tree["embed"]), **convert(tree["head"])}
    first = tree["stages"]
    n = next(iter(_leaves(first))).shape[0]
    per_stage = [convert(_map_tree(first, lambda a, s=s: a[s])) for s in range(n)]
    for name in per_stage[0]:
        out[f"stages.{name}"] = torch.stack([p[name] for p in per_stage])
    return out


def _leaves(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield np.asarray(tree)


def lm_state_dict(state: dict[str, torch.Tensor], num_layers: int) -> dict[str, torch.Tensor]:
    """The TransformerLM state_dict of the same weights as PipelinedLM's
    `state`: stage s's block_i is layer s * (layers / S) + i."""
    out = {"trunk.embed.weight": state["embed.weight"],
           "trunk.pos_embed.weight": state["pos_embed.weight"],
           "trunk.ln_f.weight": state["ln_f.weight"], "trunk.ln_f.bias": state["ln_f.bias"],
           "lm_head.weight": state["lm_head.weight"]}
    stacked = {k[len("stages."):]: v for k, v in state.items() if k.startswith("stages.")}
    n = next(iter(stacked.values())).shape[0]
    per = num_layers // n
    for name, v in stacked.items():
        block, _, rest = name.partition(".")
        i = int(block[len("block_"):])
        for s in range(n):
            out[f"trunk.layers.{s * per + i}.{rest}"] = v[s]
    return out


__all__ = ["stack_stage_params", "pipeline_apply", "gpipe_schedule", "bubble_fraction",
           "PipelinedLM",
           "make_pipelined_lm", "pipeline_rules", "params_from_flax", "lm_state_dict"]
