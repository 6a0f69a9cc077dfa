"""Mixture-of-Experts LM in PyTorch: counterpart of tf_operator_tpu/models/moe.py.

Pre-LN blocks as the LM's (models/transformer.py), the MLP of every
``moe_every``-th block replaced by ``MoEMlp``: a router ``[h, E]`` (f32
routing), stacked expert weights ``experts_in [E, h, ffn]`` and
``experts_out [E, ffn, h]`` in the flax order (no transposes), and one of
two dispatches:

  - ``dense``: GShard top-k routing with a static per-expert capacity
    (``topk_routing``) and the four one-hot einsums;
  - ``sparse``: dropless. Route, sort the token copies by expert (a stable
    argsort, as ``jnp.argsort``), run both expert products as grouped
    matmuls over the contiguous groups (``ops.grouped_matmul``: K5 on the
    card), unsort and gate-combine. The gathers carry the JAX hand VJPs
    (``_DispatchGather``, ``_PermuteRows``): gathers by the inverse
    permutation, never a scatter.

Each MoE layer's aux losses (Switch balance, router z-loss: the sown
``moe_losses``) are kept on the layer by its forward and collected (and
cleared) by ``moe_lm_loss``.

Across processes (set by parallel.train_step.parallelize), as the JAX
package's ``MOE_RULES`` lay the weights out under GSPMD:

  - ep is not a data axis: ep ranks hold the same tokens, each rank holds
    E / ep experts (and under tp their ffn / tp columns), computes only
    its experts' share of the output (sparse: its groups' rows, every
    other row 0; dense: its experts' slice of the [E, B, C, H] dispatch),
    and the layer's output is summed over ep and tp (Megatron's f and g:
    the input and the gates through ``copy_to``, the output through
    ``reduce_from``, over the group of both axes);
  - the balance loss is a global-batch quantity: the Switch fraction
    (a count of first choices, no gradient) is averaged over the data
    axes and sp, the probabilities stay local, and each rank's term is
    E * sum(fraction_global * prob_local), whose mean over the ranks is
    the JAX term and whose gradient the plan's average makes JAX's;
  - under sp each rank routes its sequence shard; the dense dispatch's
    capacity is the whole row's, and its slots are assigned over the whole
    row from the router logits all-gathered over sp (no gradient), of
    which the rank keeps its columns.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from tf_operator_tpu_torch.models import transformer as tfm
from tf_operator_tpu_torch.ops.grouped_matmul import grouped_matmul
from tf_operator_tpu_torch.parallel import collectives


@dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32000
    num_layers: int = 4
    hidden: int = 512
    num_heads: int = 8
    mlp_ratio: int = 4
    max_len: int = 1024
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_every: int = 2          # every Nth block uses the MoE MLP
    balance_coef: float = 1e-2  # Switch load-balancing aux loss weight
    zloss_coef: float = 1e-3    # router logit z-loss weight
    causal: bool = True
    dtype: torch.dtype = torch.bfloat16
    dispatch: str = "dense"     # "dense" (GShard capacity) or "sparse" (dropless)

    @property
    def head_dim(self) -> int:
        return self.hidden // self.num_heads

    @property
    def ffn(self) -> int:
        return self.hidden * self.mlp_ratio

    def capacity(self, seq_len: int) -> int:
        """Static per-expert token capacity C for a [B, T] batch row."""
        c = int(self.top_k * seq_len * self.capacity_factor / self.num_experts)
        return max(c, 1)


TINY_MOE = MoEConfig(
    vocab_size=1024, num_layers=2, hidden=128, num_heads=4, max_len=256,
    num_experts=4, top_k=2, moe_every=1,
)


def _choices(probs: torch.Tensor, top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(masks [B, K, T, E], gates [B, K, T]): the k-th choice of each token
    by argmax over what the earlier choices left (the first maximum)."""
    e = probs.shape[-1]
    remaining = probs
    masks, gates = [], []
    for _ in range(top_k):
        onehot = F.one_hot(remaining.argmax(-1), e).to(torch.float32)
        masks.append(onehot)
        gates.append((remaining * onehot).sum(-1))
        remaining = remaining * (1.0 - onehot)
    return torch.stack(masks, 1), torch.stack(gates, 1)


def _slots(mask_k: torch.Tensor, capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(fits [B, K, T, E], slot one-hot [B, K, T, C]) of the choices
    mask_k [B, K, T, E]: a cumulative count over the (K, T) order, so all
    first choices claim slots before any second one, earlier tokens first."""
    b, k, t, e = mask_k.shape
    flat = mask_k.reshape(b, k * t, e)
    pos = ((flat.cumsum(1) - flat) * flat).sum(-1)                  # [B, KT]
    fits = (pos < capacity)[..., None] * flat
    # A position past the capacity has no slot (JAX's one_hot gives zeros).
    slot = F.one_hot(pos.long().clamp(max=capacity), capacity + 1)[..., :capacity]
    return fits.reshape(b, k, t, e), slot.to(torch.float32).reshape(b, k, t, capacity)


def topk_routing(router_logits: torch.Tensor, top_k: int, capacity: int,
                 row_logits: torch.Tensor | None = None, seq: tuple[int, int] = (0, 1)):
    """GShard top-k routing with static capacity: (combine [B, T, E, C] f32,
    dispatch [B, T, E, C] bool, aux {"fraction", "prob", "logits"}).

    Priority is choice-major then token-major; top_k > 1 renormalises the
    chosen gates, top_k == 1 keeps the raw softmax probability (Switch eq.
    2). With `row_logits` (the whole rows' logits [B, T * count, E], no
    gradient) the logits are shard seq = (index, count) of those rows: the
    slots are assigned over the whole rows and this shard's columns kept;
    the gates and aux come from the shard's own logits."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    mask_k, gate_k = _choices(probs, top_k)
    if top_k > 1:
        gate_k = gate_k / gate_k.sum(1, keepdim=True).clamp_min(1e-9)
    if row_logits is None:
        fits, slot = _slots(mask_k, capacity)
    else:
        with torch.no_grad():
            row_mask, _ = _choices(torch.softmax(row_logits.float(), dim=-1), top_k)
            fits, slot = (collectives.local_slice(a, 2, *seq)
                          for a in _slots(row_mask, capacity))
    combine = (gate_k[..., None, None] * fits[..., None] * slot[:, :, :, None, :]).sum(1)
    aux = {
        # fraction of tokens whose FIRST choice is expert e (Switch f_e)
        "fraction": mask_k[:, 0].mean(dim=(0, 1)),
        "prob": probs.mean(dim=(0, 1)),
        "logits": router_logits,
    }
    return combine, combine > 0.0, aux


def expert_counts(flat_e: torch.Tensor, num_experts: int) -> torch.Tensor:
    """The rows routed to each expert (int64 [E]): the JAX dispatch's
    bincount(flat_e, length=E). torch.bincount reads its input's maximum
    back to the host on CUDA, which a CUDA graph cannot capture; a
    scatter-add into E zeros gives the same counts on the device."""
    counts = torch.zeros(num_experts, dtype=torch.int64, device=flat_e.device)
    return counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))


class _DispatchGather(torch.autograd.Function):
    """x_sorted[i] = xf[token_of[i]]. Its VJP is the JAX hand VJP: the
    cotangent gathered by the inverse permutation (row a is token a // k's
    copy) and the k copies of each token summed; never a scatter-add."""

    @staticmethod
    def forward(ctx, x, token_of, inv, k):
        ctx.save_for_backward(inv)
        ctx.k, ctx.n = k, x.shape[0]
        return x.index_select(0, token_of)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        g_rep = g.index_select(0, inv)
        return g_rep.reshape(ctx.n, ctx.k, g.shape[-1]).sum(1), None, None, None


class _PermuteRows(torch.autograd.Function):
    """y[i] = x[perm[i]] for a permutation with a known inverse; the
    cotangent flows back through a gather by the inverse."""

    @staticmethod
    def forward(ctx, x, perm, inv_perm):
        ctx.save_for_backward(inv_perm)
        return x.index_select(0, perm)

    @staticmethod
    def backward(ctx, g):
        (inv_perm,) = ctx.saved_tensors
        return g.index_select(0, inv_perm), None, None


def sparse_moe_ffn(x: torch.Tensor, w_router: torch.Tensor, experts_in: torch.Tensor,
                   experts_out: torch.Tensor, cfg: MoEConfig, first_expert: int = 0,
                   group=None):
    """Dropless sorted dispatch: (y [B, T, H] in cfg.dtype, aux).

    experts_in/experts_out hold E_local experts from first_expert on (all of
    them unless expert-parallel); the output is their share of the layer's
    output, summed over `group` by the caller (MoEMlp)."""
    b, t, h = x.shape
    n, k = b * t, cfg.top_k
    xf = x.reshape(n, h)
    # Both operands up-cast: under master weights the live router parameter
    # is the bf16 compute copy, and routing stays f32 regardless.
    logits = xf.float() @ w_router.float()                              # [N, E]
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)                           # [N, K]
    if k > 1:
        topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_e = topi.reshape(n * k)           # assignment a <-> token a // k
    order = torch.argsort(flat_e, stable=True)
    token_of = order // k
    group_sizes = expert_counts(flat_e, cfg.num_experts)
    inv = torch.argsort(order, stable=True)

    # The experts' inputs and gates through Megatron's f over `group`: each
    # rank's experts give part of their gradients.
    x_sorted = _DispatchGather.apply(collectives.copy_to(xf.to(cfg.dtype), group), token_of,
                                     inv, k)
    hmid = grouped_matmul(x_sorted, experts_in.to(cfg.dtype), group_sizes, first_expert)
    hmid = F.gelu(hmid, approximate="tanh")
    y_sorted = grouped_matmul(hmid, experts_out.to(cfg.dtype), group_sizes, first_expert)
    # Unsort first, then gate-combine: the gates are in (token, slot) order.
    y_unsorted = _PermuteRows.apply(y_sorted, inv, order).reshape(n, k, h)
    gates = collectives.copy_to(topv.to(cfg.dtype), group)
    y = (gates[..., None] * y_unsorted).sum(1)

    aux = {
        "fraction": F.one_hot(topi[:, 0], cfg.num_experts).float().mean(0),
        "prob": probs.mean(0),
        "logits": logits.reshape(b, t, cfg.num_experts),
    }
    return y.reshape(b, t, h), aux


def load_balance_loss(aux: dict, num_experts: int) -> torch.Tensor:
    """Switch load-balancing loss: E * sum_e f_e * p_e (1.0 when uniform)."""
    return num_experts * (aux["fraction"] * aux["prob"]).sum()


def router_z_loss(aux: dict) -> torch.Tensor:
    """Penalise large router logits (ST-MoE eq. 5)."""
    z = torch.logsumexp(aux["logits"].float(), dim=-1)
    return z.square().mean()


class MoEMlp(nn.Module):
    """The expert FFN. `router` [h, E] f32, `experts_in` [E, h, ffn] and
    `experts_out` [E, ffn, h] (flax's leaves and order). parallelize sets
    `first_expert` (this rank's experts start there), `group` (the ranks
    whose parts of the experts sum to the output: ep and tp), `stats` (the
    group and size of the data axes and sp, over which the fraction is
    averaged), `seq_shard` and `sp_group` (sequence parallelism). The
    forward keeps (balance, zloss) in `losses`."""

    def __init__(self, cfg: MoEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h, e = cfg.hidden, cfg.num_experts
        self.router = nn.Parameter(torch.empty(h, e, device=device))
        self.experts_in = nn.Parameter(torch.empty(e, h, cfg.ffn, device=device))
        self.experts_out = nn.Parameter(torch.empty(e, cfg.ffn, h, device=device))
        self.first_expert = 0
        self.group = None
        self.stats: tuple = (None, 1)
        self.seq_shard = (0, 1)
        self.sp_group = None
        self.losses: tuple | None = None

    @torch.no_grad()
    def init_flax_like(self, generator: torch.Generator | None = None) -> None:
        """flax's lecun_normal: fan-in h for the router; batch_axis=0 for
        the experts, so fan-in h for experts_in and ffn for experts_out
        (each expert inits as a standalone dense layer)."""
        tfm.lecun_normal_(self.router, generator, fan_in=self.router.shape[0])
        tfm.lecun_normal_(self.experts_in, generator, fan_in=self.experts_in.shape[1])
        tfm.lecun_normal_(self.experts_out, generator, fan_in=self.experts_out.shape[1])

    def _aux_losses(self, aux: dict) -> tuple[torch.Tensor, torch.Tensor]:
        group, count = self.stats
        if group is not None:
            aux = dict(aux, fraction=collectives.all_reduce(aux["fraction"], group) / count)
        return load_balance_loss(aux, self.cfg.num_experts), router_z_loss(aux)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.dispatch == "sparse":
            y, aux = sparse_moe_ffn(x, self.router, self.experts_in, self.experts_out, cfg,
                                    self.first_expert, self.group)
            self.losses = self._aux_losses(aux)
            return collectives.reduce_from(y, self.group)

        # Router math in f32 (bf16 softmax over experts is too coarse).
        logits = torch.einsum("bth,he->bte", x.float(), self.router.float())
        index, count = self.seq_shard
        capacity = cfg.capacity(x.shape[1] * count)
        row = None if count == 1 else collectives.all_gather(logits, 1, self.sp_group)
        combine, dispatch, aux = topk_routing(logits, cfg.top_k, capacity, row, (index, count))
        self.losses = self._aux_losses(aux)

        # This rank's experts' slice of [B, T, E, C]: every expert without
        # expert parallelism.
        local = slice(self.first_expert, self.first_expert + self.experts_in.shape[0])
        xd = collectives.copy_to(x.to(cfg.dtype), self.group)
        expert_in = torch.einsum("btec,bth->ebch", dispatch[:, :, local].to(cfg.dtype), xd)
        hmid = torch.einsum("ebch,ehf->ebcf", expert_in, self.experts_in.to(cfg.dtype))
        hmid = F.gelu(hmid, approximate="tanh")
        expert_out = torch.einsum("ebcf,efh->ebch", hmid, self.experts_out.to(cfg.dtype))
        # Dropped tokens (over capacity) get 0: the residual carries them.
        # Every expert's gates through f, then this rank's: their gradient,
        # zero outside this rank's experts, sums over the group to the whole.
        gates = collectives.copy_to(combine.to(cfg.dtype), self.group)[:, :, local]
        if self.group is None:
            return torch.einsum("btec,ebch->bth", gates, expert_out)
        # One process's einsum sums a token's expert outputs in f32 and
        # rounds once; so this rank's part stays f32 until the sum over the
        # group, which then rounds once.
        part = torch.einsum("btec,ebch->bth", gates.float(), expert_out.float())
        return collectives.reduce_from(part, self.group).to(cfg.dtype)


def _attn_cfg(cfg: MoEConfig) -> tfm.TransformerConfig:
    return tfm.TransformerConfig(vocab_size=cfg.vocab_size, num_layers=cfg.num_layers,
                                 hidden=cfg.hidden, num_heads=cfg.num_heads,
                                 max_len=cfg.max_len, causal=cfg.causal, dtype=cfg.dtype)


class MoEBlock(nn.Module):
    """A pre-LN block whose MLP is `moe` (use_moe) or the dense mlp_in/out."""

    def __init__(self, cfg: MoEConfig, use_moe: bool, attn_fn: tfm.AttnFn | None = None,
                 device=None):
        super().__init__()
        h = cfg.hidden
        self.ln1 = tfm.LayerNorm(h, cfg.dtype, device=device)
        self.attn = tfm.SelfAttention(_attn_cfg(cfg), attn_fn, device=device)
        self.ln2 = tfm.LayerNorm(h, cfg.dtype, device=device)
        if use_moe:
            self.moe = MoEMlp(cfg, device=device)
        else:
            self.mlp_in = tfm.Dense(h, cfg.ffn, cfg.dtype, device=device)
            self.mlp_out = tfm.Dense(cfg.ffn, h, cfg.dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        h = self.ln2(x)
        if hasattr(self, "moe"):
            return x + self.moe(h)
        h = F.gelu(self.mlp_in(tfm.tp_input(h, self.mlp_in)), approximate="tanh")
        return x + self.mlp_out(h)


class MoETransformer(nn.Module):
    """The MoE LM's trunk: embeddings, the blocks (MoE every moe_every-th),
    the final LayerNorm. `batch_rows` and `seq_shard` as the LM trunk's."""

    def __init__(self, cfg: MoEConfig, attn_fn: tfm.AttnFn | None = None, device=None):
        super().__init__()
        self.cfg = cfg
        self.batch_rows = (0, 1)
        self.seq_shard = (0, 1)
        self.embed = tfm.Embed(cfg.vocab_size, cfg.hidden, cfg.dtype, device=device)
        self.pos_embed = tfm.Embed(cfg.max_len, cfg.hidden, cfg.dtype, device=device)
        self.layers = nn.ModuleList(
            MoEBlock(cfg, i % cfg.moe_every == cfg.moe_every - 1, attn_fn, device=device)
            for i in range(cfg.num_layers))
        self.ln_f = tfm.LayerNorm(cfg.hidden, cfg.dtype, device=device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        t = tokens.shape[1]
        pos = torch.arange(self.seq_shard[0] * t, (self.seq_shard[0] + 1) * t,
                           device=tokens.device)
        x = self.embed(tokens) + self.pos_embed(pos)[None]
        for layer in self.layers:
            x = layer(x)
        return self.ln_f(x)


class MoETransformerLM(nn.Module):
    """Causal LM with MoE FFNs every `moe_every` blocks (Mixtral/Switch
    layout). `hidden` exposes the trunk output for the chunked loss."""

    def __init__(self, cfg: MoEConfig, attn_fn: tfm.AttnFn | None = None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.trunk = MoETransformer(cfg, attn_fn, device=device)
        self.lm_head = tfm.Dense(cfg.hidden, cfg.vocab_size, cfg.dtype, bias=False,
                                 device=device)
        tfm.init_flax_like(self, generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        h = self.trunk(tokens)
        return self.lm_head(tfm.tp_input(h, self.lm_head)).float()

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.trunk(tokens)

    def moe_layers(self) -> list[MoEMlp]:
        return [m for m in self.modules() if isinstance(m, MoEMlp)]


def moe_lm_loss(model: MoETransformerLM, tokens: torch.Tensor, chunked: bool = False,
                chunk: int = 2048, seq: tuple[int, int] = (0, 1),
                head_weight: torch.Tensor | None = None) -> torch.Tensor:
    """Next-token loss plus the MoE aux losses (the mean balance and z-loss
    over the MoE layers, at their coefficients). `tokens` are the whole
    rows; the model runs shard `seq` of them, and the aux terms are this
    shard's part (divided by the shard count, as the LM loss is split).
    chunked=True runs the head and softmax per `chunk` positions
    (lm_loss_chunked) with `head_weight` (the head's whole weight; the
    model's own by default)."""
    cfg = model.cfg
    local = collectives.local_slice(tokens, 1, *seq) if seq[1] > 1 else tokens
    if chunked:
        weight = model.lm_head.weight if head_weight is None else head_weight
        loss = tfm.lm_loss_chunked(model.hidden(local), weight, tokens, chunk=chunk, seq=seq)
    else:
        loss = tfm.lm_loss(model(local), tokens, seq)
    layers = model.moe_layers()
    losses = [m.losses for m in layers if m.losses is not None]
    for m in layers:
        m.losses = None  # the graph they hold is this step's only
    if losses:
        balance = sum(b for b, _ in losses) / len(losses)
        zloss = sum(z for _, z in losses) / len(losses)
        loss = loss + (cfg.balance_coef * balance + cfg.zloss_coef * zloss) / seq[1]
    return loss


def moe_reference_forward(params: dict, cfg: MoEConfig, x: torch.Tensor) -> torch.Tensor:
    """Per-token reference of MoEMlp without a capacity limit (the test
    oracle): y[t] = sum over the top-k experts of gate * FFN_e(x[t]), f32.
    `params` holds router, experts_in, experts_out."""
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.top_k > 1:
        topv = topv / topv.sum(-1, keepdim=True)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    wi, wo = params["experts_in"].float(), params["experts_out"].float()
    for k in range(cfg.top_k):
        e = topi[..., k]
        h = F.gelu(torch.einsum("bth,bthf->btf", x.float(), wi[e]), approximate="tanh")
        out = out + topv[..., k, None] * torch.einsum("btf,btfh->bth", h, wo[e])
    return out


def moe_params_from_flax(tree) -> dict[str, torch.Tensor]:
    """state_dict of MoETransformerLM from the flax MoETransformerLM's param
    tree (nested dicts of numpy arrays): params_from_flax's names, the
    trunk's under `trunk.`; the MoE leaves keep their names and order."""
    return {(k if k.startswith("lm_head.") else f"trunk.{k}"): v
            for k, v in tfm.params_from_flax(tree).items()}
