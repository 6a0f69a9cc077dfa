"""The transformer family in PyTorch: counterpart of tf_operator_tpu/models/transformer.py.

The causal LM (``TransformerLM``), the BERT masked-LM model (``BertMLM``,
BASELINE.md workload 4's) and the [CLS]-pooled ``TransformerClassifier``
over one trunk.

Pre-LN blocks (LayerNorm eps 1e-6 with f32 statistics, tanh-approximated
GELU), learned positional embeddings, a bias-free LM head. Parameters are
f32 (or the bf16 compute copy under master weights) and every layer
computes in ``cfg.dtype``, as the flax modules do with ``param_dtype=f32,
dtype=cfg.dtype``.

Module names follow the JAX package's contract (``trunk/{embed, pos_embed,
layer_i/{attn/{query,key,value,attn_out}, ln1, ln2, mlp_in, mlp_out},
ln_f}``, ``lm_head``, ``mlm_transform``, ``mlm_ln``, ``pooler``, ``cls``), so
``params_from_flax`` carries a flax param tree across. Dense weights are
stored ``[out, in]`` as ``nn.Linear`` keeps them; flax kernels are ``[in,
out]`` and are transposed on the way in.

The attention function is injectable (``attn_fn``); the trainer passes the
flash kernels from ``parallel.ring_attention.make_attention_fn`` (ring
attention or Ulysses under sequence parallelism).

Under sequence parallelism (``Transformer.seq_shard`` = (index, count), set
by ``parallel.train_step.parallelize``) the trunk takes this rank's T/count
columns of the tokens, its positions start at index * T/count, and
``lm_loss``/``lm_loss_chunked`` (given the whole rows of tokens and the
shard) take the target of the shard's last position from the next shard's
first token; their denominator stays the global B x (T - 1).

Per-layer remat (``remat_layers``) runs each block under a non-reentrant
``torch.utils.checkpoint``: the forward keeps only the block's input and
the backward replays the block. ``remat_save_flash`` gives every block, and
``remat_save_flash_layers`` = K the first K blocks, the selective policy
``ops.flash_attention.flash_save_context``, which keeps the flash
forward's (o, lse) so the replay skips the O(T^2) kernel; as the JAX
``save_only_these_names("flash_o", "flash_lse")`` policy.

Dropout (``dropout_rate``) acts as flax ``nn.Dropout`` after the attention
and after the MLP of each block, only when a forward is called with
``deterministic=False``; its masks come from the explicit ``generator``
given to that forward (one seed drawn from it per block, so a
rematerialised block replays its own masks). A deterministic forward is
the forward without dropout.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, noop_context_fn

from tf_operator_tpu_torch.ops.flash_attention import flash_save_context
from tf_operator_tpu_torch.parallel import collectives
from tf_operator_tpu_torch.parallel.ring_attention import attention_reference
from tf_operator_tpu_torch.telemetry import phases

LN_EPS = 1e-6  # flax nn.LayerNorm's default


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 30522
    num_layers: int = 12
    hidden: int = 768
    num_heads: int = 12
    mlp_ratio: int = 4
    max_len: int = 512
    causal: bool = False
    dropout_rate: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    remat_layers: bool = False
    remat_save_flash: bool = False
    remat_save_flash_layers: int = 0

    def __post_init__(self):
        # The JAX package's invariants first, so a bad combination reports
        # what is wrong with it rather than what is missing.
        if ((self.remat_save_flash or self.remat_save_flash_layers)
                and not self.remat_layers):
            raise ValueError(
                "remat_save_flash[_layers] requires remat_layers=True (they "
                "select WHICH residuals per-layer remat keeps)")
        if self.remat_save_flash and self.remat_save_flash_layers:
            raise ValueError(
                "remat_save_flash (all layers) conflicts with "
                "remat_save_flash_layers (a subset): pick one")
        if self.remat_save_flash_layers < 0:
            raise ValueError("remat_save_flash_layers must be >= 0")

    @property
    def head_dim(self) -> int:
        return self.hidden // self.num_heads


BERT_BASE = TransformerConfig()
BERT_LARGE = TransformerConfig(num_layers=24, hidden=1024, num_heads=16)
TINY = TransformerConfig(vocab_size=1024, num_layers=2, hidden=128, num_heads=4,
                         max_len=256)
TINY_LM = dataclasses.replace(TINY, causal=True)

AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


class Dense(nn.Module):
    """y = x W^T + b computed in `dtype`; W is [out, in].

    Under tensor parallelism (`tp`, set by parallel.train_step.parallelize)
    W holds this rank's shard: of the output dimension ("col": the input
    is replicated, the output sharded, the full bias sliced; `tp.gather`
    all-gathers the output; the caller passes the input through
    `tp_input` once for all the layers that read it) or of the input
    dimension ("row": the partial products are all-reduced, then the bias
    is added)."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype,
                 bias: bool = True, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device)) if bias else None
        self.tp: collectives.TpShard | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        x, w, tp = x.to(self.dtype), self.weight.to(self.dtype), self.tp
        if tp is None:
            return F.linear(x, w, b)
        if tp.mode == "col":
            if b is not None:
                b = collectives.local_slice(b, 0, tp.index, tp.size)
            y = F.linear(x, w, b)
            return collectives.gather_from(y, -1, tp.group) if tp.gather else y
        y = collectives.reduce_from(F.linear(x, w), tp.group)
        return y if b is None else y + b


def tp_input(x: torch.Tensor, layer: Dense) -> torch.Tensor:
    """x as the input of `layer` and of the layers beside it that read the
    same x: under a column-parallel `layer`, Megatron's f (identity
    forward, its gradient all-reduced over tp: each rank's columns give
    part of it)."""
    tp = layer.tp
    return x if tp is None or tp.mode != "col" else collectives.copy_to(x, tp.group)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm: eps 1e-6, statistics and affine in f32, output in
    `dtype`."""

    def __init__(self, features: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                         self.bias.float(), LN_EPS)
        return y.to(self.dtype)


class Embed(nn.Module):
    """A lookup table [num, features]. Under tensor parallelism (`tp`) it
    holds rows [index * n, (index + 1) * n) of the table: each rank looks up
    the ids it holds, zeros the rest, and the ranks' rows are summed."""

    def __init__(self, num: int, features: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num, features, device=device))
        self.tp: collectives.TpShard | None = None

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        w, tp = self.weight.to(self.dtype), self.tp
        if tp is None:
            return F.embedding(idx, w)
        n = w.shape[0]
        local = idx - tp.index * n
        held = ((local >= 0) & (local < n))[..., None].to(w.dtype)
        return collectives.reduce_from(F.embedding(local.clamp(0, n - 1), w) * held, tp.group)


class Dropout(nn.Module):
    """flax nn.Dropout: with deterministic=False each element is kept with
    probability 1 - rate, drawn from `generator`, and divided by 1 - rate;
    otherwise (or at rate 0) the identity."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None,
                rows: tuple[int, int] = (0, 1), cols: tuple[int, int] = (0, 1)) -> torch.Tensor:
        """`rows` = (index, count): x is shard `index` of `count` equal row
        shards of the global batch (`cols`: of its dimension-1 columns, a
        sequence shard), whose mask is drawn whole and sliced, so a
        data- or sequence-parallel rank drops what one process would."""
        if deterministic or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout with deterministic=False draws its mask from an "
                             "explicit generator; none was given")
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep_prob = 1.0 - self.rate
        shape = [x.shape[0] * rows[1], *x.shape[1:]]
        if cols[1] > 1:
            shape[1] *= cols[1]
        draw = torch.rand(shape, generator=generator, device=x.device)
        draw = collectives.local_slice(draw, 0, *rows)
        keep = (draw if cols[1] == 1 else collectives.local_slice(draw, 1, *cols)) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class SelfAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig, attn_fn: AttnFn | None = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.attn_fn = attn_fn
        h = cfg.hidden
        self.query = Dense(h, h, cfg.dtype, device=device)
        self.key = Dense(h, h, cfg.dtype, device=device)
        self.value = Dense(h, h, cfg.dtype, device=device)
        self.attn_out = Dense(h, h, cfg.dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, t, _ = x.shape

        def split(a):  # [B, T, H*D] -> [B, H, T, D]; H is this rank's heads under tp
            return a.view(b, t, -1, cfg.head_dim).transpose(1, 2)

        attn = self.attn_fn
        if attn is None:
            attn = functools.partial(attention_reference, causal=cfg.causal)
        x = tp_input(x, self.query)
        o = attn(split(self.query(x)), split(self.key(x)), split(self.value(x)))
        return self.attn_out(o.transpose(1, 2).reshape(b, t, -1))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, attn_fn: AttnFn | None = None,
                 device=None):
        super().__init__()
        h = cfg.hidden
        self.ln1 = LayerNorm(h, cfg.dtype, device=device)
        self.attn = SelfAttention(cfg, attn_fn, device=device)
        self.ln2 = LayerNorm(h, cfg.dtype, device=device)
        self.mlp_in = Dense(h, h * cfg.mlp_ratio, cfg.dtype, device=device)
        self.mlp_out = Dense(h * cfg.mlp_ratio, h, cfg.dtype, device=device)
        self.dropout = Dropout(cfg.dropout_rate)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                seed: int | None = None, rows: tuple[int, int] = (0, 1),
                cols: tuple[int, int] = (0, 1)) -> torch.Tensor:
        """`seed` seeds the block's dropout masks (needed only when they
        are drawn: deterministic=False at a nonzero rate); `rows` and
        `cols` are Dropout's."""
        gen = None
        if not deterministic and self.dropout.rate:
            gen = torch.Generator(device=x.device).manual_seed(seed)
        x = x + self.dropout(self.attn(self.ln1(x)), deterministic, gen, rows, cols)
        h = F.gelu(self.mlp_in(tp_input(self.ln2(x), self.mlp_in)), approximate="tanh")
        return x + self.dropout(self.mlp_out(h), deterministic, gen, rows, cols)


class Transformer(nn.Module):
    """Token trunk; returns the final (post-LayerNorm) hidden states.
    `batch_rows` = (index, count) says which row shard of the global batch
    this process holds, and `seq_shard` which shard of its sequence (both
    set by parallel.train_step.parallelize): the tokens given are that
    shard's columns, its positions start at index * T_local, and dropout
    masks are the global batch's."""

    def __init__(self, cfg: TransformerConfig, attn_fn: AttnFn | None = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.batch_rows = (0, 1)
        self.seq_shard = (0, 1)
        self.embed = Embed(cfg.vocab_size, cfg.hidden, cfg.dtype, device=device)
        self.pos_embed = Embed(cfg.max_len, cfg.hidden, cfg.dtype, device=device)
        self.layers = nn.ModuleList(
            Block(cfg, attn_fn, device=device) for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.hidden, cfg.dtype, device=device)

    def forward(self, tokens: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        cfg = self.cfg
        t = tokens.shape[1]
        pos = torch.arange(self.seq_shard[0] * t, (self.seq_shard[0] + 1) * t,
                           device=tokens.device)
        x = self.embed(tokens) + self.pos_embed(pos)[None]
        remat = cfg.remat_layers and torch.is_grad_enabled()
        dropout = not deterministic and cfg.dropout_rate > 0
        if dropout and generator is None:
            raise ValueError("dropout with deterministic=False draws its masks from an "
                             "explicit generator; none was given")
        for i, layer in enumerate(self.layers):
            # One seed a block, drawn here, so a block's replay under remat
            # draws the masks of its forward.
            seed = (int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                      device=generator.device)) if dropout else None)
            if not remat:
                x = layer(x, deterministic, seed, self.batch_rows, self.seq_shard)
                continue
            # The first remat_save_flash_layers blocks (every block under
            # remat_save_flash) keep the flash residuals; the rest replay all.
            save = cfg.remat_save_flash or i < cfg.remat_save_flash_layers
            x = checkpoint(layer, x, deterministic, seed, self.batch_rows, self.seq_shard,
                           use_reentrant=False,
                           context_fn=flash_save_context if save else noop_context_fn)
        return self.ln_f(x)


class TransformerLM(nn.Module):
    """Causal LM head over the trunk. `hidden` exposes the trunk output so
    the chunked loss can apply the head per sequence chunk."""

    def __init__(self, cfg: TransformerConfig, attn_fn: AttnFn | None = None,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.trunk = Transformer(cfg, attn_fn, device=device)
        self.lm_head = Dense(cfg.hidden, cfg.vocab_size, cfg.dtype, bias=False,
                             device=device)
        init_flax_like(self, generator)

    def forward(self, tokens: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h = self.trunk(tokens, deterministic, generator)
        return self.lm_head(tp_input(h, self.lm_head)).float()

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.trunk(tokens)


class TransformerClassifier(nn.Module):
    """Sequence classifier over the trunk: the [CLS] position's hidden
    state through the dense `pooler` and tanh, then the `cls` head; f32
    logits [B, num_classes]."""

    def __init__(self, cfg: TransformerConfig, num_classes: int = 2,
                 attn_fn: AttnFn | None = None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.trunk = Transformer(cfg, attn_fn, device=device)
        self.pooler = Dense(cfg.hidden, cfg.hidden, cfg.dtype, device=device)
        self.cls = Dense(cfg.hidden, num_classes, cfg.dtype, device=device)
        init_flax_like(self, generator)

    def forward(self, tokens: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h = self.trunk(tokens, deterministic, generator)
        return self.cls(torch.tanh(self.pooler(h[:, 0]))).float()


class BertMLM(nn.Module):
    """BERT's masked-LM model over the trunk: the MLM transform (dense,
    GELU, LayerNorm) and a bias-free decoder to the vocabulary at every
    position; f32 logits [B, T, vocab]. In a step whose device stamps are
    on, the trunk's output marks where the head's forward starts, and its
    gradient where the head's and the loss's backward end."""

    def __init__(self, cfg: TransformerConfig, attn_fn: AttnFn | None = None,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden
        self.trunk = Transformer(cfg, attn_fn, device=device)
        self.mlm_transform = Dense(h, h, cfg.dtype, device=device)
        self.mlm_ln = LayerNorm(h, cfg.dtype, device=device)
        self.lm_head = Dense(h, cfg.vocab_size, cfg.dtype, bias=False, device=device)
        init_flax_like(self, generator)

    def forward(self, tokens: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h = self.trunk(tokens, deterministic, generator)
        phases.mark("trunk")
        phases.mark_grad(h, "trunk_grad")
        h = self.mlm_ln(F.gelu(self.mlm_transform(h), approximate="tanh"))
        return self.lm_head(tp_input(h, self.lm_head)).float()


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, generator: torch.Generator | None = None,
                  fan_in: int | None = None) -> None:
    """flax's lecun_normal in place: a unit normal truncated at 2 sigma,
    scaled to variance 1/fan_in, fan_in = every dimension but the first
    (in for a [out, in] kernel, in x kh x kw for an OIHW one) unless
    given."""
    fan_in = fan_in or math.prod(weight.shape[1:])
    nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
    weight.mul_(math.sqrt(1.0 / fan_in) / 0.87962566103423978)


@torch.no_grad()
def init_flax_like(model: nn.Module, generator: torch.Generator | None = None) -> None:
    """Flax's default initialisers, in distribution: Dense kernels
    lecun-normal (truncated at 2 sigma), biases 0, embeddings normal with
    std 1/sqrt(features), LayerNorm scale 1 and bias 0; an MoE layer's
    router and experts by its own fan-ins (models/moe.py)."""
    for mod in model.modules():
        if type(mod).__name__ == "MoEMlp":
            mod.init_flax_like(generator)
        elif isinstance(mod, Dense):
            lecun_normal_(mod.weight, generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, Embed):
            nn.init.normal_(mod.weight, 0.0, math.sqrt(1.0 / mod.weight.shape[1]),
                            generator=generator)
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()


def params_from_flax(tree) -> dict[str, torch.Tensor]:
    """state_dict of TransformerLM, BertMLM or TransformerClassifier from
    the flax model's param tree given as nested dicts of numpy arrays: `layer_i` -> `layers.i`; Dense `kernel` [in, out]
    -> `weight` [out, in]; `embedding` and LayerNorm `scale` -> `weight`."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            for key, child in node.items():
                walk(child, path + [key])
            return
        *mods, leaf = path
        names = [f"layers.{m[len('layer_'):]}" if m.startswith("layer_") else m
                 for m in mods]
        arr = np.array(node)
        if leaf == "kernel":
            arr, leaf = arr.T, "weight"
        elif leaf in ("embedding", "scale"):
            leaf = "weight"
        out[".".join(names + [leaf])] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(tree, [])
    return out


def mlm_loss(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Cross entropy over the masked positions only (mask [B, T] is 1.0
    where BERT replaced the token), in f32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def make_mlm_batch(generator: torch.Generator, batch: int, seq: int, vocab_size: int,
                   mask_rate: float = 0.15, mask_token: int = 103) -> dict[str, torch.Tensor]:
    """Synthetic MLM batch on the generator's device: uniform tokens (the
    targets), `mask_rate` of them replaced by [MASK] (103, BERT's id)."""
    dev = generator.device
    targets = torch.randint(0, vocab_size, (batch, seq), generator=generator, device=dev)
    mask = (torch.rand((batch, seq), generator=generator, device=dev) < mask_rate).float()
    tokens = torch.where(mask.bool(), mask_token, targets)
    return {"tokens": tokens, "targets": targets, "mask": mask}


def _next_tokens(tokens: torch.Tensor, t_local: int, seq: tuple[int, int]) -> torch.Tensor:
    """The next-token targets of shard `seq` = (index, count) of the whole
    rows `tokens` [B, T]: T/count of them, one fewer on the last shard
    (its last position has no target)."""
    start = seq[0] * t_local + 1
    return tokens[:, start:min(start + t_local, tokens.shape[1])]


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
            seq: tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Next-token cross entropy as logsumexp(z) - z[target] (no [B, T, V]
    log-probs tensor). `logits` are those of sequence shard `seq` of the
    whole rows `tokens`; the sum over the shards is the mean over B x
    (T - 1)."""
    tgt = _next_tokens(tokens, logits.shape[1], seq)
    z = logits[:, :tgt.shape[1]].float()
    lse = torch.logsumexp(z, dim=-1)
    z_tgt = torch.gather(z, -1, tgt[..., None])[..., 0]
    return (lse - z_tgt).sum() / (tokens.shape[0] * (tokens.shape[1] - 1))


def _chunk_nll(weight: torch.Tensor, h_c: torch.Tensor, t_c: torch.Tensor) -> torch.Tensor:
    logits = F.linear(h_c, weight).float()
    lse = torch.logsumexp(logits, dim=-1)
    z = torch.gather(logits, -1, t_c[..., None])[..., 0]
    return (lse - z).sum()


def lm_loss_chunked(h: torch.Tensor, head_weight: torch.Tensor,
                    tokens: torch.Tensor, chunk: int = 2048,
                    seq: tuple[int, int] = (0, 1)) -> torch.Tensor:
    """lm_loss without the full [B, T, vocab] logits: the head and the cross
    entropy run per sequence chunk, each chunk under a checkpoint so the
    backward recomputes its logits instead of keeping every chunk's (the
    stacked-logits residual the JAX docstring describes). head_weight is
    the LM head's [vocab, hidden] weight; `h` the hidden states of shard
    `seq` of the whole rows `tokens`, as in lm_loss."""
    b, t = tokens.shape
    tgt = _next_tokens(tokens, h.shape[1], seq)
    n = tgt.shape[1]
    preds = h[:, :n]
    weight = head_weight.to(h.dtype)
    total = h.new_zeros((), dtype=torch.float32)
    for s in range(0, n, chunk):
        total = total + checkpoint(_chunk_nll, weight, preds[:, s:s + chunk],
                                   tgt[:, s:s + chunk], use_reentrant=False)
    return total / (b * (t - 1))
