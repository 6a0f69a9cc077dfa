"""Causal transformer LM in PyTorch: counterpart of tf_operator_tpu/models/transformer.py.

Pre-LN blocks (LayerNorm eps 1e-6 with f32 statistics, tanh-approximated
GELU), learned positional embeddings, a bias-free LM head. Parameters are
f32 (or the bf16 compute copy under master weights) and every layer
computes in ``cfg.dtype``, as the flax modules do with ``param_dtype=f32,
dtype=cfg.dtype``.

Module names follow the JAX package's contract (``trunk/{embed, pos_embed,
layer_i/{attn/{query,key,value,attn_out}, ln1, ln2, mlp_in, mlp_out},
ln_f}``, ``lm_head``), so ``params_from_flax`` carries a flax param tree
across. Dense weights are stored ``[out, in]`` as ``nn.Linear`` keeps them;
flax kernels are ``[in, out]`` and are transposed on the way in.

The attention function is injectable (``attn_fn``); the trainer passes the
flash kernels from ``parallel.ring_attention.make_attention_fn``.
Per-layer remat (``remat_layers``, ``remat_save_flash[_layers]``),
dropout, BERT, the classifier and the MLM head are not ported yet.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tf_operator_tpu_torch.parallel.ring_attention import attention_reference

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
        if self.remat_layers:
            raise NotImplementedError(
                "per-layer remat (remat_layers, remat_save_flash[_layers]) is "
                "not ported to the PyTorch package yet")
        if self.dropout_rate:
            raise NotImplementedError(
                "dropout is not ported to the PyTorch package yet")

    @property
    def head_dim(self) -> int:
        return self.hidden // self.num_heads


TINY_LM = TransformerConfig(
    vocab_size=1024, num_layers=2, hidden=128, num_heads=4, max_len=256,
    causal=True,
)

AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


class Dense(nn.Module):
    """y = x W^T + b computed in `dtype`; W is [out, in]."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype,
                 bias: bool = True, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


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
    def __init__(self, num: int, features: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num, features, device=device))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx, self.weight.to(self.dtype))


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

        def split(a):  # [B, T, H*D] -> [B, H, T, D]
            return a.view(b, t, cfg.num_heads, cfg.head_dim).transpose(1, 2)

        attn = self.attn_fn
        if attn is None:
            attn = functools.partial(attention_reference, causal=cfg.causal)
        o = attn(split(self.query(x)), split(self.key(x)), split(self.value(x)))
        return self.attn_out(o.transpose(1, 2).reshape(b, t, cfg.hidden))


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        h = F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh")
        return x + self.mlp_out(h)


class Transformer(nn.Module):
    """Token trunk; returns the final (post-LayerNorm) hidden states."""

    def __init__(self, cfg: TransformerConfig, attn_fn: AttnFn | None = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.hidden, cfg.dtype, device=device)
        self.pos_embed = Embed(cfg.max_len, cfg.hidden, cfg.dtype, device=device)
        self.layers = nn.ModuleList(
            Block(cfg, attn_fn, device=device) for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.hidden, cfg.dtype, device=device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = self.embed(tokens) + self.pos_embed(pos)[None]
        for layer in self.layers:
            x = layer(x)
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

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.trunk(tokens)).float()

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.trunk(tokens)


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, generator: torch.Generator | None = None) -> None:
    """flax's lecun_normal in place: a unit normal truncated at 2 sigma,
    scaled to variance 1/fan_in, fan_in = every dimension but the first
    (in for a [out, in] kernel, in x kh x kw for an OIHW one)."""
    fan_in = math.prod(weight.shape[1:])
    nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
    weight.mul_(math.sqrt(1.0 / fan_in) / 0.87962566103423978)


@torch.no_grad()
def init_flax_like(model: nn.Module, generator: torch.Generator | None = None) -> None:
    """Flax's default initialisers, in distribution: Dense kernels
    lecun-normal (truncated at 2 sigma), biases 0, embeddings normal with
    std 1/sqrt(features), LayerNorm scale 1 and bias 0."""
    for mod in model.modules():
        if isinstance(mod, Dense):
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
    """state_dict of TransformerLM from a flax param tree given as nested
    dicts of numpy arrays: `layer_i` -> `layers.i`; Dense `kernel` [in, out]
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


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy as logsumexp(z) - z[target] (no [B, T, V]
    log-probs tensor)."""
    z = logits[:, :-1].float()
    tgt = tokens[:, 1:]
    lse = torch.logsumexp(z, dim=-1)
    z_tgt = torch.gather(z, -1, tgt[..., None])[..., 0]
    return (lse - z_tgt).mean()


def _chunk_nll(weight: torch.Tensor, h_c: torch.Tensor, t_c: torch.Tensor) -> torch.Tensor:
    logits = F.linear(h_c, weight).float()
    lse = torch.logsumexp(logits, dim=-1)
    z = torch.gather(logits, -1, t_c[..., None])[..., 0]
    return (lse - z).sum()


def lm_loss_chunked(h: torch.Tensor, head_weight: torch.Tensor,
                    tokens: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """lm_loss without the full [B, T, vocab] logits: the head and the cross
    entropy run per sequence chunk, each chunk under a checkpoint so the
    backward recomputes its logits instead of keeping every chunk's (the
    stacked-logits residual the JAX docstring describes). head_weight is
    the LM head's [vocab, hidden] weight."""
    b, t, _ = h.shape
    preds, tgt = h[:, :-1], tokens[:, 1:]
    n = t - 1
    weight = head_weight.to(h.dtype)
    total = h.new_zeros((), dtype=torch.float32)
    for s in range(0, n, chunk):
        total = total + checkpoint(_chunk_nll, weight, preds[:, s:s + chunk],
                                   tgt[:, s:s + chunk], use_reentrant=False)
    return total / (b * n)
