"""Decode-capable TransformerLM forward with an explicit KV cache: counterpart
of tf_operator_tpu/models/decode.py.

The serving decode loop (serve/server.py) needs what the training forward
cannot give it: a PREFILL that returns the per-layer K/V it computed, a
single-token DECODE STEP that reads and extends a cache (O(T) work a
generated token instead of a full re-forward), and slot-addressed cache
writes, so the continuous-batching scheduler can admit and retire
sequences between ticks without touching the others' state.

This is a hand-written functional forward over the port's TransformerLM
state_dict (`trunk.embed.weight`, `trunk.pos_embed.weight`,
`trunk.layers.<i>.{ln1, attn.{query, key, value, attn_out}, ln2, mlp_in,
mlp_out}`, `trunk.ln_f`, `lm_head.weight`: the names the port's
checkpoints hold; dense weights are [out, in]). Numerics are the JAX
module's: f32 parameters, products in `cfg.dtype` (each product rounded,
then its bias added in dtype), f32 LayerNorm statistics with eps 1e-6,
attention scores in dtype divided by sqrt(D) rounded to dtype, NEG_INF
masking, an f32 softmax cast back to dtype, tanh GELU, f32 logits and the
first index of the maximum.

A dense weight is cast to `cfg.dtype` where it is used, which is a no-op
for a weight already in that dtype: `prepare_params` casts them once
(the server does so at load and at each checkpoint swap), with the bits
of the per-call cast.

Cache layout: one (k, v) pair of [num_layers, slots, heads, max_len,
head_dim] tensors in `cfg.dtype`; position p of slot s holds the K/V of
the token fed at absolute position p. Prefill and the decode step update
the cache in place (JAX donates the buffers; here the returned tensors are
the ones given). Slot ids and positions are host values (numpy arrays,
sequences or CPU tensors): they are checked on the host, since an index out
of range on a CUDA tensor is a device-side assert that poisons the
context.

Each public function is a host part and a device body. The host part checks
the index arguments (`check_slot_ids`, `check_positions`) and moves the
inputs to the device; the body (`prefill_body`, `prefill_into_slots_body`,
`decode_step_body`) reads only device tensors: the parameters, the cache,
int64 tokens, lengths, slot ids and positions, and the score scale
(`score_scale`). A body copies nothing from the host, so the serving graphs
(serve/decode_graphs.py) capture it over static inputs and give the public
function's bits.
"""

from __future__ import annotations

import math
import os
import re

import numpy as np
import torch
import torch.nn.functional as F

from tf_operator_tpu_torch.models.transformer import LN_EPS, TransformerConfig
from tf_operator_tpu_torch.ops.flash_attention import NEG_INF

ENV_NUM_HEADS = "TPUJOB_SERVE_NUM_HEADS"

# Conventional attention head width: every shape in a TransformerLM state
# dict determines vocab/hidden/layers/max_len, but the head COUNT appears
# in none, so serving a bare checkpoint needs a rule (the JAX package's).
# Non-conforming models override via TPUJOB_SERVE_NUM_HEADS.
DEFAULT_HEAD_DIM = 64

_LAYER_RE = re.compile(r"^trunk\.layers\.(\d+)\.")
_DENSE = ("attn.query", "attn.key", "attn.value", "attn.attn_out", "mlp_in", "mlp_out")


def config_from_params(params, num_heads: int | None = None) -> TransformerConfig:
    """Reconstruct the decode config from a TransformerLM state dict.

    vocab/hidden come from the embedding table, num_layers from the
    trunk.layers.<i> count, max_len from the position table, mlp_ratio from
    the mlp_in weight. num_heads is NOT derivable from shapes: pass it, set
    TPUJOB_SERVE_NUM_HEADS, or inherit the head_dim=64 convention."""
    try:
        vocab, hidden = params["trunk.embed.weight"].shape
        max_len = params["trunk.pos_embed.weight"].shape[0]
        layers = len({int(m.group(1)) for k in params if (m := _LAYER_RE.match(str(k)))})
        mlp_ratio = params["trunk.layers.0.mlp_in.weight"].shape[0] // hidden
    except (KeyError, TypeError) as e:
        raise ValueError(
            f"param tree is not a TransformerLM checkpoint (missing "
            f"{e}): decode serving needs the trunk/lm_head layout") from None
    if num_heads is None:
        env = os.environ.get(ENV_NUM_HEADS)
        if env:
            num_heads = int(env)
        elif hidden % DEFAULT_HEAD_DIM == 0:
            num_heads = hidden // DEFAULT_HEAD_DIM
        else:
            raise ValueError(
                f"cannot infer num_heads for hidden={hidden} (not a "
                f"multiple of {DEFAULT_HEAD_DIM}); set {ENV_NUM_HEADS}")
    if hidden % num_heads:
        raise ValueError(f"num_heads {num_heads} does not divide "
                         f"hidden {hidden}")
    return TransformerConfig(
        vocab_size=vocab, num_layers=layers, hidden=hidden,
        num_heads=num_heads, mlp_ratio=mlp_ratio, max_len=max_len,
        causal=True)


def prepare_params(params, cfg: TransformerConfig) -> dict[str, torch.Tensor]:
    """params with every dense weight and bias (and the LM head) cast to
    cfg.dtype once; embeddings and LayerNorm parameters stay f32. The
    decode functions give the same bits on either dict."""
    out = {}
    for name, t in params.items():
        dense = name == "lm_head.weight" or any(
            name.endswith(f".{d}.weight") or name.endswith(f".{d}.bias") for d in _DENSE)
        out[name] = t.to(cfg.dtype) if dense else t
    return out


def init_kv_cache(cfg: TransformerConfig, slots: int, max_len: int,
                  device: torch.device | str = "cuda"):
    """Zeroed (k, v) cache: [layers, slots, heads, max_len, head_dim]."""
    shape = (cfg.num_layers, slots, cfg.num_heads, max_len, cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


def _dense(params, name: str, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    y = torch.matmul(x, params[f"{name}.weight"].to(dtype).t())
    bias = params.get(f"{name}.bias")
    return y if bias is None else y + bias.to(dtype)


def _layernorm(params, name: str, x: torch.Tensor) -> torch.Tensor:
    """flax LayerNorm numerics: f32 statistics, eps 1e-6, f32 affine,
    result back in the compute dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + LN_EPS)
    return (y * params[f"{name}.weight"].float() + params[f"{name}.bias"].float()).to(x.dtype)


def score_scale(cfg: TransformerConfig, device) -> torch.Tensor:
    """sqrt(head_dim) computed in f32, rounded to the compute dtype, on
    `device` (a host copy: made once by a caller that captures a body)."""
    return torch.tensor(math.sqrt(cfg.head_dim), dtype=torch.float32).to(cfg.dtype).to(device)


def host_index(x, name: str) -> np.ndarray:
    """A host int64 array of an index argument (numpy, sequence or CPU
    tensor); a CUDA tensor is refused, since checking it would wait for
    the device."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"{name} must be a host array, got a {x.device} tensor")
        x = x.numpy()
    return np.asarray(x, dtype=np.int64)


def check_slot_ids(slot_ids, slots: int) -> np.ndarray:
    """The host part of a slot write: `slot_ids` as host int64, each in
    [0, slots), and none repeated but the scratch slot (the cache's last,
    slots - 1), because a repeated index has no defined write order on
    CUDA."""
    ids = host_index(slot_ids, "slot_ids")
    scratch = slots - 1
    if ids.size and (ids.min() < 0 or ids.max() > scratch):
        raise ValueError(f"slot ids {ids.tolist()} outside [0, {scratch}]")
    real = ids[ids != scratch]
    if len(np.unique(real)) != len(real):
        raise ValueError(f"slot ids {ids.tolist()} repeat a slot other than the "
                         f"scratch slot {scratch}")
    return ids


def check_positions(positions, max_len: int) -> np.ndarray:
    """The host part of a decode tick: `positions` as host int64, each in
    the cache's [0, max_len)."""
    pos = host_index(positions, "positions")
    if pos.size and (pos.min() < 0 or pos.max() >= max_len):
        raise ValueError(f"decode positions {pos.tolist()} outside the cache's "
                         f"[0, {max_len})")
    return pos


def last_index(lengths: torch.Tensor) -> torch.Tensor:
    """The position whose logits prefill returns for each row: its last
    real token, lengths - 1 (0 for an empty row)."""
    return (lengths - 1).clamp_min(0)


def visible_mask(positions: torch.Tensor, max_len: int) -> torch.Tensor:
    """[S, max_len]: the cached positions slot s attends to at a decode
    tick, those at or before the position it is fed at."""
    return torch.arange(max_len, device=positions.device)[None] <= positions[:, None]


def write_token_kv(cache: torch.Tensor, layer: int, positions: torch.Tensor,
                   kv: torch.Tensor) -> None:
    """cache[layer, s, :, positions[s], :] = kv[s] for every slot s, in
    place (kv [S, H, D]; the index's [S, H, D] shape is numpy's and JAX's)."""
    slots = torch.arange(kv.shape[0], device=cache.device)
    cache[layer, slots, :, positions, :] = kv


def prefill(params, tokens, lengths, cfg: TransformerConfig):
    """Full causal forward over prompt tokens, keeping per-layer K/V.

    tokens: [rows, T] int (zero-padded past each row's length); lengths:
    [rows] int, the true prompt length of each row. Host arrays or tensors;
    they are moved to the parameters' device.

    Returns (k [L, rows, H, T, D], v [...], next_tokens [rows] int32,
    last_logits [rows, vocab] f32): the K/V ready to write into cache
    slots, plus the greedy first generated token (the logits at each row's
    LAST real position). Padding rows and positions produce garbage K/V
    past `lengths`, which decode never reads: it masks by position, and
    slot reuse overwrites from 0."""
    device = params["trunk.embed.weight"].device
    return prefill_body(params, torch.as_tensor(tokens, device=device).long(),
                        torch.as_tensor(lengths, device=device).long(),
                        score_scale(cfg, device), cfg)


def prefill_body(params, tokens: torch.Tensor, lengths: torch.Tensor, scale: torch.Tensor,
                 cfg: TransformerConfig):
    """prefill's device body: tokens [rows, T] and lengths [rows] int64 and
    `scale` (score_scale) on the parameters' device."""
    dtype = cfg.dtype
    embed = params["trunk.embed.weight"]
    device = embed.device
    rows, t = tokens.shape
    x = F.embedding(tokens, embed).to(dtype)
    x = x + params["trunk.pos_embed.weight"][:t].to(dtype)[None]
    mask = torch.ones((t, t), dtype=torch.bool, device=device).tril()

    def heads(a):  # [B, T, H*D] -> [B, H, T, D]
        return a.view(rows, t, cfg.num_heads, cfg.head_dim).transpose(1, 2)

    ks, vs = [], []
    for i in range(cfg.num_layers):
        pre = f"trunk.layers.{i}."
        h = _layernorm(params, pre + "ln1", x)
        q = heads(_dense(params, pre + "attn.query", h, dtype))
        k = heads(_dense(params, pre + "attn.key", h, dtype))
        v = heads(_dense(params, pre + "attn.value", h, dtype))
        ks.append(k)
        vs.append(v)
        s = torch.matmul(q, k.transpose(-1, -2)) / scale
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s.float(), dim=-1).to(dtype)
        o = torch.matmul(p, v).transpose(1, 2).reshape(x.shape)
        x = x + _dense(params, pre + "attn.attn_out", o, dtype)
        h = _dense(params, pre + "mlp_in", _layernorm(params, pre + "ln2", x), dtype)
        x = x + _dense(params, pre + "mlp_out", F.gelu(h, approximate="tanh"), dtype)
    x = _layernorm(params, "trunk.ln_f", x)
    last = x[torch.arange(rows, device=device), last_index(lengths)]
    logits = torch.matmul(last, params["lm_head.weight"].to(dtype).t()).float()
    return (torch.stack(ks), torch.stack(vs),
            torch.argmax(logits, dim=-1).to(torch.int32), logits)


def write_slots(k_cache, v_cache, k_chunk, v_chunk, slot_ids):
    """Write a prefill chunk's K/V ([L, rows, H, T, D]) into cache slots
    `slot_ids` ([rows], host ints) at token positions [0, T), in place.
    The scheduler pads short chunks by repeating its scratch slot (the
    cache's last): only that slot may repeat (check_slot_ids)."""
    ids = check_slot_ids(slot_ids, k_cache.shape[1])
    write_slots_body(k_cache, v_cache, k_chunk, v_chunk,
                     torch.as_tensor(ids, device=k_cache.device))
    return k_cache, v_cache


def write_slots_body(k_cache, v_cache, k_chunk, v_chunk, idx: torch.Tensor) -> None:
    """write_slots' device body: `idx` the checked slot ids, int64 on the
    cache's device."""
    t = k_chunk.shape[3]
    k_cache[:, idx, :, :t, :] = k_chunk
    v_cache[:, idx, :, :t, :] = v_chunk


def prefill_into_slots(params, k_cache, v_cache, tokens, lengths, slot_ids,
                       cfg: TransformerConfig):
    """Prefill + slot write: one call per admission chunk. Returns (k_cache,
    v_cache, next_tokens [rows] int32, last_logits [rows, vocab] f32)."""
    ids = check_slot_ids(slot_ids, k_cache.shape[1])
    device = params["trunk.embed.weight"].device
    next_tokens, logits = prefill_into_slots_body(
        params, k_cache, v_cache, torch.as_tensor(tokens, device=device).long(),
        torch.as_tensor(lengths, device=device).long(), torch.as_tensor(ids, device=device),
        score_scale(cfg, device), cfg)
    return k_cache, v_cache, next_tokens, logits


def prefill_into_slots_body(params, k_cache, v_cache, tokens: torch.Tensor,
                            lengths: torch.Tensor, idx: torch.Tensor, scale: torch.Tensor,
                            cfg: TransformerConfig):
    """prefill_into_slots' device body over checked int64 device inputs:
    the caches updated in place; returns (next_tokens, last_logits)."""
    k_chunk, v_chunk, next_tokens, logits = prefill_body(params, tokens, lengths, scale, cfg)
    write_slots_body(k_cache, v_cache, k_chunk, v_chunk, idx)
    return next_tokens, logits


def decode_step(params, k_cache, v_cache, tokens, positions, cfg: TransformerConfig):
    """One decode tick over every cache slot.

    tokens: [slots] ints, the token FED to each slot this tick (its K/V
    lands at `positions`); positions: [slots] host ints, absolute positions
    in [0, max_len). Attention for slot s covers cached positions <=
    positions[s], so an inactive slot's stale state is never read once the
    scheduler re-prefills on reuse.

    Returns (k_cache, v_cache, next_tokens [slots] int32, logits [slots,
    vocab] f32); the caches are the ones given, updated in place."""
    pos = check_positions(positions, k_cache.shape[3])
    device = params["trunk.embed.weight"].device
    next_tokens, logits = decode_step_body(
        params, k_cache, v_cache, torch.as_tensor(tokens, device=device).long(),
        torch.as_tensor(pos, device=device), score_scale(cfg, device), cfg)
    return k_cache, v_cache, next_tokens, logits


def decode_step_body(params, k_cache, v_cache, tokens: torch.Tensor, positions: torch.Tensor,
                     scale: torch.Tensor, cfg: TransformerConfig):
    """decode_step's device body over int64 device tokens and checked
    positions: the caches updated in place; returns (next_tokens, logits)."""
    dtype = cfg.dtype
    max_len = k_cache.shape[3]
    slots = tokens.shape[0]
    x = F.embedding(tokens, params["trunk.embed.weight"]).to(dtype)
    x = x + F.embedding(positions, params["trunk.pos_embed.weight"]).to(dtype)  # [S, H*D]
    visible = visible_mask(positions, max_len)  # [S, ML]

    def heads(a):  # [S, hidden] -> [S, H, D]
        return a.view(slots, cfg.num_heads, cfg.head_dim)

    for i in range(cfg.num_layers):
        pre = f"trunk.layers.{i}."
        h = _layernorm(params, pre + "ln1", x)
        q = heads(_dense(params, pre + "attn.query", h, dtype))
        write_token_kv(k_cache, i, positions, heads(_dense(params, pre + "attn.key", h, dtype)))
        write_token_kv(v_cache, i, positions, heads(_dense(params, pre + "attn.value", h, dtype)))
        k_l, v_l = k_cache[i], v_cache[i]  # [S, H, ML, D]
        s = torch.matmul(k_l, q[..., None])[..., 0] / scale  # [S, H, ML]
        s = torch.where(visible[:, None, :], s, NEG_INF)
        p = torch.softmax(s.float(), dim=-1).to(dtype)
        o = torch.matmul(p[:, :, None, :], v_l)[:, :, 0].reshape(slots, cfg.hidden)
        x = x + _dense(params, pre + "attn.attn_out", o, dtype)
        h = _dense(params, pre + "mlp_in", _layernorm(params, pre + "ln2", x), dtype)
        x = x + _dense(params, pre + "mlp_out", F.gelu(h, approximate="tanh"), dtype)
    x = _layernorm(params, "trunk.ln_f", x)
    logits = torch.matmul(x, params["lm_head.weight"].to(dtype).t()).float()
    return torch.argmax(logits, dim=-1).to(torch.int32), logits
