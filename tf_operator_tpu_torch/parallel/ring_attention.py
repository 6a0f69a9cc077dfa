"""Attention for model code: the plain reference, ring attention over the
sequence-parallel axis, and the attention factory.

Counterpart of ``tf_operator_tpu/parallel/ring_attention.py``. Sequences
are sharded over the `sp` mesh axis: each rank holds a [B, H, T/n, D]
block of Q, K and V, K and V rotate around the ring (collectives.rotate,
JAX's ppermute), and each rank folds the incoming blocks into its result
with the exact logsumexp merge (`merge_partials`). Blocks are whole T/n
slabs, so causal masking has three cases: the diagonal (the rank's own
block, computed first with causal=True), fully visible (the block of an
earlier rank) and fully masked (a later rank's: computed, then given an
lse of NEG_INF and zeros, as the JAX body does, so every rank runs the
same kernels and collectives in the same order). Every block has Tq == Tk,
so the kernels' start-aligned causal rule and `attention_reference`'s
end-aligned one agree on it.

The block primitive (`resolve_block_impl`): on a CUDA tensor always the
flash kernels through ``FlashAttentionWithLse`` (its lse output is
differentiable, so the merge's lse cotangent reaches the backward kernels
as delta - g_lse); on CPU tensors the plain `_block_norm_naive` unless
TPUJOB_RING_BLOCK asks for the kernels' plain versions ("flash").

Autograd composes the body (JAX's scan AD does the same): each step's
rotated K/V and its (o, lse) are kept for the backward, O(T) K/V a rank.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Callable

import torch

from tf_operator_tpu_torch.ops.flash_attention import NEG_INF
from tf_operator_tpu_torch.parallel import collectives


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """Plain softmax(QK^T/sqrt(d))V on one device, [B, H, T, D]: QK^T in
    the input dtype, the softmax in f32, P cast back before P.V."""
    d = q.shape[-1]
    scale = torch.tensor(math.sqrt(d), dtype=torch.float32).to(q.dtype)
    s = torch.matmul(q, k.transpose(-1, -2)) / scale.to(q.device)
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril(tk - tq)
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.matmul(p, v)


def _block_attn(q, k, v, causal: bool, sm_scale: float):
    """Unnormalised block attention with running-max statistics, local
    indices: (o [B, H, Tq, D] f32, m [B, H, Tq] f32, l [B, H, Tq] f32)."""
    s = torch.matmul(q, k.transpose(-1, -2)).float() * sm_scale
    if causal:
        q_pos = torch.arange(q.shape[-2], device=q.device)
        k_pos = torch.arange(k.shape[-2], device=q.device)
        s = s.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    # Fully-masked rows: exp(NEG_INF - NEG_INF) = 1 would poison l; zero them.
    p = torch.where((m == NEG_INF)[..., None], 0.0, p)
    l = p.sum(-1)
    o = torch.matmul(p, v.float())
    return o, m, l


def _block_norm_naive(q, k, v, causal: bool, sm_scale: float):
    """Normalised (o f32, lse f32) of one whole block pair (plain torch)."""
    o, m, l = _block_attn(q, k, v, causal, sm_scale)
    empty = l == 0.0
    safe = torch.where(empty, 1.0, l)
    lse = torch.where(empty, NEG_INF, m + torch.log(safe))
    return o / safe[..., None], lse


def merge_partials(o1, lse1, o2, lse2):
    """Exact logsumexp merge of two normalised partial attention results.
    lse == NEG_INF marks an empty (fully-masked) partial."""
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(m <= NEG_INF, 0.0, m)
    w1 = torch.where(lse1 <= NEG_INF, 0.0, torch.exp(lse1 - m_safe))
    w2 = torch.where(lse2 <= NEG_INF, 0.0, torch.exp(lse2 - m_safe))
    denom = w1 + w2
    denom_safe = torch.where(denom == 0.0, 1.0, denom)
    o = (o1 * w1[..., None] + o2 * w2[..., None]) / denom_safe[..., None]
    lse = torch.where(denom == 0.0, NEG_INF, m_safe + torch.log(denom_safe))
    return o, lse


def _block_flash(q, k, v, causal: bool):
    """(o f32, lse) of one block pair through the flash kernels."""
    from tf_operator_tpu_torch.ops.flash_attention import FlashAttentionWithLse

    if q.shape[-2] != k.shape[-2]:
        raise ValueError(f"ring blocks have Tq == Tk, got {q.shape[-2]} and {k.shape[-2]}")
    o, lse = FlashAttentionWithLse.apply(q, k, v, causal)
    return o.float(), lse


def block_visible(src: int, my: int) -> bool:
    """Whether the block of rank `src` is visible to rank `my` under causal
    masking (whole blocks; the diagonal is computed apart)."""
    return src < my


def _ring_attention_sharded(q, k, v, group, n: int, my: int, causal: bool,
                            block_impl: str = "naive") -> torch.Tensor:
    """This rank's body: q, k, v are its [B, H, T_local, D] shards; n ring
    ranks, this one at position `my`. Folds n partial results, one a K/V
    block, with merge_partials."""
    sm_scale = 1.0 / (q.shape[-1] ** 0.5)

    def block_fn(k_blk, v_blk, blk_causal: bool):
        if block_impl == "flash":
            return _block_flash(q, k_blk, v_blk, blk_causal)
        return _block_norm_naive(q, k_blk, v_blk, blk_causal, sm_scale)

    # The diagonal block (the only one masked inside).
    o, lse = block_fn(k, v, causal)
    if n == 1:
        return o.to(q.dtype)
    k_cur, v_cur = collectives.rotate(k, v, group)
    for i in range(1, n):
        src = (my - i) % n  # whose K/V block this rank holds at step i
        ob, lseb = block_fn(k_cur, v_cur, False)
        if causal:
            # A fill on the device, not a copy from the host: the step may
            # be under a CUDA graph's capture.
            visible = torch.full((), block_visible(src, my), device=q.device)
            lseb = torch.where(visible, lseb, NEG_INF)
            ob = torch.where(visible, ob, 0.0)
        o, lse = merge_partials(o, lse, ob, lseb)
        # The last step's rotation would never be read: every rank skips it.
        if i < n - 1:
            k_cur, v_cur = collectives.rotate(k_cur, v_cur, group)
    return o.to(q.dtype)


def resolve_block_impl(block_impl: str | None, device: torch.device) -> str:
    """The block primitive: an explicit argument beats TPUJOB_RING_BLOCK
    beats "auto". On a CUDA tensor it is the flash kernels ("auto" and
    "flash"; "naive" raises rather than run the plain block on the card);
    on CPU tensors "auto" is the plain block, as off a TPU in the JAX
    package. Unknown values raise with the JAX message."""
    impl = block_impl or os.environ.get("TPUJOB_RING_BLOCK", "auto") or "auto"
    impl = impl.strip().lower()
    if impl not in ("auto", "naive", "flash"):
        raise ValueError(
            f"unknown ring block impl {impl!r} (TPUJOB_RING_BLOCK / "
            f"block_impl): expected 'auto', 'naive' or 'flash'")
    if torch.device(device).type == "cuda":
        if impl == "naive":
            raise ValueError("ring block impl 'naive' runs the plain block, which the port "
                             "does not run on a CUDA tensor: use 'auto' or 'flash'")
        return "flash"
    return "naive" if impl == "auto" else impl


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis_name: str = "sp", causal: bool = False,
                   block_impl: str | None = None) -> torch.Tensor:
    """Exact attention over sequences sharded along `axis_name` of `mesh`
    (parallel.mesh.Mesh): q, k, v are this rank's [B, H_local, T/sp, D]
    shards (its rows, its tp heads, its sequence block); returns its
    output shard."""
    n = mesh.shape.get(axis_name, 1)
    impl = resolve_block_impl(block_impl, q.device)
    return _ring_attention_sharded(q, k, v, mesh.group(axis_name), n, mesh.coord(axis_name),
                                   causal, impl)


def make_attention_fn(mesh=None, causal: bool = False, axis_name: str = "sp") -> Callable:
    """Attention callable for model code. Over a mesh with sp > 1 the
    scheme is picked per call by parallel.ulysses.sp_mode (Ulysses when the
    heads divide by sp, ring otherwise; TPUJOB_SP_MODE overrides), on this
    rank's [B, H_local, T/sp, D] shards. Without sp, the flash kernels
    through ops.attention.flash_attention."""
    if mesh is not None and mesh.shape.get(axis_name, 1) > 1:
        from tf_operator_tpu_torch.parallel.ulysses import sp_mode, ulysses_attention

        sp, tp = mesh.shape[axis_name], mesh.shape.get("tp", 1)

        def sp_attn(q, k, v):
            # sp_mode reads the global head count and sequence length.
            if sp_mode(mesh, q.shape[1] * tp, axis_name, seq_len=q.shape[2] * sp) == "ulysses":
                return ulysses_attention(q, k, v, mesh=mesh, causal=causal, axis_name=axis_name)
            return ring_attention(q, k, v, mesh=mesh, causal=causal, axis_name=axis_name)

        return sp_attn
    from tf_operator_tpu_torch.ops.attention import flash_attention

    return functools.partial(flash_attention, causal=causal)
