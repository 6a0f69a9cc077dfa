"""Attention entry point: the hand-written flash kernels, everywhere.

Counterpart of ``tf_operator_tpu/ops/attention.py``. On CUDA
``flash_attention`` always runs the Hopper kernels through
``FlashAttention``; the TPU's eligibility thresholds (T >= 1024, T % 128,
d % 64) were measured on a v5e and are not carried over. A shape the
kernels do not take raises ``ValueError`` instead of quietly taking the
reference. On CPU the same binding runs the kernels' plain versions, which
take any shape.
"""

from __future__ import annotations

import torch

from tf_operator_tpu_torch.ops.flash_attention import FlashAttention


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """[B, H, T, D] attention through the flash kernels (whose wrappers
    raise ValueError on CUDA operands they do not take)."""
    if q.dim() != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2]:
        raise ValueError(
            f"flash_attention takes [B, H, T, D] q/k/v, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    return FlashAttention.apply(q, k, v, causal)
