"""Attention for model code: the plain reference and the attention factory.

Counterpart of the single-device part of
``tf_operator_tpu/parallel/ring_attention.py``. Ring attention and Ulysses
over a sequence-parallel axis are not ported yet: asking for one raises.
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import torch

from tf_operator_tpu_torch.ops.flash_attention import NEG_INF


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


def make_attention_fn(sp: int = 1, causal: bool = False) -> Callable:
    """Attention callable for model code. One device (sp == 1): the flash
    kernels through ops.attention.flash_attention."""
    if sp > 1:
        raise NotImplementedError(
            "sequence-parallel attention (ring / Ulysses) is not ported to "
            "the PyTorch package yet")
    from tf_operator_tpu_torch.ops.attention import flash_attention

    return functools.partial(flash_attention, causal=causal)
