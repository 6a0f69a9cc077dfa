"""Float8 rounding for the control: the reference computed one precision
below the configurations' bfloat16.

Each operand is scaled per tensor so that its largest magnitude meets the
format's largest finite value, rounded to the format and scaled back, as a
float8 training recipe does before each product (e4m3 for weights and
activations, e5m2 for the gradients flowing back). The products themselves
then run in float32 on the rounded values.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = top / amax
    return (x.detach() * scale).to(dtype).to(x.dtype) / scale


class _RoundE4M3(torch.autograd.Function):
    """Round to e4m3 going forward; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    return _RoundE4M3.apply(x)


class _Fp8Linear(torch.autograd.Function):
    """y = x w^T (+ b) on e4m3-rounded x and w; the backward's products on
    the e5m2-rounded output gradient and the rounded operands."""

    @staticmethod
    def forward(ctx, x, w, b):
        xq = _round(x, torch.float8_e4m3fn, E4M3_MAX)
        wq = _round(w, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(xq, wq)
        ctx.has_bias = b is not None
        y = torch.matmul(xq, wq.t())
        return y if b is None else y + b

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        gq = _round(gy, torch.float8_e5m2, E5M2_MAX)
        gx = torch.matmul(gq, wq)
        gw = torch.matmul(gq.reshape(-1, gq.shape[-1]).t(), xq.reshape(-1, xq.shape[-1]))
        gb = gy.reshape(-1, gy.shape[-1]).sum(0) if ctx.has_bias else None
        return gx, gw, gb


def fp8_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    return _Fp8Linear.apply(x, w, b)
