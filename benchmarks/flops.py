"""The yardstick's arithmetic: published H100 peaks, model FLOPs of a
training step, and the least work of each kernel group, from shapes alone.

Frozen copies of the port's own measurement arithmetic (``chip_smoke.py``:
``bound``, ``bert_flops_per_step``), kept here so that a change to the
program cannot move the yardstick; each family's reference module gives its
step's FLOPs (``step_flops``) from them. Nothing here imports the program or
torch.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the 700 W limit.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
ITEM_BYTES = {"bfloat16": 2, "float32": 4}


def bert_flops_per_step(batch: int, seq: int, layers: int = 12, hidden: int = 768,
                        vocab: int = 30522, mlp_ratio: int = 4) -> float:
    """Model FLOPs of one BERT MLM training step: 6 x the dense weights per
    token (each layer's 4 h^2 + 2 mlp h^2, the MLM transform's h^2 and the
    h x vocab decoder over every position) plus full attention's QK^T and
    PV, 12 x layers x T x h per token for forward and backward."""
    dense = layers * (4 + 2 * mlp_ratio) * hidden * hidden + hidden * hidden + hidden * vocab
    return batch * seq * (6.0 * dense + 12.0 * layers * seq * hidden)


def bound(shape, dtype: str, causal: bool, n_matmuls: int, n_in: int, n_out: int,
          lse_arrays: int) -> tuple[float, str]:
    """(bound_ms, bound_by) of one attention call on [B, H, T, D]: the larger
    of the FLOP time of its n_matmuls products over the visible (q, k) pairs
    at the dtype's dense peak, and the time to read n_in and write n_out
    [B, H, T, D] arrays plus lse_arrays [B, H, T] f32 arrays at the HBM rate."""
    b, h, t, d = shape
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    flops = n_matmuls * 2.0 * pairs * d
    nbytes = (n_in + n_out) * b * h * t * d * ITEM_BYTES[dtype] + lse_arrays * b * h * t * 4
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _attention_shape(shape: dict) -> tuple[int, int, int, int]:
    heads = shape["heads"]
    return shape["batch"], heads, shape["seq"], shape["hidden"] // heads


def attention_fwd(shape: dict) -> tuple[float, str]:
    """(ms, bound_by) a step of the flash forward: Q.K^T and P.V over the
    visible pairs; q, k, v read and o and lse written once; every layer."""
    ms, by = bound(_attention_shape(shape), shape["dtype"], shape["causal"], n_matmuls=2,
                   n_in=3, n_out=1, lse_arrays=1)
    return ms * shape["layers"], by


def attention_bwd(shape: dict) -> tuple[float, str]:
    """(ms, bound_by) a step of the flash backward as one pass: S recomputed
    once, dP, dV, dQ and dK (five products); q, k, v, o, dO and lse read and
    dq, dk, dv written once each, whatever the kernels read again."""
    ms, by = bound(_attention_shape(shape), shape["dtype"], shape["causal"], n_matmuls=5,
                   n_in=5, n_out=3, lse_arrays=1)
    return ms * shape["layers"], by


WORK = {"attention_fwd": attention_fwd, "attention_bwd": attention_bwd}
