"""Flash attention: hand-written Hopper kernels and their plain versions.

Counterpart of ``tf_operator_tpu/ops/flash_attention.py``. Three CUDA
kernels in ``csrc/flash_attention.cu`` replace the three Pallas kernels:

  forward   ``_fwd_kernel``      -> ``flash_fwd``       (LAUNCHES["fwd"])
  dQ        ``_bwd_dq_kernel``   -> ``flash_bwd_dq``    (LAUNCHES["bwd_dq"])
  dK/dV     ``_bwd_dkv_kernel``  -> ``flash_bwd_dkv``   (LAUNCHES["bwd_dkv"])

and a fourth, ``bwd_delta`` (LAUNCHES["bwd_delta"]), computes the backward's
delta = rowsum(dO o O) - g_lse once for both backward kernels, which the
Pallas kernels computed in-block. In bf16 the forward and backward kernels
run their products on the tensor cores (wgmma fed by TMA); in f32 on FMA
units.

Each wrapper takes ``[BH, T, D]`` operands (batch*heads flattened) and lse
as ``[BH, T]`` f32; the TPU's ``[BH, T, 128]`` lane-broadcast lse layout was
a Mosaic workaround, not part of the semantics. On a CUDA tensor a wrapper
launches its kernel or raises; on a CPU tensor it runs the plain PyTorch
version (``flash_fwd_plain`` / ``flash_bwd_plain``), written from the FA-2
equations rather than through autograd, with the kernels' rounding points:
P is rounded to the input dtype before P.V, dS before dS.K and dS^T.Q.

``FlashAttention`` and ``FlashAttentionWithLse`` are the autograd bindings
(counterparts of ``flash_attention_pallas`` and ``flash_attention_with_lse``)
over ``[B, H, T, D]`` inputs.
"""

from __future__ import annotations

import ctypes
import math

import torch

# Fully-masked sentinel, as in the JAX package: an lse of NEG_INF marks a row
# with no visible key, and the kernels guard p = 0, alpha = 0 and o = 0 on it.
NEG_INF = -1e30

SUPPORTED_HEAD_DIMS = (64, 128)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Launch counts of each kernel, incremented where the wrapper launches it.
LAUNCHES = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0, "bwd_delta": 0}

_lib_handle = None


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        from tf_operator_tpu_torch.ops import _build

        lib = _build.load("flash_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.tfo_flash_fwd.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
        lib.tfo_flash_bwd_delta.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
        lib.tfo_flash_bwd_dq.argtypes = [ptr] * 7 + [i32] * 6 + [ptr]
        lib.tfo_flash_bwd_dkv.argtypes = [ptr] * 8 + [i32] * 6 + [ptr]
        for fn in (lib.tfo_flash_fwd, lib.tfo_flash_bwd_delta,
                   lib.tfo_flash_bwd_dq, lib.tfo_flash_bwd_dkv):
            fn.restype = i32
        _lib_handle = lib
    return _lib_handle


def sm_scale(d: int) -> float:
    """1/sqrt(D), rounded to f32 as the kernels use it."""
    return float(torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _scores(q, k, causal: bool) -> torch.Tensor:
    """S = scale * Q K^T in f32 with invalid (q, k) pairs set to NEG_INF;
    causal keeps k_pos <= q_pos, as the kernels index it."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale(q.shape[-1])
    if causal:
        tq, tk = q.shape[-2], k.shape[-2]
        q_pos = torch.arange(tq, device=q.device)[:, None]
        k_pos = torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(q_pos < k_pos, NEG_INF)
    return s


def flash_fwd_plain(q, k, v, causal: bool = False):
    """(o [BH, T, D] in q.dtype, lse [BH, T] f32) from the softmax
    equations; a row with no visible key gives o = 0 and lse = NEG_INF."""
    s = _scores(q, k, causal)
    if s.shape[-1]:
        m = s.amax(-1, keepdim=True)
    else:  # no keys at all
        m = s.new_full((*s.shape[:-1], 1), NEG_INF)
    p = torch.where(m == NEG_INF, 0.0, torch.exp(s - m))
    l = p.sum(-1)
    empty = l == 0
    safe_l = torch.where(empty, 1.0, l)
    lse = torch.where(empty, NEG_INF, m[..., 0] + torch.log(safe_l))
    acc = torch.matmul(p.to(q.dtype).float(), v.float())
    return (acc / safe_l[..., None]).to(q.dtype), lse


def _bwd_delta_plain(o, do, g_lse=None):
    """delta = rowsum(dO o O) - g_lse, [BH, T] f32 (FA-2 eq. 13 plus the
    lse cotangent)."""
    delta = (do.float() * o.float()).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta


def _bwd_p_ds(q, k, v, o, lse, do, causal, g_lse, delta=None):
    """P rebuilt from lse and dS = P o (dO V^T - delta) * scale; delta,
    when not given, from _bwd_delta_plain."""
    s = _scores(q, k, causal)
    lse = lse.float()[..., None]
    p = torch.where(lse <= NEG_INF, 0.0, torch.exp(s - lse))
    if delta is None:
        delta = _bwd_delta_plain(o, do, g_lse)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None]) * sm_scale(q.shape[-1])


def _bwd_dq_plain(q, k, v, o, lse, do, causal, g_lse=None, delta=None):
    _, ds = _bwd_p_ds(q, k, v, o, lse, do, causal, g_lse, delta)
    return torch.matmul(ds.to(q.dtype).float(), k.float()).to(q.dtype)


def _bwd_dkv_plain(q, k, v, o, lse, do, causal, g_lse=None, delta=None):
    p, ds = _bwd_p_ds(q, k, v, o, lse, do, causal, g_lse, delta)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    # dV takes the unrounded P against dO upcast to f32, as the TPU kernel.
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_plain(q, k, v, o, lse, do, causal: bool = False, g_lse=None):
    """(dq, dk, dv) from the FA-2 backward equations."""
    dq = _bwd_dq_plain(q, k, v, o, lse, do, causal, g_lse)
    dk, dv = _bwd_dkv_plain(q, k, v, o, lse, do, causal, g_lse)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda(q, k, v, *rest_bhtd, rows=()) -> None:
    """Raise ValueError unless the operands are what the kernels take:
    contiguous 16-byte-aligned [BH, T, D] tensors of one supported dtype on
    one CUDA device, D in SUPPORTED_HEAD_DIMS; `rows` are [BH, T] f32."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash kernels take [BH, T, D] operands")
    bh, t, d = q.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash kernels take head_dim in {SUPPORTED_HEAD_DIMS}, got {d}")
    if q.dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"flash kernels take f32 or bf16, got {q.dtype}")
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if bh > 65535:  # the kernels' grid y dimension
        raise ValueError(f"flash kernels take at most 65535 batch*heads, got {bh}")
    for x in (q, k, v, *rest_bhtd):
        if x.dtype != q.dtype:
            raise ValueError(f"mixed dtypes {x.dtype} and {q.dtype}")
    for x in rest_bhtd:
        if x.shape != q.shape:
            raise ValueError(f"operand shape {tuple(x.shape)} != q {tuple(q.shape)}")
    for x in rows:
        if x.dtype != torch.float32 or x.shape != (bh, t):
            raise ValueError(f"lse operands are [BH, T] f32, got {x.dtype} {tuple(x.shape)}")
    for x in (q, k, v, *rest_bhtd, *rows):
        if x.device != q.device or x.device.type != "cuda":
            raise ValueError("flash kernel operands must share one CUDA device")
        if not x.is_contiguous():
            raise ValueError("flash kernel operands must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError("flash kernel operands must be 16-byte aligned")


def _stream(x) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _ptr(x) -> ctypes.c_void_p | None:
    return None if x is None else ctypes.c_void_p(x.data_ptr())


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"flash {name} kernel launch failed: error {err} (a cudaError, or "
            "1000 + the CUresult of a refused cuTensorMapEncodeTiled)")


def flash_fwd(q, k, v, causal: bool = False, save_lse: bool = True):
    """K1 on [BH, T, D]: (o, lse [BH, T] f32) — lse is None when
    save_lse=False (the primal skips its writes)."""
    if q.device.type == "cpu":
        o, lse = flash_fwd_plain(q, k, v, causal)
        return o, (lse if save_lse else None)
    _check_cuda(q, k, v)
    bh, t, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device) if save_lse else None
    if t == 0:
        return o, lse
    with torch.cuda.device(q.device):
        err = _lib().tfo_flash_fwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(lse), bh, t, k.shape[1],
            d, _DTYPE_CODE[q.dtype], int(causal), _stream(q))
    _raise_on(err, "fwd")
    LAUNCHES["fwd"] += 1
    return o, lse


def bwd_delta(o, do, g_lse=None):
    """delta = rowsum(dO o O) - g_lse on [BH, T, D] operands: [BH, T] f32.
    A helper of K2 and K3 (one launch for both), not a TPU kernel's port."""
    if o.device.type == "cpu":
        return _bwd_delta_plain(o, do, g_lse)
    _check_cuda(o, o, o, do, rows=() if g_lse is None else (g_lse,))
    bh, t, d = o.shape
    delta = torch.empty((bh, t), dtype=torch.float32, device=o.device)
    if t == 0:
        return delta
    with torch.cuda.device(o.device):
        err = _lib().tfo_flash_bwd_delta(
            _ptr(o), _ptr(do), _ptr(g_lse), _ptr(delta), bh * t, d,
            _DTYPE_CODE[o.dtype], _stream(o))
    _raise_on(err, "bwd_delta")
    LAUNCHES["bwd_delta"] += 1
    return delta


def flash_bwd_dq(q, k, v, o, lse, do, causal: bool = False, g_lse=None, delta=None):
    """K2 on [BH, T, D]: dq. delta, when given, is bwd_delta(o, do, g_lse)
    (g_lse is then not read); without it the wrapper runs that pass."""
    if q.device.type == "cpu":
        return _bwd_dq_plain(q, k, v, o, lse, do, causal, g_lse, delta)
    if delta is None:
        delta = bwd_delta(o, do, g_lse)
    _check_cuda(q, k, v, do, rows=(lse, delta))
    bh, t, d = q.shape
    dq = torch.empty_like(q)
    if t == 0:
        return dq
    with torch.cuda.device(q.device):
        err = _lib().tfo_flash_bwd_dq(
            _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
            _ptr(dq), bh, t, k.shape[1], d, _DTYPE_CODE[q.dtype], int(causal),
            _stream(q))
    _raise_on(err, "bwd_dq")
    LAUNCHES["bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, o, lse, do, causal: bool = False, g_lse=None, delta=None):
    """K3 on [BH, T, D]: (dk, dv). delta as for flash_bwd_dq."""
    if q.device.type == "cpu":
        return _bwd_dkv_plain(q, k, v, o, lse, do, causal, g_lse, delta)
    if delta is None:
        delta = bwd_delta(o, do, g_lse)
    _check_cuda(q, k, v, do, rows=(lse, delta))
    bh, t, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if k.shape[1] == 0:
        return dk, dv
    with torch.cuda.device(q.device):
        err = _lib().tfo_flash_bwd_dkv(
            _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
            _ptr(dk), _ptr(dv), bh, t, k.shape[1], d, _DTYPE_CODE[q.dtype],
            int(causal), _stream(q))
    _raise_on(err, "bwd_dkv")
    LAUNCHES["bwd_dkv"] += 1
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, causal: bool = False, g_lse=None):
    """(dq, dk, dv): the delta pass, then K2 and K3, on CUDA; the plain
    backward on CPU."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, causal, g_lse)
    delta = bwd_delta(o, do, g_lse)
    dq = flash_bwd_dq(q, k, v, o, lse, do, causal, delta=delta)
    dk, dv = flash_bwd_dkv(q, k, v, o, lse, do, causal, delta=delta)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Autograd bindings over [B, H, T, D]
# ---------------------------------------------------------------------------

def _flat(x: torch.Tensor) -> torch.Tensor:
    b, h, t, d = x.shape
    return x.reshape(b * h, t, d).contiguous()


class FlashAttention(torch.autograd.Function):
    """softmax(Q K^T / sqrt(D)) V over [B, H, T, D]. Without grad the
    forward skips the lse; with grad it saves (q, k, v, o, lse) flattened
    and the backward runs K2 and K3."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = False):
        b, h, t, d = q.shape
        qf, kf, vf = _flat(q), _flat(k), _flat(v)
        need_grad = any(ctx.needs_input_grad[:3])
        o, lse = flash_fwd(qf, kf, vf, causal, save_lse=need_grad)
        if need_grad:
            ctx.save_for_backward(qf, kf, vf, o, lse)
        ctx.causal = causal
        ctx.bh = (b, h)
        return o.view(b, h, t, d)

    @staticmethod
    def backward(ctx, g):
        qf, kf, vf, o, lse = ctx.saved_tensors
        b, h = ctx.bh
        dq, dk, dv = flash_bwd(qf, kf, vf, o, lse, _flat(g), ctx.causal)
        return (dq.view(b, h, *dq.shape[1:]), dk.view(b, h, *dk.shape[1:]),
                dv.view(b, h, *dv.shape[1:]), None)


class FlashAttentionWithLse(torch.autograd.Function):
    """(o [B, H, T, D], lse [B, H, T] f32). The lse output is
    differentiable: its cotangent enters both backward kernels as
    delta - g_lse (the dlse/dS = P term)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = False):
        b, h, t, d = q.shape
        qf, kf, vf = _flat(q), _flat(k), _flat(v)
        o, lse = flash_fwd(qf, kf, vf, causal, save_lse=True)
        ctx.save_for_backward(qf, kf, vf, o, lse)
        ctx.causal = causal
        ctx.bh = (b, h)
        return o.view(b, h, t, d), lse.view(b, h, t)

    @staticmethod
    def backward(ctx, g_o, g_lse):
        qf, kf, vf, o, lse = ctx.saved_tensors
        b, h = ctx.bh
        g_o = torch.zeros_like(o) if g_o is None else _flat(g_o)
        if g_lse is not None:
            g_lse = g_lse.reshape(b * h, -1).float().contiguous()
        dq, dk, dv = flash_bwd(qf, kf, vf, o, lse, g_o, ctx.causal, g_lse)
        return (dq.view(b, h, *dq.shape[1:]), dk.view(b, h, *dk.shape[1:]),
                dv.view(b, h, *dv.shape[1:]), None)
