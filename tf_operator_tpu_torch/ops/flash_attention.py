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

The kernels are built for head widths 64, 128 and 256
(``SUPPORTED_HEAD_DIMS``); the Pallas kernel took any multiple of 64 and
Mosaic padded the lane dimension. Here the wrappers zero-pad any other
width up to 256 to the next built one (``kernel_head_dim``), pass the
softmax scale of the unpadded width, and slice o, dq, dk and dv back:
zero columns change neither Q.K^T nor rowsum(dO o O), and come out as
zeros. A built width is passed through without a copy. Past 256 a CUDA
call raises ``ValueError``. The padding runs on either device, so the CPU
tests reach it.

``FlashAttention`` and ``FlashAttentionWithLse`` are the autograd bindings
(counterparts of ``flash_attention_pallas`` and ``flash_attention_with_lse``)
over ``[B, H, T, D]`` inputs; they pad once in the forward and keep the
padded operands for the backward.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

# Fully-masked sentinel, as in the JAX package: an lse of NEG_INF marks a row
# with no visible key, and the kernels guard p = 0, alpha = 0 and o = 0 on it.
NEG_INF = -1e30

# Head widths the kernels are built for; kernel_head_dim pads up to one.
SUPPORTED_HEAD_DIMS = (64, 128, 256)
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
        f32 = ctypes.c_float
        lib.tfo_flash_fwd.argtypes = [ptr] * 5 + [i32] * 6 + [f32, ptr]
        lib.tfo_flash_bwd_delta.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
        lib.tfo_flash_bwd_dq.argtypes = [ptr] * 7 + [i32] * 6 + [f32, ptr]
        lib.tfo_flash_bwd_dkv.argtypes = [ptr] * 8 + [i32] * 6 + [f32, ptr]
        for fn in (lib.tfo_flash_fwd, lib.tfo_flash_bwd_delta,
                   lib.tfo_flash_bwd_dq, lib.tfo_flash_bwd_dkv):
            fn.restype = i32
        _lib_handle = lib
    return _lib_handle


@functools.lru_cache(maxsize=None)
def sm_scale(d: int) -> float:
    """1/sqrt(D), rounded to f32 as the kernels use it (the wrappers pass
    it on every call: cached per width)."""
    return float(torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32))


def kernel_head_dim(d: int) -> int:
    """The built head width that a head of width d runs at: the smallest of
    SUPPORTED_HEAD_DIMS that is >= d. ValueError past the largest."""
    for width in SUPPORTED_HEAD_DIMS:
        if 1 <= d <= width:
            return width
    raise ValueError(f"flash kernels take head_dim 1..{SUPPORTED_HEAD_DIMS[-1]} "
                     f"(zero-padded to one of {SUPPORTED_HEAD_DIMS}), got {d}")


def pad_head(x: torch.Tensor, width: int) -> torch.Tensor:
    """x [..., D] with zero columns appended up to `width`; x itself when
    D == width (no copy)."""
    d = x.shape[-1]
    return x if d == width else F.pad(x, (0, width - d))


def unpad_head(x: torch.Tensor, d: int) -> torch.Tensor:
    """The first d columns of x, contiguous; x itself when it has d."""
    return x if x.shape[-1] == d else x[..., :d].contiguous()


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _scores(q, k, causal: bool, scale: float | None = None) -> torch.Tensor:
    """S = scale * Q K^T in f32 with invalid (q, k) pairs set to NEG_INF;
    causal keeps k_pos <= q_pos, as the kernels index it. scale defaults to
    sm_scale of q's width (a zero-padded q passes its unpadded width's)."""
    if scale is None:
        scale = sm_scale(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        tq, tk = q.shape[-2], k.shape[-2]
        q_pos = torch.arange(tq, device=q.device)[:, None]
        k_pos = torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(q_pos < k_pos, NEG_INF)
    return s


def flash_fwd_plain(q, k, v, causal: bool = False, scale: float | None = None):
    """(o [BH, T, D] in q.dtype, lse [BH, T] f32) from the softmax
    equations; a row with no visible key gives o = 0 and lse = NEG_INF."""
    s = _scores(q, k, causal, scale)
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


def _bwd_p_ds(q, k, v, o, lse, do, causal, g_lse, delta=None, scale=None):
    """P rebuilt from lse and dS = P o (dO V^T - delta) * scale; delta,
    when not given, from _bwd_delta_plain."""
    if scale is None:
        scale = sm_scale(q.shape[-1])
    s = _scores(q, k, causal, scale)
    lse = lse.float()[..., None]
    p = torch.where(lse <= NEG_INF, 0.0, torch.exp(s - lse))
    if delta is None:
        delta = _bwd_delta_plain(o, do, g_lse)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None]) * scale


def _bwd_dq_plain(q, k, v, o, lse, do, causal, g_lse=None, delta=None, scale=None):
    _, ds = _bwd_p_ds(q, k, v, o, lse, do, causal, g_lse, delta, scale)
    return torch.matmul(ds.to(q.dtype).float(), k.float()).to(q.dtype)


def _bwd_dkv_plain(q, k, v, o, lse, do, causal, g_lse=None, delta=None, scale=None):
    p, ds = _bwd_p_ds(q, k, v, o, lse, do, causal, g_lse, delta, scale)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    # dV takes the unrounded P against dO upcast to f32, as the TPU kernel.
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_plain(q, k, v, o, lse, do, causal: bool = False, g_lse=None, scale=None):
    """(dq, dk, dv) from the FA-2 backward equations."""
    dq = _bwd_dq_plain(q, k, v, o, lse, do, causal, g_lse, scale=scale)
    dk, dv = _bwd_dkv_plain(q, k, v, o, lse, do, causal, g_lse, scale=scale)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda(q, k, v, *rest_bhtd, rows=()) -> None:
    """Raise ValueError unless the operands are what the kernels take:
    contiguous 16-byte-aligned [BH, T, D] tensors of one supported dtype on
    one CUDA device, D in SUPPORTED_HEAD_DIMS (the wrappers pad to one);
    `rows` are [BH, T] f32."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash kernels take [BH, T, D] operands")
    bh, t, d = q.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash kernels take head_dim in {SUPPORTED_HEAD_DIMS} (a "
                         f"narrower one padded up to them), got {d}")
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


def _fwd_at(q, k, v, causal, save_lse, scale):
    """K1 on operands of a width the kernels take (or any on the CPU)."""
    if q.device.type == "cpu":
        o, lse = flash_fwd_plain(q, k, v, causal, scale)
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
            d, _DTYPE_CODE[q.dtype], int(causal), scale, _stream(q))
    _raise_on(err, "fwd")
    LAUNCHES["fwd"] += 1
    return o, lse


def _delta_at(o, do, g_lse):
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


def _dq_at(q, k, v, o, lse, do, causal, g_lse, delta, scale):
    if q.device.type == "cpu":
        return _bwd_dq_plain(q, k, v, o, lse, do, causal, g_lse, delta, scale)
    if delta is None:
        delta = _delta_at(o, do, g_lse)
    _check_cuda(q, k, v, do, rows=(lse, delta))
    bh, t, d = q.shape
    dq = torch.empty_like(q)
    if t == 0:
        return dq
    with torch.cuda.device(q.device):
        err = _lib().tfo_flash_bwd_dq(
            _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
            _ptr(dq), bh, t, k.shape[1], d, _DTYPE_CODE[q.dtype], int(causal),
            scale, _stream(q))
    _raise_on(err, "bwd_dq")
    LAUNCHES["bwd_dq"] += 1
    return dq


def _dkv_at(q, k, v, o, lse, do, causal, g_lse, delta, scale):
    if q.device.type == "cpu":
        return _bwd_dkv_plain(q, k, v, o, lse, do, causal, g_lse, delta, scale)
    if delta is None:
        delta = _delta_at(o, do, g_lse)
    _check_cuda(q, k, v, do, rows=(lse, delta))
    bh, t, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if k.shape[1] == 0:
        return dk, dv
    with torch.cuda.device(q.device):
        err = _lib().tfo_flash_bwd_dkv(
            _ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
            _ptr(dk), _ptr(dv), bh, t, k.shape[1], d, _DTYPE_CODE[q.dtype],
            int(causal), scale, _stream(q))
    _raise_on(err, "bwd_dkv")
    LAUNCHES["bwd_dkv"] += 1
    return dk, dv


def _bwd_at(q, k, v, o, lse, do, causal, g_lse, scale):
    """(dq, dk, dv): the delta pass, then K2 and K3, on CUDA; the plain
    backward on CPU."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, causal, g_lse, scale)
    delta = _delta_at(o, do, g_lse)
    dq = _dq_at(q, k, v, o, lse, do, causal, None, delta, scale)
    dk, dv = _dkv_at(q, k, v, o, lse, do, causal, None, delta, scale)
    return dq, dk, dv


def _padded(d, *xs):
    """xs zero-padded to kernel_head_dim(d); as they are past the largest
    built width (the plain versions take any width, a CUDA call then fails
    _check_cuda)."""
    width = kernel_head_dim(d) if 1 <= d <= SUPPORTED_HEAD_DIMS[-1] else d
    return [pad_head(x, width) for x in xs]


def flash_fwd(q, k, v, causal: bool = False, save_lse: bool = True):
    """K1 on [BH, T, D]: (o, lse [BH, T] f32) — lse is None when
    save_lse=False (the primal skips its writes)."""
    d = q.shape[-1]
    q, k, v = _padded(d, q, k, v)
    o, lse = _fwd_at(q, k, v, causal, save_lse, sm_scale(d))
    return unpad_head(o, d), lse


def bwd_delta(o, do, g_lse=None):
    """delta = rowsum(dO o O) - g_lse on [BH, T, D] operands: [BH, T] f32.
    A helper of K2 and K3 (one launch for both), not a TPU kernel's port."""
    o, do = _padded(o.shape[-1], o, do)
    return _delta_at(o, do, g_lse)


def flash_bwd_dq(q, k, v, o, lse, do, causal: bool = False, g_lse=None, delta=None):
    """K2 on [BH, T, D]: dq. delta, when given, is bwd_delta(o, do, g_lse)
    (g_lse is then not read); without it the wrapper runs that pass."""
    d = q.shape[-1]
    q, k, v, o, do = _padded(d, q, k, v, o, do)
    return unpad_head(_dq_at(q, k, v, o, lse, do, causal, g_lse, delta, sm_scale(d)), d)


def flash_bwd_dkv(q, k, v, o, lse, do, causal: bool = False, g_lse=None, delta=None):
    """K3 on [BH, T, D]: (dk, dv). delta as for flash_bwd_dq."""
    d = q.shape[-1]
    q, k, v, o, do = _padded(d, q, k, v, o, do)
    dk, dv = _dkv_at(q, k, v, o, lse, do, causal, g_lse, delta, sm_scale(d))
    return unpad_head(dk, d), unpad_head(dv, d)


def flash_bwd(q, k, v, o, lse, do, causal: bool = False, g_lse=None):
    """(dq, dk, dv): the delta pass, then K2 and K3, on CUDA; the plain
    backward on CPU."""
    d = q.shape[-1]
    q, k, v, o, do = _padded(d, q, k, v, o, do)
    grads = _bwd_at(q, k, v, o, lse, do, causal, g_lse, sm_scale(d))
    return tuple(unpad_head(g, d) for g in grads)


# ---------------------------------------------------------------------------
# Autograd bindings over [B, H, T, D]
# ---------------------------------------------------------------------------

def _flat(x: torch.Tensor) -> torch.Tensor:
    b, h, t, d = x.shape
    return x.reshape(b * h, t, d).contiguous()


def _binding_grads(ctx, qf, kf, vf, o, lse, g_o, g_lse):
    """The bindings' backward on their saved (padded) operands: (dq, dk,
    dv, None) as [B, H, T, D] at the caller's width."""
    b, h = ctx.bh
    g_o = torch.zeros_like(o) if g_o is None else pad_head(_flat(g_o), o.shape[-1])
    grads = _bwd_at(qf, kf, vf, o, lse, g_o, ctx.causal, g_lse, sm_scale(ctx.d))
    return tuple(unpad_head(g, ctx.d).view(b, h, *g.shape[1:-1], ctx.d)
                 for g in grads) + (None,)


class FlashAttention(torch.autograd.Function):
    """softmax(Q K^T / sqrt(D)) V over [B, H, T, D]. Without grad the
    forward skips the lse; with grad it saves (q, k, v, o, lse) flattened
    and the backward runs K2 and K3."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = False):
        b, h, t, d = q.shape
        qf, kf, vf = _padded(d, _flat(q), _flat(k), _flat(v))
        need_grad = any(ctx.needs_input_grad[:3])
        o, lse = _fwd_at(qf, kf, vf, causal, need_grad, sm_scale(d))
        if need_grad:
            ctx.save_for_backward(qf, kf, vf, o, lse)
        ctx.causal, ctx.bh, ctx.d = causal, (b, h), d
        return unpad_head(o, d).view(b, h, t, d)

    @staticmethod
    def backward(ctx, g):
        qf, kf, vf, o, lse = ctx.saved_tensors
        return _binding_grads(ctx, qf, kf, vf, o, lse, g, None)


class FlashAttentionWithLse(torch.autograd.Function):
    """(o [B, H, T, D], lse [B, H, T] f32). The lse output is
    differentiable: its cotangent enters both backward kernels as
    delta - g_lse (the dlse/dS = P term)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = False):
        b, h, t, d = q.shape
        qf, kf, vf = _padded(d, _flat(q), _flat(k), _flat(v))
        o, lse = _fwd_at(qf, kf, vf, causal, True, sm_scale(d))
        ctx.save_for_backward(qf, kf, vf, o, lse)
        ctx.causal, ctx.bh, ctx.d = causal, (b, h), d
        return unpad_head(o, d).view(b, h, t, d), lse.view(b, h, t)

    @staticmethod
    def backward(ctx, g_o, g_lse):
        qf, kf, vf, o, lse = ctx.saved_tensors
        if g_lse is not None:
            g_lse = g_lse.reshape(ctx.bh[0] * ctx.bh[1], -1).float().contiguous()
        return _binding_grads(ctx, qf, kf, vf, o, lse, g_o, g_lse)
