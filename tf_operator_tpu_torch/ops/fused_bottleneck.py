"""Fused stride-1 ResNet bottleneck forward: a hand-written Hopper kernel
and its plain version.

Counterpart of ``tf_operator_tpu/ops/fused_bottleneck.py``. The CUDA kernel
in ``csrc/fused_bottleneck.cu`` replaces the Pallas ``_fwd_kernel``: per
batch tile of ``tile_b`` images,

    t1 = x . w1          -> ghost BN1 -> relu -> round to x's dtype = n1
    t2 = conv3x3(n1)     -> ghost BN2 -> relu -> round                = n2
    t3 = n2 . w3         -> ghost BN3 -> + x -> relu -> round         = y

where "ghost" BN normalises with the tile's own moments, (t - m) * a + b
with a = scale / sqrt(max(E[t^2] - m^2, 0) + eps), and the 3x3 SAME
convolution zero-pads n1 (after BN and relu). Every product accumulates
in f32. Outputs are y in x's dtype and the raw moments (mean, mean of
squares) of t1, t2 and t3 per tile, ``[tiles, 2, C]`` f32, which
``combine_stats`` turns into whole-batch (mean, var).

Layouts are the JAX package's: x ``[B, H, W, Cw]`` (NHWC), w1 ``[Cw, Cn]``,
w2 ``[3, 3, Cn, Cn]`` (HWIO), w3 ``[Cn, Cw]``; the weights are taken in x's
dtype, BN scale and bias as f32 ``[C]``.

``fused_bottleneck`` runs the plain version ``fused_bottleneck_reference``
only for CPU tensors; on a CUDA tensor it launches the kernel (and counts
the launch in ``LAUNCHES["fwd"]``) or raises. No model calls it: the JAX
package keeps the kernel as a measured negative result, and the ResNet
trainer runs the unfused block.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

EPS = 1e-5
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Rows of a tile that one block of the kernel's products covers; the
# wrapper sizes the per-block moment partials by it.
ROWS_PER_BLOCK = 64

# Launch count of the kernel, incremented where the wrapper launches it.
LAUNCHES = {"fwd": 0}

_lib_handle = None


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        from tf_operator_tpu_torch.ops import _build

        lib = _build.load("fused_bottleneck")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.tfo_fused_bottleneck_fwd.argtypes = [ptr] * 19 + [i32] * 7 + [ptr]
        lib.tfo_fused_bottleneck_fwd.restype = i32
        _lib_handle = lib
    return _lib_handle


def default_tile(h: int, w: int, batch: int) -> int:
    """The JAX package's batch tile: the largest power of two up to
    ~4096 // (h * w) rows' worth of images that divides the batch."""
    target = max(1, 4096 // (h * w))
    t = 1
    while t * 2 <= target and batch % (t * 2) == 0:
        t *= 2
    return t


def combine_stats(st: torch.Tensor):
    """[tiles, 2, C] raw moments -> (mean, var) over the whole batch. The
    equal-weight mean over tiles is exact because every tile has the same
    sample count (tile_b divides the batch)."""
    m = st[:, 0].mean(0)
    q = st[:, 1].mean(0)
    return m, torch.clamp_min(q - m.square(), 0.0)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _ghost_bn(t: torch.Tensor, tiles: int, scale, bias):
    """Ghost BN of t [N, C] over each of `tiles` equal row groups, in t's
    dtype: (normalised [N, C], [tiles, 2, C] raw moments)."""
    n, c = t.shape
    tt = t.view(tiles, n // tiles, c)
    m = tt.mean(1)
    q = tt.square().mean(1)
    v = torch.clamp_min(q - m.square(), 0.0)
    a = scale.to(t.dtype) * torch.rsqrt(v + EPS)
    z = (tt - m[:, None]) * a[:, None] + bias.to(t.dtype)
    return z.view(n, c), torch.stack([m, q], 1)


def fused_bottleneck_reference(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, tile_b: int,
                               acc_dtype: torch.dtype = torch.float32):
    """The kernel's function in stock ops: (y [B, H, W, Cw] in x's dtype,
    (st1, st2, st3) in acc_dtype). Products are taken in acc_dtype over
    operands rounded to x's dtype, and n1, n2 and y are rounded to x's
    dtype, where the kernel and the Pallas kernel round them: f32 (exact
    products, f32 sums) is the kernel's function; float64 measures how far
    f32 sums alone move the result."""
    b, h, w, cw = x.shape
    cn = w1.shape[-1]
    _check_tile(b, tile_b)
    tiles = b // tile_b
    dt, acc = x.dtype, acc_dtype
    flat = x.reshape(-1, cw)
    t1 = flat.to(acc) @ w1.to(dt).to(acc)
    z1, st1 = _ghost_bn(t1, tiles, s1, b1)
    n1 = torch.relu(z1).to(dt).to(acc).view(b, h, w, cn).permute(0, 3, 1, 2)
    t2 = F.conv2d(n1, w2.to(dt).to(acc).permute(3, 2, 0, 1), padding=1)
    t2 = t2.permute(0, 2, 3, 1).reshape(-1, cn)
    z2, st2 = _ghost_bn(t2, tiles, s2, b2)
    n2 = torch.relu(z2).to(dt).to(acc)
    t3 = n2 @ w3.to(dt).to(acc)
    z3, st3 = _ghost_bn(t3, tiles, s3, b3)
    y = torch.relu(z3 + flat.to(acc)).to(dt).view(b, h, w, cw)
    return y, (st1, st2, st3)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def _check_tile(batch: int, tile_b: int) -> None:
    if tile_b < 1 or batch % tile_b:
        raise ValueError(f"tile_b={tile_b} must divide the batch {batch}")


def _check_cuda(x, w1, w2, w3, vectors) -> None:
    """Raise ValueError unless the operands are what the kernel takes."""
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, Cw], got {tuple(x.shape)}")
    _, _, _, cw = x.shape
    cn = w1.shape[-1]
    if x.dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"the fused bottleneck takes f32 or bf16, got {x.dtype}")
    if w1.shape != (cw, cn) or w2.shape != (3, 3, cn, cn) or w3.shape != (cn, cw):
        raise ValueError(f"weights {tuple(w1.shape)}, {tuple(w2.shape)}, "
                         f"{tuple(w3.shape)} do not fit x {tuple(x.shape)}")
    for v, c in zip(vectors, (cn, cn, cn, cn, cw, cw)):
        if v.shape != (c,):
            raise ValueError(f"BN scale/bias must be [{c}], got {tuple(v.shape)}")
    if x.numel() >= 2 ** 31 or x.shape[0] * x.shape[1] * x.shape[2] * cn >= 2 ** 31:
        raise ValueError("the fused bottleneck indexes rows with 32-bit ints")
    for t in (x, w1, w2, w3, *vectors):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError("fused bottleneck operands must share one CUDA device")


def fused_bottleneck(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, tile_b: int):
    """K4 in the JAX layout: (y, (st1, st2, st3)). The plain version for
    CPU tensors; the CUDA kernel (or an error) for CUDA tensors."""
    b, h, w, cw = x.shape
    _check_tile(b, tile_b)
    if x.device.type == "cpu":
        return fused_bottleneck_reference(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, tile_b)
    vectors = (s1, b1, s2, b2, s3, b3)
    _check_cuda(x, w1, w2, w3, vectors)
    cn = w1.shape[-1]
    dt, dev = x.dtype, x.device
    x = x.contiguous()
    w1, w2, w3 = (t.to(dt).contiguous() for t in (w1, w2, w3))
    s1, b1, s2, b2, s3, b3 = (t.float().contiguous() for t in vectors)
    tiles = b // tile_b
    rows = b * h * w
    blocks = -(-(tile_b * h * w) // ROWS_PER_BLOCK)
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    st1 = torch.empty((tiles, 2, cn), **f32)
    st2 = torch.empty((tiles, 2, cn), **f32)
    st3 = torch.empty((tiles, 2, cw), **f32)
    # f32 workspace: t1, t2 [rows, Cn], t3 [rows, Cw], the per-block moment
    # partials and the per-tile BN multipliers.
    t1 = torch.empty((rows, cn), **f32)
    t2 = torch.empty((rows, cn), **f32)
    t3 = torch.empty((rows, cw), **f32)
    part = torch.empty((tiles * blocks * 2 * max(cn, cw),), **f32)
    mult = torch.empty((tiles * max(cn, cw),), **f32)
    if rows:
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (
            x, w1, w2, w3, s1, b1, s2, b2, s3, b3, y, st1, st2, st3, t1, t2, t3,
            part, mult)]
        with torch.cuda.device(dev):
            err = _lib().tfo_fused_bottleneck_fwd(
                *ptrs, b, h, w, cw, cn, tile_b, _DTYPE_CODE[dt],
                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        if err != 0:
            raise RuntimeError(f"fused bottleneck kernel launch failed: cudaError {err}")
        LAUNCHES["fwd"] += 1
    return y, (st1, st2, st3)
