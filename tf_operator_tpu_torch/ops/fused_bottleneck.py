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

Two routes (``route``): bf16 runs the tensor-core kernels (``wgmma``
products over 128-row blocks, nine launches, t3 recomputed instead of
stored), on Cn and Cw that are multiples of 64: other widths are
zero-padded up to them first (``pad_channels``: zero weights and zero BN
scale and bias keep the padded channels at zero through every BN, relu
and product, so they add nothing to the real ones) and y and the moments
sliced back; f32 runs the first version's FMA kernels (64-row blocks,
seven launches, t1, t2, t3 in f32), which take any width.
``workspace_plan`` lists each route's scratch buffers.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

EPS = 1e-5
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
# Rows of a tile in one moment partial of each route: the row block of its
# products (a 128-row wgmma item, a 64-row FMA block).
ROWS_PER_BLOCK = {"wgmma": 128, "fma": 64}
# Channel counts of the wgmma route are multiples of this (one 128-byte
# swizzle box of bf16, the depth of a k-tile).
WGMMA_CHANNELS = 64

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
        lib.tfo_fused_bottleneck_fwd.argtypes = [ptr] * 19 + [i32] * 6 + [ptr]
        lib.tfo_fused_bottleneck_fwd.restype = i32
        lib.tfo_fused_bottleneck_fwd_wgmma.argtypes = [ptr] * 18 + [i32] * 6 + [ptr]
        lib.tfo_fused_bottleneck_fwd_wgmma.restype = i32
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


def route(dtype: torch.dtype, cw: int, cn: int) -> str:
    """The kernel route of a CUDA call: "wgmma" for bf16 (Cn and Cw padded
    to multiples of 64 first, pad_channels), "fma" for f32."""
    if dtype == torch.float32:
        return "fma"
    if dtype != torch.bfloat16:
        raise ValueError(f"the fused bottleneck takes f32 or bf16, got {dtype}")
    if cn < 1 or cw < 1:
        raise ValueError(f"channel counts must be positive, got Cn {cn}, Cw {cw}")
    return "wgmma"


def _round_up(c: int) -> int:
    return -(-c // WGMMA_CHANNELS) * WGMMA_CHANNELS


def pad_channels(x, w1, w2, w3, s1, b1, s2, b2, s3, b3):
    """The operands with Cw and Cn zero-padded up to multiples of 64: zero
    input channels, weights and BN scale/bias. A padded channel's t is 0,
    its ghost BN gives 0 * rsqrt(0 + eps) + 0 = 0, and its weights carry
    nothing into the real channels."""
    cw, cn = w1.shape
    pw, pn = _round_up(cw) - cw, _round_up(cn) - cn
    x = F.pad(x, (0, pw))
    w1 = F.pad(w1, (0, pn, 0, pw))
    w2 = F.pad(w2, (0, pn, 0, pn))
    w3 = F.pad(w3, (0, pw, 0, pn))
    s1, b1, s2, b2 = (F.pad(t, (0, pn)) for t in (s1, b1, s2, b2))
    s3, b3 = (F.pad(t, (0, pw)) for t in (s3, b3))
    return x, w1, w2, w3, s1, b1, s2, b2, s3, b3


def padded_call(fn, x, w1, w2, w3, s1, b1, s2, b2, s3, b3, tile_b: int):
    """fn (the kernel's launch, or the plain version) on the channel-padded
    operands, its y and moments sliced back to Cw and Cn."""
    cw, cn = w1.shape
    y, (st1, st2, st3) = fn(*pad_channels(x, w1, w2, w3, s1, b1, s2, b2, s3, b3),
                            tile_b=tile_b)
    return (y[..., :cw].contiguous(),
            (st1[..., :cn].contiguous(), st2[..., :cn].contiguous(),
             st3[..., :cw].contiguous()))


def workspace_plan(b: int, h: int, w: int, cw: int, cn: int, tile_b: int,
                   dtype: torch.dtype) -> dict:
    """The scratch buffers of one CUDA call, {name: (shape, dtype)}, in the
    order the C entry point takes them. The wgmma route keeps one f32 t
    [rows, Cn] (t1, then t2) and one bf16 n [rows, Cn] (n1, then n2): t3 is
    recomputed, never stored. The FMA route stores t1, t2 and t3 in f32."""
    kind = route(dtype, cw, cn)
    rows, tiles = b * h * w, b // tile_b
    blocks = -(-(tile_b * h * w) // ROWS_PER_BLOCK[kind])
    f32 = torch.float32
    plan = ({"t": ((rows, cn), f32), "n": ((rows, cn), torch.bfloat16)} if kind == "wgmma"
            else {"t1": ((rows, cn), f32), "t2": ((rows, cn), f32), "t3": ((rows, cw), f32)})
    plan["part"] = ((tiles * blocks * 2 * max(cn, cw),), f32)
    plan["mult"] = ((tiles * max(cn, cw),), f32)
    return plan


def fused_bottleneck(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, tile_b: int):
    """K4 in the JAX layout: (y, (st1, st2, st3)). The plain version for
    CPU tensors; the CUDA kernels (or an error) for CUDA tensors, a bf16
    call whose Cn or Cw is not a multiple of 64 on zero-padded channels."""
    b, h, w, cw = x.shape
    _check_tile(b, tile_b)
    if x.device.type == "cpu":
        return fused_bottleneck_reference(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, tile_b)
    vectors = (s1, b1, s2, b2, s3, b3)
    _check_cuda(x, w1, w2, w3, vectors)
    cn = w1.shape[-1]
    if route(x.dtype, cw, cn) == "wgmma" and (cw % WGMMA_CHANNELS or cn % WGMMA_CHANNELS):
        return padded_call(_launch, x, w1, w2, w3, *vectors, tile_b=tile_b)
    return _launch(x, w1, w2, w3, *vectors, tile_b=tile_b)


def _launch(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, tile_b: int):
    """One call of the kernels on checked CUDA operands."""
    b, h, w, cw = x.shape
    cn = w1.shape[-1]
    dt, dev = x.dtype, x.device
    kind = route(dt, cw, cn)
    vectors = (s1, b1, s2, b2, s3, b3)
    x = x.contiguous()
    w1, w2, w3 = (t.to(dt).contiguous() for t in (w1, w2, w3))
    s1, b1, s2, b2, s3, b3 = (t.float().contiguous() for t in vectors)
    tiles = b // tile_b
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    st1 = torch.empty((tiles, 2, cn), **f32)
    st2 = torch.empty((tiles, 2, cn), **f32)
    st3 = torch.empty((tiles, 2, cw), **f32)
    work = [torch.empty(shape, dtype=dtype, device=dev)
            for shape, dtype in workspace_plan(b, h, w, cw, cn, tile_b, dt).values()]
    if b * h * w:
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (
            x, w1, w2, w3, s1, b1, s2, b2, s3, b3, y, st1, st2, st3, *work)]
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        with torch.cuda.device(dev):
            if kind == "wgmma":
                err = _lib().tfo_fused_bottleneck_fwd_wgmma(*ptrs, b, h, w, cw, cn, tile_b,
                                                            stream)
            else:
                err = _lib().tfo_fused_bottleneck_fwd(*ptrs, b, h, w, cw, cn, tile_b, stream)
        if err != 0:
            raise RuntimeError(f"fused bottleneck kernel launch failed: error {err}")
        LAUNCHES["fwd"] += 1
    return y, (st1, st2, st3)
