"""Grouped matrix products over contiguous row groups: a hand-written Hopper
kernel (K5) and its plain version.

Counterpart of ``tf_operator_tpu/models/moe.py::_grouped_matmul``, the
product of the MoE LM's dropless dispatch: ``[M, K] x [E, K, N] -> [M, N]``
where ``group_sizes[e]`` consecutive rows of x use ``w[e]``. The JAX package
runs it through ``lax.ragged_dot``, or megablox's Pallas ``gmm``/``tgmm``
under ``TPUJOB_MOE_GMM=megablox``; the CUDA kernels in
``csrc/grouped_matmul.cu`` replace them (``gmm`` NN for the forward, NT for
dX, ``tgmm`` for dW).

Expert parallelism: ``w`` may hold only ``w.shape[0]`` of the groups, from
``first_group`` on (a rank's own experts). Then only those groups' rows are
computed, and every other row of the output is zero, as is every row past
the sum of ``group_sizes`` (``lax.ragged_dot``'s rule).

``grouped_matmul`` is differentiable (``GroupedMatmul``: dX = gmm(dY, w^T),
dW = tgmm(x, dY) written in w's dtype: one rounding of the f32 sum). On CPU
tensors every product runs its plain version, a loop over the groups of
``x[s:e] @ w[g]``, which reads ``group_sizes`` on the host. On CUDA tensors
it launches the kernels (counted in ``LAUNCHES``, and by route in
``ROUTE_LAUNCHES``) or raises; the host never reads ``group_sizes`` there,
so nothing syncs. Both accumulate in f32 and round the output to the
inputs' dtype (tgmm: to ``out_dtype``).

Which kernel a CUDA call launches is ``route``'s choice, from the dtype,
the shapes and the operands' alignment alone: ``"wgmma"`` (TMA + wgmma,
persistent) for bf16 whose K and N are multiples of 8 and whose bases are
16-byte aligned, ``"mma"`` (mma.sync) for other bf16, ``"fma"`` for f32. A
launch error raises; no route falls back to another.
"""

from __future__ import annotations

import ctypes

import torch

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)

# Launch counts of the kernels, incremented where the wrapper launches them,
# by product and by route.
LAUNCHES = {"gmm_nn": 0, "gmm_nt": 0, "tgmm": 0}
ROUTE_LAUNCHES = {"wgmma": 0, "mma": 0, "fma": 0}
# The C interface's `kind` argument of each route.
ROUTE_KINDS = {"fma": 0, "mma": 1, "wgmma": 2}

_lib_handle = None


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTE_LAUNCHES):
        for key in counts:
            counts[key] = 0


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        from tf_operator_tpu_torch.ops import _build

        lib = _build.load("grouped_matmul")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.tfo_gmm.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
        lib.tfo_gmm.restype = i32
        lib.tfo_tgmm.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
        lib.tfo_tgmm.restype = i32
        _lib_handle = lib
    return _lib_handle


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _group_rows(group_sizes: torch.Tensor, first_group: int, local: int, m: int):
    """[(local group j, first row, end row)] of the groups with weights here,
    non-empty and clipped to m rows (host ints: a sync on a CUDA tensor)."""
    sizes = [max(int(s), 0) for s in group_sizes.tolist()]
    start = sum(sizes[:first_group])
    out = []
    for j, size in enumerate(sizes[first_group:first_group + local]):
        lo, hi = min(start, m), min(start + size, m)
        if hi > lo:
            out.append((j, lo, hi))
        start += size
    return out


def gmm_reference(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
                  first_group: int = 0, trans_w: bool = False) -> torch.Tensor:
    """x [M, K] times w[g] ([G, K, N]; with trans_w, w[g]^T of [G, N, K])
    over group g's rows, in f32, rounded to x's dtype; other rows 0."""
    n = w.shape[1] if trans_w else w.shape[2]
    out = torch.zeros((x.shape[0], n), dtype=x.dtype, device=x.device)
    for j, lo, hi in _group_rows(group_sizes, first_group, w.shape[0], x.shape[0]):
        wj = w[j].float()
        out[lo:hi] = (x[lo:hi].float() @ (wj.T if trans_w else wj)).to(x.dtype)
    return out


def tgmm_reference(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor,
                   first_group: int, num_groups: int,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """dw [G, K, N] with dw[g] = x[rows of g]^T dy[rows of g] (0 for an
    empty group), summed in f32 and rounded once to out_dtype."""
    out = torch.zeros((num_groups, x.shape[1], dy.shape[1]), dtype=torch.float32,
                      device=x.device)
    for j, lo, hi in _group_rows(group_sizes, first_group, num_groups, x.shape[0]):
        out[j] = x[lo:hi].float().T @ dy[lo:hi].float()
    return out.to(out_dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError("grouped matmul operands must share one CUDA device")
    if tensors[0].dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"the grouped matmul takes f32 or bf16, got {tensors[0].dtype}")
    if any(t.dtype != tensors[0].dtype for t in tensors[1:2]):
        raise ValueError(f"operands of one dtype, got {[t.dtype for t in tensors[:2]]}")
    if any(t.numel() >= 2 ** 31 for t in tensors):
        raise ValueError("the grouped matmul indexes with 32-bit dimensions")


def route(dtype: torch.dtype, m: int, k: int, n: int, groups: int, *base_ptrs: int) -> str:
    """The kernel route of a CUDA call with m rows, reduction K, width N and
    `groups` local groups, whose operands start at base_ptrs: "wgmma" (TMA
    + wgmma) for bf16 that TMA can describe (no empty dimension, K and N
    multiples of 8, so 16-byte row strides, and 16-byte aligned bases),
    "mma" (mma.sync) for other bf16, "fma" for f32."""
    if dtype == torch.float32:
        return "fma"
    if dtype != torch.bfloat16:
        raise ValueError(f"the grouped matmul takes f32 or bf16, got {dtype}")
    if min(m, k, n, groups) > 0 and k % 8 == 0 and n % 8 == 0 \
            and all(p % 16 == 0 for p in base_ptrs):
        return "wgmma"
    return "mma"


def _sizes32(group_sizes: torch.Tensor, device) -> torch.Tensor:
    """group_sizes as int32 on the device (a device-side cast: no sync)."""
    return group_sizes.to(device=device, dtype=torch.int32).contiguous()


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def gmm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
        first_group: int = 0, trans_w: bool = False) -> torch.Tensor:
    """out [M, N] in x's dtype: x[rows of g] . w[g] (w [G, K, N]), or
    . w[g]^T with trans_w (w [G, N, K]), for the G groups from first_group
    on; every other row 0."""
    m, k = x.shape
    g = w.shape[0]
    kw, n = (w.shape[2], w.shape[1]) if trans_w else (w.shape[1], w.shape[2])
    if w.dim() != 3 or kw != k:
        raise ValueError(f"w {tuple(w.shape)} does not fit x {tuple(x.shape)} "
                         f"({'NT' if trans_w else 'NN'})")
    if x.device.type == "cpu":
        return gmm_reference(x, w, group_sizes, first_group, trans_w)
    _check_cuda(x, w)
    x, w = x.contiguous(), w.contiguous()
    sizes = _sizes32(group_sizes, x.device)
    # The kernel writes every row: zeros outside the local groups' rows.
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    path = route(x.dtype, m, k, n, g, x.data_ptr(), w.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        err = _lib().tfo_gmm(_ptr(x), _ptr(w), _ptr(sizes), _ptr(out), m, k, n, first_group,
                             g, int(trans_w), ROUTE_KINDS[path], stream)
    if err != 0:
        raise RuntimeError(f"grouped matmul kernel launch failed ({path}): error {err}")
    LAUNCHES["gmm_nt" if trans_w else "gmm_nn"] += 1
    ROUTE_LAUNCHES[path] += 1
    return out


def tgmm(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor, first_group: int,
         num_groups: int, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """dw [num_groups, K, N] in out_dtype (f32 or bf16): x[rows of g]^T .
    dy[rows of g] for the groups from first_group on (zeros for an empty
    one), summed in f32 and rounded once."""
    m, k = x.shape
    if dy.dim() != 2 or dy.shape[0] != m:
        raise ValueError(f"dy {tuple(dy.shape)} does not fit x {tuple(x.shape)}")
    if out_dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"tgmm writes f32 or bf16, not {out_dtype}")
    if x.device.type == "cpu":
        return tgmm_reference(x, dy, group_sizes, first_group, num_groups, out_dtype)
    _check_cuda(x, dy)
    x, dy = x.contiguous(), dy.contiguous()
    sizes = _sizes32(group_sizes, x.device)
    n = dy.shape[1]
    out = torch.empty((num_groups, k, n), dtype=out_dtype, device=x.device)
    path = route(x.dtype, m, k, n, num_groups, x.data_ptr(), dy.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        err = _lib().tfo_tgmm(_ptr(x), _ptr(dy), _ptr(sizes), _ptr(out), m, k, n, first_group,
                              num_groups, ROUTE_KINDS[path], int(out_dtype == torch.bfloat16),
                              stream)
    if err != 0:
        raise RuntimeError(f"grouped matmul (tgmm) kernel launch failed ({path}): error {err}")
    LAUNCHES["tgmm"] += 1
    ROUTE_LAUNCHES[path] += 1
    return out


class GroupedMatmul(torch.autograd.Function):
    """gmm with megablox's backward: dX = gmm(dY, w, NT), dW = tgmm(x, dY)
    written in w's dtype."""

    @staticmethod
    def forward(ctx, x, w, group_sizes, first_group):
        ctx.save_for_backward(x, w, group_sizes)
        ctx.first_group = first_group
        return gmm(x, w, group_sizes, first_group)

    @staticmethod
    def backward(ctx, g):
        x, w, group_sizes = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gmm(g, w, group_sizes, ctx.first_group, trans_w=True)
        if ctx.needs_input_grad[1]:
            dw = tgmm(x, g, group_sizes, ctx.first_group, w.shape[0], w.dtype)
        return dx, dw, None, None


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
                   first_group: int = 0) -> torch.Tensor:
    """[M, K] x [G, K, N] -> [M, N] over the row groups of group_sizes (the
    G groups from first_group on), differentiable in x and w."""
    return GroupedMatmul.apply(x, w, group_sizes, first_group)
