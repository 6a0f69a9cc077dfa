"""K5's routes and tgmm's output dtype, on CPU.

``grouped_matmul.route`` picks the kernel a CUDA call launches from the
dtype, the shapes and the operands' alignment alone: TMA + wgmma for bf16
that TMA can describe, mma.sync for other bf16, FMA units for f32. The
kernels run only on the card (chip_smoke.py holds each against the plain
version there); here the route function, and the plain version of what
the trainer's backward now asks of tgmm (dW written in w's dtype, one
rounding of the f32 sum), are held to their rules and to the JAX
package's ``lax.ragged_dot`` on the same numpy inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu_torch.ops import grouped_matmul as gm

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,m,k,n,groups,ptrs,want", [
    # bf16 that TMA can describe: the MoE cell's products, tails off 64
    (BF16, 32768, 768, 3072, 8, (0, 1 << 20), "wgmma"),
    (BF16, 32768, 3072, 768, 8, (256, 512), "wgmma"),
    (BF16, 300, 72, 136, 4, (16, 48), "wgmma"),
    (BF16, 1, 8, 8, 1, (), "wgmma"),
    # K or N off 8: rows are not 16-byte strided
    (BF16, 257, 30, 50, 2, (0, 0), "mma"),
    (BF16, 517, 40, 100, 2, (0, 0), "mma"),
    (BF16, 300, 12, 136, 4, (0, 0), "mma"),
    # a misaligned base (a view that starts 8 bytes in)
    (BF16, 300, 72, 136, 4, (8, 0), "mma"),
    (BF16, 300, 72, 136, 4, (0, 2), "mma"),
    # an empty dimension or no local group: nothing for TMA to map
    (BF16, 0, 72, 136, 4, (0, 0), "mma"),
    (BF16, 300, 0, 136, 4, (0, 0), "mma"),
    (BF16, 300, 72, 136, 0, (0, 0), "mma"),
    # f32 always on FMA units, whatever its shapes
    (F32, 32768, 768, 3072, 8, (0, 0), "fma"),
    (F32, 257, 30, 50, 2, (8, 4), "fma"),
])
def test_route_is_fixed_by_dtype_shape_and_alignment(dtype, m, k, n, groups, ptrs, want):
    assert gm.route(dtype, m, k, n, groups, *ptrs) == want


def test_route_refuses_other_dtypes():
    with pytest.raises(ValueError, match="f32 or bf16"):
        gm.route(torch.float16, 8, 8, 8, 1)


def _operands(seed, m=70, k=24, n=16, sizes=(5, 0, 63, 2)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((len(sizes), k, n)) * k ** -0.5).astype(np.float32)
    ct = rng.standard_normal((m, n)).astype(np.float32)
    return x, w, ct, np.array(sizes, np.int32)


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_tgmm_in_the_weights_dtype_is_one_rounding_of_the_f32_sum(dtype):
    """tgmm(out_dtype) is the f32 output rounded once, bit for bit, and
    GroupedMatmul's dW is that output in w's dtype."""
    x, w, ct, gs = _operands(6)
    tx, tw, tct = (torch.from_numpy(a).to(dtype) for a in (x, w, ct))
    sizes = torch.from_numpy(gs)
    f32 = gm.tgmm(tx, tct, sizes, 0, len(gs))
    assert f32.dtype == F32
    got = gm.tgmm(tx, tct, sizes, 0, len(gs), dtype)
    assert got.dtype == dtype and torch.equal(got, f32.to(dtype))
    tw.requires_grad_()
    gm.grouped_matmul(tx, tw, sizes).backward(tct)
    assert tw.grad.dtype == dtype and torch.equal(tw.grad, got)
    with pytest.raises(ValueError, match="f32 or bf16"):
        gm.tgmm(tx, tct, sizes, 0, len(gs), torch.float16)


def test_bf16_dw_matches_ragged_dot():
    """In bf16, the port's dW (tgmm written in bf16) against the JAX
    package's lax.ragged_dot VJP on the same bf16 inputs: both sum in f32
    and round once, so they may differ by one bf16 step (2^-8 relative)
    where the sums' orders round differently; groups of 0-63 rows."""
    x, w, ct, gs = _operands(7)
    xb, wb, cb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, ct))
    _, vjp = jax.vjp(lambda a, b: jax.lax.ragged_dot(a, b, jnp.asarray(gs),
                                                     preferred_element_type=jnp.float32),
                     xb, wb)
    _, jdw = vjp(jnp.asarray(cb, jnp.float32))
    tx, tc = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(BF16) for a in (xb, cb))
    got = gm.tgmm(tx, tc, torch.from_numpy(gs), 0, len(gs), BF16).float().numpy()
    want = np.array(jnp.asarray(jdw, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
    assert not got[1].any()  # the empty group's dW is zero
