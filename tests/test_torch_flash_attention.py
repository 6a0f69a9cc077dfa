"""The PyTorch port's flash attention (K1 forward, K2 dQ, K3 dK/dV) on CPU.

On CPU tensors the port's wrappers run the kernels' plain versions; these
tests hold them against the JAX package's Pallas kernels in interpret mode,
run as tests/test_ops.py runs them, on the same numpy inputs. Tolerances as
in tests/test_ops.py: f32 2e-5 on outputs and lse, 1e-4 on gradients; bf16
3e-2 on outputs and 1e-1 on gradients (8-bit mantissas, contraction order).
The CUDA kernels themselves are held against the same plain versions on the
card by chip_smoke.py.
"""

import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.ops import attention as jattention
from tf_operator_tpu.ops import flash_attention as jfa
from tf_operator_tpu.parallel.ring_attention import (
    attention_reference as jax_attention_reference,
)
from tf_operator_tpu_torch.ops import _build
from tf_operator_tpu_torch.ops import flash_attention as fa
from tf_operator_tpu_torch.ops.attention import flash_attention
from tf_operator_tpu_torch.parallel.ring_attention import (
    attention_reference,
    make_attention_fn,
)

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The module's tests and fixtures at one intra-op thread. On a loaded
    machine the plain forward's first multi-threaded torch.exp in a fresh
    process (torch 2.13, CPU, MKL and OpenMP) returns values up to 1.5e-4
    relative off in 6 of 96 processes at 2 threads and in 0 of 96 at one; a
    second call is exact (6.1e-8). That moved o by up to 3.6e-5 and failed
    the f32 2e-5 check of test_matches_pallas_interpret[shape0-False]. A
    module-level set_num_threads does not hold here: collecting the suite
    imports every test module, and the last one imported sets the count for
    all."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

F32_OUT, F32_GRAD = 2e-5, 1e-4
BF16_OUT, BF16_GRAD = 3e-2, 1e-1


def _inputs(seed, shape, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _jax(arrs, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrs]


def _torch(arrs, dtype=torch.float32, grad=False):
    return [torch.from_numpy(a.copy()).to(dtype).requires_grad_(grad) for a in arrs]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(x, np.float32)


class TestForward:
    @pytest.mark.parametrize("shape,causal", [
        ((2, 2, 256, 128), False),
        ((2, 2, 256, 128), True),
        ((1, 1, 192, 128), False),  # ragged tail: T % 128 != 0
        ((1, 2, 192, 64), True),
    ])
    def test_matches_pallas_interpret(self, shape, causal):
        arrs = _inputs(0, shape)
        expected = jfa.flash_attention_pallas(*_jax(arrs), causal, 128, 128, True)
        got = fa.FlashAttention.apply(*_torch(arrs), causal)
        np.testing.assert_allclose(_np(got), _np(expected), atol=F32_OUT)

    @pytest.mark.parametrize("shape,causal", [
        ((1, 2, 256, 128), True), ((1, 1, 192, 64), False)])
    def test_lse_matches_pallas_residual(self, shape, causal):
        b, h, t, d = shape
        arrs = [a.reshape(b * h, t, d) for a in _inputs(1, shape)]
        o_j, lse_j = jfa._flash_fwd(*_jax(arrs), causal, 128, 128, True,
                                    save_residuals=True)
        o_t, lse_t = fa.flash_fwd(*_torch(arrs), causal)
        assert lse_t.shape == (b * h, t) and lse_t.dtype == torch.float32
        np.testing.assert_allclose(_np(o_t), _np(o_j), atol=F32_OUT)
        np.testing.assert_allclose(_np(lse_t), _np(lse_j)[:, :, 0], atol=F32_OUT)

    def test_bf16(self):
        arrs = _inputs(4, (1, 2, 256, 128))
        expected = jfa.flash_attention_pallas(*_jax(arrs, jnp.bfloat16), True,
                                              128, 128, True)
        got = fa.FlashAttention.apply(*_torch(arrs, torch.bfloat16), True)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), _np(expected), atol=BF16_OUT,
                                   rtol=BF16_OUT)

    def test_primal_without_grad_keeps_no_lse(self):
        q, k, v = _torch(_inputs(2, (1, 1, 64, 32)))
        with torch.no_grad():
            o = fa.FlashAttention.apply(q, k, v, True)
        assert o.grad_fn is None
        o_ref, _ = fa.flash_fwd_plain(q[0], k[0], v[0], True)
        torch.testing.assert_close(o[0], o_ref)


class TestBackward:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("shape", [(1, 2, 128, 128), (2, 2, 256, 64)])
    def test_grad_matches_pallas_interpret(self, causal, shape):
        arrs = _inputs(2, shape)

        def loss_flash(q, k, v):
            return jnp.sum(jfa.flash_attention_pallas(q, k, v, causal, 128, 128, True) ** 2)

        gj = jax.grad(loss_flash, argnums=(0, 1, 2))(*_jax(arrs))
        qkv = _torch(arrs, grad=True)
        gt = torch.autograd.grad((fa.FlashAttention.apply(*qkv, causal) ** 2).sum(), qkv)
        for a, b in zip(gt, gj):
            np.testing.assert_allclose(_np(a), _np(b), atol=F32_GRAD)

    def test_grad_ragged_tail(self):
        """Padded tail rows must not leak into dk/dv (T=192, blocks of 128
        on the JAX side, 64 in the port's kernels)."""
        arrs = _inputs(5, (1, 1, 192, 128))

        def loss_flash(q, k, v):
            return jnp.sum(jfa.flash_attention_pallas(q, k, v, True, 128, 128, True) ** 2)

        gj = jax.grad(loss_flash, argnums=(0, 1, 2))(*_jax(arrs))
        qkv = _torch(arrs, grad=True)
        gt = torch.autograd.grad((fa.FlashAttention.apply(*qkv, True) ** 2).sum(), qkv)
        for a, b in zip(gt, gj):
            np.testing.assert_allclose(_np(a), _np(b), atol=F32_GRAD)

    def test_grad_bf16(self):
        arrs = _inputs(6, (1, 2, 256, 64))

        def loss_flash(q, k, v):
            o = jfa.flash_attention_pallas(q, k, v, True, 128, 128, True)
            return jnp.sum(o.astype(jnp.float32) ** 2)

        gj = jax.grad(loss_flash, argnums=(0, 1, 2))(*_jax(arrs, jnp.bfloat16))
        qkv = _torch(arrs, torch.bfloat16, grad=True)
        o = fa.FlashAttention.apply(*qkv, True)
        gt = torch.autograd.grad((o.float() ** 2).sum(), qkv)
        for a, b in zip(gt, gj):
            assert a.dtype == torch.bfloat16
            np.testing.assert_allclose(_np(a), _np(b), atol=BF16_GRAD, rtol=BF16_GRAD)

    @pytest.mark.parametrize("shape,causal", [
        ((1, 2, 256, 64), True), ((1, 1, 192, 128), False)])
    def test_lse_cotangent_matches_pallas_interpret(self, shape, causal):
        """The lse output's cotangent enters both backward passes as
        delta - g_lse: grads of sum(o * go) + sum(lse * gl)."""
        q, k, v, go = _inputs(7, shape, n=4)
        gl = np.random.default_rng(8).standard_normal(shape[:3]).astype(np.float32)

        def loss(q, k, v):
            o, lse = jfa.flash_attention_with_lse(q, k, v, causal, 128, 128, True)
            return jnp.sum(o * go) + jnp.sum(lse * gl)

        val_j = jfa.flash_attention_with_lse(*_jax([q, k, v]), causal, 128, 128, True)
        gj = jax.grad(loss, argnums=(0, 1, 2))(*_jax([q, k, v]))
        qkv = _torch([q, k, v], grad=True)
        o_t, lse_t = fa.FlashAttentionWithLse.apply(*qkv, causal)
        np.testing.assert_allclose(_np(o_t), _np(val_j[0]), atol=F32_OUT)
        np.testing.assert_allclose(_np(lse_t), _np(val_j[1]), atol=F32_OUT)
        gt = torch.autograd.grad(
            (o_t * torch.from_numpy(go)).sum() + (lse_t * torch.from_numpy(gl)).sum(), qkv)
        for a, b in zip(gt, gj):
            np.testing.assert_allclose(_np(a), _np(b), atol=F32_GRAD)

    def test_split_backward_equals_plain(self):
        """flash_bwd_dq and flash_bwd_dkv (the K2/K3 wrappers) together
        give flash_bwd_plain's three gradients."""
        q, k, v, do = _torch(_inputs(9, (2, 96, 64), n=4))
        gl = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 96)).astype(np.float32))
        o, lse = fa.flash_fwd(q, k, v, True)
        dq = fa.flash_bwd_dq(q, k, v, o, lse, do, True, gl)
        dk, dv = fa.flash_bwd_dkv(q, k, v, o, lse, do, True, gl)
        for a, b in zip((dq, dk, dv), fa.flash_bwd_plain(q, k, v, o, lse, do, True, gl)):
            torch.testing.assert_close(a, b)


class TestDeltaPass:
    """The backward's delta pass, delta = rowsum(dO o O) - g_lse, and the
    backward wrappers given that delta."""

    @pytest.mark.parametrize("with_glse", [False, True])
    def test_delta_plain_matches_numpy(self, with_glse):
        o, do = _inputs(13, (3, 40, 64), n=2)
        gl = np.random.default_rng(14).standard_normal((3, 40)).astype(np.float32)
        expected = (do.astype(np.float64) * o).sum(-1) - (gl if with_glse else 0.0)
        o_t, do_t = _torch([o, do])
        got = fa.bwd_delta(o_t, do_t, torch.from_numpy(gl) if with_glse else None)
        assert got.shape == (3, 40) and got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), expected, atol=1e-5, rtol=1e-5)

    def test_delta_plain_of_bf16_is_f32_of_the_rounded_inputs(self):
        o, do = _inputs(15, (2, 24, 128), n=2)
        o_t, do_t = _torch([o, do], torch.bfloat16)
        expected = (_np(do_t).astype(np.float64) * _np(o_t)).sum(-1)
        got = fa._bwd_delta_plain(o_t, do_t)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), expected, atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("causal,with_glse", [(True, True), (False, False), (True, False)])
    def test_given_delta_equals_own_delta_and_plain(self, causal, with_glse):
        """flash_bwd_dq / flash_bwd_dkv with delta=bwd_delta(o, do, g_lse)
        equal the same calls that compute it themselves, and flash_bwd_plain."""
        q, k, v, do = _torch(_inputs(16, (2, 80, 64), n=4))
        gl = (torch.from_numpy(np.random.default_rng(17).standard_normal((2, 80))
                               .astype(np.float32)) if with_glse else None)
        o, lse = fa.flash_fwd(q, k, v, causal)
        delta = fa.bwd_delta(o, do, gl)
        dq = fa.flash_bwd_dq(q, k, v, o, lse, do, causal, delta=delta)
        dk, dv = fa.flash_bwd_dkv(q, k, v, o, lse, do, causal, delta=delta)
        own = (fa.flash_bwd_dq(q, k, v, o, lse, do, causal, gl),
               *fa.flash_bwd_dkv(q, k, v, o, lse, do, causal, gl))
        plain = fa.flash_bwd_plain(q, k, v, o, lse, do, causal, gl)
        for a, b, c in zip((dq, dk, dv), own, plain):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
            torch.testing.assert_close(a, c)

    def test_given_delta_is_used_and_g_lse_ignored(self):
        """A given delta replaces rowsum(dO o O) - g_lse: shifting it by s
        shifts the result as an lse cotangent of -s would."""
        q, k, v, do = _torch(_inputs(18, (1, 48, 32), n=4))
        o, lse = fa.flash_fwd(q, k, v, True)
        shift = torch.full((1, 48), 0.25)
        got = fa.flash_bwd_dq(q, k, v, o, lse, do, True, g_lse=torch.zeros(1, 48),
                              delta=fa.bwd_delta(o, do) + shift)
        want = fa.flash_bwd_dq(q, k, v, o, lse, do, True, g_lse=-shift)
        torch.testing.assert_close(got, want)


class TestFullyMaskedRows:
    def test_empty_rows_give_zero_and_neg_inf(self):
        """With no key visible to any row, the plain version's guards give
        o = 0, lse = NEG_INF and a zero dq."""
        q = torch.randn(1, 4, 8, generator=torch.Generator().manual_seed(0))
        k = torch.zeros(1, 0, 8)
        o, lse = fa.flash_fwd_plain(q, k, k, False)
        assert torch.all(o == 0) and torch.all(lse == fa.NEG_INF)
        dq = fa.flash_bwd_dq(q, k, k, o, lse, torch.ones_like(o))
        assert torch.all(dq == 0)


class TestDispatch:
    def test_cpu_runs_plain_and_counts_no_launch(self):
        fa.reset_launches()
        qkv = _torch(_inputs(3, (1, 2, 64, 32)), grad=True)
        (flash_attention(*qkv, causal=True) ** 2).sum().backward()
        assert fa.LAUNCHES == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0, "bwd_delta": 0}

    def test_dispatcher_matches_jax_reference(self):
        arrs = _inputs(3, (1, 1, 64, 32))
        expected = jax_attention_reference(*_jax(arrs), causal=True)
        got = flash_attention(*_torch(arrs), causal=True)
        np.testing.assert_allclose(_np(got), _np(expected), atol=1e-6)

    @pytest.mark.parametrize("causal", [False, True])
    def test_attention_reference_matches_jax(self, causal):
        arrs = _inputs(10, (2, 2, 48, 32))
        expected = jax_attention_reference(*_jax(arrs), causal=causal)
        got = attention_reference(*_torch(arrs), causal=causal)
        np.testing.assert_allclose(_np(got), _np(expected), atol=1e-6)

    def test_attention_fn_is_flash_and_sp_raises(self, monkeypatch):
        """Without sp (no mesh, or sp = 1) the factory gives the flash
        binding; over sp it gives the sequence-parallel scheme, which
        raises JAX's error when Ulysses is forced on heads sp does not
        divide (before any collective)."""
        from tf_operator_tpu_torch.parallel import mesh as mesh_lib

        q, k, v = _torch(_inputs(11, (1, 2, 32, 16)))
        for mesh in (None, mesh_lib.Mesh({"dp": 1, "sp": 1})):
            torch.testing.assert_close(make_attention_fn(mesh, causal=True)(q, k, v),
                                       fa.FlashAttention.apply(q, k, v, True))
        monkeypatch.setenv("TPUJOB_SP_MODE", "ulysses")
        with pytest.raises(ValueError, match="divisible by sp=4"):
            make_attention_fn(mesh_lib.Mesh({"sp": 4}), causal=True)(q, k, v)

    def test_kernel_checks_refuse_non_cuda_operands(self):
        q, k, v = _torch(_inputs(12, (2, 64, 64)))
        with pytest.raises(ValueError, match="CUDA"):
            fa._check_cuda(q, k, v)
        with pytest.raises(ValueError, match="head_dim"):
            fa._check_cuda(q[..., :32], k[..., :32], v[..., :32])


class TestHeadWidthPadding:
    """Head widths the kernels are not built for run zero-padded to one
    that they are (64, 128, 256, 384, 512), with the unpadded width's scale. The
    plain versions on CPU reach the same padding and slicing as the
    kernels on the card."""

    @pytest.mark.parametrize("d", [32, 96, 160, 192, 320])
    @pytest.mark.parametrize("causal", [False, True])
    def test_padded_path_equals_the_unpadded_plain_version(self, d, causal):
        q, k, v, do = _torch(_inputs(20 + d, (3, 40, d), n=4))
        g_lse = torch.from_numpy(_inputs(21, (3, 40), n=1)[0])
        o, lse = fa.flash_fwd(q, k, v, causal)
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal)
        assert o.shape == q.shape and o.is_contiguous()
        torch.testing.assert_close(o, o_p, rtol=0, atol=1e-6)
        torch.testing.assert_close(lse, lse_p, rtol=0, atol=1e-6)
        got = fa.flash_bwd(q, k, v, o, lse, do, causal, g_lse)
        want = fa.flash_bwd_plain(q, k, v, o_p, lse_p, do, causal, g_lse)
        for g, w in zip(got, want):
            assert g.shape == q.shape
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
        torch.testing.assert_close(fa.bwd_delta(o, do, g_lse),
                                   fa._bwd_delta_plain(o_p, do, g_lse), rtol=0, atol=1e-6)

    @pytest.mark.parametrize("d", [32, 96, 160, 192, 320, 448])
    def test_padded_columns_come_out_zero(self, d):
        width = fa.kernel_head_dim(d)
        q, k, v, do = (fa.pad_head(x, width) for x in _torch(_inputs(30 + d, (2, 48, d), n=4)))
        scale = fa.sm_scale(d)
        o, lse = fa.flash_fwd_plain(q, k, v, True, scale)
        grads = fa.flash_bwd_plain(q, k, v, o, lse, do, True, scale=scale)
        for x in (o, *grads):
            assert x.shape[-1] == width and torch.all(x[..., d:] == 0)
        torch.testing.assert_close(lse, fa.flash_fwd_plain(q[..., :d], k[..., :d],
                                                           v[..., :d], True)[1])

    @pytest.mark.parametrize("causal", [False, True])
    def test_binding_at_d32_matches_the_jax_dispatcher(self, causal):
        """The JAX dispatcher takes its reference attention at d = 32 (the
        Pallas kernel wants d % 64 == 0); the port pads to 64."""
        arrs = _inputs(40, (2, 2, 64, 32))
        expected, vjp = jax.vjp(lambda *x: jattention.flash_attention(*x, causal=causal),
                                *_jax(arrs))
        qkv = _torch(arrs, grad=True)
        got = flash_attention(*qkv, causal=causal)
        np.testing.assert_allclose(_np(got), _np(expected), atol=F32_OUT)
        g = _inputs(41, (2, 2, 64, 32), n=1)[0]
        got_grads = torch.autograd.grad(got, qkv, torch.from_numpy(g))
        for gt, gj in zip(got_grads, vjp(jnp.asarray(g))):
            assert gt.shape == (2, 2, 64, 32)
            np.testing.assert_allclose(_np(gt), _np(gj), atol=F32_GRAD)

    def test_supported_head_dims_take_every_width_to_256(self):
        """Every width up to 512 pads to a built one (384 and 512 since the
        FMA kernels run at 16-row tiles there); past 512 a CUDA call raises."""
        assert fa.SUPPORTED_HEAD_DIMS == (64, 128, 256, 384, 512)
        for d in range(1, 513):
            width = fa.kernel_head_dim(d)
            assert width in fa.SUPPORTED_HEAD_DIMS and d <= width
            assert width == d or width // 2 < d or width == 64
        for d in (0, 513, 640):
            with pytest.raises(ValueError, match="head_dim"):
                fa.kernel_head_dim(d)
        q = torch.zeros(1, 8, 640)
        with pytest.raises(ValueError, match="head_dim"):
            fa._check_cuda(q, q, q)

    @pytest.mark.parametrize("causal", [False, True])
    def test_binding_at_d320_matches_the_pallas_kernel(self, causal):
        """D = 320, a multiple of 64 that the Pallas kernel takes as it is;
        the port pads it to 384 and slices the outputs back."""
        arrs = _inputs(42, (1, 2, 128, 320))
        expected, vjp = jax.vjp(
            lambda *x: jfa.flash_attention_pallas(*x, causal, 128, 128, True), *_jax(arrs))
        qkv = _torch(arrs, grad=True)
        got = fa.FlashAttention.apply(*qkv, causal)
        np.testing.assert_allclose(_np(got), _np(expected), atol=F32_OUT)
        g = _inputs(43, (1, 2, 128, 320), n=1)[0]
        got_grads = torch.autograd.grad(got, qkv, torch.from_numpy(g))
        for gt, gj in zip(got_grads, vjp(jnp.asarray(g))):
            assert gt.shape == (1, 2, 128, 320)
            np.testing.assert_allclose(_np(gt), _np(gj), atol=F32_GRAD)

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("d", [256, 192])
    def test_binding_at_the_wide_widths_matches_the_pallas_kernel(self, d, causal):
        """D = 256, and 192 padded to it: the widths whose bf16 backward
        runs the wide K2/K3 kernels on the card (here, as there, held
        through their plain version); f32 at the f32 limits."""
        arrs = _inputs(44, (1, 2, 128, d))
        expected, vjp = jax.vjp(
            lambda *x: jfa.flash_attention_pallas(*x, causal, 128, 128, True), *_jax(arrs))
        qkv = _torch(arrs, grad=True)
        got = fa.FlashAttention.apply(*qkv, causal)
        np.testing.assert_allclose(_np(got), _np(expected), atol=F32_OUT)
        g = _inputs(45, (1, 2, 128, d), n=1)[0]
        got_grads = torch.autograd.grad(got, qkv, torch.from_numpy(g))
        for gt, gj in zip(got_grads, vjp(jnp.asarray(g))):
            assert gt.shape == (1, 2, 128, d)
            np.testing.assert_allclose(_np(gt), _np(gj), atol=F32_GRAD)

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("d", [256, 192])
    def test_bf16_binding_at_the_wide_widths_matches_the_pallas_kernel(self, d, causal):
        """The same in bf16, the dtype the wide route takes, at the bf16
        limits (8-bit mantissas, contraction order)."""
        arrs = _inputs(46, (1, 2, 128, d))
        expected, vjp = jax.vjp(
            lambda *x: jfa.flash_attention_pallas(*x, causal, 128, 128, True),
            *_jax(arrs, jnp.bfloat16))
        qkv = _torch(arrs, torch.bfloat16, grad=True)
        got = fa.FlashAttention.apply(*qkv, causal)
        np.testing.assert_allclose(_np(got), _np(expected), atol=BF16_OUT, rtol=BF16_OUT)
        g = _inputs(47, (1, 2, 128, d), n=1)[0]
        got_grads = torch.autograd.grad(got, qkv, torch.from_numpy(g).to(torch.bfloat16))
        for gt, gj in zip(got_grads, vjp(jnp.asarray(g, jnp.bfloat16))):
            assert gt.dtype == torch.bfloat16 and gt.shape == (1, 2, 128, d)
            np.testing.assert_allclose(_np(gt), _np(gj), atol=BF16_GRAD, rtol=BF16_GRAD)

    @pytest.mark.parametrize("t", [1, 63, 64, 65, 127, 128, 129, 200])
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("d", [256, 192])
    def test_forward_at_the_wide_kernels_tile_edges_matches_the_pallas_kernel(
            self, d, dtype, causal, t):
        """K1 at D 256 and 192 (padded to 256; bf16 runs the wide forward
        on the card: 128-row q blocks, 64-row k tiles) at T on either side
        of those tiles' edges: o and lse of flash_fwd (here its plain
        version) against the Pallas _fwd_kernel in interpret mode, at the
        limits of the wide-width binding tests above."""
        arrs = _inputs(48 + t, (2, t, d))
        jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
            (jnp.bfloat16, torch.bfloat16)
        o_j, lse_j = jfa._flash_fwd(*_jax(arrs, jdt), causal, 128, 128, True,
                                    save_residuals=True)
        o_t, lse_t = fa.flash_fwd(*_torch(arrs, tdt), causal)
        assert o_t.dtype == tdt and o_t.shape == (2, t, d) and lse_t.shape == (2, t)
        tol = F32_OUT if dtype == "float32" else BF16_OUT
        rtol = 0.0 if dtype == "float32" else BF16_OUT
        np.testing.assert_allclose(_np(o_t), _np(o_j), atol=tol, rtol=rtol)
        np.testing.assert_allclose(_np(lse_t), _np(lse_j)[:, :, 0], atol=tol, rtol=rtol)

    def test_a_built_width_is_passed_through_without_a_copy(self):
        x = torch.randn(2, 8, 128)
        assert fa.pad_head(x, 128) is x and fa.unpad_head(x, 128) is x
        padded = fa.pad_head(x[..., :96].contiguous(), 128)
        assert padded.shape == (2, 8, 128) and torch.all(padded[..., 96:] == 0)


class TestBuild:
    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.delenv("CUDA_HOME", raising=False)
        monkeypatch.delenv("CUDA_PATH", raising=False)
        monkeypatch.setattr(_build, "NVCC_ROOTS", ())
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
        monkeypatch.setattr(_build, "_loaded", {})
        with pytest.raises(_build.KernelBuildError, match="nvcc"):
            _build.load("flash_attention")

    def test_library_name_follows_the_source_hash(self):
        p = _build.library_path("flash_attention")
        assert p.parent == _build.BUILD_DIR
        assert p.name.startswith("libflash_attention-") and p.suffix == ".so"

    def test_library_name_follows_the_headers(self, monkeypatch, tmp_path):
        """An edited, added or removed csrc/*.cuh renames every library,
        so no stale build of an including source is loaded."""
        (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
        (tmp_path / "h.cuh").write_text("// v1\n")
        (tmp_path / "notes.txt").write_text("not a header\n")
        monkeypatch.setattr(_build, "CSRC", tmp_path)
        first = _build.library_path("k")
        assert _build.library_path("k") == first
        (tmp_path / "notes.txt").write_text("edited\n")
        assert _build.library_path("k") == first
        (tmp_path / "h.cuh").write_text("// v2\n")
        second = _build.library_path("k")
        assert second != first
        (tmp_path / "g.cuh").write_text("// new\n")
        third = _build.library_path("k")
        assert third not in (first, second)
        (tmp_path / "g.cuh").unlink()
        assert _build.library_path("k") == second

    def test_build_links_libcuda_after_the_source(self, monkeypatch, tmp_path):
        """The tensor-map encoder lives in libcuda: -lcuda follows the
        source on nvcc's command line (a linker that drops unneeded
        libraries keeps only those named after their users)."""
        seen = []

        def fake_run(cmd, capture_output, text):
            seen.append(cmd)
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
            return subprocess.CompletedProcess(cmd, 0, "", "")

        monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(_build.subprocess, "run", fake_run)
        out = _build.build("flash_attention")
        assert out.exists() and out.parent == tmp_path
        cmd = seen[0]
        src = cmd.index(str(_build.CSRC / "flash_attention.cu"))
        assert cmd.index("-lcuda") > src
        assert "arch=compute_90a,code=sm_90a" in cmd
