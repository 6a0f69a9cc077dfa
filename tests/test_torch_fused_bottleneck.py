"""The fused bottleneck's plain version and wrapper on CPU against the
Pallas kernel, run as tests/test_ops.py runs it (interpret mode).

The same numpy inputs go to both sides. f32 at 1e-4, as test_ops.py holds
the Pallas kernel against its own reference. In bf16 both sides round n1,
n2 and y to bf16 at the same points from f32 values that differ only in
summation order, so y is held within one bf16 step (rtol 1e-2, plus 1e-2
absolute for elements near 0) and the f32 moments at 1e-4. On CPU the
wrapper runs the plain version and counts no launch; the CUDA kernel is
held against the plain version on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.ops import fused_bottleneck as jfb
from tf_operator_tpu_torch.ops import fused_bottleneck as fb

torch.set_num_threads(2)


def _args(b=4, h=8, w=8, cw=32, cn=16, seed=0):
    """x, w1, w2, w3 and the BN scale/bias vectors as in test_ops.py:
    weights 0.1 N, scales |N| + 0.5, biases 0.1 N."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return [n(b, h, w, cw), n(cw, cn) * 0.1, n(3, 3, cn, cn) * 0.1, n(cn, cw) * 0.1,
            np.abs(n(cn)) + 0.5, n(cn) * 0.1, np.abs(n(cn)) + 0.5, n(cn) * 0.1,
            np.abs(n(cw)) + 0.5, n(cw) * 0.1]


def _both(args, tile_b, dtype_name):
    """(Pallas interpret-mode outputs, wrapper outputs) as numpy f32."""
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    if dtype_name == "bfloat16":
        jargs = [a.astype(jnp.bfloat16) if i < 4 else a for i, a in enumerate(jargs)]
        targs = [a.to(torch.bfloat16) if i < 4 else a for i, a in enumerate(targs)]
    yj, stj = jfb._fwd(*jargs, tile_b=tile_b, interpret=True)
    yt, stt = fb.fused_bottleneck(*targs, tile_b=tile_b)
    assert yt.dtype == targs[0].dtype and yt.shape == targs[0].shape
    return ((np.array(yj.astype(jnp.float32)), [np.array(s) for s in stj]),
            (yt.float().numpy(), [s.numpy() for s in stt]))


@pytest.mark.parametrize("shape,tile_b", [
    ((4, 8, 8, 32, 16), 2),   # test_ops.py's sizes
    ((4, 7, 7, 32, 16), 2),   # the 7x7 of ResNet's last stage
    ((4, 7, 7, 48, 24), 1),   # one image a tile, channels no power of two
])
def test_f32_matches_pallas_interpret(shape, tile_b):
    (yj, stj), (yt, stt) = _both(_args(*shape), tile_b, "float32")
    np.testing.assert_allclose(yt, yj, rtol=1e-4, atol=1e-4)
    for a, b in zip(stt, stj):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,tile_b", [
    ((4, 8, 8, 32, 16), 2), ((2, 7, 7, 64, 32), 1),
    ((4, 7, 7, 256, 64), 2),  # widths the wgmma route takes, 98 rows a tile
])
def test_bf16_matches_pallas_interpret(shape, tile_b):
    (yj, stj), (yt, stt) = _both(_args(*shape), tile_b, "bfloat16")
    np.testing.assert_allclose(yt, yj, rtol=1e-2, atol=1e-2)
    for a, b in zip(stt, stj):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_combine_stats_gives_batch_moments():
    args = _args()
    _, (st1, _, _) = fb.fused_bottleneck(*map(torch.from_numpy, args), tile_b=2)
    m, v = fb.combine_stats(st1)
    jm, jv = jfb.combine_stats(jnp.asarray(st1.numpy()))
    np.testing.assert_allclose(m.numpy(), np.array(jm), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(v.numpy(), np.array(jv), rtol=1e-6, atol=1e-7)
    # ... which are the full-batch moments of the first 1x1's output.
    x, w1 = args[0], args[1]
    t1 = x.reshape(-1, x.shape[-1]).astype(np.float64) @ w1.astype(np.float64)
    np.testing.assert_allclose(m.numpy(), t1.mean(0), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(v.numpy(), t1.var(0), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("h,w,batch", [(56, 56, 256), (28, 28, 256), (14, 14, 256),
                                       (7, 7, 256), (7, 7, 12), (8, 8, 5)])
def test_default_tile_matches_jax(h, w, batch):
    assert fb.default_tile(h, w, batch) == jfb.default_tile(h, w, batch)


@pytest.mark.parametrize("tile_b", [3, 0])
def test_tile_that_does_not_divide_the_batch_raises(tile_b):
    with pytest.raises(ValueError, match="divide"):
        fb.fused_bottleneck(*map(torch.from_numpy, _args()), tile_b=tile_b)


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    fb.reset_launches()
    targs = list(map(torch.from_numpy, _args()))
    y, st = fb.fused_bottleneck(*targs, tile_b=2)
    y_p, st_p = fb.fused_bottleneck_reference(*targs, tile_b=2)
    torch.testing.assert_close(y, y_p, rtol=0, atol=0)
    for a, b in zip(st, st_p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fb.LAUNCHES == {"fwd": 0}


def test_border_pixels_read_zero_padding_of_n1():
    """The 3x3 pads n1 (after BN and relu) with zeros: with a constant x
    the interior pixels of t2 agree and the border ones differ."""
    b, h, w, cw, cn = 1, 5, 5, 8, 4
    args = [np.ones((b, h, w, cw), np.float32), np.full((cw, cn), 0.1, np.float32),
            np.full((3, 3, cn, cn), 0.1, np.float32), np.full((cn, cw), 0.1, np.float32)]
    args += [np.ones(cn, np.float32), np.ones(cn, np.float32)] * 2
    args += [np.ones(cw, np.float32), np.zeros(cw, np.float32)]
    (yj, _), (yt, _) = _both(args, 1, "float32")
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5)
    # n1 = relu(0 * a + 1) = 1 everywhere; t2 counts the in-image taps.
    t2 = torch.nn.functional.conv2d(torch.ones(1, cn, h, w), torch.full((cn, cn, 3, 3), 0.1),
                                    padding=1)
    assert t2[0, 0, 2, 2] > t2[0, 0, 0, 0] > 0


@pytest.mark.parametrize("cw,cn", [(256, 64), (2048, 512), (320, 64), (64, 192)])
def test_bf16_takes_the_wgmma_route(cw, cn):
    assert fb.route(torch.bfloat16, cw, cn) == "wgmma"


@pytest.mark.parametrize("cw,cn", [(96, 24), (256, 96), (200, 64), (256, 32)])
def test_bf16_channels_off_the_wgmma_tiles_raise(cw, cn):
    """They no longer raise: the call pads Cn and Cw up to multiples of
    64 and takes the wgmma route (only a channel count below 1 raises)."""
    assert fb.route(torch.bfloat16, cw, cn) == "wgmma"
    padded = fb.pad_channels(*map(torch.from_numpy, _args(b=2, h=3, w=3, cw=cw, cn=cn)))
    assert padded[1].shape == (-(-cw // 64) * 64, -(-cn // 64) * 64)
    with pytest.raises(ValueError, match="positive"):
        fb.route(torch.bfloat16, cw, 0)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_channel_padding_equals_the_plain_version_unpadded(dtype_name):
    """Cn 40 and Cw 96 padded to 64 and 128 and sliced back: the plain
    version on the padded operands equals it on the unpadded ones, f32 to
    1e-5 (the zero channels add exact zeros; only the products' blocking
    may change the summation order), bf16 within one bf16 step."""
    targs = list(map(torch.from_numpy, _args(b=4, h=7, w=7, cw=96, cn=40, seed=3)))
    if dtype_name == "bfloat16":
        targs = [a.to(torch.bfloat16) if i < 4 else a for i, a in enumerate(targs)]
    padded = fb.pad_channels(*targs)
    assert padded[0].shape == (4, 7, 7, 128) and padded[2].shape == (3, 3, 64, 64)
    for t, n in zip(padded[4:], (64, 64, 64, 64, 128, 128)):
        assert t.shape == (n,)
    y, st = fb.padded_call(fb.fused_bottleneck_reference, *targs, tile_b=2)
    y_p, st_p = fb.fused_bottleneck_reference(*targs, tile_b=2)
    assert y.shape == y_p.shape and y.dtype == y_p.dtype
    rtol, atol = (1e-2, 1e-2) if dtype_name == "bfloat16" else (0.0, 1e-5)
    torch.testing.assert_close(y.float(), y_p.float(), rtol=rtol, atol=atol)
    for a, b in zip(st, st_p):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-4 if dtype_name == "bfloat16" else 0.0,
                                   atol=1e-5)
    # The padded channels themselves come out zero.
    y_full, st_full = fb.fused_bottleneck_reference(*padded, tile_b=2)
    assert torch.all(y_full[..., 96:] == 0)
    assert all(torch.all(s[..., c:] == 0) for s, c in zip(st_full, (40, 40, 96)))


@pytest.mark.parametrize("cw,cn", [(96, 24), (256, 64)])
def test_f32_takes_the_fma_route(cw, cn):
    assert fb.route(torch.float32, cw, cn) == "fma"


def test_other_dtypes_raise():
    with pytest.raises(ValueError, match="f32 or bf16"):
        fb.route(torch.float16, 256, 64)


@pytest.mark.parametrize("b,h,w,cw,cn,tile_b", [
    (256, 56, 56, 256, 64, 1), (256, 7, 7, 2048, 512, 64), (6, 7, 7, 256, 64, 2)])
def test_bf16_workspace_holds_no_wide_f32_buffer(b, h, w, cw, cn, tile_b):
    """The wgmma route recomputes t3: no [rows, Cw] f32 buffer, one f32 t
    and one bf16 n of [rows, Cn], and moment partials per 128-row block."""
    rows = b * h * w
    plan = fb.workspace_plan(b, h, w, cw, cn, tile_b, torch.bfloat16)
    assert list(plan) == ["t", "n", "part", "mult"]
    assert ((rows, cw), torch.float32) not in plan.values()
    assert plan["t"] == ((rows, cn), torch.float32)
    assert plan["n"] == ((rows, cn), torch.bfloat16)
    blocks = -(-(tile_b * h * w) // 128)
    assert plan["part"] == ((b // tile_b * blocks * 2 * max(cn, cw),), torch.float32)
    assert max(s[0][0] * (s[0][1] if len(s[0]) > 1 else 1) * s[1].itemsize
               for s in plan.values()) <= rows * cn * 4


def test_f32_workspace_keeps_the_fma_buffers():
    plan = fb.workspace_plan(4, 7, 7, 96, 24, 2, torch.float32)
    assert list(plan) == ["t1", "t2", "t3", "part", "mult"]
    assert plan["t3"] == ((4 * 49, 96), torch.float32)
    assert plan["part"][0] == (2 * 2 * 2 * 96,)  # 98 rows: two 64-row blocks a tile
