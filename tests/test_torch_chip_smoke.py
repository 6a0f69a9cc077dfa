"""chip_smoke.py's kernel checks, on CPU.

The check holds each kernel's output to its plain version elementwise. In
bf16 the flash limit scales with the rms of the reference's own row, so it
must reject an output whose late causal rows are wrong even though those
rows are small beside the first ones, and must accept one bf16 rounding
step. The fused bottleneck's check must accept y one bf16 step away and
reject each of chip_smoke.K4_MUTATIONS. Here the plain versions stand in
for the kernels' outputs.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from tf_operator_tpu_torch.ops import flash_attention as fa
from tf_operator_tpu_torch.ops import fused_bottleneck as fb

torch.set_num_threads(2)

BH, T, D = 2, 1024, 64


@pytest.fixture(scope="module")
def plain_outputs():
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((BH, T, D), dtype=np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_fwd_plain(q, k, v, True)
    dq, dk, dv = fa.flash_bwd_plain(q, k, v, o, lse, do, True)
    return {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}


@pytest.mark.parametrize("name", ["o", "lse", "dq", "dk", "dv"])
def test_check_accepts_agreement(plain_outputs, name):
    ref = plain_outputs[name]
    assert chip_smoke.excess(ref, ref, "bfloat16", chip_smoke._kind(name)) == 0.0


@pytest.mark.parametrize("name", ["o", "dq", "dk", "dv"])
def test_check_accepts_one_bf16_step(plain_outputs, name):
    ref = plain_outputs[name]
    # Every element moved one bf16 step away from zero.
    got = (ref.view(torch.int16) + 1).view(torch.bfloat16)
    assert (got != ref).all()
    assert chip_smoke.excess(got, ref, "bfloat16", chip_smoke._kind(name)) <= 1.0


def test_check_accepts_noise_on_a_row_that_cancels(plain_outputs):
    # Causal dq's row 0 is exactly zero (one visible key: P = 1, dP = delta);
    # the kernel leaves f32 rounding noise there.
    ref = plain_outputs["dq"]
    assert (ref[:, 0] == 0).all()
    got = ref.clone()
    got[:, 0] = 1e-7
    assert chip_smoke.excess(got, ref, "bfloat16", "grad") <= 1.0


@pytest.mark.parametrize("mutation", chip_smoke.MUTATIONS, ids=lambda m: f"{m[0]} {m[1]}")
def test_check_rejects_broken_output(plain_outputs, mutation):
    name, _, mutate = mutation
    assert chip_smoke.excess(mutate(plain_outputs[name]), plain_outputs[name],
                             "bfloat16", chip_smoke._kind(name)) > 1.0


def test_self_test_passes_on_true_outputs(plain_outputs):
    verdicts = chip_smoke.checker_self_test(plain_outputs, plain_outputs, "bfloat16")
    assert len(verdicts) == len(chip_smoke.MUTATIONS)
    assert min(verdicts.values()) > 1.0


@pytest.fixture(scope="module")
def k4_outputs():
    """The fused bottleneck's plain outputs on a post-relu bf16 x, one
    image a tile, with BN scale/bias as chip_smoke draws them."""
    rng = np.random.default_rng(0)
    b, h, w, cw, cn = 4, 14, 14, 64, 16

    def n(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(shape).astype(np.float32))

    x = n(b, h, w, cw).relu().to(torch.bfloat16)
    weights = [n(cw, cn, scale=cw ** -0.5), n(3, 3, cn, cn, scale=(9 * cn) ** -0.5),
               n(cn, cw, scale=cn ** -0.5)]
    bn = [n(cn).abs() + 0.5, n(cn, scale=0.1), n(cn).abs() + 0.5, n(cn, scale=0.1),
          n(cw).abs() + 0.5, n(cw, scale=0.1)]
    y, st = fb.fused_bottleneck(x, *(t.to(torch.bfloat16) for t in weights), *bn, tile_b=1)
    return {"y": y, "st1": st[0], "st2": st[1], "st3": st[2]}, x


@pytest.mark.parametrize("name", ["y", "st1", "st2", "st3"])
def test_k4_check_accepts_agreement(k4_outputs, name):
    outs, _ = k4_outputs
    assert chip_smoke.k4_excess(outs[name], outs[name], "bfloat16", name) == 0.0


def test_k4_check_accepts_one_bf16_step_of_y(k4_outputs):
    y = k4_outputs[0]["y"]
    got = torch.where(y == 0, y, (y.view(torch.int16) + 1).view(torch.bfloat16))
    assert (got != y).any()
    assert chip_smoke.k4_excess(got, y, "bfloat16", "y") <= 1.0


@pytest.mark.parametrize("mutation", chip_smoke.K4_MUTATIONS, ids=lambda m: f"{m[0]} {m[1]}")
def test_k4_check_rejects_broken_output(k4_outputs, mutation):
    outs, x = k4_outputs
    name, _, mutate = mutation
    assert chip_smoke.k4_excess(mutate(outs, x, 1), outs[name], "bfloat16", name) > 1.0


def test_k4_self_test_passes_on_true_outputs(k4_outputs):
    outs, x = k4_outputs
    verdicts = chip_smoke.k4_checker_self_test(outs, outs, x, 1, "bfloat16")
    assert len(verdicts) == len(chip_smoke.K4_MUTATIONS)
    assert min(verdicts.values()) > 1.0


def test_k4_check_rejects_a_non_finite_output(k4_outputs):
    outs, _ = k4_outputs
    st = outs["st3"].clone()
    st[0, 0, 0] = float("nan")
    assert not chip_smoke.k4_excess(st, outs["st3"], "bfloat16", "st3") <= 1.0
