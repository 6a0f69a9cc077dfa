"""chip_smoke.py's kernel check, on CPU.

The check holds each kernel's output to its plain version elementwise. In
bf16 the limit scales with the rms of the reference's own row, so it must
reject an output whose late causal rows are wrong even though those rows
are small beside the first ones, and must accept one bf16 rounding step.
Here the plain versions stand in for the kernels' outputs.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from tf_operator_tpu_torch.ops import flash_attention as fa

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
