"""The PyTorch port's trainer across two processes in its shipping dtype (gloo, CPU).

The other multi-process tests set the trainer's compute dtype to f32 so
that rtol 1e-4 can hold; this one runs the bf16 path the trainer ships,
the tiny LM at dp = 2, fsdp = 2 and tp = 2 against one bf16 process at the
same global batch and seed: every step's loss within BF16_LOSS_RTOL and
the update as a whole (tests/torch_dist.py's change_gap) within
BF16_CHANGE_GAP. The limits sit between the sound runs' readings (loss
3.2e-5 at dp and fsdp, 7.2e-5 at tp; change gap 0.009 and 0.019) and a
planted fault's (each rank stepping on its own rows' gradients: loss
2.8e-3, change gap 0.41), which the last test must see rejected.
"""

import pytest
import torch
from torch_dist import (
    assert_ok,
    assert_same_losses,
    change_gap,
    initial_params,
    progress_losses,
    run_world,
)

from tf_operator_tpu_torch.models import checkpoint as ckpt

STEPS = 4
ARGV = ["--device", "cpu", "--model", "transformer-lm", "--batch", "8", "--seq", "32",
        "--layers", "2", "--hidden", "64", "--heads", "4", "--steps", str(STEPS),
        "--log-every", "1", "--checkpoint-mode", "sync"]
BF16_LOSS_RTOL = 5e-4
BF16_CHANGE_GAP = 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("one")
    runs = run_world(tmp, ARGV + ["--checkpoint-dir", str(tmp / "ck")], 1, f32=False)
    assert_ok(runs)
    return runs, ckpt.restore(str(tmp / "ck"), STEPS), initial_params(ARGV, torch.bfloat16)


MESHES = {"dp": {"dp": 2}, "fsdp": {"fsdp": 2}, "tp": {"tp": 2}}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_bf16_processes_train_the_one_process_model(name, reference, tmp_path):
    ref_runs, ref_params, init = reference
    runs = run_world(tmp_path, ARGV + ["--checkpoint-dir", str(tmp_path / "ck")], 2,
                     MESHES[name], f32=False)
    assert_ok(runs)
    assert_same_losses(runs, ref_runs, rtol=BF16_LOSS_RTOL)
    assert change_gap(ckpt.restore(str(tmp_path / "ck"), STEPS), ref_params,
                      init) <= BF16_CHANGE_GAP


# The planted fault: each rank steps on its own rows' gradients.
_NO_GRAD_REDUCE = """
import sys
from tf_operator_tpu_torch.models import train
from tf_operator_tpu_torch.parallel import train_step as ts
ts.ParallelPlan.reduce_grads = lambda self, grads: grads
sys.exit(train.main(sys.argv[1:]))
"""


def test_bf16_gates_reject_ranks_that_skip_the_gradient_reduction(reference, tmp_path):
    ref_runs, ref_params, init = reference
    runs = run_world(tmp_path, ARGV + ["--checkpoint-dir", str(tmp_path / "ck")], 2,
                     {"dp": 2}, code=_NO_GRAD_REDUCE)
    assert_ok(runs)
    want, got = progress_losses(ref_runs[0]["events"]), progress_losses(runs[0]["events"])
    assert max(abs(got[s] - want[s]) / abs(want[s]) for s in want) > BF16_LOSS_RTOL
    gap = change_gap(ckpt.restore(str(tmp_path / "ck"), STEPS), ref_params, init)
    assert gap > BF16_CHANGE_GAP, gap
