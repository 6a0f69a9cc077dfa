"""Checkpoints and failures of the PyTorch port's multi-process trainer (gloo, CPU).

Rank 0 of the world is the only writer, and it writes full tensors (the
sharded leaves gathered), so a save made by two processes at fsdp = 2 or
tp = 2 resumes in one process with --allow-reshape and continues on the
uninterrupted one-process run (losses at rtol 1e-4, final parameters as
tests/torch_dist.py holds them); the `resumed` event says what reshaped.
Without the flag that save is the JAX trainer's foreign shape: skipped with
its message, then a cold start. Two ranks that see different checkpoint
directories fail the JAX trainer's visibility agreement, and a rank whose
peer died (a collective that fails) exits 138, retryable under
restartPolicy ExitCode.
"""

import pytest
import torch
from torch_dist import assert_ok, assert_same_tensors, progress_losses, run_world

from tf_operator_tpu_torch.models import checkpoint as ckpt

LR = 1e-3
ARGV = ["--device", "cpu", "--model", "transformer-lm", "--batch", "4", "--seq", "32",
        "--layers", "2", "--hidden", "64", "--heads", "4", "--log-every", "1",
        "--checkpoint-mode", "sync"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("one")
    runs = run_world(tmp, ARGV + ["--steps", "4", "--checkpoint-dir", str(tmp / "ck")], 1)
    assert_ok(runs)
    return progress_losses(runs[0]["events"]), ckpt.restore(str(tmp / "ck"), 4)


@pytest.mark.parametrize("mesh", [{"fsdp": 2}, {"tp": 2}], ids=["fsdp", "tp"])
def test_a_two_process_save_resumes_in_one_process(mesh, uninterrupted, tmp_path):
    ref_losses, ref_params = uninterrupted
    ck = str(tmp_path / "ck")
    assert_ok(run_world(tmp_path, ARGV + ["--steps", "2", "--checkpoint-dir", ck], 2, mesh,
                        tag="two"))
    runs = run_world(tmp_path, ARGV + ["--steps", "4", "--checkpoint-dir", ck,
                                       "--allow-reshape"], 1, tag="resume")
    assert_ok(runs)
    resumed = [e for e in runs[0]["events"] if e["event"] == "resumed"]
    assert len(resumed) == 1 and resumed[0]["from_step"] == 2
    assert not resumed[0]["params_only"]
    assert resumed[0]["reshaped"] == {"from_processes": 2, "from_mesh": mesh,
                                      "to_processes": 1, "to_mesh": {"dp": 1}}
    got = progress_losses(runs[0]["events"])
    assert sorted(got) == [4]  # step 3 is the first_step event's
    first = next(e for e in runs[0]["events"] if e["event"] == "first_step")
    torch.testing.assert_close(first["loss"], ref_losses[3], rtol=1e-4, atol=0)
    torch.testing.assert_close(got[4], ref_losses[4], rtol=1e-4, atol=0)
    assert_same_tensors(ckpt.restore(ck, 4), ref_params, LR, 4, noise=("attn.key.bias",))


def test_without_allow_reshape_a_foreign_save_is_skipped(tmp_path):
    ck = str(tmp_path / "ck")
    assert_ok(run_world(tmp_path, ARGV + ["--steps", "2", "--checkpoint-dir", ck], 2,
                        {"dp": 2}, tag="two"))
    runs = run_world(tmp_path, ARGV + ["--steps", "3", "--checkpoint-dir", ck], 1,
                     tag="resume")
    assert_ok(runs)
    fallbacks = [e for e in runs[0]["events"] if e["event"] == "resume_fallback"]
    assert fallbacks[0]["skipped_step"] == 2
    assert fallbacks[0]["reason"] == (
        "foreign_shape: saved on 2 process(es), mesh {'dp': 2} (running 1, {'dp': 1}); "
        "pass --allow-reshape to reshard")
    assert fallbacks[-1]["to_step"] == 0 and fallbacks[-1]["reason"] == "no_valid_checkpoint"
    assert not [e for e in runs[0]["events"] if e["event"] == "resumed"]


def test_ranks_that_see_different_checkpoints_refuse_to_resume(tmp_path):
    """Rank 0 sees a step-2 save, rank 1 an empty directory: rank 1 raises
    the visibility error, and rank 0, whose next collective then finds its
    peer gone, exits 138."""
    ck = str(tmp_path / "ck")
    assert_ok(run_world(tmp_path, ARGV + ["--steps", "2", "--checkpoint-dir", ck], 2,
                        {"dp": 2}, tag="two"))
    runs = run_world(tmp_path, ARGV + ["--steps", "4"], 2, {"dp": 2}, tag="split",
                     rank_argv=[["--checkpoint-dir", ck],
                                ["--checkpoint-dir", str(tmp_path / "empty")]])
    assert runs[1]["rc"] == 1
    assert ("checkpoint visibility differs across replicas (this process sees step -1, "
            "process 0 sees 2)") in runs[1]["stderr"]
    assert runs[0]["rc"] == 138, runs[0]["stderr"][-2000:]
    assert [e["event"] for e in runs[0]["events"]][-1] == "peer_lost"


# Rank 1 leaves (os._exit) right after the resume agreement's first
# collective, the visibility verdict, which it passed.
_LEAVES_AFTER_FIRST_AGREEMENT = (
    "import os, sys, torch\n"
    "from tf_operator_tpu_torch.models import train\n"
    "from tf_operator_tpu_torch.parallel import collectives\n"
    "train.COMPUTE_DTYPE = torch.float32\n"
    "real = collectives.all_gather_int\n"
    "def all_gather_int(*args, **kwargs):\n"
    "    out = real(*args, **kwargs)\n"
    "    if os.environ['JAX_PROCESS_ID'] == '1':\n"
    "        os._exit(3)\n"
    "    return out\n"
    "collectives.all_gather_int = all_gather_int\n"
    "sys.exit(train.main(sys.argv[1:]))\n")


def test_a_peer_that_leaves_after_the_first_agreement_exits_rank_0_retryably(tmp_path):
    """Both ranks see the step-2 save and agree on it; rank 1 then leaves
    before the second agreement (full vs params-only), and rank 0, whose
    agreement needs rank 1's part, exits 138 with peer_lost last."""
    ck = str(tmp_path / "ck")
    assert_ok(run_world(tmp_path, ARGV + ["--steps", "2", "--checkpoint-dir", ck], 2,
                        {"dp": 2}, tag="two"))
    runs = run_world(tmp_path, ARGV + ["--steps", "4", "--checkpoint-dir", ck], 2,
                     {"dp": 2}, tag="leave", code=_LEAVES_AFTER_FIRST_AGREEMENT)
    assert runs[1]["rc"] == 3
    assert runs[0]["rc"] == 138, runs[0]["stderr"][-2000:]
    assert [e["event"] for e in runs[0]["events"]][-1] == "peer_lost"
    assert not [e for e in runs[0]["events"] if e["event"] == "resumed"]


def test_a_peer_death_exits_retryably(tmp_path):
    runs = run_world(tmp_path, ARGV + ["--steps", "6", "--chaos",
                                       "kill:step=2,signal=KILL,index=1"], 2, {"dp": 2},
                     per_rank_env=[{"TPUJOB_REPLICA_TYPE": "worker",
                                    "TPUJOB_REPLICA_INDEX": str(r)} for r in range(2)])
    assert runs[1]["rc"] == -9
    assert runs[0]["rc"] == 138, runs[0]["stderr"][-2000:]
    lost = [e for e in runs[0]["events"] if e["event"] == "peer_lost"]
    assert len(lost) == 1 and lost[0]["exit_code"] == 138
    assert not [e for e in runs[0]["events"] if e["event"] == "done"]
