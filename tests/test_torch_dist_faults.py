"""Faults across the PyTorch port's processes (gloo, CPU).

A planted fault the gates must catch: ResNet-18 whose batch norms use each
rank's own moments fails tests/test_torch_dist_models.py's losses and
change gap.

A lost peer (its sockets closed or reset, or a receive past the group's
timeout) exits 138, retryable under restartPolicy ExitCode, so the
operator rolls the gang. Every other error of a collective (out of memory,
shapes that differ between ranks) would fail again after a roll: it
propagates, the rank exits 1 and fails the job, and only its peer, which
then finds the rank gone, exits 138.
"""

import pytest
import torch
import torch.distributed as dist
from test_torch_dist_models import CHANGE_GAP
from torch_dist import assert_ok, change_gap, initial_params, progress_losses, run_world

from tf_operator_tpu_torch.models import checkpoint as ckpt
from tf_operator_tpu_torch.parallel import collectives

ARGV = ["--device", "cpu", "--model", "transformer-lm", "--batch", "4", "--seq", "32",
        "--layers", "2", "--hidden", "64", "--heads", "4", "--log-every", "1",
        "--steps", "3"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The planted fault: each rank normalises by its own rows' moments.
_NO_BN_SYNC = """
import sys, torch
from tf_operator_tpu_torch.models import train
from tf_operator_tpu_torch.parallel import train_step as ts
train.COMPUTE_DTYPE = torch.float32
real = ts.parallelize

def parallelize(model, *args, **kwargs):
    plan = real(model, *args, **kwargs)
    for mod in model.modules():
        if hasattr(mod, "sync"):
            mod.sync = None
    return plan

ts.parallelize = parallelize
sys.exit(train.main(sys.argv[1:]))
"""


def test_resnet18_without_synced_batch_norm_fails_the_gates(tmp_path):
    """Batch norm over each rank's rows alone trains another model: the
    losses leave rtol 1e-4 and the update leaves CHANGE_GAP."""
    steps = 3
    args = ["--device", "cpu", "--model", "resnet18", "--steps", str(steps), "--log-every",
            "1", "--checkpoint-mode", "sync", "--image-size", "32", "--batch", "8"]
    one = run_world(tmp_path, args + ["--checkpoint-dir", str(tmp_path / "one")], 1, tag="one")
    bad = run_world(tmp_path, args + ["--checkpoint-dir", str(tmp_path / "bad")], 2,
                    {"dp": 2}, tag="bad", code=_NO_BN_SYNC)
    assert_ok(one + bad)
    want, got = progress_losses(one[0]["events"]), progress_losses(bad[0]["events"])
    assert max(abs(got[s] - want[s]) / abs(want[s]) for s in want) > 1e-4
    gap = change_gap(ckpt.restore(str(tmp_path / "bad"), steps),
                     ckpt.restore(str(tmp_path / "one"), steps), initial_params(args))
    assert gap > CHANGE_GAP, gap


# (what the backend raised, whether it is a lost peer); the messages are
# gloo's and NCCL's own.
ERRORS = {
    "gloo-reset": (RuntimeError("[gloo/transport/tcp/pair.cc:537] Read error "
                                "[127.0.0.1]:59556: Connection reset by peer."), True),
    "gloo-closed": (RuntimeError("[gloo/transport/tcp/pair.cc:589] Connection closed by "
                                 "peer [127.0.0.1]:41312"), True),
    "gloo-timeout": (RuntimeError("[gloo/transport/tcp/unbound_buffer.cc:78] Timed out "
                                  "waiting 5000ms for recv operation to complete"), True),
    "nccl-remote": (dist.DistBackendError("NCCL error in: ProcessGroupNCCL.cpp:1970, remote "
                                          "process exited or there was a network error"),
                    True),
    "store": (dist.DistStoreError("wait timeout after 300000ms, keys: /barrier"), True),
    "network": (dist.DistNetworkError("failed to recv, got 0 bytes"), True),
    "oom": (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 440.00 MiB"),
            False),
    "shape": (RuntimeError("The size of tensor a (8) must match the size of tensor b (4) at "
                           "non-singleton dimension 0"), False),
    "cuda": (RuntimeError("CUDA error: an illegal memory access was encountered"), False),
    "nccl-usage": (dist.DistBackendError("NCCL error in: ProcessGroupNCCL.cpp:1970, invalid "
                                         "usage"), False),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_only_a_lost_peer_becomes_peer_lost_error(name):
    err, lost = ERRORS[name]

    def all_reduce():
        raise err

    with pytest.raises(collectives.PeerLostError if lost else type(err)) as got:
        collectives._call(all_reduce)
    assert isinstance(got.value, collectives.PeerLostError) == lost
    assert (got.value.__cause__ is err) if lost else (got.value is err)


# Rank 0's gradient bucket all-reduce raises sys.argv[1]'s error.
_FAILING_BUCKET = """
import os, sys, torch, torch.distributed as dist
from tf_operator_tpu_torch.models import train
kind = sys.argv.pop(1)
real = dist.all_reduce

def all_reduce(t, *args, **kwargs):
    if os.environ["JAX_PROCESS_ID"] == "0" and t.numel() > 1000:
        if kind == "oom":
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 440.00 MiB")
        raise RuntimeError("The size of tensor a (8) must match the size of tensor b (4)")
    return real(t, *args, **kwargs)

dist.all_reduce = all_reduce
train.COMPUTE_DTYPE = torch.float32
sys.exit(train.main(sys.argv[1:]))
"""


@pytest.mark.parametrize("kind", ["oom", "shape"])
def test_a_permanent_error_in_a_collective_fails_the_job(kind, tmp_path):
    runs = run_world(tmp_path, [kind] + ARGV, 2, {"dp": 2}, code=_FAILING_BUCKET)
    assert runs[0]["rc"] == 1, runs[0]["stderr"][-2000:]
    assert ("OutOfMemoryError" if kind == "oom" else "must match") in runs[0]["stderr"]
    assert not [e for e in runs[0]["events"] if e["event"] == "peer_lost"]
    assert runs[1]["rc"] == 138, runs[1]["stderr"][-2000:]
    assert [e["event"] for e in runs[1]["events"]][-1] == "peer_lost"
