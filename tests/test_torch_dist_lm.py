"""The PyTorch port's trainer across processes (gloo, CPU): the tiny LM.

A9's gate, part 1, for the transformer-lm: trainer processes started
through the operator's env (JAX_COORDINATOR_ADDRESS, JAX_PROCESS_ID,
JAX_NUM_PROCESSES, TPUJOB_MESH) train the model one process trains at the
same global batch and seed: the loss of every step at rtol 1e-4, and the
final parameters, read from the checkpoint rank 0 writes gathered, as
tests/torch_dist.py's assert_same_tensors holds them (Adam's reach, rtol
1e-4 in norm). Compute runs in f32 (tests/torch_dist.py says why). The
events carry the live mesh and device count, the manifest the mesh and
each leaf's spec, and every rank exits 0 after the closing barrier. Two
processes at dp = 2, fsdp = 2 and tp = 2 here;
tests/test_torch_dist_mesh.py runs four on two axes.
"""

import json
import math

import pytest
import torch
from torch_dist import assert_ok, assert_same_losses, assert_same_tensors, run_world

from tf_operator_tpu_torch.models import checkpoint as ckpt

STEPS, LR = 4, 1e-3
ARGV = ["--device", "cpu", "--model", "transformer-lm", "--batch", "4", "--seq", "32",
        "--layers", "2", "--hidden", "64", "--heads", "4", "--steps", str(STEPS),
        "--log-every", "1", "--checkpoint-mode", "sync"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("one")
    runs = run_world(tmp, ARGV + ["--checkpoint-dir", str(tmp / "ck")], 1)
    assert_ok(runs)
    return runs, ckpt.restore(str(tmp / "ck"), STEPS)


MESHES = {"dp": {"dp": 2}, "fsdp": {"fsdp": 2}, "tp": {"tp": 2}}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_processes_train_the_one_process_model(name, reference, tmp_path):
    check_world(MESHES[name], reference, tmp_path)


def check_world(mesh, reference, tmp_path):
    ref_runs, ref_params = reference
    n = math.prod(mesh.values())
    runs = run_world(tmp_path, ARGV + ["--checkpoint-dir", str(tmp_path / "ck")], n, mesh)
    assert_ok(runs)
    assert_same_losses(runs, ref_runs, rtol=1e-4)
    for r in runs:
        first = next(e for e in r["events"] if e["event"] == "first_step")
        assert first["mesh"] == mesh and first["n_devices"] == n
        ready = next(e for e in r["events"] if e["event"] == "jax_ready")
        assert ready["dist_backend"] == "gloo"
    # Rank 0 is the one writer.
    assert [e["event"] for e in runs[1]["events"]].count("checkpoint") == 0
    assert_same_tensors(ckpt.restore(str(tmp_path / "ck"), STEPS), ref_params, LR, STEPS,
                        noise=("attn.key.bias",))
    sm = json.loads((tmp_path / "ck" / "step_4.sharding.json").read_text())
    assert (sm["processCount"], sm["deviceCount"], sm["mesh"]) == (n, n, mesh)
    spec = sm["leaves"]["['trunk.layers.0.attn.query.weight']"]["spec"]
    # flax's query kernel [in, out] is P(None, "tp"), fsdp composed on its
    # first largest free dimension; the port's weight is [out, in].
    assert spec == ["tp" if "tp" in mesh else None, "fsdp" if "fsdp" in mesh else None]
