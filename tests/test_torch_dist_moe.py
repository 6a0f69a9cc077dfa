"""The PyTorch port's MoE LM across processes (gloo, CPU).

Trainer processes started through the operator's env train the tiny MoE LM
(2 layers, the second an MoE layer of 8 experts, top-2) that one process
trains at the same global batch and seed, in f32 (tests/torch_dist.py says
why): every step's loss at rtol 1e-4, and the final parameters, which rank
0 writes gathered to full tensors, as tests/torch_dist.py's
assert_same_tensors holds them. The worlds are the JAX layout's:

  - ep = 2, both dispatches, and ep = 4: each rank holds 4 (2) experts
    and the layer's output is summed over ep (ep ranks hold the same
    rows);
  - ep x tp = 2 x 2: the experts also split their ffn columns over tp;
  - dp x ep = 2 x 2: the Switch balance loss is the global batch's (its
    fraction averaged over dp); a planted fault that keeps each rank's own
    fraction moves the router off the one-process run and is rejected;
  - sp x ep = 2 x 2, dense: capacity and slots over the whole rows;
  - fsdp = 2: the expert weights sharded, gathered by their block.

A checkpoint saved at ep = 2 holds the full expert tensors and resumes in
one process with --allow-reshape onto the uninterrupted run.
"""

import json
import math
from pathlib import Path

import pytest
import torch
import yaml
from torch_dist import assert_ok, assert_same_losses, assert_same_tensors, run_world

from tf_operator_tpu_torch.models import checkpoint as ckpt
from tf_operator_tpu_torch.models import train

STEPS, LR = 3, 1e-3
ARGV = ["--device", "cpu", "--model", "moe-lm", "--batch", "4", "--seq", "32",
        "--layers", "2", "--hidden", "64", "--heads", "4", "--log-every", "1",
        "--checkpoint-mode", "sync"]
NOISE = ("attn.key.bias",)
EXPERTS = "trunk.layers.1.moe.experts_in"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _argv(dispatch: str, steps: int = STEPS) -> list[str]:
    return ARGV + ["--moe-dispatch", dispatch, "--steps", str(steps)]


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """One process's runs and final parameters, by dispatch."""
    out = {}
    for dispatch in ("sparse", "dense"):
        tmp = tmp_path_factory.mktemp(f"one-{dispatch}")
        runs = run_world(tmp, _argv(dispatch) + ["--checkpoint-dir", str(tmp / "ck")], 1)
        assert_ok(runs)
        out[dispatch] = runs, ckpt.restore(str(tmp / "ck"), STEPS)
    return out


def _world(tmp_path, dispatch: str, mesh: dict, code: str | None = None):
    """(runs, final parameters) of `mesh`'s world."""
    n = math.prod(mesh.values())
    runs = run_world(tmp_path, _argv(dispatch) + ["--checkpoint-dir", str(tmp_path / "ck")],
                     n, mesh, code=code)
    assert_ok(runs)
    for r in runs:
        first = next(e for e in r["events"] if e["event"] == "first_step")
        assert first["mesh"] == mesh and first["n_devices"] == n
    return runs, ckpt.restore(str(tmp_path / "ck"), STEPS)


WORLDS = {
    "ep-sparse": ("sparse", {"ep": 2}),
    "ep4": ("sparse", {"ep": 4}),
    "ep-dense": ("dense", {"ep": 2}),
    "ep-tp": ("sparse", {"ep": 2, "tp": 2}),
    "dp-ep": ("sparse", {"dp": 2, "ep": 2}),
    "sp-ep-dense": ("dense", {"ep": 2, "sp": 2}),
    "fsdp": ("sparse", {"fsdp": 2}),
}


@pytest.mark.parametrize("name", list(WORLDS))
def test_processes_train_the_one_process_moe_model(name, references, tmp_path):
    dispatch, mesh = WORLDS[name]
    ref_runs, ref_params = references[dispatch]
    runs, params = _world(tmp_path, dispatch, mesh)
    assert_same_losses(runs, ref_runs, rtol=1e-4)
    assert_same_tensors(params, ref_params, LR, STEPS, noise=NOISE)
    sm = ckpt.read_sharding_manifest(str(tmp_path / "ck"), f"step_{STEPS}")
    spec = sm["leaves"][f"['{EXPERTS}']"]["spec"]
    assert spec[0] == ("ep" if "ep" in mesh else None)
    assert spec[2] == ("tp" if "tp" in mesh else "fsdp" if "fsdp" in mesh else None)


# Each rank's balance loss from its own rows' fraction: the fault the
# global-batch average (MoEMlp.stats) repairs.
_LOCAL_FRACTION = (
    "import sys, torch\n"
    "from tf_operator_tpu_torch.models import moe, train\n"
    "train.COMPUTE_DTYPE = torch.float32\n"
    "moe.MoEMlp._aux_losses = lambda self, aux: (\n"
    "    moe.load_balance_loss(aux, self.cfg.num_experts), moe.router_z_loss(aux))\n"
    "sys.exit(train.main(sys.argv[1:]))\n")


def test_a_local_balance_loss_is_rejected(references, tmp_path):
    """At dp x ep the fault changes each rank's balance term but not its
    mean's value by much; its gradient reaches the router, whose final
    weights then fail the check that the sound world passes."""
    ref_runs, ref_params = references["sparse"]
    _, params = _world(tmp_path, "sparse", {"dp": 2, "ep": 2}, code=_LOCAL_FRACTION)
    router = {k: v for k, v in ref_params.items() if k.endswith("moe.router")}
    with pytest.raises(AssertionError):
        assert_same_tensors({k: params[k] for k in router}, router, LR, STEPS)


def test_an_ep_save_resumes_in_one_process(references, tmp_path):
    ref_runs, ref_params = references["sparse"]
    ck = str(tmp_path / "ck")
    assert_ok(run_world(tmp_path, _argv("sparse", 2) + ["--checkpoint-dir", ck], 2,
                        {"ep": 2}, tag="two"))
    saved = ckpt.restore(ck, 2)
    assert tuple(saved[EXPERTS].shape) == (8, 64, 256)  # the full expert tensor
    runs = run_world(tmp_path, _argv("sparse") + ["--checkpoint-dir", ck, "--allow-reshape"],
                     1, tag="resume")
    assert_ok(runs)
    resumed = [e for e in runs[0]["events"] if e["event"] == "resumed"]
    assert len(resumed) == 1 and resumed[0]["from_step"] == 2
    assert resumed[0]["reshaped"] == {"from_processes": 2, "from_mesh": {"ep": 2},
                                      "to_processes": 1, "to_mesh": {"dp": 1}}
    first = next(e for e in runs[0]["events"] if e["event"] == "first_step")
    want = next(e["loss"] for e in ref_runs[0]["events"]
                if e["event"] == "progress" and e["step"] == STEPS)
    torch.testing.assert_close(first["loss"], want, rtol=1e-4, atol=0)
    assert_same_tensors(ckpt.restore(ck, STEPS), ref_params, LR, STEPS, noise=NOISE)


def test_example_manifest_runs_the_trainer_at_ep(monkeypatch):
    """examples/torch-moe-lm.yaml: two Workers at mesh {ep: 2} whose command
    (the bench's MoE cell, sparse) the port trainer accepts under the env
    the operator gives them."""
    spec = yaml.safe_load((Path(__file__).resolve().parents[1] / "examples"
                           / "torch-moe-lm.yaml").read_text())["spec"]
    axes = spec["mesh"]["axes"]
    worker = spec["replicaSpecs"]["Worker"]
    assert axes == {"ep": 2} and worker["replicas"] == 2
    cmd = worker["template"]["spec"]["containers"][0]["command"]
    argv = cmd[cmd.index("tf_operator_tpu_torch.models.train") + 1:]
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("TPUJOB_MESH", json.dumps(axes))
    ap = train.build_parser()
    args = ap.parse_args(argv)
    train.check_flags(ap, args)
    assert (args.model, args.moe_dispatch, args.seq, args.batch, args.layers, args.hidden,
            args.heads) == ("moe-lm", "sparse", 2048, 8, 12, 768, 6)
