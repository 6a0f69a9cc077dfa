"""The PyTorch port across two processes (gloo, CPU): BERT, ResNet, MNIST.

A9's gate, part 1, for the models whose data parallelism touches more than
the gradients, each run as two processes through the operator's env at
dp = 2 and held against one process at the same global batch and seed:
every step's loss at rtol 1e-4 and the final parameters at rtol 1e-4 of
each tensor's scale (tests/torch_dist.py), in f32 compute.

  - bert-tiny with dropout 0.1, at dp = 2 and tp = 2: the masks are drawn
    for the global batch and each rank takes its rows, the MLM loss is the
    global masked mean (each rank's share weighted by its count of masked
    tokens), and the gradient norm is the global one. The
    trainer runs BERT without dropout, as the JAX trainer does, so this
    case drives parallel/train_step.py's plan directly; bert-tiny through
    the trainer is the second case.
  - resnet18 at 32x32: batch norm's moments are all-reduced over the data
    axis, so the statistics (and the running averages) are the global
    batch's, as JAX's mean over a sharded batch is. Its elementwise gate is
    Adam's reach alone (tests/torch_dist.py), so the update as a whole is
    held too: change_gap within CHANGE_GAP, which the planted fault
    (batch norm's moments left per rank, tests/test_torch_dist_faults.py)
    exceeds.
  - mnist-mlp from --data-dir: each process reads its own shards, --batch / 2
    rows a step; the reference trains one process on the two readers' rows
    concatenated, in process.
"""

import numpy as np
import pytest
import torch
from torch_dist import (
    assert_ok,
    assert_same_losses,
    assert_same_tensors,
    change_gap,
    initial_params,
    run_world,
)

from tf_operator_tpu_torch import optim
from tf_operator_tpu_torch.data import dataset as dataset_lib
from tf_operator_tpu_torch.models import checkpoint as ckpt
from tf_operator_tpu_torch.models import train
from tf_operator_tpu_torch.parallel import train_step as ts

LR = 1e-3
# |two - one| / |one - init| over the final parameters, in f32 compute.
# resnet18 read 0.029 sound and 0.905 with batch norm's moments per rank;
# bert-tiny is held elementwise at rtol 1e-4 besides.
CHANGE_GAP = 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_BERT_DROPOUT = """
import dataclasses, sys, torch
from tf_operator_tpu_torch import optim
from tf_operator_tpu_torch.models import transformer as tfm
from tf_operator_tpu_torch.parallel import distributed, sharding_rules
from tf_operator_tpu_torch.parallel import mesh as mesh_lib, train_step as ts
torch.set_num_threads(1)
distributed.initialize_from_env()
cfg = dataclasses.replace(tfm.TINY, dtype=torch.float32, dropout_rate=0.1, max_len=32)
model = tfm.BertMLM(cfg, generator=torch.Generator().manual_seed(0))
plan = ts.parallelize(model, mesh_lib.mesh_from_env(), sharding_rules.TRANSFORMER_TP_RULES)
tx = optim.make_optimizer(optim.OptimizerConfig(learning_rate=1e-3))
state = ts.create_train_state(model, tx, plan)

def make_batch(g):
    return {**tfm.make_mlm_batch(g, 8, 32, cfg.vocab_size),
            "dropout_seed": torch.randint(0, 2 ** 62, (), generator=g)}

def loss_fn(m, b):
    gen = torch.Generator().manual_seed(int(b["dropout_seed"]))
    return tfm.mlm_loss(m(b["tokens"], deterministic=False, generator=gen), b["targets"],
                        b["mask"])

run = ts.make_chunked_train_step(loss_fn, tx, make_batch, "cpu", plan=plan)
losses, norms = [], []
for _ in range(3):
    state, metrics = run(state, 1)
    losses.append(float(metrics["loss"]))
    norms.append(float(metrics["grad_norm"]))
full = ts.full_state_tensors(state, plan)
if plan.mesh.rank == 0:
    torch.save({"losses": losses, "norms": norms,
                "params": {k: v for k, v in full.items() if k.startswith("params/")}},
               sys.argv[1])
distributed.distributed_goodbye()
"""


@pytest.mark.parametrize("mesh", [{"dp": 2}, {"tp": 2}], ids=["dp", "tp"])
def test_bert_tiny_with_dropout(mesh, tmp_path):
    """At tp = 2 both ranks draw the same masks over the full hidden
    width; the gradient norm is the global one (tp shards' squares summed
    over the tp group)."""
    one = run_world(tmp_path, [str(tmp_path / "one.pt")], 1, code=_BERT_DROPOUT, tag="one")
    two = run_world(tmp_path, [str(tmp_path / "two.pt")], 2, mesh, code=_BERT_DROPOUT,
                    tag="two")
    assert_ok(one + two)
    a, b = torch.load(tmp_path / "two.pt"), torch.load(tmp_path / "one.pt")
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-4)
    np.testing.assert_allclose(a["norms"], b["norms"], rtol=1e-4)
    assert a["losses"][0] != a["losses"][1]
    assert_same_tensors({k: v.numpy() for k, v in a["params"].items()},
                        {k: v.numpy() for k, v in b["params"].items()}, LR, 3,
                        noise=("attn.key.bias",))


@pytest.mark.parametrize("model,argv", [
    ("bert-tiny", ["--seq", "32", "--batch", "8"]),
    # Batch 8: at batch 4 the last stage's batch norms normalise 4 values a
    # channel (1x1 maps), and the f32 noise of E[x^2] - m^2 there moves the
    # third step's loss by 5.6e-4 between one process and two, with
    # gradients equal at 2e-5 of their scale; at 8 it stays under 4e-6.
    ("resnet18", ["--image-size", "32", "--batch", "8"]),
], ids=["bert-tiny", "resnet18"])
def test_trainer_at_dp2(model, argv, tmp_path):
    steps = 3
    args = ["--device", "cpu", "--model", model, "--steps", str(steps), "--log-every", "1",
            "--checkpoint-mode", "sync", "--checkpoint-every", "1", *argv]
    one = run_world(tmp_path, args + ["--checkpoint-dir", str(tmp_path / "one")], 1, tag="one")
    two = run_world(tmp_path, args + ["--checkpoint-dir", str(tmp_path / "two")], 2,
                    {"dp": 2}, tag="two")
    assert_ok(one + two)
    assert_same_losses(two, one, rtol=1e-4)
    got, want = (ckpt.restore(str(tmp_path / tag), steps) for tag in ("two", "one"))
    assert_same_tensors(got, want, LR, steps, noise=("attn.key.bias",),
                        in_norm=model != "resnet18")
    assert change_gap(got, want, initial_params(args)) <= CHANGE_GAP
    # ResNet's running statistics are the global batch's: after the first
    # step (from the same parameters) they hold its moments at rtol 1e-4.
    got = ckpt.restore_named(str(tmp_path / "two"), "trainstate_1")
    want = ckpt.restore_named(str(tmp_path / "one"), "trainstate_1")
    buffers = [k for k in want if k.startswith("buffers/")]
    assert len(buffers) == (58 if model == "resnet18" else 0)  # 29 batch norms
    for key in buffers:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6, err_msg=key)


def test_mnist_mlp_from_data_dir_at_dp2(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    data = tmp_path / "data"
    dataset_lib.write_array_shards(str(data), {
        "x": rng.standard_normal((64, 28, 28)).astype(np.float32),
        "y": rng.integers(0, 10, 64).astype(np.int32)}, num_shards=4)
    steps, batch = 4, 8
    argv = ["--device", "cpu", "--model", "mnist-mlp", "--steps", str(steps), "--batch",
            str(batch), "--log-every", "1", "--data-dir", str(data), "--checkpoint-mode",
            "sync", "--checkpoint-dir", str(tmp_path / "ck")]
    two = run_world(tmp_path, argv, 2, {"dp": 2})
    assert_ok(two)
    for rank, r in enumerate(two):
        first = next(e for e in r["events"] if e["event"] == "first_step")
        assert first["local_samples"] == 32 and first["mesh"] == {"dp": 2}

    # One process on the same global batches: each step's rows of reader 0,
    # then reader 1's.
    monkeypatch.setattr(train, "COMPUTE_DTYPE", torch.float32)
    args = train.build_parser().parse_args(argv)
    model, loss_fn, _ = train._build_model(args, torch.device("cpu"))
    tx = optim.make_optimizer(optim.OptimizerConfig(learning_rate=LR))
    state = ts.create_train_state(model, tx)
    readers = [dataset_lib.ShardedDataset(str(data), r, 2).batches(batch // 2, seed=0)
               for r in range(2)]
    losses = []
    for _ in range(steps):
        parts = [next(it) for it in readers]
        b = {k: torch.from_numpy(np.concatenate([p[k] for p in parts])) for k in parts[0]}
        state, metrics = ts.train_step(state, b, loss_fn, tx)
        losses.append(float(metrics["loss"]))
    got = {e["step"]: e["loss"] for e in two[0]["events"] if e["event"] == "progress"}
    np.testing.assert_allclose([got[s] for s in range(2, steps + 1)], losses[1:], rtol=1e-4)
    first = next(e for e in two[0]["events"] if e["event"] == "first_step")
    np.testing.assert_allclose(first["loss"], losses[0], rtol=1e-4)
    want = {n: p.detach().numpy() for n, p in state.model.named_parameters()}
    assert_same_tensors(ckpt.restore(str(tmp_path / "ck"), steps), want, LR, steps)
