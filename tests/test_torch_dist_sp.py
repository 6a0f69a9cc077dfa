"""The PyTorch port's trainer over the sequence-parallel axis (gloo, CPU).

A10's gate: trainer processes started through the operator's env with
TPUJOB_MESH holding sp train what one process trains at the same global
batch and seed, in f32 compute (tests/torch_dist.py says why):

  - the tiny LM at sp = 2 through ring attention and through Ulysses
    (TPUJOB_SP_MODE), and in four processes at dp x sp and sp x tp, with
    per-layer remat keeping the flash residuals on two of them (the replay
    runs the rotations and all-to-alls again): every step's loss and global
    gradient norm at rtol 1e-4, the final parameters by Adam's reach and
    rtol 1e-4 in norm;
  - bert-tiny with dropout at sp = 2, through the plan directly (the
    trainer runs BERT without dropout, as the JAX one): each rank draws the
    global batch's masks and keeps its columns;
  - the MNIST MLP at sp = 2, whose batch is replicated over sp (the JAX
    step's) and whose gradients are therefore not summed over it;
  - the port's two-process step against the JAX package's SPMD step on a
    {sp: 2} CPU mesh from the same flax weights (params_from_flax), ring
    and Ulysses: losses and norms at rtol 1e-4;
  - a checkpoint written at sp = 2 resumed by one process.
"""

import dataclasses
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist import (
    assert_ok,
    assert_same_losses,
    assert_same_tensors,
    progress_losses,
    run_world,
)

from tf_operator_tpu import optim as joptim
from tf_operator_tpu.models import transformer as jtfm
from tf_operator_tpu.parallel import mesh as jmesh
from tf_operator_tpu.parallel import ring_attention as jring
from tf_operator_tpu.parallel import sharding_rules as jrules
from tf_operator_tpu.parallel import train_step as jts
from tf_operator_tpu_torch.models import checkpoint as ckpt
from tf_operator_tpu_torch.models import transformer as tfm

STEPS, LR = 3, 1e-3
LM = ["--device", "cpu", "--model", "transformer-lm", "--batch", "4", "--seq", "32",
      "--layers", "2", "--hidden", "64", "--heads", "4", "--log-every", "1",
      "--checkpoint-mode", "sync"]
REMAT = ["--remat", "--remat-save-flash"]
# A trainer rank (f32 compute) that writes every step's global gradient
# norm to argv[1].<rank>.json.
_NORMS = """
import json, os, sys, torch
from tf_operator_tpu_torch.models import train
from tf_operator_tpu_torch.parallel import train_step as ts
train.COMPUTE_DTYPE = torch.float32
torch.set_num_threads(1)
norms, real = [], ts.train_step

def train_step(*args, **kwargs):
    state, metrics = real(*args, **kwargs)
    norms.append(float(metrics["grad_norm"]))
    return state, metrics

ts.train_step = train_step
rc = train.main(sys.argv[2:])
with open(f"{sys.argv[1]}.{os.environ.get('JAX_PROCESS_ID', '0')}.json", "w") as f:
    json.dump(norms, f)
sys.exit(rc)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _world(tmp, argv, mesh, tag, env=None):
    """(runs, per-rank norms) of the trainer with `argv` over `mesh` (None:
    one process), checkpointing to tmp/tag."""
    n = 1 if mesh is None else math.prod(mesh.values())
    runs = run_world(tmp, [str(tmp / f"{tag}-norms")] + argv + ["--checkpoint-dir",
                                                                 str(tmp / tag)],
                     n, mesh, tag=tag, env=env, code=_NORMS)
    assert_ok(runs)
    norms = [json.loads((tmp / f"{tag}-norms.{r}.json").read_text()) for r in range(n)]
    return runs, norms


@pytest.fixture(scope="module")
def lm_reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("one")
    runs, norms = _world(tmp, LM + ["--steps", str(STEPS)], None, "one")
    return runs, norms[0], ckpt.restore(str(tmp / "one"), STEPS)


LM_RUNS = {
    "ring": ({"sp": 2}, "ring", REMAT),
    "ulysses": ({"sp": 2}, "ulysses", []),
    "dp-sp-ulysses": ({"dp": 2, "sp": 2}, "ulysses", REMAT),
    "sp-tp-ring": ({"sp": 2, "tp": 2}, "ring", []),
}


@pytest.mark.parametrize("name", sorted(LM_RUNS))
def test_lm_at_sp_trains_the_one_process_model(name, lm_reference, tmp_path):
    mesh, mode, extra = LM_RUNS[name]
    ref_runs, ref_norms, ref_params = lm_reference
    runs, norms = _world(tmp_path, LM + ["--steps", str(STEPS)] + extra, mesh, "sp",
                         env={"TPUJOB_SP_MODE": mode})
    assert_same_losses(runs, ref_runs, rtol=1e-4)
    for rank_norms in norms:
        np.testing.assert_allclose(rank_norms, ref_norms, rtol=1e-4)
    for r in runs:
        first = next(e for e in r["events"] if e["event"] == "first_step")
        assert first["mesh"] == mesh and first["n_devices"] == math.prod(mesh.values())
    assert_same_tensors(ckpt.restore(str(tmp_path / "sp"), STEPS), ref_params, LR, STEPS,
                        noise=("attn.key.bias",))
    sm = json.loads((tmp_path / "sp" / f"step_{STEPS}.sharding.json").read_text())
    assert sm["mesh"] == mesh


def test_sp_checkpoint_resumes_in_one_process(lm_reference, tmp_path):
    """Three steps at sp = 2, then one process resumes the checkpoint to
    step 5 (--allow-reshape, as the JAX trainer asks for a foreign mesh):
    its steps 4 and 5 are the uninterrupted one-process run's."""
    steps = 5
    _world(tmp_path, LM + ["--steps", str(STEPS)], {"sp": 2}, "ck",
           env={"TPUJOB_SP_MODE": "ring"})
    resumed = run_world(tmp_path, LM + ["--steps", str(steps), "--checkpoint-dir",
                                        str(tmp_path / "ck"), "--allow-reshape"], 1,
                        tag="resume")
    straight = run_world(tmp_path, LM + ["--steps", str(steps), "--checkpoint-dir",
                                         str(tmp_path / "straight")], 1, tag="straight")
    assert_ok(resumed + straight)
    ev = resumed[0]["events"]
    assert [e["from_step"] for e in ev if e["event"] == "resumed"] == [STEPS]
    got, want = progress_losses(ev), progress_losses(straight[0]["events"])
    got[STEPS + 1] = next(e["loss"] for e in ev if e["event"] == "first_step")
    np.testing.assert_allclose([got[s] for s in (4, 5)], [want[s] for s in (4, 5)],
                               rtol=1e-4)


def test_mnist_at_sp_is_one_process(tmp_path):
    argv = ["--device", "cpu", "--model", "mnist-mlp", "--batch", "8", "--log-every", "1",
            "--steps", str(STEPS), "--checkpoint-mode", "sync"]
    one, one_norms = _world(tmp_path, argv, None, "one")
    two, two_norms = _world(tmp_path, argv, {"sp": 2}, "two")
    assert_same_losses(two, one, rtol=1e-4)
    for norms in two_norms:
        np.testing.assert_allclose(norms, one_norms[0], rtol=1e-4)
    assert_same_tensors(ckpt.restore(str(tmp_path / "two"), STEPS),
                        ckpt.restore(str(tmp_path / "one"), STEPS), LR, STEPS)
    first = next(e for e in two[0]["events"] if e["event"] == "first_step")
    assert first["mesh"] == {"sp": 2}


_BERT_DROPOUT = """
import dataclasses, sys, torch
from tf_operator_tpu_torch import optim
from tf_operator_tpu_torch.models import transformer as tfm
from tf_operator_tpu_torch.parallel import distributed, sharding_rules
from tf_operator_tpu_torch.parallel import mesh as mesh_lib, train_step as ts
from tf_operator_tpu_torch.parallel.ring_attention import make_attention_fn
torch.set_num_threads(1)
distributed.initialize_from_env()
mesh = mesh_lib.mesh_from_env()
cfg = dataclasses.replace(tfm.TINY, dtype=torch.float32, dropout_rate=0.1, max_len=32)
model = tfm.BertMLM(cfg, attn_fn=make_attention_fn(mesh, causal=False),
                    generator=torch.Generator().manual_seed(0))
plan = ts.parallelize(model, mesh, sharding_rules.TRANSFORMER_TP_RULES)
tx = optim.make_optimizer(optim.OptimizerConfig(learning_rate=1e-3))
state = ts.create_train_state(model, tx, plan)

def make_batch(g):
    return {**tfm.make_mlm_batch(g, 8, 32, cfg.vocab_size),
            "dropout_seed": torch.randint(0, 2 ** 62, (), generator=g)}

def loss_fn(m, b):
    gen = torch.Generator().manual_seed(int(b["dropout_seed"]))
    seq = m.trunk.seq_shard
    tokens, targets, mask = (ts.seq_slice(b[k], seq) for k in ("tokens", "targets", "mask"))
    return tfm.mlm_loss(m(tokens, deterministic=False, generator=gen), targets, mask)

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


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_bert_tiny_with_dropout_at_sp2(mode, tmp_path):
    """Each rank draws the global batch's dropout masks and keeps its
    sequence columns; the MLM loss is the global masked mean (each rank's
    share weighted by its columns' count of masked tokens)."""
    env = {"TPUJOB_SP_MODE": mode}
    one = run_world(tmp_path, [str(tmp_path / "one.pt")], 1, code=_BERT_DROPOUT, tag="one")
    two = run_world(tmp_path, [str(tmp_path / "two.pt")], 2, {"sp": 2}, code=_BERT_DROPOUT,
                    tag="two", env=env)
    assert_ok(one + two)
    a, b = torch.load(tmp_path / "two.pt"), torch.load(tmp_path / "one.pt")
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-4)
    np.testing.assert_allclose(a["norms"], b["norms"], rtol=1e-4)
    assert a["losses"][0] != a["losses"][1]
    assert_same_tensors({k: v.numpy() for k, v in a["params"].items()},
                        {k: v.numpy() for k, v in b["params"].items()}, LR, 3,
                        noise=("attn.key.bias",))


# The JAX SPMD step against the port's two processes at {sp: 2}.
T, BATCH, JAX_STEPS, JAX_LR = 64, 4, 3, 1e-2


def _batches():
    rng = np.random.default_rng(0)
    return np.stack([rng.integers(0, 1024, (BATCH, T)).astype(np.int32)
                     for _ in range(JAX_STEPS)])


_PORT_RANK = """
import dataclasses, sys, numpy as np, torch
from tf_operator_tpu_torch import optim
from tf_operator_tpu_torch.models import transformer as tfm
from tf_operator_tpu_torch.parallel import distributed, sharding_rules
from tf_operator_tpu_torch.parallel import mesh as mesh_lib, train_step as ts
from tf_operator_tpu_torch.parallel.ring_attention import make_attention_fn
torch.set_num_threads(1)
distributed.initialize_from_env()
mesh = mesh_lib.mesh_from_env()
model = tfm.TransformerLM(dataclasses.replace(tfm.TINY_LM, dtype=torch.float32),
                          attn_fn=make_attention_fn(mesh, causal=True))
model.load_state_dict(torch.load(sys.argv[1]))
plan = ts.parallelize(model, mesh, sharding_rules.TRANSFORMER_TP_RULES)
tx = optim.make_optimizer(optim.OptimizerConfig(learning_rate=float(sys.argv[4])))
state = ts.create_train_state(model, tx, plan)

def loss_fn(m, b):
    seq = m.trunk.seq_shard
    return tfm.lm_loss(m(ts.seq_slice(b["tokens"], seq)), b["tokens"], seq)

losses, norms = [], []
for b in np.load(sys.argv[2]):
    batch = plan.local_rows({"tokens": torch.from_numpy(b).long()})
    state, metrics = ts.train_step(state, batch, loss_fn, tx, plan)
    losses.append(float(metrics["loss"]))
    norms.append(float(metrics["grad_norm"]))
if plan.mesh.rank == 0:
    torch.save({"losses": losses, "norms": norms}, sys.argv[3])
distributed.distributed_goodbye()
"""


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_port_sp_step_follows_the_jax_spmd_step(mode, tmp_path, monkeypatch):
    monkeypatch.setenv("TPUJOB_SP_MODE", mode)
    cfg = dataclasses.replace(jtfm.TINY_LM, dtype=jnp.float32)
    params = jtfm.TransformerLM(cfg).init(jax.random.key(0), jnp.zeros((1, T), jnp.int32))
    params = jax.tree.map(np.array, params["params"])
    torch.save(tfm.params_from_flax(params), tmp_path / "init.pt")
    np.save(tmp_path / "batches.npy", _batches())
    runs = run_world(tmp_path, [str(tmp_path / "init.pt"), str(tmp_path / "batches.npy"),
                                str(tmp_path / "port.pt"), str(JAX_LR)], 2, {"sp": 2},
                     code=_PORT_RANK, env={"TPUJOB_SP_MODE": mode})
    assert_ok(runs)
    port = torch.load(tmp_path / "port.pt")

    mesh = jmesh.make_mesh({"sp": 2}, devices=jax.devices()[:2])
    jmodel = jtfm.TransformerLM(cfg, attn_fn=jring.make_attention_fn(mesh, causal=True))

    def jloss(p, model_state, batch, rng):
        return jtfm.lm_loss(jmodel.apply({"params": p}, batch["tokens"]),
                            batch["tokens"]), model_state

    jtx = joptim.make_optimizer(joptim.OptimizerConfig(learning_rate=JAX_LR))
    _, compile_step = jts.make_train_step(jloss, jtx, mesh, jrules.TRANSFORMER_TP_RULES)
    state = jts.shard_state(jts.create_train_state(params, jtx), mesh,
                            jrules.TRANSFORMER_TP_RULES)
    step, losses, norms = None, [], []
    for b in _batches():
        batch = {"tokens": jnp.asarray(b)}
        step = step or compile_step(state, batch)
        state, m = step(state, batch, jax.random.key(0))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(port["losses"], losses, rtol=1e-4)
    np.testing.assert_allclose(port["norms"], norms, rtol=1e-4)


def test_example_manifest_runs_the_trainer_at_sp(monkeypatch):
    """examples/torch-lm-sp.yaml: two Workers at mesh {sp: 2} whose command
    the port trainer accepts under the env the operator gives them, with
    Ulysses picked for its 6 heads at 65536 tokens."""
    import yaml

    from tf_operator_tpu_torch.models import train
    from tf_operator_tpu_torch.parallel import mesh as mesh_lib
    from tf_operator_tpu_torch.parallel.ulysses import sp_mode

    spec = yaml.safe_load((Path(__file__).resolve().parents[1] / "examples"
                           / "torch-lm-sp.yaml").read_text())["spec"]
    axes = spec["mesh"]["axes"]
    worker = spec["replicaSpecs"]["Worker"]
    assert axes == {"sp": 2} and worker["replicas"] == 2
    cmd = worker["template"]["spec"]["containers"][0]["command"]
    argv = cmd[cmd.index("tf_operator_tpu_torch.models.train") + 1:]
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("TPUJOB_MESH", json.dumps(axes))
    monkeypatch.delenv("TPUJOB_SP_MODE", raising=False)
    ap = train.build_parser()
    args = ap.parse_args(argv)
    train.check_flags(ap, args)
    assert args.remat and args.remat_save_flash and args.seq == 65536
    assert sp_mode(mesh_lib.Mesh(axes), args.heads, seq_len=args.seq) == "ulysses"
