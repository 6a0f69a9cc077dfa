"""The PyTorch port's sharded train step against the JAX package's (CPU).

The same flax init of the tiny LM, the same numpy batches and f32 AdamW go
through the JAX package's SPMD step (make_train_step on a two-device CPU
mesh, the state laid out by shard_state with TRANSFORMER_TP_RULES) and
through the port's (two gloo processes started through the operator's
env, the model laid out by parallelize with the port's
TRANSFORMER_TP_RULES) at dp = 2, fsdp = 2 and tp = 2: every step's loss
and global gradient norm at rtol 1e-4 (tests/test_torch_train.py's
one-device parity). The final parameters, gathered by the port's
full_state_tensors, are held elementwise by Adam's reach
(tests/torch_dist.py) and as a whole by change_gap within CHANGE_GAP: the
two packages' kernels sum in other orders, and Adam turns the noise of a
few near-zero gradients (2-5 elements of rare tokens' embedding rows, the
key biases) into full steps, which read 0.0014-0.0017 (a rank that never
updated reads 1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist import assert_ok, assert_same_tensors, change_gap, run_world

from tf_operator_tpu import optim as joptim
from tf_operator_tpu.models import transformer as jtfm
from tf_operator_tpu.parallel import mesh as jmesh
from tf_operator_tpu.parallel import sharding_rules as jrules
from tf_operator_tpu.parallel import train_step as jts
from tf_operator_tpu_torch.models import transformer as tfm

T, BATCH, STEPS, LR = 64, 4, 3, 1e-2
MESHES = {"dp": {"dp": 2}, "fsdp": {"fsdp": 2}, "tp": {"tp": 2}}
CHANGE_GAP = 0.02


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches():
    rng = np.random.default_rng(0)
    return np.stack([rng.integers(0, 1024, (BATCH, T)).astype(np.int32)
                     for _ in range(STEPS)])


@pytest.fixture(scope="module")
def init():
    jmodel = jtfm.TransformerLM(dataclasses.replace(jtfm.TINY_LM, dtype=jnp.float32))
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, T), jnp.int32))["params"]
    # Host copies: the JAX step donates its state's buffers.
    return jmodel, jax.tree.map(np.array, params)


def _jax_run(jmodel, params, mesh_axes):
    def jloss(p, model_state, batch, rng):
        return jtfm.lm_loss(jmodel.apply({"params": p}, batch["tokens"]),
                            batch["tokens"]), model_state

    mesh = jmesh.make_mesh(mesh_axes, devices=jax.devices()[:int(np.prod(list(
        mesh_axes.values())))])
    jtx = joptim.make_optimizer(joptim.OptimizerConfig(learning_rate=LR))
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
    final = {k: v.numpy() for k, v in
             tfm.params_from_flax(jax.tree.map(np.array, state.params)).items()}
    return losses, norms, final


# One rank of the port: the flax init (argv[1]) and the batches (argv[2])
# through the port's parallel step; rank 0 writes the metrics and the full
# final parameters to argv[3].
_PORT_RANK = """
import dataclasses, sys, numpy as np, torch
from tf_operator_tpu_torch import optim
from tf_operator_tpu_torch.models import transformer as tfm
from tf_operator_tpu_torch.parallel import distributed, sharding_rules
from tf_operator_tpu_torch.parallel import mesh as mesh_lib, train_step as ts
torch.set_num_threads(1)
distributed.initialize_from_env()
model = tfm.TransformerLM(dataclasses.replace(tfm.TINY_LM, dtype=torch.float32))
model.load_state_dict(torch.load(sys.argv[1]))
plan = ts.parallelize(model, mesh_lib.mesh_from_env(), sharding_rules.TRANSFORMER_TP_RULES)
tx = optim.make_optimizer(optim.OptimizerConfig(learning_rate=float(sys.argv[4])))
state = ts.create_train_state(model, tx, plan)

def loss_fn(m, b):
    return tfm.lm_loss(m(b["tokens"]), b["tokens"])

losses, norms = [], []
for b in np.load(sys.argv[2]):
    batch = plan.local_rows({"tokens": torch.from_numpy(b).long()})
    state, metrics = ts.train_step(state, batch, loss_fn, tx, plan)
    losses.append(float(metrics["loss"]))
    norms.append(float(metrics["grad_norm"]))
full = ts.full_state_tensors(state, plan)
if plan.mesh.rank == 0:
    torch.save({"losses": losses, "norms": norms,
                "params": {k[7:]: v.numpy() for k, v in full.items() if k.startswith("params/")}},
               sys.argv[3])
distributed.distributed_goodbye()
"""


@pytest.mark.parametrize("name", sorted(MESHES))
def test_port_processes_follow_the_jax_spmd_step(name, init, tmp_path):
    jmodel, params = init
    start = tfm.params_from_flax(params)
    torch.save(start, tmp_path / "init.pt")
    np.save(tmp_path / "batches.npy", _batches())
    runs = run_world(tmp_path, [str(tmp_path / "init.pt"), str(tmp_path / "batches.npy"),
                                str(tmp_path / "port.pt"), str(LR)], 2, MESHES[name],
                     code=_PORT_RANK)
    assert_ok(runs)
    port = torch.load(tmp_path / "port.pt", weights_only=False)
    losses, norms, final = _jax_run(jmodel, params, MESHES[name])
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(port["losses"], losses, rtol=1e-4)
    np.testing.assert_allclose(port["norms"], norms, rtol=1e-4)
    assert_same_tensors(port["params"], final, LR, STEPS, in_norm=False)
    assert change_gap(port["params"], final,
                      {k: v.double().numpy() for k, v in start.items()}) <= CHANGE_GAP
