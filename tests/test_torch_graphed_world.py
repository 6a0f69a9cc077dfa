"""The graphed step in worlds of several processes (gloo, CPU).

The port replays a CUDA graph of each step on every rank of an NCCL world
(parallel/graphed_step.py). Here two gloo processes, started through the
operator's env (tests/torch_dist.py's run_world), run graphed_chunks and
graphed_batches with tests/graph_standins.py's stand-ins in place of the
capture (a "capture" runs the step and puts its state back, a "replay"
runs it again), at each world of WORLDS: dp 2, fsdp 2, tp 2, sp 2 through
ring attention and through Ulysses (the tiny LM), and ep 2 (the tiny MoE,
sparse dispatch). In every world:

  - (a) no host read in the captured body: inside the stand-in capture
    and every replay, Tensor.item, tolist, __bool__, __float__, __int__,
    cpu and numpy raise (graph_standins.HOST_READS), and both graphed loops
    still run to their end;
  - (b) the graphed losses, gradient norms and each rank's final
    parameters and optimizer state equal the eager loop's bit for bit
    (graphed_chunks on the batches made from the re-seeded generator,
    graphed_batches on the same batches copied into its static input),
    and the losses and norms follow the JAX package's make_train_step on a
    two-device CPU mesh from the same flax init and batches at rtol 1e-4,
    as tests/test_torch_dist_jax.py and tests/test_torch_dist_sp.py hold
    the eager worlds.

What a replay computes on the card, and the capture of NCCL's collectives,
are held by chip_smoke's world graph check, not here.
"""

import dataclasses

import graph_standins
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist import ROOT, assert_ok, run_world

from tf_operator_tpu import optim as joptim
from tf_operator_tpu.models import moe as jmoe
from tf_operator_tpu.models import transformer as jtfm
from tf_operator_tpu.parallel import mesh as jmesh
from tf_operator_tpu.parallel import ring_attention as jring
from tf_operator_tpu.parallel import sharding_rules as jrules
from tf_operator_tpu.parallel import train_step as jts
from tf_operator_tpu_torch import optim
from tf_operator_tpu_torch.models import moe
from tf_operator_tpu_torch.models import transformer as tfm
from tf_operator_tpu_torch.parallel import graphed_step
from tf_operator_tpu_torch.parallel import train_step as ts

T, BATCH, STEPS, LR, SEED = 32, 4, 4, 1e-2, 0
# (model, mesh, TPUJOB_SP_MODE) of each world.
WORLDS = {"dp": ("lm", {"dp": 2}, None), "fsdp": ("lm", {"fsdp": 2}, None),
          "tp": ("lm", {"tp": 2}, None), "sp-ring": ("lm", {"sp": 2}, "ring"),
          "sp-ulysses": ("lm", {"sp": 2}, "ulysses"), "ep": ("moe", {"ep": 2}, None)}
ROUTES = ("eager", "chunks", "batches")
STATE_GROUPS = ("params/", "mu/", "nu/", "master/")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_batch(gen: torch.Generator) -> dict:
    """A step's global batch, drawn from its generator (as the trainer's;
    the ranks' _RANK draws the same)."""
    return {"tokens": torch.randint(0, 1024, (BATCH, T), generator=gen, device=gen.device)}


def _batches() -> np.ndarray:
    """Every step's global batch on the host, for the JAX side: the stream
    make_chunked_train_step draws, batch_generator(SEED, step)'s."""
    return np.stack([make_batch(ts.batch_generator(SEED, i, "cpu"))["tokens"].numpy()
                     for i in range(STEPS)]).astype(np.int32)


# One rank: the flax init (argv[3]) through the port's plan on the world's
# mesh, STEPS steps on each route of ROUTES from a fresh state; the graphed
# routes under the stand-ins with host reads refused. Writes each route's
# losses, norms and final state tensors to argv[4].<rank>.
_RANK = """
import dataclasses, sys
import torch
sys.path.insert(0, sys.argv[1])
import graph_standins
from tf_operator_tpu_torch import optim
from tf_operator_tpu_torch.models import moe, transformer as tfm
from tf_operator_tpu_torch.parallel import distributed, graphed_step, sharding_rules
from tf_operator_tpu_torch.parallel import mesh as mesh_lib, train_step as ts
from tf_operator_tpu_torch.parallel.ring_attention import make_attention_fn
torch.set_num_threads(1)
kind, init_path, out = sys.argv[2:5]
T, BATCH, STEPS, SEED = map(int, sys.argv[5:9])
LR, ROUTES = float(sys.argv[9]), sys.argv[10].split(",")
distributed.initialize_from_env()
mesh = mesh_lib.mesh_from_env()
init = torch.load(init_path)


def make_batch(gen):
    return {"tokens": torch.randint(0, 1024, (BATCH, T), generator=gen, device=gen.device)}


def build():
    if kind == "moe":
        model = moe.MoETransformerLM(dataclasses.replace(moe.TINY_MOE, dtype=torch.float32,
                                                         dispatch="sparse"))
        rules = sharding_rules.MOE_RULES

        def loss_fn(m, b):
            return moe.moe_lm_loss(m, b["tokens"])
    else:
        model = tfm.TransformerLM(dataclasses.replace(tfm.TINY_LM, dtype=torch.float32),
                                  attn_fn=make_attention_fn(mesh, causal=True))
        rules = sharding_rules.TRANSFORMER_TP_RULES

        def loss_fn(m, b):
            seq = m.trunk.seq_shard
            return tfm.lm_loss(m(ts.seq_slice(b["tokens"], seq)), b["tokens"], seq)
    model.load_state_dict(init)
    plan = ts.parallelize(model, mesh, rules)
    tx = optim.make_optimizer(optim.OptimizerConfig(learning_rate=LR))
    return ts.create_train_state(model, tx, plan), loss_fn, tx, plan


record = {}
for route in ROUTES:
    state, loss_fn, tx, plan = build()
    every = []
    with graph_standins.patched() as setattr_:
        if route != "eager":
            fake = graph_standins.install(setattr_, graph_standins.FakeCuda(True))
            fake.keep(state)
        if route == "batches":
            step = graphed_step.graphed_batches(loss_fn, tx, lambda b: b, plan)
            for i in range(STEPS):
                batch = plan.local_rows(make_batch(ts.batch_generator(SEED, i, "cpu")))
                state, metrics = step(state, batch)
                every.append(metrics)
        else:
            run = ts.make_chunked_train_step(loss_fn, tx, make_batch, "cpu", seed=SEED,
                                             plan=plan, graphed=route == "chunks")
            for n in (1, STEPS - 1):
                state, _ = run(state, n, every)
        replays = sum(g.replays for g in fake.graphs) if route != "eager" else 0
    record[route] = {
        "loss": [float(m["loss"]) for m in every],
        "grad_norm": [float(m["grad_norm"]) for m in every], "replays": replays,
        "state": {k: v.clone() for k, v in ts.state_tensors(state).items()
                  if isinstance(v, torch.Tensor)}}
torch.save(record, f"{out}.{mesh.rank}")
distributed.distributed_goodbye()
"""


@pytest.fixture(scope="module")
def flax_inits():
    """The flax init of each model, as host arrays."""
    lm = jtfm.TransformerLM(dataclasses.replace(jtfm.TINY_LM, dtype=jnp.float32))
    mo = jmoe.MoETransformerLM(dataclasses.replace(jmoe.TINY_MOE, dtype=jnp.float32,
                                                   dispatch="sparse"))
    tokens = jnp.zeros((1, T), jnp.int32)
    return {kind: (m, jax.tree.map(np.array, m.init(jax.random.key(0), tokens)["params"]))
            for kind, m in (("lm", lm), ("moe", mo))}


@pytest.fixture(scope="module", params=sorted(WORLDS))
def world(request, flax_inits, tmp_path_factory):
    """(name, each rank's records by route) of one world of WORLDS."""
    name = request.param
    kind, mesh, mode = WORLDS[name]
    tmp = tmp_path_factory.mktemp(f"graphed_world_{name}")
    params = flax_inits[kind][1]
    to_port = moe.moe_params_from_flax if kind == "moe" else tfm.params_from_flax
    torch.save(to_port(params), tmp / "init.pt")
    argv = [str(ROOT / "tests"), kind, str(tmp / "init.pt"), str(tmp / "out"),
            *map(str, (T, BATCH, STEPS, SEED, LR)), ",".join(ROUTES)]
    runs = run_world(tmp, argv, 2, mesh, code=_RANK, env={"TPUJOB_SP_MODE": mode} if mode else None)
    assert_ok(runs)
    return name, [torch.load(tmp / f"out.{r}") for r in range(2)]


def test_no_host_read_in_a_captured_world_step(world):
    """(a) Both graphed loops ran to their end under the refusal, each
    rank replaying its graph STEPS - 1 times."""
    name, ranks = world
    for rank in ranks:
        for route in ("chunks", "batches"):
            assert len(rank[route]["loss"]) == STEPS, (name, route)
            assert rank[route]["replays"] == STEPS - 1, (name, route)


def _jax_run(name, flax_inits, monkeypatch):
    kind, mesh_axes, mode = WORLDS[name]
    if mode:
        monkeypatch.setenv("TPUJOB_SP_MODE", mode)
    jmodel, params = flax_inits[kind]
    mesh = jmesh.make_mesh(mesh_axes, devices=jax.devices()[:2])
    if kind == "moe":
        rules = jrules.MOE_RULES

        def jloss(p, model_state, batch, rng):
            return jmoe.moe_lm_loss(jmodel, p, batch["tokens"]), model_state
    else:
        rules = jrules.TRANSFORMER_TP_RULES
        jmodel = jtfm.TransformerLM(jmodel.cfg,
                                    attn_fn=jring.make_attention_fn(mesh, causal=True))

        def jloss(p, model_state, batch, rng):
            return jtfm.lm_loss(jmodel.apply({"params": p}, batch["tokens"]),
                                batch["tokens"]), model_state

    jtx = joptim.make_optimizer(joptim.OptimizerConfig(learning_rate=LR))
    _, compile_step = jts.make_train_step(jloss, jtx, mesh, rules)
    state = jts.shard_state(jts.create_train_state(params, jtx), mesh, rules)
    step, losses, norms = None, [], []
    for b in _batches():
        batch = {"tokens": jnp.asarray(b)}
        step = step or compile_step(state, batch)
        state, m = step(state, batch, jax.random.key(0))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms


def test_graphed_world_is_its_eager_loop_and_the_jax_step(world, flax_inits, monkeypatch):
    """(b) Every route of every rank bit-equal to the eager loop; the
    global losses and norms at rtol 1e-4 of the JAX SPMD step's."""
    name, ranks = world
    for r, rank in enumerate(ranks):
        eager = rank["eager"]
        for route in ("chunks", "batches"):
            got = rank[route]
            assert got["loss"] == eager["loss"] and got["grad_norm"] == eager["grad_norm"], \
                (name, r, route)
            for key, want in eager["state"].items():
                assert key.startswith(STATE_GROUPS + ("buffers/",)), key
                assert torch.equal(got["state"][key], want), (name, r, route, key)
    losses, norms = _jax_run(name, flax_inits, monkeypatch)
    assert losses[-1] < losses[0]
    for rank in ranks:
        np.testing.assert_allclose(rank["eager"]["loss"], losses, rtol=1e-4)
        np.testing.assert_allclose(rank["eager"]["grad_norm"], norms, rtol=1e-4)


def test_the_stand_in_capture_refuses_a_host_read(monkeypatch):
    """The refusal (a) leans on: a loss that reads the host inside the
    captured step raises; the warm-up, which is eager, may read."""
    fake = graph_standins.install(monkeypatch.setattr, graph_standins.FakeCuda(True))
    model = tfm.TransformerLM(dataclasses.replace(tfm.TINY_LM, dtype=torch.float32))
    tx = optim.make_optimizer(optim.OptimizerConfig(learning_rate=LR))
    state = ts.create_train_state(model, tx)
    fake.keep(state)

    def loss_fn(m, b):
        loss = tfm.lm_loss(m(b["tokens"]), b["tokens"])
        float(loss.detach())
        return loss

    run = ts.make_chunked_train_step(loss_fn, tx, make_batch, "cpu", graphed=True)
    with pytest.raises(graph_standins.HostReadInCapture, match="__float__"):
        run(state, 1)


def test_a_world_refuses_nccl_blocking_waits(monkeypatch):
    """world_watch in a rank of an NCCL world: an empty all-reduce over the
    world after each replay, unless the environment makes NCCL wait on
    the host, which no capture could hold."""
    calls = []
    monkeypatch.setattr(graphed_step.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(graphed_step.dist, "get_world_size", lambda *a: 4)
    monkeypatch.setattr(graphed_step.dist, "get_backend", lambda *a: "nccl")
    monkeypatch.setattr(graphed_step.collectives, "all_reduce",
                        lambda t, group: calls.append((tuple(t.shape), group)))
    for name in graphed_step.BLOCKING_WAIT_ENV:
        monkeypatch.delenv(name, raising=False)
    watch = graphed_step.world_watch("cpu")
    watch()
    assert calls == [((0,), graphed_step.dist.group.WORLD)]
    for name in graphed_step.BLOCKING_WAIT_ENV:
        monkeypatch.setenv(name, "1")
        with pytest.raises(RuntimeError, match=name):
            graphed_step.world_watch("cpu")
        monkeypatch.setenv(name, "0")
    monkeypatch.setattr(graphed_step.dist, "get_world_size", lambda *a: 1)
    assert graphed_step.world_watch("cpu") is None
