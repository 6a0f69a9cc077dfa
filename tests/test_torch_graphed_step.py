"""The compiled step of the PyTorch port, on CPU: the capturable AdamW, the
route rule, the launch bookkeeping and the graphed chunk's bookkeeping.

- The in-place AdamW (device count, f32 bias corrections computed from
  it) against the JAX package's update on the same numpy inputs for 5
  steps: f32 moments without master weights at atol 1e-6, bf16 moments
  with f32 masters at atol 1e-6 for the masters and one bf16 ulp for the
  bf16 tensors (as tests/test_torch_optim.py holds the functional form);
  and bit for bit against the functional form the port had before the
  update went in place (copied here as `_functional_update`), across a
  state_tensors -> load_state_tensors round trip in the middle of the run.
- step_route as a pure function for every kind of world.
- GraphedStep's launch bookkeeping and graphed_chunks' re-seeding, with
  torch.cuda's stream and graph calls replaced by tests/graph_standins.py's
  stand-ins, which run the step again at each "replay": what a replay
  computes on the card is held in chip_smoke's graph check, not here.
- The MoE dispatch's expert counts against torch.bincount and the JAX
  dispatch's jnp.bincount.
"""

import graph_standins
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu import optim as joptim
from tf_operator_tpu_torch import optim
from tf_operator_tpu_torch.models import moe
from tf_operator_tpu_torch.parallel import graphed_step
from tf_operator_tpu_torch.parallel import train_step as ts

SHAPES = [(16, 8), (8,), (3, 5, 2)]
STEPS = 5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) * 0.1 for s in SHAPES]
             for _ in range(STEPS)]
    return params, grads


def _within_one_bf16_ulp(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(a - b) <= ulp), np.max(np.abs(a - b) / ulp)


class _Params(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        self.ps = torch.nn.ParameterList(torch.nn.Parameter(torch.from_numpy(p.copy()))
                                         for p in params)


def _in_place_run(cfg_kw, params, grads, round_trip_at=None):
    """The in-place update through a TrainState; with round_trip_at, the
    state goes through state_tensors (host copies) and load_state_tensors
    into a freshly built state after that many steps."""
    tx = optim.make_optimizer(optim.OptimizerConfig(**cfg_kw))

    def fresh():
        return ts.create_train_state(_Params(params), tx)

    state = fresh()
    for i, g in enumerate(grads):
        if i == round_trip_at:
            saved = {k: v.clone() if isinstance(v, torch.Tensor) else v
                     for k, v in ts.state_tensors(state).items()}
            state = ts.load_state_tensors(fresh(), saved)
        ps = state.params
        tx.update_in_place([torch.from_numpy(x).to(p.dtype) for x, p in zip(g, ps)],
                           state.opt_state, ps)
    return [p.detach() for p in state.params], state.opt_state


def _functional_update(cfg, grads, count, mu, nu, master, params):
    """The port's update before it went in place: a host count, the bias
    corrections as host floats, new tensors returned."""
    count = count + 1
    c = torch.tensor(float(count), dtype=torch.float32)
    bc1 = float(1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** c)
    bc2 = float(1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** c)
    masters = master if cfg.master_weights else params
    new_mu, new_nu, new_master, new_params = [], [], [], []
    for g, m1, m2, p, m in zip(grads, mu, nu, params, masters):
        g32 = g.float()
        mu32 = cfg.b1 * m1.float() + (1.0 - cfg.b1) * g32
        nu32 = cfg.b2 * m2.float() + (1.0 - cfg.b2) * g32 * g32
        step = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + cfg.eps)
        target = m.float()
        if cfg.name == "adamw" and cfg.weight_decay:
            step = step + cfg.weight_decay * target
        upd = target - cfg.learning_rate * step
        new_mu.append(mu32.to(m1.dtype))
        new_nu.append(nu32.to(m2.dtype))
        if cfg.master_weights:
            new_master.append(upd)
        new_params.append(upd.to(p.dtype))
    return count, new_mu, new_nu, new_master, new_params


def _functional_run(cfg_kw, params, grads):
    cfg = optim.OptimizerConfig(**cfg_kw)
    p = [torch.from_numpy(x.copy()) for x in params]
    dt = cfg.moment_dtype
    mu = [torch.zeros_like(x, dtype=dt or x.dtype) for x in p]
    nu = [torch.zeros_like(x, dtype=dt or x.dtype) for x in p]
    master = [x.clone() for x in p] if cfg.master_weights else []
    if cfg.master_weights:
        p = [x.to(cfg.compute_dtype) for x in p]
    count = 0
    for g in grads:
        count, mu, nu, master, p = _functional_update(
            cfg, [torch.from_numpy(x).to(pp.dtype) for x, pp in zip(g, p)],
            count, mu, nu, master, p)
    return p, count, mu, nu, master


def _jax_run(cfg_kw, params, grads):
    tx = joptim.make_optimizer(joptim.OptimizerConfig(**cfg_kw))
    p = [jnp.asarray(x) for x in params]
    state = tx.init(p)
    p = joptim.compute_params(tx, p)
    for g in grads:
        g = [jnp.asarray(x).astype(pp.dtype) for x, pp in zip(g, p)]
        updates, state = tx.update(g, state, p)
        p = joptim.apply_updates(tx, p, updates)
    return p, state


CONFIGS = {
    "f32-moments": {"learning_rate": 1e-2, "moment_dtype": "f32"},
    "f32-moments-master": {"learning_rate": 1e-2, "moment_dtype": "f32",
                           "master_weights": True},
    "bf16-moments": {"learning_rate": 1e-2, "moment_dtype": "bf16"},
    "bf16-moments-master": {"learning_rate": 1e-2, "moment_dtype": "bf16",
                            "master_weights": True},
}


@pytest.mark.parametrize("name", ["adam", "adamw"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_in_place_update_matches_jax(config, name):
    cfg = dict(CONFIGS[config], name=name)
    params, grads = _problem(1)
    pj, sj = _jax_run(cfg, params, grads)
    pt, st = _in_place_run(cfg, params, grads)
    assert isinstance(st.count, torch.Tensor) and st.count.dtype == torch.int32
    assert int(st.count) == int(sj.count) == STEPS
    for a, b in zip(st.master, sj.master):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    for a, b in zip(pt + st.mu + st.nu, list(pj) + list(sj.mu) + list(sj.nu)):
        got, want = a.float().numpy(), np.asarray(b, np.float32)
        if a.dtype == torch.bfloat16:
            _within_one_bf16_ulp(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("round_trip_at", [None, 2])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_in_place_update_is_the_functional_one_bit_for_bit(config, round_trip_at):
    cfg = dict(CONFIGS[config], name="adamw")
    params, grads = _problem(2)
    pf, count, mu, nu, master = _functional_run(cfg, params, grads)
    pt, st = _in_place_run(cfg, params, grads, round_trip_at)
    assert int(st.count) == count == STEPS
    for got, want in zip(pt + st.mu + st.nu + st.master, pf + mu + nu + master):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_the_functional_update_leaves_its_inputs_alone():
    tx = optim.make_optimizer(optim.OptimizerConfig(moment_dtype="bf16",
                                                    master_weights=True))
    params, grads = _problem(3)
    p = [torch.from_numpy(x.copy()) for x in params]
    state = tx.init(p)
    p = [x.to(torch.bfloat16) for x in p]
    before = [t.clone() for t in p + state.mu + state.nu + state.master]
    new_p, new_state = tx.update([torch.from_numpy(g).to(torch.bfloat16) for g in grads[0]],
                                 state, p)
    assert int(state.count) == 0 and int(new_state.count) == 1
    assert all(torch.equal(a, b) for a, b in
               zip(p + state.mu + state.nu + state.master, before))
    assert not torch.equal(new_p[0], p[0])


def test_a_restore_writes_the_live_count_and_keeps_an_int_on_the_wire():
    tx = optim.make_optimizer(optim.OptimizerConfig())
    params, grads = _problem(4)
    state = ts.create_train_state(_Params(params), tx)
    live = state.opt_state.count
    saved = dict(ts.state_tensors(state), count=7)
    assert isinstance(ts.state_tensors(state)["count"], int)
    restored = ts.load_state_tensors(state, saved)
    assert restored.opt_state.count is live and int(live) == 7


@pytest.mark.parametrize("device,world,backend,multislice,route,why", [
    ("cpu", 1, None, False, "eager", "CUDA device"),
    ("cpu", 2, "gloo", False, "eager", "CUDA device"),
    ("cuda", 1, None, False, "graph", "one process"),
    ("cuda", 1, "nccl", False, "graph", "one process"),
    ("cuda", 2, "gloo", False, "eager", "gloo"),
    ("cuda", 2, "nccl", False, "graph", "NCCL"),
    ("cuda", 4, "nccl", False, "graph", "NCCL"),
    ("cuda", 8, "nccl", False, "graph", "world of 8"),
    ("cuda", 4, "gloo", False, "eager", "gloo"),
    ("cuda", 1, None, True, "graph", "multi-slice job, one process"),
    ("cuda", 2, "nccl", True, "graph", "slice of 2 processes over NCCL"),
    ("cuda", 2, "gloo", True, "eager", "gloo"),
    ("cpu", 1, None, True, "eager", "CUDA device"),
])
def test_step_route(device, world, backend, multislice, route, why):
    got, reason = graphed_step.step_route(device, world, backend, multislice)
    assert got == route and why in reason


@pytest.fixture
def fake_cuda(monkeypatch):
    return graph_standins.install(monkeypatch.setattr, graph_standins.FakeCuda())


def test_replays_count_the_captured_launches(fake_cuda):
    counters = ({"fwd": 0, "bwd": 0}, {"gmm": 0})
    calls = []

    def body():
        calls.append(len(calls))
        counters[0]["fwd"] += 12
        counters[0]["bwd"] += 24
        counters[1]["gmm"] += 3
        return {"loss": torch.tensor(float(len(calls)))}

    step = graphed_step.GraphedStep(body, counters=counters)
    step()  # the warm-up runs, the capture records
    assert len(calls) == 2 and counters == ({"fwd": 12, "bwd": 24}, {"gmm": 3})
    assert step.recorded == [{"fwd": 12, "bwd": 24}, {"gmm": 3}]
    replays = 4
    for _ in range(replays):
        step()
    assert fake_cuda.graphs[0].replays == replays
    assert counters == ({"fwd": 12 * (1 + replays), "bwd": 24 * (1 + replays)},
                        {"gmm": 3 * (1 + replays)})


def test_counts_since_and_add_counts():
    counters = ({"a": 5, "b": 1},)
    before = [dict(c) for c in counters]
    counters[0]["a"] += 3
    delta = graphed_step.counts_since(counters, before)
    assert delta == [{"a": 3, "b": 0}]
    graphed_step.add_counts(counters, delta)
    assert counters == ({"a": 11, "b": 1},)


def _tiny_problem():
    model = _Params([np.linspace(-1, 1, 24, dtype=np.float32).reshape(4, 6)])

    def loss_fn(m, batch):
        w = m.ps[0]
        return ((batch["x"] @ w.T - batch["y"]) ** 2).mean()

    def make_batch(gen):
        return {"x": torch.randn((3, 6), generator=gen, device=gen.device),
                "y": torch.randn((3, 4), generator=gen, device=gen.device)}

    return model, loss_fn, make_batch


def test_graphed_chunks_reseed_each_step_as_the_eager_loop_does(fake_cuda):
    tx = optim.make_optimizer(optim.OptimizerConfig(learning_rate=1e-2))
    runs = {}
    for graphed in (False, True):
        model, loss_fn, make_batch = _tiny_problem()
        state = ts.create_train_state(model, tx)
        fake_cuda.keep(state)
        run = ts.make_chunked_train_step(loss_fn, tx, make_batch, "cpu", seed=3,
                                         graphed=graphed)
        every: list = []
        for n in (2, 3, 1):
            state, last = run(state, n, every)
            assert torch.equal(last["loss"], every[-1]["loss"])
        runs[graphed] = (state, every)
    (eager, e_every), (graphed, g_every) = runs[False], runs[True]
    assert graphed.step == eager.step == 6 and int(graphed.opt_state.count) == 6
    assert [float(m["loss"]) for m in g_every] == [float(m["loss"]) for m in e_every]
    assert torch.equal(graphed.params[0], eager.params[0])
    (graph,) = fake_cuda.graphs
    assert graph.replays == 5 and len(graph.generators) == 1


def test_a_graphed_run_refuses_another_state(fake_cuda):
    tx = optim.make_optimizer(optim.OptimizerConfig())
    model, loss_fn, make_batch = _tiny_problem()
    run = ts.make_chunked_train_step(loss_fn, tx, make_batch, "cpu", graphed=True)
    run(ts.create_train_state(model, tx), 1)
    other, _, _ = _tiny_problem()
    with pytest.raises(RuntimeError, match="another train state"):
        run(ts.create_train_state(other, tx), 1)


def test_graphed_batches_copy_into_the_static_input(fake_cuda):
    tx = optim.make_optimizer(optim.OptimizerConfig(learning_rate=1e-2))
    gen = torch.Generator().manual_seed(0)
    model, loss_fn, make_batch = _tiny_problem()
    batches = [make_batch(gen) for _ in range(4)]
    ref_model, _, _ = _tiny_problem()
    ref = ts.create_train_state(ref_model, tx)
    state = ts.create_train_state(model, tx)
    fake_cuda.keep(state)
    step = graphed_step.graphed_batches(loss_fn, tx, lambda b: b)
    for b in batches:
        ref, want = ts.train_step(ref, b, loss_fn, tx)
        state, got = step(state, b)
        assert torch.equal(got["loss"], want["loss"])
    assert torch.equal(state.params[0], ref.params[0]) and state.step == 4
    with pytest.raises(ValueError, match="captured at"):
        step(state, {"x": torch.zeros(2, 6), "y": torch.zeros(2, 4)})


@pytest.mark.parametrize("seed", [0, 1])
def test_expert_counts_are_bincounts(seed):
    rng = np.random.default_rng(seed)
    num_experts, n, k = 8, 512, 2
    logits = torch.from_numpy(rng.standard_normal((n, num_experts)).astype(np.float32))
    flat_e = torch.topk(torch.softmax(logits, -1), k, dim=-1).indices.reshape(-1)
    got = moe.expert_counts(flat_e, num_experts)
    assert got.dtype == torch.int64
    assert torch.equal(got, torch.bincount(flat_e, minlength=num_experts))
    want = jnp.bincount(jnp.asarray(flat_e.numpy()), length=num_experts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # An expert no row chose still has its zero.
    lone = torch.tensor([0, 0, 5])
    assert moe.expert_counts(lone, num_experts).tolist() == [2, 0, 0, 0, 0, 1, 0, 0]
