"""The last three compiled paths of the PyTorch port, on CPU: the multi-slice
halves, a classifier server's bucketed forward and the Evaluator's loss,
each as CUDA graphs (parallel/graphed_step.GraphedStep) held bit for bit
against its eager route, under tests/graph_standins.py's stand-in capture
(a replay runs the body again; with forbid_host_reads a tensor read on the
host inside a capture or a replay raises). What a replay computes on the
card is held by chip_smoke.py's multislice, serve and eval phases.

- The multi-slice halves: two slices x two microbatches of a tiny f32 LM
  made in one process (each step's batch, the backward of every slice's
  row blocks, their mean as the DCN exchange makes it, the apply), with a
  rewind in the middle (the state restored in place from a snapshot, as
  SliceRewind's re-restore does): every step's loss and norm and the final
  state equal to the eager halves'; the trainer's flat wire split on the
  host as the eager (loss, grads).
- A classifier server (mnist-conv, f32) loaded on the graph route: the
  predictions and logits at every bucket equal the eager server's, through
  the dispatch loop, before and after a follower swap (copied into the
  captured parameters); one graph a bucket, sealed after load; and the
  graph server's predictions against the JAX server's forward on the same
  weights at every bucket (exact on argmax where the f32 top-2 margin is
  over 0.1, as tests/test_torch_serve.py holds the eager servers).
- The Evaluator: its graphed round against the eager one over two rounds
  with the parameters copied in between; the trainer's --eval on the graph
  route (stand-ins) gives the eager run's eval events, and `eval_ready`
  names the route.
"""

from __future__ import annotations

import dataclasses
import json

import graph_standins
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import mnist as jmnist
from tf_operator_tpu.serve import server as jserver
from tf_operator_tpu_torch import optim
from tf_operator_tpu_torch.models import checkpoint as ckpt
from tf_operator_tpu_torch.models import mnist, train
from tf_operator_tpu_torch.models import transformer as tfm
from tf_operator_tpu_torch.parallel import train_step as ts
from tf_operator_tpu_torch.serve import server as tserver

T, ROWS, SLICES, MICRO = 16, 2, 2, 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def fake_cuda(monkeypatch):
    return graph_standins.install(monkeypatch.setattr,
                                  graph_standins.FakeCuda(forbid_host_reads=True))


# ------------------------------------------------------- the multi-slice halves

def _lm():
    torch.manual_seed(0)
    cfg = dataclasses.replace(tfm.TINY_LM, dtype=torch.float32, max_len=T)
    model = tfm.TransformerLM(cfg)

    def make_batch(gen):
        return {"tokens": torch.randint(0, cfg.vocab_size, (SLICES * MICRO * ROWS, T),
                                        generator=gen, device=gen.device)}

    def loss_fn(m, b):
        return tfm.lm_loss(m(b["tokens"]), b["tokens"])

    return model, loss_fn, make_batch


def _halves_run(graphed: bool, fake=None, steps: int = 5, rewind_at: int = 3,
                snapshot_at: int = 2, flat: bool = False) -> dict:
    """`steps` multi-slice steps of the tiny LM, every slice's microbatches
    in this process; after step `rewind_at` the state is restored in place
    to its snapshot after step `snapshot_at` and the steps replay from there."""
    model, loss_fn, make_batch = _lm()
    tx = optim.make_optimizer(optim.OptimizerConfig(learning_rate=1e-2))
    state = ts.create_train_state(model, tx)
    if fake is not None:
        fake.keep(state)
    gen_batch, backward, apply = ts.make_multislice_step_fns(
        loss_fn, tx, make_batch, "cpu", ROWS, seed=3, graphed=graphed, flat=flat)
    losses, norms, snap, rewound = [], [], None, False
    step = 0
    while step < steps:
        batch = gen_batch(step + 1)
        outs = []
        for block in range(SLICES * MICRO):
            out = backward(state, batch, block * ROWS)
            if flat:
                outs.append(out.clone())
            else:
                loss, grads = out
                outs.append(torch.cat([loss.reshape(1).float()]
                                      + [g.reshape(-1).float() for g in grads]))
        mean = torch.stack(outs).mean(0).numpy()
        at, host = 1, []
        for p in state.params:
            host.append(mean[at:at + p.numel()].reshape(p.shape))
            at += p.numel()
        state, norm = apply(state, host)
        step += 1
        losses.append(float(mean[0]))
        norms.append(float(norm))
        if step == snapshot_at:
            snap = {k: v.clone() if isinstance(v, torch.Tensor) else v
                    for k, v in ts.state_tensors(state).items()}
        if step == rewind_at and not rewound:
            rewound = True
            state = ts.load_state_tensors(state, snap)
            step = snapshot_at
    return {"losses": losses, "norms": norms,
            "state": {k: v.clone() for k, v in ts.state_tensors(state).items()
                      if isinstance(v, torch.Tensor)}}


@pytest.mark.parametrize("flat", [False, True], ids=["loss-grads", "flat"])
def test_graphed_halves_are_the_eager_halves_across_a_rewind(fake_cuda, flat):
    eager = _halves_run(False, flat=flat)
    graphed = _halves_run(True, fake_cuda, flat=flat)
    assert len(eager["losses"]) == 6  # 5 steps, 1 of them replayed after the rewind
    assert graphed["losses"] == eager["losses"]
    assert graphed["norms"] == eager["norms"]
    assert eager["losses"][2] == eager["losses"][3]  # step 3 replayed from step 2's state
    assert eager["state"].keys() == graphed["state"].keys()
    for k, v in eager["state"].items():
        assert torch.equal(graphed["state"][k], v), k
    # gen_batch (replayed at every call, the first too), one backward an
    # offset and apply (replayed at every later call): 6 calls each.
    assert [g.replays for g in fake_cuda.graphs] == [6] + [5] * (SLICES * MICRO + 1)


def test_a_graphed_half_refuses_another_state_or_batch(fake_cuda):
    model, loss_fn, make_batch = _lm()
    tx = optim.make_optimizer(optim.OptimizerConfig())
    state = ts.create_train_state(model, tx)
    gen_batch, backward, _ = ts.make_multislice_step_fns(
        loss_fn, tx, make_batch, "cpu", ROWS, graphed=True)
    batch = gen_batch(1)
    backward(state, batch, 0)
    other, _, _ = _lm()
    with pytest.raises(RuntimeError, match="another train state"):
        backward(ts.create_train_state(other, tx), batch, 0)
    with pytest.raises(RuntimeError, match="static batch"):
        backward(state, {k: v.clone() for k, v in batch.items()}, 0)


def test_host_grads_splits_the_flat_wire_as_the_eager_halves():
    model, loss_fn, make_batch = _lm()
    tx = optim.make_optimizer(optim.OptimizerConfig())
    state = ts.create_train_state(model, tx)
    gen_batch, backward, _ = ts.make_multislice_step_fns(loss_fn, tx, make_batch, "cpu", ROWS)
    _, flat_backward, _ = ts.make_multislice_step_fns(loss_fn, tx, make_batch, "cpu", ROWS,
                                                      flat=True)
    batch = gen_batch(1)
    loss, grads = backward(state, batch, ROWS)
    out = flat_backward(state, batch, ROWS)
    views, event = train._host_grads(out, [(1,)] + [tuple(p.shape) for p in state.params])
    assert event is None and len(views) == 1 + len(grads)
    assert views[0][0] == float(loss)
    for v, g in zip(views[1:], grads):
        assert np.array_equal(v, g.numpy())
    out.zero_()  # the views own their buffer: a later replay may rewrite `out`
    assert views[0][0] == float(loss)


# ---------------------------------------------------------- the classifier

CONV_BATCH_MAX = 8


def _conv_checkpoints(tmp_path):
    """mnist-conv weights at two seeds: the first as a port checkpoint at
    step 3 (port/) and as the JAX server's (jax/), the second at step 4 in
    port4/ (a swap's)."""
    from tf_operator_tpu.models import checkpoint as jckpt

    net = jmnist.ConvNet()
    trees = [jax.device_get(net.init(jax.random.PRNGKey(s), jnp.zeros((1, 28, 28))))["params"]
             for s in (5, 6)]
    for step, tree, sub in ((3, trees[0], "port"), (4, trees[1], "port4")):
        ckpt.save(str(tmp_path / sub), step, mnist.params_from_flax(tree))
    jckpt.save(str(tmp_path / "jax"), 3, trees[0])
    return net, trees


def _conv_server(ckpt_dir, graph: bool):
    srv = tserver.InferenceServer("mnist-conv", str(ckpt_dir), 0, batch_max=CONV_BATCH_MAX,
                                  batch_timeout_ms=5.0, replica="c", device="cpu")
    if graph:
        srv.route = "graph"
    srv.load()
    assert (srv._graphs is not None) == graph
    return srv


def _dispatch(srv, rows: np.ndarray) -> list[int]:
    """One batch of `rows` through the server's dispatch loop (padded to
    its bucket, as the assembler stages it)."""
    n = rows.shape[0]
    bucket = tserver.select_bucket(n, srv.buckets)
    padded = np.zeros((bucket, 28, 28), np.float32)
    padded[:n] = rows
    item = tserver._Pending(rows.tolist())
    srv._shift_inflight(+1)
    srv.slot = tserver.StagingSlot()
    srv.slot.put(tserver._Staged([item], padded, n, bucket))
    srv.slot.close()
    srv._dispatch_loop()
    assert item.error is None, item.error
    return item.result


def _rows(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, 28, 28)).astype(np.float32)


def test_graphed_classifier_is_the_eager_one_at_every_bucket_across_a_swap(
        fake_cuda, tmp_path):
    _conv_checkpoints(tmp_path)
    eager = _conv_server(tmp_path / "port", graph=False)
    graphed = _conv_server(tmp_path / "port", graph=True)
    assert graphed.route == "graph" and graphed._graphs.sealed
    assert sorted(graphed._graphs.buckets) == list(graphed.buckets)
    assert len(fake_cuda.graphs) == len(graphed.buckets)
    captured = graphed._live[0]
    swapped = ckpt.restore(str(tmp_path / "port4"), 4)
    fresh = graphed._to_device(swapped)
    for phase in ("before", "after"):
        if phase == "after":
            # The follower's swap: a new dict in _live; the dispatch loop
            # copies it into the captured tensors and hands _live it back.
            eager._live = (eager._to_device(swapped), 4)
            graphed._live = (fresh, 4)
        for n in graphed.buckets:
            rows = _rows(n, n)
            got = _dispatch(graphed, rows)
            assert got == _dispatch(eager, rows), (phase, n)
            with torch.inference_mode():  # as the dispatch loop calls it
                out = graphed._graphs.forward(graphed._live[0], rows)
                logits = torch.func.functional_call(graphed._graphs.model, eager._live[0],
                                                    (torch.from_numpy(rows),))
            assert torch.equal(out["logits"], logits)
        assert graphed._live[0] is captured
    assert all(torch.equal(captured[k], fresh[k]) for k in fresh)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="outside the captured buckets"):
            graphed._graphs(captured, _rows(0, 3))
        with pytest.raises(RuntimeError, match="another parameter dict"):
            graphed._graphs(dict(captured), _rows(0, 4))


def test_graphed_classifier_answers_as_the_jax_server_at_every_bucket(fake_cuda, tmp_path):
    net, trees = _conv_checkpoints(tmp_path)
    port = _conv_server(tmp_path / "port", graph=True)
    jax_srv = jserver.InferenceServer("mnist-conv", str(tmp_path / "jax"), 0,
                                      batch_max=CONV_BATCH_MAX, batch_timeout_ms=5.0,
                                      replica="j")
    jax_srv.load()
    assert port.buckets == jax_srv.buckets
    sure_rows = 0
    for n in port.buckets:
        rows = _rows(100 + n, n)
        with torch.inference_mode():
            got = port._apply(port._live[0], rows)
        want = np.asarray(jax_srv._apply(jax_srv._live[0], rows))
        logits = np.asarray(type(net)(dtype=jnp.float32).apply({"params": trees[0]}, rows))
        top = np.sort(logits, -1)
        sure = top[:, -1] - top[:, -2] > 0.1
        sure_rows += int(sure.sum())
        assert np.array_equal(got[sure], want[sure]), n
        assert np.array_equal(got[sure], logits.argmax(-1)[sure]), n
    assert sure_rows >= 0.75 * sum(port.buckets)


# ----------------------------------------------------------- the Evaluator

LM_ARGV = ["--model", "transformer-lm", "--device", "cpu", "--batch", "2", "--seq", "16",
           "--layers", "2", "--hidden", "32", "--heads", "2", "--log-every", "2"]


def test_graphed_evaluator_is_the_eager_one_across_rounds(fake_cuda):
    args = train.build_parser().parse_args(LM_ARGV + ["--steps", "3"])
    model, loss_fn, make_batch = train._build_model(args, torch.device("cpu"))
    device = torch.device("cpu")
    graphed = train.evaluator(model, loss_fn, make_batch, device, 3, graphed=True)
    for round_ in range(2):
        want = train.evaluate(model, loss_fn, make_batch, device, 3)
        assert graphed() == want
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(0.5)
    (graph,) = fake_cuda.graphs
    assert graph.replays == 2 * 3 - 1  # the first batch is the warm-up


def test_eval_route():
    assert train.eval_route("cuda")[0] == "graph"
    route, why = train.eval_route("cpu")
    assert route == "eager" and "CUDA device" in why


def test_evaluator_on_the_graph_route_emits_the_eager_events(fake_cuda, tmp_path, monkeypatch):
    d = str(tmp_path / "ckpt")
    monkeypatch.setenv("TPUJOB_METRICS_FILE", str(tmp_path / "train.jsonl"))
    assert train.main(LM_ARGV + ["--steps", "4", "--checkpoint-dir", d,
                                 "--checkpoint-every", "2"]) == 0
    runs = {}
    for route in ("eager", "graph"):
        path = tmp_path / f"{route}.jsonl"
        monkeypatch.setenv("TPUJOB_METRICS_FILE", str(path))
        monkeypatch.setattr(train, "eval_route", lambda device_type, r=route: (r, "test"))
        assert train.main(LM_ARGV + ["--steps", "2", "--eval", "--checkpoint-dir", d,
                                     "--eval-timeout", "5"]) == 0
        runs[route] = [json.loads(x) for x in path.read_text().splitlines()]
    for route, events in runs.items():
        (ready,) = [e for e in events if e["event"] == "eval_ready"]
        assert ready["step_route"] == route
    evals = {r: [e for e in ev if e["event"] == "eval"] for r, ev in runs.items()}
    assert [e["checkpoint_step"] for e in evals["graph"]] == [2, 4]
    assert evals["graph"] == evals["eager"]
    assert len(fake_cuda.graphs) == 1
