"""The serving decode as CUDA graphs (tf_operator_tpu_torch/serve/decode_graphs.py
and the graph route of serve/server.py), on the CPU.

- The device bodies of models/decode.py (prefill_into_slots_body,
  decode_step_body: static int64 inputs staged through StaticInputs, the
  score scale computed once) against the JAX package's prefill_into_slots
  and decode_step on the same numpy inputs from a seed: 2 layers, hidden
  64, 4 heads, window 64, 4 + 1 slots, f32 within tests/test_torch_decode.py's
  atol 1e-5, a retired slot parked at position 0 among the ticks.
- The server on the graph route with torch.cuda's graph calls replaced by
  tests/graph_standins.py's stand-ins (a "replay" runs the captured
  body again on the captured static inputs, parameters and cache) against
  the JAX server on the scheduler scenarios of tests/test_torch_serve.py,
  with a tiny f32 LM on both: the same tokens, and the eager port server's.
  The hot swap lands during active decode; the replayed body reads the
  captured parameters, so a swap that skipped the in-place copy would
  answer with the old weights.
- serve_route as a pure function.
- The bookkeeping: a batch outside the captured grid raises, a position
  outside the cache and a repeated slot raise on the host before anything
  is staged.
- chip_smoke's serve graph check at a CPU size through the stand-ins: the
  sound run passes and each planted fault fails by its name.

What a replay computes on the card, bit for bit against the eager
functions, is chip_smoke's serve graph check on the H100.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from graph_standins import FakeGraph as _FakeGraph
from graph_standins import FakeStream as _FakeStream
from tf_operator_tpu.models import decode as jdecode
from tf_operator_tpu.models.transformer import TransformerConfig as JConfig
from tf_operator_tpu.models.transformer import TransformerLM as JLM
from tf_operator_tpu.serve import server as jserver
from tf_operator_tpu_torch.models import checkpoint as ckpt
from tf_operator_tpu_torch.models import decode
from tf_operator_tpu_torch.models import transformer as tfm
from tf_operator_tpu_torch.parallel import graphed_step
from tf_operator_tpu_torch.serve import decode_graphs
from tf_operator_tpu_torch.serve import server as tserver

F32_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _FakeCuda:
    """The graphs made, and the caches a stand-in capture restores: a real
    capture records the body without running it, this one runs it."""

    def __init__(self):
        self.graphs, self.kept = [], []


@pytest.fixture
def fake_cuda(monkeypatch):
    fake = _FakeCuda()

    @contextlib.contextmanager
    def graph(g, pool=None, capture_error_mode=None):
        fake.graphs.append(g)
        saved = [t.clone() for t in fake.kept]
        yield
        for t, v in zip(fake.kept, saved):
            t.copy_(v)

    real_capture = graphed_step.GraphedStep._capture
    real_init = decode_graphs.GraphedDecode.__init__

    def capture(self):
        real_capture(self)
        self.graph.step = self

    def init(self, params, kv, cfg):
        real_init(self, params, kv, cfg)
        fake.kept.extend(kv)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, s: None)
    monkeypatch.setattr(graphed_step.GraphedStep, "_capture", capture)
    monkeypatch.setattr(decode_graphs.GraphedDecode, "__init__", init)
    return fake


# ------------------------------------------------ the split decode functions


@pytest.fixture(scope="module")
def lm64():
    jc = JConfig(vocab_size=61, num_layers=2, hidden=64, num_heads=4, max_len=64,
                 causal=True, dtype=jnp.float32)
    params = jax.device_get(JLM(jc).init(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 4), jnp.int32))["params"])
    sd = tfm.params_from_flax(params)
    cfg = dataclasses.replace(decode.config_from_params(sd, num_heads=4), dtype=torch.float32)
    return jc, params, sd, cfg


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=F32_ATOL)


def test_split_bodies_match_jax(lm64):
    """4 rows prefilled into slots 0-3 (slot 4 is the scratch), then 3 ticks
    over every slot, then slot 2 retired (parked at position 0, token 0, as
    the server parks it) and 3 more."""
    jc, params, sd, cfg = lm64
    rng = np.random.default_rng(7)
    lengths = np.array([9, 1, 14, 5], np.int64)
    tokens = np.zeros((4, 16), np.int64)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(0, jc.vocab_size, n)
    ids = np.arange(4, dtype=np.int64)
    kc, vc = decode.init_kv_cache(cfg, 5, 64, device="cpu")
    jkc, jvc = jdecode.init_kv_cache(jc, 5, 64)
    scale = decode.score_scale(cfg, "cpu")
    assert scale.dtype == torch.float32 and float(scale) == 4.0
    pre = decode_graphs.StaticInputs({"tokens": (4, 16), "lengths": (4,), "slot_ids": (4,)},
                                     torch.device("cpu"))
    decode_graphs.stage(pre, {"tokens": tokens, "lengths": lengths, "slot_ids": ids})
    s = pre.views
    first, logits = decode.prefill_into_slots_body(sd, kc, vc, s["tokens"], s["lengths"],
                                                   s["slot_ids"], scale, cfg)
    jkc, jvc, jfirst, jlogits = jdecode.prefill_into_slots(
        params, jkc, jvc, jnp.asarray(tokens, jnp.int32), jnp.asarray(lengths, jnp.int32),
        jnp.asarray(ids, jnp.int32), jc)
    assert first.tolist() == np.asarray(jfirst).tolist()
    _close(logits, jlogits)
    _close(kc, jkc)
    _close(vc, jvc)

    tick = decode_graphs.StaticInputs({"tokens": (5,), "positions": (5,)}, torch.device("cpu"))
    active = np.arange(5) < 4
    last = np.where(active, np.append(np.asarray(jfirst), 0), 0).astype(np.int64)
    pos = np.where(active, np.append(lengths, 0), 0)
    for t in range(6):
        if t == 3:
            active[2] = False
            last[2], pos[2] = 0, 0
        decode_graphs.stage(tick, {"tokens": last, "positions": pos})
        nxt, logits = decode.decode_step_body(sd, kc, vc, tick.views["tokens"],
                                              tick.views["positions"], scale, cfg)
        jkc, jvc, jnxt, jlogits = jdecode.decode_step(
            params, jkc, jvc, jnp.asarray(last, jnp.int32), jnp.asarray(pos, jnp.int32), jc)
        assert nxt.tolist() == np.asarray(jnxt).tolist()
        _close(logits, jlogits)
        _close(kc, jkc)
        _close(vc, jvc)
        last = np.where(active, np.asarray(jnxt), 0).astype(np.int64)
        pos = np.where(active, pos + 1, 0)
    assert pos[2] == 0 and pos[0] == lengths[0] + 6


def test_public_functions_are_their_bodies(lm64):
    """decode_step and prefill_into_slots give their bodies' bits."""
    jc, _, sd, cfg = lm64
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jc.vocab_size, (2, 16))
    lengths, ids = np.array([16, 3]), np.array([1, 0])
    out = []
    for body in (False, True):
        k, v = decode.init_kv_cache(cfg, 3, 64, device="cpu")
        if body:
            scale = decode.score_scale(cfg, "cpu")
            first, logits = decode.prefill_into_slots_body(
                sd, k, v, torch.from_numpy(tokens), torch.from_numpy(lengths),
                torch.from_numpy(ids), scale, cfg)
            nxt, tick = decode.decode_step_body(sd, k, v, torch.tensor([4, 5, 0]),
                                                torch.tensor([3, 16, 0]), scale, cfg)
        else:
            _, _, first, logits = decode.prefill_into_slots(sd, k, v, tokens, lengths, ids, cfg)
            _, _, nxt, tick = decode.decode_step(sd, k, v, [4, 5, 0], [3, 16, 0], cfg)
        out.append((first, logits, nxt, tick, k, v))
    for a, b in zip(*out):
        assert torch.equal(a, b)


# ---------------------------------------------------------- the route rule


@pytest.mark.parametrize("device,generative,route,why", [
    ("cpu", True, "eager", "CUDA device"),
    ("cpu", False, "eager", "CUDA device"),
    ("cuda", False, "graph", "a classifier on CUDA"),
    ("cuda", True, "graph", "replays one captured CUDA graph"),
])
def test_serve_route(device, generative, route, why):
    got, reason = decode_graphs.serve_route(device, generative)
    assert got == route and why in reason


def test_servers_report_their_route():
    lm = tserver.InferenceServer("transformer-lm", "/nope", 0, batch_max=2,
                                 batch_timeout_ms=5.0, device="cpu")
    clf = tserver.InferenceServer("mnist-mlp", "/nope", 0, batch_max=2,
                                  batch_timeout_ms=5.0, device="cpu")
    assert (lm.route, clf.route) == ("eager", "eager")
    assert "CUDA device" in lm.route_why and lm._graphs is None


# ----------------------------------------------------------- bookkeeping


@pytest.fixture
def graphed(fake_cuda, lm64):
    """A GraphedDecode over the 64-wide LM, 4 + 1 slots, captured at (2, 16),
    (4, 32) and the tick, then sealed."""
    _, _, sd, cfg = lm64
    g = decode_graphs.GraphedDecode(sd, decode.init_kv_cache(cfg, 5, 64, device="cpu"), cfg)
    for rb, tb in ((2, 16), (4, 32)):
        g.prefill(sd, g.k, g.v, np.zeros((rb, tb), np.int32), np.ones(rb, np.int32),
                  np.full(rb, 4, np.int32))
    g.decode(sd, g.k, g.v, np.zeros(5, np.int32), np.zeros(5, np.int32))
    g.seal()
    assert len(fake_cuda.graphs) == 3
    return g


def test_a_batch_outside_the_captured_grid_raises(graphed):
    g = graphed
    with pytest.raises(ValueError, match="outside the captured grid"):
        g.prefill(g.params, g.k, g.v, np.zeros((2, 32), np.int32), np.ones(2), [0, 1])
    with pytest.raises(ValueError, match="do not make one batch"):
        g.prefill(g.params, g.k, g.v, np.zeros((2, 16), np.int32), np.ones(3), [0, 1])
    with pytest.raises(ValueError, match="every one of the 5 slots"):
        g.decode(g.params, g.k, g.v, np.zeros(4), np.zeros(4))
    with pytest.raises(RuntimeError, match="another parameter dict"):
        g.decode(dict(g.params), g.k, g.v, np.zeros(5), np.zeros(5))
    _, _, first, _ = g.prefill(g.params, g.k, g.v, np.ones((2, 16), np.int32),
                               np.array([3, 16]), [0, 1])
    assert first.shape == (2,)


@pytest.mark.parametrize("pos", [[0, 0, 64, 0, 0], [-1, 0, 0, 0, 0]])
def test_a_position_outside_the_cache_raises_before_any_copy(graphed, pos):
    g = graphed
    static, _ = g.tick
    before = static.host_buffer.clone(), static.device_buffer.clone()
    with pytest.raises(ValueError, match="outside the cache"):
        g.decode(g.params, g.k, g.v, np.full(5, 7), np.array(pos))
    assert torch.equal(static.host_buffer, before[0])
    assert torch.equal(static.device_buffer, before[1])


@pytest.mark.parametrize("ids,needle", [([1, 1], "repeat a slot other than"),
                                        ([0, 5], "outside"), ([-1, 4], "outside")])
def test_a_bad_slot_id_raises_before_any_copy(graphed, ids, needle):
    g = graphed
    static, _ = g.prefills[(2, 16)]
    before = static.host_buffer.clone(), static.device_buffer.clone()
    with pytest.raises(ValueError, match=needle):
        g.prefill(g.params, g.k, g.v, np.full((2, 16), 9), np.array([4, 4]), np.array(ids))
    assert torch.equal(static.host_buffer, before[0])
    assert torch.equal(static.device_buffer, before[1])
    g.prefill(g.params, g.k, g.v, np.full((2, 16), 9), np.array([4, 4]), np.array([4, 4]))


def test_adopt_copies_in_place_and_keeps_the_captured_dict(graphed):
    g = graphed
    held = {k: v for k, v in g.params.items()}
    new = {k: v + 1.0 for k, v in g.params.items()}
    assert g.adopt(new) is g.params
    assert all(g.params[k] is held[k] and torch.equal(g.params[k], new[k]) for k in new)
    with pytest.raises(ValueError, match="captured names"):
        g.adopt({"lm_head.weight": new["lm_head.weight"]})


# ------------------------------------ the server with stand-in graphs vs JAX


@pytest.fixture(scope="module")
def lms():
    """The tiny f32 LM (tests/test_torch_serve.py's) at two seeds, the old
    and the new weights of a swap, and the JAX decode functions jitted once."""
    jc = JConfig(vocab_size=61, num_layers=2, hidden=32, num_heads=2, max_len=32,
                 causal=True, dtype=jnp.float32)
    old, new = (jax.device_get(JLM(jc).init(jax.random.PRNGKey(s),
                                            jnp.zeros((1, 4), jnp.int32))["params"])
                for s in (3, 4))
    fns = (jax.jit(functools.partial(jdecode.prefill_into_slots, cfg=jc)),
           jax.jit(functools.partial(jdecode.decode_step, cfg=jc)))
    return jc, old, new, fns


def _jax_server(lms, continuous):
    jc, old, _, (prefill_fn, decode_fn) = lms
    srv = jserver.InferenceServer("transformer-lm", "/nope", 0, batch_max=2,
                                  batch_timeout_ms=5.0, replica="g", max_seq_len=32,
                                  max_new_tokens=31, max_slots=2, continuous=continuous)
    srv._prefill_fn, srv._decode_fn = prefill_fn, decode_fn
    srv._kv = jdecode.init_kv_cache(jc, 3, 32)
    srv._positions = np.zeros((3,), np.int32)
    srv._last_tokens = np.zeros((3,), np.int32)
    srv._live = (old, 1)
    return srv


def _port_server(ckpt_dir, monkeypatch, continuous, graph):
    """The port server loaded from ckpt_dir by its own load(), in f32, on the
    graph route (with the stand-ins) or the eager one."""
    real = decode.config_from_params
    monkeypatch.setattr(decode, "config_from_params", lambda *a, **k: dataclasses.replace(
        real(*a, **k), dtype=torch.float32))
    monkeypatch.setenv("TPUJOB_SERVE_NUM_HEADS", "2")
    srv = tserver.InferenceServer("transformer-lm", str(ckpt_dir), 0, batch_max=2,
                                  batch_timeout_ms=5.0, replica="g", max_seq_len=32,
                                  max_new_tokens=31, max_slots=2, continuous=continuous,
                                  device="cpu")
    if graph:
        srv.route = "graph"
    srv.load()
    assert (srv._graphs is not None) == graph
    return srv


def _run(mod, srv, requests, swap=None):
    """Submit every request, then serve them all; `swap` = (tick, params):
    the follower's swap, made at that tick's call."""
    items = []
    for rows, max_new in requests:
        item = mod._Pending([list(r) for r in rows], max_new=max_new)
        srv._shift_inflight(+1)
        assert srv.queue.submit(item)
        items.append(item)
    if swap is not None:
        at, params = swap
        fn, n = srv._decode_fn, [0]

        def tick(*args):
            n[0] += 1
            if n[0] == at:
                srv._live = (params, 2)
            return fn(*args)

        srv._decode_fn = tick
    srv.queue.close()
    threads = srv.start_pipeline()
    for item in items:
        assert item.event.wait(60), "request never answered"
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    return [(i.result, i.error, i.step) for i in items]


def _rows(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 61, n).tolist() for n in lengths]


SCENARIOS = {
    # (continuous, [(rows, maxNewTokens)], the tick of the swap or None)
    "continuous_admits_mid_decode": (True, [(_rows(0, [2]), 8), (_rows(1, [3]), 2),
                                            (_rows(2, [2]), 2)], None),
    "run_to_completion_gates_admission": (False, [(_rows(0, [2]), 8), (_rows(1, [3]), 2),
                                                  (_rows(2, [2]), 2)], None),
    "single_token_retires_at_prefill": (True, [(_rows(3, [2, 1]), 1)], None),
    "hot_swap_during_active_decode": (True, [(_rows(4, [3]), 12), (_rows(5, [5]), 6)], 3),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_graphed_server_answers_as_the_jax_server(name, lms, fake_cuda, tmp_path,
                                                  monkeypatch):
    continuous, requests, swap_at = SCENARIOS[name]
    jc, old, new, _ = lms
    ckpt.save(str(tmp_path / "ck"), 1, tfm.params_from_flax(old))
    want = _run(jserver, _jax_server(lms, continuous), requests,
                swap_at and (swap_at, new))
    got = {}
    for graph in (True, False):
        srv = _port_server(tmp_path / "ck", monkeypatch, continuous, graph)
        got[graph] = _run(tserver, srv, requests,
                          swap_at and (swap_at, tfm.params_from_flax(new)))
        if graph:
            graphs = srv._graphs
            assert graphs.sealed and sorted(graphs.prefills) == [(1, 16), (1, 32), (2, 16),
                                                                 (2, 32)]
            assert sum(g.replays for g in fake_cuda.graphs) > 0
            if swap_at:  # the captured dict serves on, holding the new weights
                assert srv._live[0] is graphs.params and srv._live[1] == 2
                want_w = tfm.params_from_flax(new)["lm_head.weight"]
                assert torch.equal(graphs.params["lm_head.weight"], want_w)
    assert all(err is None for _, err, _ in want)
    assert got[True] == got[False] == want
    if swap_at:
        assert [step for _, _, step in want] == [2, 2]


# ------------------------------------------ chip_smoke's serve graph check


def test_serve_graph_check_passes_sound_and_names_each_fault(graphed, lm64):
    """chip_smoke.serve_graph_check at a CPU size (3 points of the grid, 6
    ticks, the swap) through the stand-ins: the sound run has no failure,
    each planted fault one that starts with its name."""
    g = graphed
    points = ((2, 16), (4, 32))
    fails = chip_smoke.serve_graph_run(g, points, ticks=6, seed=0)
    assert fails == []
    for _, fault, must in chip_smoke.SERVE_GRAPH_FAULTS:
        with chip_smoke.planted_serve_graph_fault(fault):
            got = chip_smoke.serve_graph_run(g, points, ticks=6, seed=0)
        assert got and any(f.startswith(must) for f in got), (fault, got)
        if must == "swap":
            assert all(f.startswith("swap") for f in got), got


def _tick_events(graphed: bool, ticks: int = 10, kernels: int = 5):
    """A synthetic profile of `ticks` ticks: each tick's staging copy in,
    `kernels` kernels, the next tokens' copy out and a synchronise, with
    the host call behind each device event: one cudaGraphLaunch a tick for
    the kernels when graphed, else one cudaLaunchKernel a kernel."""
    device, host, t, corr = [], [], 0, 0

    def call(name):
        nonlocal corr
        corr += 1
        host.append((name, corr))
        return corr

    for _ in range(ticks):
        device.append(("Memcpy HtoD (Pinned -> Device)", t, call("cudaMemcpyAsync")))
        graph = call("cudaGraphLaunch") if graphed else None
        for i in range(kernels):
            t += 10
            device.append((f"kernel_{i}", t, graph or call("cudaLaunchKernel")))
        t += 10
        device.append(("Memcpy DtoH (Device -> Pageable)", t, call("cudaMemcpyAsync")))
        host.append(("cudaStreamSynchronize", 0))
        t += 10
    return device, host


def test_tick_census_counts_one_graph_launch_a_tick():
    device, host = _tick_events(graphed=True)
    census = chip_smoke.tick_census(device, host, 10)
    assert census["graph_launches"] == 10 and census["device_events_per_tick"] == 7
    assert census["host_calls_per_tick"] == {"cudaMemcpyAsync": 2.0, "cudaGraphLaunch": 1.0,
                                             "cudaStreamSynchronize": 1.0}
    assert census["kernels_by_launch_api"] == {"cudaGraphLaunch": 50}
    assert chip_smoke.tick_census_failures(census) == []
    # Events the profile missed (a tick's first kernels, a graph launch's
    # host record) leave the census sound.
    lost = [e for e in device if e[0] != "kernel_0" or e[1] > 100]
    launches = [h for h in host if h[0] == "cudaGraphLaunch"]
    census = chip_smoke.tick_census(lost, [h for h in host if h != launches[3]], 10)
    assert census["graph_launches"] == 10 and census["kernels_by_launch_api"] == {
        "cudaGraphLaunch": 43, "unattributed": 5}
    assert chip_smoke.tick_census_failures(census) == []


def test_tick_census_rejects_kernels_launched_one_by_one():
    device, host = _tick_events(graphed=False)
    census = chip_smoke.tick_census(device, host, 10)
    assert census["graph_launches"] == 0
    assert census["kernels_by_launch_api"] == {"cudaLaunchKernel": 50}
    fails = chip_smoke.tick_census_failures(census)
    assert len(fails) == 2 and "cudaGraphLaunch" in fails[0] and "outside the graph" in fails[1]
    device, host = _tick_events(graphed=True, ticks=12)
    fails = chip_smoke.tick_census_failures(chip_smoke.tick_census(device, host, 10))
    assert fails == ["12 cudaGraphLaunch calls over 10 ticks"]
