"""The port's inference server (tf_operator_tpu_torch/serve/server.py) held
against the JAX package's (tf_operator_tpu/serve/server.py) and run as a
pod would run it, on the CPU (`--device cpu`).

- the bucket ladders and the generative grid equal the JAX functions';
- tests/test_serve.py's and tests/test_serve_fastpath.py's claims on the
  queue, the staging slot and the classifier pipeline (stub apply:
  padding, demux, a malformed batch, a swap under load) hold on both;
- the stub-driven scheduler scenarios of tests/test_serve_decode.py run on
  both servers with equal recorded event orders and answers (the hot swap
  made deterministic: the stub swaps the params at its third tick);
- the retired-slot boundary case (a row with len + maxNew == the window ==
  the position table) through both servers' real decode paths in f32:
  equal answers, no position past the cache on either side, and the
  port's retired slot parked at 0;
- /predict answers of both servers for mnist-mlp and mnist-conv from one
  set of weights, written as a JAX and as a port checkpoint;
- the metric families and their exposition text equal the JAX registry's;
- the port server as a subprocess: the LM's answers equal the same
  request through the server's code in this process; /healthz, /metrics,
  the stats file, the heartbeat and the start/serve_ready/done events; a
  SIGTERM drain that exits 0; a hot swap during active decode that drops
  nothing; a drifted checkpoint kept out; `--device cuda` without CUDA
  exits 1;
- a LocalSession: the unchanged controller starts a port server pod from
  a port TrainJob's checkpoint, and a /predict through it answers.

Torch runs at one thread here and in the server processes
(OMP_NUM_THREADS=1), so the in-process chains are the subprocess's bit for
bit.
"""

import dataclasses
import functools
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import checkpoint as jckpt
from tf_operator_tpu.models import decode as jdecode
from tf_operator_tpu.models import mnist as jmnist
from tf_operator_tpu.models.transformer import TransformerConfig as JConfig
from tf_operator_tpu.models.transformer import TransformerLM as JLM
from tf_operator_tpu.serve import server as jserver
from tf_operator_tpu.status import metrics as jmetrics
from tf_operator_tpu_torch.models import checkpoint as ckpt
from tf_operator_tpu_torch.models import decode
from tf_operator_tpu_torch.models import mnist
from tf_operator_tpu_torch.models import transformer as tfm
from tf_operator_tpu_torch.serve import server as tserver
from tf_operator_tpu_torch.status import metrics as tmetrics

ROOT = Path(__file__).resolve().parents[1]
PY = sys.executable
POD_ENV = {"PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ buckets


@pytest.mark.parametrize("m", [1, 2, 3, 7, 8, 9, 16, 17, 31, 32, 100, 256, 2048])
def test_bucket_ladders_match_jax(m):
    assert tserver.bucket_sizes(m) == jserver.bucket_sizes(m)
    assert tserver.seq_bucket_sizes(m) == jserver.seq_bucket_sizes(m)
    assert tserver.SEQ_BUCKET_FLOOR == jserver.SEQ_BUCKET_FLOOR
    rows, toks = tserver.bucket_sizes(m), tserver.seq_bucket_sizes(m)
    for n in range(1, m + 1):
        assert tserver.select_bucket(n, rows) == jserver.select_bucket(n, rows)
        assert (tserver.select_grid_bucket(min(n, 8), n, rows[:4], toks)
                == jserver.select_grid_bucket(min(n, 8), n, rows[:4], toks)) \
            if min(n, 8) <= rows[:4][-1] else True
    for mod in (tserver, jserver):
        with pytest.raises(ValueError):
            mod.select_bucket(m + 1, rows)


@pytest.mark.parametrize("bucketing,max_slots,batch_max", [(True, 4, 8), (True, 8, 8),
                                                           (False, 8, 8), (True, 16, 5)])
def test_generative_grid_matches_jax(bucketing, max_slots, batch_max):
    kw = dict(batch_max=batch_max, batch_timeout_ms=5.0, replica="g", bucketing=bucketing,
              max_seq_len=128, max_slots=max_slots)
    got = tserver.InferenceServer("transformer-lm", "/nope", 0, device="cpu", **kw)
    want = jserver.InferenceServer("transformer-lm", "/nope", 0, **kw)
    assert (got.buckets, got.seq_buckets, got.generative) == \
        (want.buckets, want.seq_buckets, want.generative)
    assert tserver.GENERATIVE_MODELS == jserver.GENERATIVE_MODELS


# ------------------------------------------------- scheduler (stub-driven)


class _StubModel:
    """tests/test_serve_decode.py's fake device model: prefill's first
    token is 1, every tick emits last + 1, and every call is recorded (the
    params by name) so the two servers' orders can be compared."""

    def __init__(self):
        self.events: list[tuple] = []
        self.lock = threading.Lock()
        self.on_decode = None

    def prefill(self, params, k, v, tok, lens, ids):
        with self.lock:
            self.events.append(("prefill", params[0], tuple(int(x) for x in ids)))
        return k, v, np.ones((tok.shape[0],), np.int32), None

    def decode(self, params, k, v, last, positions):
        with self.lock:
            self.events.append(("decode", params[0]))
            n = sum(e[0] == "decode" for e in self.events)
        if self.on_decode is not None:
            self.on_decode(n)
        return k, v, last + 1, None


def _stub_server(mod, *, max_slots=2, continuous=True, batch_max=4, params=("p1",)):
    extra = {"device": "cpu"} if mod is tserver else {}
    srv = mod.InferenceServer("transformer-lm", "/nope", 0, batch_max=batch_max,
                              batch_timeout_ms=5.0, replica="dec", max_seq_len=32,
                              max_new_tokens=32, max_slots=max_slots, continuous=continuous,
                              **extra)
    stub = _StubModel()
    srv._prefill_fn = stub.prefill
    srv._decode_fn = stub.decode
    srv._kv = (np.zeros(1), np.zeros(1))
    srv._positions = np.zeros((max_slots + 1,), np.int32)
    srv._last_tokens = np.zeros((max_slots + 1,), np.int32)
    srv._live = (params, 1)
    return srv, stub


def _submit(mod, srv, rows, max_new):
    item = mod._Pending([list(r) for r in rows], max_new=max_new)
    srv._shift_inflight(+1)
    assert srv.queue.submit(item)
    return item


def _finish(srv, items, timeout=10.0):
    srv.queue.close()
    threads = srv.start_pipeline()
    for item in items:
        assert item.event.wait(timeout), "request never answered"
    for t in threads:
        t.join(timeout)
        assert not t.is_alive()


def _scenario_continuous(mod, continuous=True):
    srv, stub = _stub_server(mod, continuous=continuous)
    items = [_submit(mod, srv, [[1, 2]], 8), _submit(mod, srv, [[3, 4]], 2),
             _submit(mod, srv, [[5, 6]], 2)]
    _finish(srv, items)
    kinds = [e[0] for e in stub.events]
    prefills = [i for i, k in enumerate(kinds) if k == "prefill"]
    between = kinds[prefills[0]:prefills[1]].count("decode")
    # Continuous: c is admitted after one tick; run-to-completion: after all
    # 7 of a's remaining ticks.
    assert between < 7 if continuous else between == 7, stub.events
    assert items[0].result[0] == list(range(1, 9))
    assert srv._served == 3 and srv._active_now == 0
    return stub.events, [i.result for i in items]


def _scenario_hot_swap(mod):
    srv, stub = _stub_server(mod, params=("old",))

    def swap(n):  # the follower's atomic pair swap, at the third tick
        if n == 3:
            srv._live = (("new",), 2)

    stub.on_decode = swap
    item = _submit(mod, srv, [[1, 2, 3]], 12)
    _finish(srv, [item])
    assert item.error is None and len(item.result[0]) == 12 and item.step == 2
    assert srv._reprefills == 1
    last = None
    for ev in stub.events:  # every tick under new params follows their re-prefill
        if ev[0] == "prefill":
            last = ev[1]
        else:
            assert ev[1] == last, stub.events
    return stub.events, [item.result]


def _scenario_single_token(mod):
    srv, stub = _stub_server(mod)
    item = _submit(mod, srv, [[9, 9], [7]], 1)
    _finish(srv, [item])
    assert item.result == [[1], [1]] and srv._served == 1
    return stub.events, [item.result]


def _scenario_error(mod):
    srv, stub = _stub_server(mod)
    boom = [True]
    orig = stub.prefill

    def flaky(params, k, v, tok, lens, ids):
        if boom[0]:
            boom[0] = False
            raise RuntimeError("device lost")
        return orig(params, k, v, tok, lens, ids)

    srv._prefill_fn = flaky
    a = _submit(mod, srv, [[1, 2], [3, 4]], 3)
    threads = srv.start_pipeline()
    assert a.event.wait(10.0)
    assert a.error is not None and "device lost" in a.error
    b = _submit(mod, srv, [[5, 6]], 3)
    srv.queue.close()
    assert b.event.wait(10.0)
    for t in threads:
        t.join(10.0)
    assert b.error is None and b.result[0] == [1, 2, 3] and srv._inflight == 0
    return stub.events, [a.error, b.result]


SCENARIOS = {
    "continuous_admits_mid_decode": _scenario_continuous,
    "run_to_completion_gates_admission": functools.partial(_scenario_continuous,
                                                           continuous=False),
    "hot_swap_reprefills_first": _scenario_hot_swap,
    "single_token_retires_at_prefill": _scenario_single_token,
    "scheduler_error_answers_and_serves_on": _scenario_error,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scheduler_scenarios_match_jax(name):
    want = SCENARIOS[name](jserver)
    got = SCENARIOS[name](tserver)
    assert got == want


# ------------------------------------- the classifier pipeline (stub apply)

# tests/test_serve.py's and tests/test_serve_fastpath.py's JAX-free claims
# on the queue, the staging slot and the run-to-completion pipeline, run on
# both servers' code.
BOTH = pytest.mark.parametrize("mod", [jserver, tserver], ids=["jax", "port"])


def _classifier(mod, **kw):
    extra = {"device": "cpu"} if mod is tserver else {}
    base = dict(batch_max=8, batch_timeout_ms=5.0, replica="c")
    base.update(kw)
    srv = mod.InferenceServer("mnist-mlp", "/nope", 0, **base, **extra)
    srv._input_shape = (1,)
    return srv


@BOTH
def test_batch_queue_coalesces_caps_and_drains(mod):
    q = mod.BatchQueue(max_rows=4, timeout_s=0.5)
    items = [mod._Pending([[i]]) for i in range(3)]
    for it in items:
        assert q.submit(it)
    assert q.take_batch() == items  # coalesced under the timeout
    full = [mod._Pending([[i]]) for i in range(4)]
    for it in full:
        q.submit(it)
    t0 = time.monotonic()
    assert q.take_batch() == full and time.monotonic() - t0 < 0.4  # no wait when full
    assert not q.submit(mod._Pending([[0]] * 5))  # over max_rows: the 413
    a, b = mod._Pending([[0]] * 3), mod._Pending([[0]] * 3)
    q.submit(a)
    q.submit(b)
    assert q.take_batch() == [a] and q.take_batch() == [b]  # 3 + 3 > 4
    last = mod._Pending([[1]])
    q.submit(last)
    q.close()
    assert q.take_batch() == [last] and q.take_batch() is None
    assert not q.submit(mod._Pending([[1]]))


@BOTH
def test_staging_slot_backpressure_and_close(mod):
    def staged(n):
        return mod._Staged([], None, n, n)

    slot = mod.StagingSlot()
    assert slot.take(timeout_s=0.01) is None and not slot.is_closed()
    assert slot.put(staged(1))
    done = threading.Event()
    t = threading.Thread(target=lambda: (slot.put(staged(2)), done.set()), daemon=True)
    t.start()
    assert not done.wait(0.2), "put must block while the slot is full"
    assert slot.take(timeout_s=1.0).n == 1
    assert done.wait(2.0) and slot.take(timeout_s=1.0).n == 2
    slot.put(staged(3))
    refused = []
    t = threading.Thread(target=lambda: refused.append(slot.put(staged(4))), daemon=True)
    t.start()
    time.sleep(0.05)
    slot.close()
    t.join(2.0)
    assert refused == [False]
    assert slot.take(timeout_s=0.5).n == 3 and slot.take(timeout_s=0.05) is None
    assert slot.is_closed()


def test_http_server_queues_a_burst_of_clients():
    """The server's socket holds 48 connections that it has not accepted
    yet (a burst, while its handler threads are busy): each connect
    completes at once, where a backlog of 5 leaves the later ones waiting
    on dropped handshakes."""
    httpd = tserver._HTTPServer(("127.0.0.1", 0), object)
    socks = []
    try:
        for _ in range(48):
            s = socket.create_connection(httpd.server_address, timeout=2.0)
            socks.append(s)
        assert httpd.request_queue_size >= len(socks)
    finally:
        for s in socks:
            s.close()
        httpd.server_close()


@BOTH
@pytest.mark.parametrize("bucketing", [True, False])
def test_classifier_pipeline_pads_demuxes_and_isolates_errors(mod, bucketing):
    shapes = []
    srv = _classifier(mod, bucketing=bucketing)
    srv._apply = lambda p, x: (shapes.append(x.shape),
                               np.asarray([int(v[0]) * 10 for v in x]))[1]
    bad = mod._Pending([[1, 2], [3]])  # ragged: its batch errors, the pipeline lives
    srv._shift_inflight(+1)
    srv.queue.submit(bad)
    threads = srv.start_pipeline()
    assert bad.event.wait(5.0) and bad.error is not None and bad.result is None
    a, b = mod._Pending([[1], [2]]), mod._Pending([[3]])
    for it in (a, b):
        srv._shift_inflight(+1)
        srv.queue.submit(it)
    srv.queue.close()
    for t in threads:
        t.join(5.0)
        assert not t.is_alive()
    assert a.result == [10, 20] and b.result == [30] and a.step is None
    assert shapes == ([(4, 1)] if bucketing else [(8, 1)])
    assert srv._served == 2 and srv._batches == 1 and srv._inflight == 0
    assert srv.pad_efficiency() == (0.75 if bucketing else 3 / 8)


@BOTH
def test_classifier_swap_under_load_is_never_torn(mod):
    """The follower's atomic pair swap while clients hammer the pipeline:
    every answer comes from a coherent (params, step) pair and each
    client's steps never go backwards."""
    srv = _classifier(mod, batch_timeout_ms=0.5)

    def apply(p, x):
        assert p[0] == p[1], f"torn params: {p}"
        time.sleep(0.001)
        return np.full((x.shape[0],), p[0])

    srv._apply = apply
    srv._live = ((0, 0), 0)
    threads = srv.start_pipeline()
    stop = threading.Event()
    seqs = [[] for _ in range(3)]
    errors = []

    def client(seq):
        while not stop.is_set():
            it = mod._Pending([[1.0]])
            srv._shift_inflight(+1)
            if not srv.queue.submit(it):
                return
            if not it.event.wait(5.0) or it.error is not None:
                errors.append(it.error or "timeout")
                return
            seq.append((it.step, it.result[0]))

    clients = [threading.Thread(target=client, args=(q,), daemon=True) for q in seqs]
    for c in clients:
        c.start()
    for v in range(1, 40):
        srv._live = ((v, v), v)
        time.sleep(0.002)
    stop.set()
    for c in clients:
        c.join(5.0)
    srv.queue.close()
    for t in threads:
        t.join(5.0)
    served = [x for q in seqs for x in q]
    assert not errors and served and all(step == val for step, val in served)
    assert all([s for s, _ in q] == sorted(s for s, _ in q) for q in seqs)
    assert max(s for s, _ in served) > 0


@BOTH
def test_preempt_during_the_follow_wait_is_graceful(mod, tmp_path):
    srv = _classifier(mod, follow=True, follow_poll_s=0.05)
    srv.ckpt_dir = str(tmp_path / "empty")
    srv.stop.set()  # SIGTERM latched while waiting for the first save
    srv.load()
    assert srv._apply is None and srv.loaded_step is None


# ------------------------------------------------- the real decode path


def _lm(seed=0, **kw) -> tuple[JConfig, dict]:
    base = dict(vocab_size=61, num_layers=2, hidden=32, num_heads=2, max_len=32,
                causal=True, dtype=jnp.float32)
    base.update(kw)
    cfg = JConfig(**base)
    return cfg, jax.device_get(JLM(cfg).init(jax.random.PRNGKey(seed),
                                             jnp.zeros((1, 4), jnp.int32))["params"])


def test_retired_slot_boundary_matches_jax(tmp_path, monkeypatch):
    """Row A: len + maxNew == maxSequenceLength == the position table (28 +
    4 == 32), retired after its last tick while row B decodes on; then C
    reuses A's slot. In f32 the two servers give the same tokens. A's slot
    retires at position 31 on the JAX side (the handler's 400 bounds len +
    maxNew by the window, so the feed position stays inside it) and is
    parked at 0 on the port's; no tick on either side reads past the
    cache."""
    monkeypatch.setenv("TPUJOB_SERVE_NUM_HEADS", "2")
    jc, params = _lm(seed=3)
    jckpt.save(str(tmp_path / "jax"), 1, params)
    ckpt.save(str(tmp_path / "port"), 1, tfm.params_from_flax(params))
    rng = np.random.default_rng(0)
    a_row = rng.integers(0, 61, 28).tolist()
    b_row, c_row = rng.integers(0, 61, 2).tolist(), rng.integers(0, 61, 5).tolist()
    out = {}
    for mod, path in ((jserver, "jax"), (tserver, "port")):
        extra = {"device": "cpu"} if mod is tserver else {}
        srv = mod.InferenceServer("transformer-lm", str(tmp_path / path), 0, batch_max=2,
                                  batch_timeout_ms=50.0, max_seq_len=32, max_new_tokens=31,
                                  max_slots=2, **extra)
        srv.load()
        assert srv._decode_cfg.max_len == srv.max_seq_len == 32
        # The same decode functions at f32, so the answers compare exactly.
        if mod is jserver:
            cfg = dataclasses.replace(srv._decode_cfg, dtype=jnp.float32)
            srv._prefill_fn = jax.jit(functools.partial(jdecode.prefill_into_slots, cfg=cfg))
            step_fn = jax.jit(functools.partial(jdecode.decode_step, cfg=cfg))
            srv._kv = jdecode.init_kv_cache(cfg, 3, 32)
        else:
            cfg = dataclasses.replace(srv._decode_cfg, dtype=torch.float32)
            srv._prefill_fn = functools.partial(decode.prefill_into_slots, cfg=cfg)
            step_fn = functools.partial(decode.decode_step, cfg=cfg)
            srv._kv = decode.init_kv_cache(cfg, 3, 32, device="cpu")
            srv._live = ({k: v.float() for k, v in srv._live[0].items()}, srv._live[1])
        seen, late = [], {}
        submitted = threading.Event()

        def tick(params, k, v, last, positions, step_fn=step_fn, seen=seen, late=late,
                 mod=mod, srv=srv, submitted=submitted):
            seen.append(np.array(positions))
            if len(seen) == 4:
                # C is submitted on the dispatch thread after tick 3 was fed,
                # so its admission follows tick 3 on both servers.
                late["c"] = _submit(mod, srv, [c_row], 6)
                submitted.set()
            return step_fn(params, k, v, last, positions)

        srv._decode_fn = tick
        a = _submit(mod, srv, [a_row], 4)
        b = _submit(mod, srv, [b_row], 20)
        threads = srv.start_pipeline()
        assert a.event.wait(30) and a.error is None
        assert submitted.wait(30)
        c = late["c"]
        srv.queue.close()
        assert b.event.wait(30) and c.event.wait(30)
        for t in threads:
            t.join(30)
        assert b.error is None and c.error is None
        seen = np.stack(seen)
        out[path] = ([a.result, b.result, c.result], seen)
    (answers_j, seen_j), (answers_t, seen_t) = out["jax"], out["port"]
    assert answers_t == answers_j
    assert [len(r[0]) for r in answers_t] == [4, 20, 6]
    assert seen_j.max() == 31 and seen_t.max() <= 31
    # A is fed at 28, 29, 30 and retires after its third tick: its slot
    # then sits at 31 on the JAX side until C's admission, at 0 on the port's.
    a_slot = int(np.argmax(seen_j[2]))
    assert seen_j[2, a_slot] == seen_t[2, a_slot] == 30
    assert seen_j[3, a_slot] == 31 and seen_t[3, a_slot] == 0


def _mnist_servers(tmp_path, model: str):
    net = jmnist.MLP() if model == "mnist-mlp" else jmnist.ConvNet()
    params = jax.device_get(net.init(jax.random.PRNGKey(5), jnp.zeros((1, 28, 28))))["params"]
    jckpt.save(str(tmp_path / "jax"), 3, params)
    ckpt.save(str(tmp_path / "port"), 3, mnist.params_from_flax(params))
    return net, params


def _http(srv) -> tuple[ThreadingHTTPServer, list]:
    """run()'s serving half without its signal handlers: the pipeline and
    the handler on an ephemeral port."""
    srv.load()
    threads = srv.start_pipeline()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv._make_handler())
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    srv.ready.set()
    return httpd, threads


def _post(port: int, body: dict, timeout: float = 60.0) -> tuple[int, dict]:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        body = r.read().decode()
    return json.loads(body) if path == "/healthz" else body


@pytest.mark.parametrize("model", ["mnist-mlp", "mnist-conv"])
def test_mnist_predict_matches_jax(tmp_path, model):
    """One set of weights as a JAX and as a port checkpoint; both servers
    over HTTP answer the same rows with the same classes (bf16 compute on
    both: rows whose f32 top-2 margin is under 0.1 may round either way,
    and are left out)."""
    net, params = _mnist_servers(tmp_path, model)
    rows = np.random.default_rng(7).normal(size=(8, 28, 28)).astype(np.float32)
    answers = {}
    for mod, path in ((jserver, "jax"), (tserver, "port")):
        extra = {"device": "cpu"} if mod is tserver else {}
        srv = mod.InferenceServer(model, str(tmp_path / path), 0, batch_max=8,
                                  batch_timeout_ms=5.0, replica=f"mnist-{path}", **extra)
        httpd, threads = _http(srv)
        try:
            code, resp = _post(httpd.server_address[1], {"instances": rows.tolist()})
            assert code == 200 and resp["checkpoint_step"] == 3 and resp["model"] == model
            answers[path] = resp["predictions"]
        finally:
            srv.stop.set()
            srv.queue.close()
            for t in threads:
                t.join(10)
            httpd.shutdown()
    logits = np.asarray(type(net)(dtype=jnp.float32).apply({"params": params}, rows))
    top = np.sort(logits, -1)
    sure = top[:, -1] - top[:, -2] > 0.1
    assert sure.sum() >= 6
    assert np.array_equal(np.array(answers["port"])[sure], np.array(answers["jax"])[sure])
    assert np.array_equal(np.array(answers["jax"])[sure], logits.argmax(-1)[sure])


# ------------------------------------------------------------ metrics


def test_metric_families_match_jax():
    names = tmetrics.DEFAULT.names()
    assert names and all(n.startswith("tpujob_serve_") for n in names)
    assert names == [n for n in jmetrics.DEFAULT.names() if n.startswith("tpujob_serve_")]
    for name in names:
        got, want = tmetrics.DEFAULT._metrics[name], jmetrics.DEFAULT._metrics[name]
        assert (got._kind, got.help, got._labels_only) == (want._kind, want.help,
                                                           want._labels_only)
        assert getattr(got, "buckets", None) == getattr(want, "buckets", None)


def test_metric_exposition_matches_jax():
    """Fresh registries of every serve family on both sides, the same
    operations (children, a bare sample, escaping, remove), equal text."""
    def fill(mod):
        reg = mod.Registry()
        for name in tmetrics.DEFAULT.names():
            fam = tmetrics.DEFAULT._metrics[name]
            kw = {"labels_only": fam._labels_only}
            if fam._kind == "histogram":
                m = reg.histogram(name, fam.help, buckets=fam.buckets, **kw)
            else:
                m = getattr(reg, fam._kind)(name, fam.help, **kw)
            for i, replica in enumerate(('a"1', "b\\2\n", "c")):
                child = m.labels(replica=replica)
                if fam._kind == "histogram":
                    for v in (0.0005, 0.03 * (i + 1), 7.0, 1e9):
                        child.observe(v)
                elif fam._kind == "gauge":
                    child.set(0.25 * i)
                else:
                    child.inc(i + 1)
            m.remove(replica="c")
        bare = reg.counter("tpujob_serve_bare_total", "help with \\ and\nnewline")
        bare.inc(2)
        return reg.expose()

    assert fill(tmetrics) == fill(jmetrics)


# ------------------------------------------------ the server as a pod


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_lm(path, step: int, seed: int, hidden: int = 32, max_len: int = 32) -> dict:
    _, params = _lm(seed=seed, hidden=hidden, max_len=max_len)
    sd = tfm.params_from_flax(params)
    ckpt.save(str(path), step, sd)
    return sd


def _pod_env(tmp_path, ckpt_dir, port: int, **extra) -> dict:
    env = {**os.environ, **POD_ENV,
           "TPUJOB_SERVE_MODEL": "transformer-lm",
           "TPUJOB_SERVE_CHECKPOINT_DIR": str(ckpt_dir),
           "TPUJOB_SERVE_PORT": str(port), "TPUJOB_SERVE_LISTEN_PORT": str(port),
           "TPUJOB_SERVE_BATCH_MAX": "4", "TPUJOB_SERVE_BATCH_TIMEOUT_MS": "2.0",
           "TPUJOB_SERVE_MAX_SEQ_LEN": "32", "TPUJOB_SERVE_MAX_NEW_TOKENS": "16",
           "TPUJOB_SERVE_MAX_CONCURRENT_SEQS": "4", "TPUJOB_SERVE_NUM_HEADS": "2",
           "TPUJOB_SERVE_DEVICE": "cpu", "TPUJOB_POD_NAME": "port-serve-0",
           "TPUJOB_SERVE_STATS_FILE": str(tmp_path / "stats.json"),
           "TPUJOB_HEARTBEAT_FILE": str(tmp_path / "heartbeat.json"),
           "TPUJOB_METRICS_FILE": str(tmp_path / "events.jsonl")}
    env.update(extra)
    return env


def _start(env) -> subprocess.Popen:
    proc = subprocess.Popen([PY, "-m", "tf_operator_tpu_torch.serve.server"], env=env,
                            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True)
    port = int(env["TPUJOB_SERVE_PORT"])
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.stderr.read()
        try:
            if _get(port, "/healthz").get("ok"):
                return proc
        except OSError:
            pass
        time.sleep(0.1)
    proc.kill()
    pytest.fail("the port server never became ready")


def _stop(proc) -> int:
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _inprocess(ckpt_dir, rows, max_new: int, monkeypatch, **kw):
    """The same request through the port server's code in this process
    (load, scheduler, decode functions at the same bucket shapes)."""
    monkeypatch.setenv("TPUJOB_SERVE_NUM_HEADS", "2")
    srv = tserver.InferenceServer("transformer-lm", str(ckpt_dir), 0, batch_max=4,
                                  batch_timeout_ms=2.0, max_seq_len=32, max_new_tokens=16,
                                  max_slots=4, device="cpu", **kw)
    srv.load()
    item = _submit(tserver, srv, rows, max_new)
    _finish(srv, [item], timeout=60)
    assert item.error is None
    return item.result


ROWS = [[5, 9, 2], [7], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]]


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    """One port server subprocess: request ROWS (6 new tokens), then four
    concurrent single rows, /healthz and /metrics, then SIGTERM."""
    tmp = tmp_path_factory.mktemp("pod")
    _write_lm(tmp / "ck", 2, seed=1)
    port = _free_port()
    proc = _start(_pod_env(tmp, tmp / "ck", port))
    try:
        first = _post(port, {"instances": ROWS, "maxNewTokens": 6})
        rng = np.random.default_rng(2)
        reqs = [{"instances": [rng.integers(0, 61, 4).tolist()], "maxNewTokens": n}
                for n in (3, 16, 1, 9)]
        results = [None] * len(reqs)

        def client(i):
            results[i] = _post(port, reqs[i])

        clients = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
        for t in clients:
            t.start()
        for t in clients:
            t.join(60)
        too_long = _post(port, {"instances": [[1] * 20], "maxNewTokens": 16})
        healthz = _get(port, "/healthz")
        metrics = _get(port, "/metrics")
        time.sleep(0.7)  # an idle dispatch loop ticks the heartbeat every 0.5 s
        heartbeat = json.loads((tmp / "heartbeat.json").read_text())
    finally:
        rc = _stop(proc)
    events = [json.loads(x) for x in (tmp / "events.jsonl").read_text().splitlines()]
    return {"tmp": tmp, "first": first, "reqs": reqs, "results": results, "rc": rc,
            "too_long": too_long, "healthz": healthz, "metrics": metrics,
            "heartbeat": heartbeat, "events": events,
            "stats": json.loads((tmp / "stats.json").read_text())}


def test_pod_lm_answers_equal_the_inprocess_chains(pod, monkeypatch):
    code, resp = pod["first"]
    assert code == 200 and resp["checkpoint_step"] == 2 and resp["model"] == "transformer-lm"
    assert [len(p) for p in resp["predictions"]] == [6, 6, 6]
    assert resp["predictions"] == _inprocess(pod["tmp"] / "ck", ROWS, 6, monkeypatch)
    for req, (code, r) in zip(pod["reqs"], pod["results"]):
        assert code == 200 and [len(p) for p in r["predictions"]] == [req["maxNewTokens"]]


def test_pod_healthz_metrics_and_validation(pod):
    h = pod["healthz"]
    assert h["ok"] and h["generative"] and h["checkpoint_step"] == 2
    assert h["buckets"] == [1, 2, 4] and h["seq_buckets"] == [16, 32] and h["max_slots"] == 4
    assert h["tokens_total"] == 18 + 29 and h["decode_steps"] > 0
    code, body = pod["too_long"]
    assert code == 400 and "exceeds maxSequenceLength 32" in body["error"]
    m = pod["metrics"]
    # The 400 is answered before the request is counted, as in the JAX server.
    assert 'tpujob_serve_requests_total{replica="port-serve-0"} 5.0' in m
    assert 'tpujob_serve_tokens_total{replica="port-serve-0"} 47.0' in m
    for fam in ("tpujob_serve_latency_seconds", "tpujob_serve_active_slots",
                "tpujob_serve_decode_steps_total", "tpujob_serve_token_pad_efficiency"):
        assert f"# TYPE {fam} " in m


def test_pod_stats_file_and_heartbeat(pod):
    s = pod["stats"]
    assert set(s) == {"t", "inflight", "inflight_now", "requests_total", "served_total",
                      "batches_total", "rows_useful", "rows_padded", "tokens_useful",
                      "tokens_padded", "pad_efficiency", "pad_efficiency_rows",
                      "pad_efficiency_tokens", "tokens_total", "decode_steps", "reprefills",
                      "active_slots", "max_slots", "loaded_step", "latency_p50_ms",
                      "latency_p99_ms"}
    assert (s["requests_total"], s["served_total"], s["inflight_now"], s["active_slots"],
            s["max_slots"], s["loaded_step"]) == (5, 5, 0, 0, 4, 2)
    assert s["tokens_total"] == 47 and s["latency_p99_ms"] >= s["latency_p50_ms"] > 0
    hb = pod["heartbeat"]  # step = dispatched batches: prefills + ticks
    assert hb["step"] == s["batches_total"] > 0 and hb["pid"] > 0


def test_pod_events_and_sigterm_drain(pod):
    assert pod["rc"] == 0
    names = [e["event"] for e in pod["events"]]
    assert names == ["start", "serve_ready", "done"]
    start, ready, done = pod["events"]
    assert start["role"] == "serve" and start["model"] == "transformer-lm"
    assert ready["checkpoint_step"] == 2 and ready["max_slots"] == 4 and ready["continuous"]
    assert ready["buckets"] == [1, 2, 4] and ready["seq_buckets"] == [16, 32]
    assert done["served"] == 5 and done["batches"] == pod["stats"]["batches_total"]


def test_hot_swap_during_active_decode_drops_nothing(tmp_path):
    """Follow mode: clients keep decoding while a strictly newer checkpoint
    lands; every request gets its full budget, the swap re-prefills
    in-flight sequences, and traffic after it serves the new step."""
    _write_lm(tmp_path / "ck", 1, seed=0, max_len=64)
    port = _free_port()
    proc = _start(_pod_env(tmp_path, tmp_path / "ck", port, TPUJOB_SERVE_FOLLOW="1",
                           TPUJOB_SERVE_FOLLOW_POLL_S="0.2", TPUJOB_SERVE_MAX_SEQ_LEN="64",
                           TPUJOB_SERVE_MAX_NEW_TOKENS="48"))
    swapped = threading.Event()
    results, errors = [], []

    def client(seed, max_new):
        rng = np.random.default_rng(seed)
        extra = 2
        while extra:
            code, r = _post(port, {"instances": [rng.integers(0, 61, 6).tolist()],
                                   "maxNewTokens": max_new})
            if code != 200:
                errors.append((code, r))
            results.append((max_new, r))
            if swapped.is_set():
                extra -= 1

    try:
        clients = [threading.Thread(target=client, args=(i, n), daemon=True)
                   for i, n in enumerate((48, 48, 8, 24))]
        for t in clients:
            t.start()
        time.sleep(0.5)
        _write_lm(tmp_path / "ck", 2, seed=42, max_len=64)
        deadline = time.monotonic() + 30
        while _get(port, "/healthz")["checkpoint_step"] != 2:
            assert time.monotonic() < deadline, "the server never swapped"
            time.sleep(0.05)
        swapped.set()
        for t in clients:
            t.join(60)
            assert not t.is_alive()
        after = _post(port, {"instances": [[1, 2, 3]], "maxNewTokens": 4})
    finally:
        rc = _stop(proc)
    assert not errors, errors
    assert all(len(r["predictions"][0]) == n for n, r in results)
    assert after[0] == 200 and after[1]["checkpoint_step"] == 2
    assert {r["checkpoint_step"] for _, r in results} == {1, 2}
    stats = json.loads((tmp_path / "stats.json").read_text())
    assert stats["reprefills"] >= 1 and rc == 0
    events = [json.loads(x) for x in (tmp_path / "events.jsonl").read_text().splitlines()]
    follows = [e for e in events if e["event"] == "ckpt_follow"]
    assert [(e["result"], e["from_step"], e["step"]) for e in follows] == [("swapped", 1, 2)]


def test_follower_keeps_a_drifted_checkpoint_out(tmp_path, monkeypatch):
    """A newer step with another width is rejected (one error event, the old
    step served on); a newer step with the served signature swaps in."""
    monkeypatch.setenv("TPUJOB_SERVE_NUM_HEADS", "2")
    monkeypatch.setenv("TPUJOB_METRICS_FILE", str(tmp_path / "events.jsonl"))
    _write_lm(tmp_path / "ck", 1, seed=0)
    srv = tserver.InferenceServer("transformer-lm", str(tmp_path / "ck"), 0, batch_max=2,
                                  batch_timeout_ms=2.0, max_seq_len=32, max_slots=2,
                                  follow=True, follow_poll_s=0.05, device="cpu")
    srv.load()
    follower = threading.Thread(target=srv._follow_loop, daemon=True)
    follower.start()
    try:
        _write_lm(tmp_path / "ck", 2, seed=0, hidden=64)

        def follows():
            path = tmp_path / "events.jsonl"
            lines = path.read_text().splitlines() if path.exists() else []
            return [json.loads(x) for x in lines]

        deadline = time.monotonic() + 20
        while not follows():
            assert time.monotonic() < deadline
            time.sleep(0.05)
        time.sleep(0.3)  # several polls: the drifted step is restored once
        assert [(e["result"], e["step"]) for e in follows()] == [("error", 2)]
        assert "param signature" in follows()[0]["reason"] and srv.loaded_step == 1
        _write_lm(tmp_path / "ck", 3, seed=7)
        while srv.loaded_step != 3:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert [(e["result"], e["step"]) for e in follows()] == [("error", 2), ("swapped", 3)]
        params = srv._live[0]
        assert params["trunk.layers.0.attn.query.weight"].dtype == torch.bfloat16
    finally:
        srv.stop.set()
        follower.join(10)


def test_device_cuda_without_cuda_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([PY, "-m", "tf_operator_tpu_torch.serve.server", "--device", "cuda",
                           "--checkpoint-dir", str(tmp_path)], env={**os.environ, **POD_ENV},
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "no CUDA device" in proc.stderr and proc.stdout == ""


def test_example_manifest_starts_a_port_server_pod():
    """examples/torch-serve-lm.yaml through the unchanged controller: with
    follow, its fromTrainJob (examples/torch-lm-preemptible.yaml) resolves
    once the job exists, and the server pod runs the port's server with
    the controller's env, the template's TPUJOB_SERVE_NUM_HEADS and the
    TrainJob's checkpoint dir and model."""
    from tf_operator_tpu.api import compat
    from tf_operator_tpu.core.cluster import InMemoryCluster
    from tf_operator_tpu.serve.controller import InferenceServiceController

    cluster = InMemoryCluster()
    c = InferenceServiceController(cluster)
    cluster.create_job(compat.job_from_yaml(
        (ROOT / "examples/torch-lm-preemptible.yaml").read_text()))
    cluster.create_infsvc(compat.infsvc_from_yaml(
        (ROOT / "examples/torch-serve-lm.yaml").read_text()))
    assert c.run_until_idle(10)
    pods = cluster.list_pods("default")
    assert len(pods) == 1
    container = pods[0].spec.containers[0]
    assert container.command[:3] == ["python", "-m", "tf_operator_tpu_torch.serve.server"]
    env = container.env_dict()
    assert env["TPUJOB_SERVE_NUM_HEADS"] == "6"
    assert env["TPUJOB_SERVE_MODEL"] == "transformer-lm"
    assert env["TPUJOB_SERVE_CHECKPOINT_DIR"] == "/tmp/tpujob-ckpt/torch-lm-preemptible"
    assert (env["TPUJOB_SERVE_FOLLOW"], env["TPUJOB_SERVE_MAX_SEQ_LEN"],
            env["TPUJOB_SERVE_MAX_CONCURRENT_SEQS"]) == ("1", "2048", "8")


def test_local_session_serves_a_port_trainjob(tmp_path, monkeypatch):
    """The unchanged InferenceService controller, through LocalSession:
    a port TrainJob (tiny LM on the CPU) checkpoints; a service with
    fromTrainJob starts a port server pod (`--device cpu`,
    TPUJOB_SERVE_NUM_HEADS in its template) on it; /predict answers with
    the chains of the same checkpoint served in this process."""
    from tf_operator_tpu.api import compat, defaults
    from tf_operator_tpu.api.types import (
        ContainerSpec,
        JobConditionType,
        ObjectMeta,
        PodTemplateSpec,
        ReplicaSpec,
        TrainJob,
        TrainJobSpec,
        is_succeeded,
    )
    from tf_operator_tpu.runtime.session import LocalSession

    monkeypatch.setenv("TPUJOB_PRESPAWN", "0")
    ckpt_dir = str(tmp_path / "ckpt")
    session = LocalSession(env_overrides=dict(POD_ENV), log_dir=str(tmp_path / "logs"))
    try:
        job = TrainJob(metadata=ObjectMeta(name="lm-train"), spec=TrainJobSpec(replica_specs={
            defaults.canonical_replica_type("worker"): ReplicaSpec(
                replicas=1, template=PodTemplateSpec(containers=[ContainerSpec(
                    name="train", image="local", command=[
                        PY, "-m", "tf_operator_tpu_torch.models.train", "--device", "cpu",
                        "--model", "transformer-lm", "--layers", "2", "--hidden", "64",
                        "--heads", "2", "--seq", "32", "--batch", "2", "--steps", "2",
                        "--log-every", "1", "--checkpoint-dir", ckpt_dir])]))}))
        job.spec.run_policy.scheduling.gang = False
        session.submit(defaults.set_defaults(job))
        job = session.wait_for_condition(
            "default", "lm-train", (JobConditionType.SUCCEEDED, JobConditionType.FAILED),
            timeout=180)
        assert is_succeeded(job.status)
        svc = compat.infsvc_from_dict({
            "apiVersion": "tpujob.dev/v1", "kind": "InferenceService",
            "metadata": {"name": "lm-serve", "namespace": "default"},
            "spec": {
                "model": {"fromTrainJob": "lm-train", "maxSequenceLength": 32},
                "serving": {"batchMaxSize": 4, "batchTimeoutMs": 2, "port": 8500,
                            "maxNewTokens": 8, "maxConcurrentSequences": 4},
                "autoscale": {"minReplicas": 1, "maxReplicas": 1},
                "template": {"spec": {"containers": [{
                    "name": "serve", "image": "local",
                    "command": [PY, "-m", "tf_operator_tpu_torch.serve.server",
                                "--device", "cpu"],
                    "env": [{"name": "TPUJOB_SERVE_NUM_HEADS", "value": "2"}]}]}}}})
        session.submit_service(svc)
        session.wait_for_service_condition("default", "lm-serve",
                                           (JobConditionType.RUNNING,), timeout=120)
        addr = session.server_address("lm-serve", "default", 0, port=8500)
        assert addr is not None
        port = int(addr.rsplit(":", 1)[1])
        deadline = time.monotonic() + 90
        while True:
            try:
                if _get(port, "/healthz").get("ok"):
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline, "the port server pod never became ready"
            time.sleep(0.25)
        rows = [[3, 1, 4, 1, 5], [9, 2, 6]]
        code, resp = _post(port, {"instances": rows, "maxNewTokens": 5})
        assert code == 200 and resp["checkpoint_step"] == 2
        assert resp["model"] == "transformer-lm"
        want = _inprocess(ckpt_dir, rows, 5, monkeypatch)
        assert resp["predictions"] == want
    finally:
        session.close()
