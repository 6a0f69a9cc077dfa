"""The device phase stamps of the port's training step (telemetry/phases.py,
csrc/phase_stamp.cu), on the CPU.

The stamp kernel runs only on the card (benchmarks/tests/
test_port_bench_phase_stamps.py holds it there). Here a Python stand-in of
the kernel (`emulate`) writes a counter where the kernel writes
%globaltimer, so what surrounds it runs as on the card: the ring, its
wrap-around, the telescoping phases, the marks' order in a real forward and
backward of BertMLM (the trunk's gradient hook included), the done event's
fields, the Chrome track and the count of each phase's operations in a
graph. Also: the disabled path launches nothing and costs one attribute
read; the tracer's spans open a torch.profiler range only while a profiler
records; the trainer's done event on the CPU has no device fields.
"""

from __future__ import annotations

import itertools
import json
import time

import pytest
import torch

from tf_operator_tpu_torch.telemetry import phases, tracer

M = len(phases.MARKS)


def emulate(monkeypatch, clock=None):
    """Replace the kernel launch by its arithmetic on a CPU ring, with a
    clock that advances 1000 ns a stamp (or `clock`); returns the launch
    log [(mark, ring)]."""
    ticks = clock or itertools.count(1000, 1000)
    log = []

    def launch(ring, mark, marks, slots, advance, node=None):
        step = int(ring[0])
        at = 1 + (step % slots) * marks
        if mark == 0:
            ring[at + 1:at + marks] = 0
        ring[at + mark] = next(ticks)
        if advance:
            ring[0] = step + 1
        log.append((mark, ring))

    monkeypatch.setattr(phases, "_launch", launch)
    return log


def armed(stamps: phases.DeviceStamps) -> phases.DeviceStamps:
    """DeviceStamps.start without its CUDA check: a CPU ring, armed."""
    if stamps.ring is None:
        stamps.ring = torch.zeros(1 + stamps.slots * M, dtype=torch.int64)
    stamps.armed, stamps.seen = True, set()
    stamps._stamp(0)
    return stamps


def one_step(stamps, marks=phases.MARKS[1:]):
    armed(stamps)
    for name in marks:
        stamps.mark(name)


def test_ring_keeps_the_last_steps_across_the_wrap(monkeypatch):
    emulate(monkeypatch)
    stamps = phases.DeviceStamps(slots=4)
    for _ in range(10):
        one_step(stamps)
    assert int(stamps.ring[0]) == 10
    rows = stamps.rows(100)
    # At most slots - 1 steps: the next row is the next step's.
    assert len(rows) == 3
    starts = [r[0] for r in rows]
    assert starts == sorted(starts) and starts[-1] == 9 * M * 1000 + 1000
    assert all(r == sorted(r) for r in rows)
    assert stamps.rows(2) == rows[1:]


def test_last_rows_on_a_synthetic_ring():
    slots, marks = 5, 3
    ring = [7] + [0] * (slots * marks)
    for step in range(7):  # steps 0..6: step s in row s % 5
        at = 1 + (step % slots) * marks
        ring[at:at + marks] = [100 * step + 1, 100 * step + 2, 100 * step + 3]
    rows = phases.last_rows(ring, 4, slots, marks)
    assert [r[0] for r in rows] == [301, 401, 501, 601]  # oldest first, across the wrap
    assert phases.last_rows(ring, 99, slots, marks)[0][0] == 301
    assert phases.last_rows([0] + ring[1:], 4, slots, marks) == []
    assert phases.last_rows([2] + ring[1:], 4, slots, marks) == [ring[1:4], ring[4:7]]


def test_phases_telescope_to_the_step_span():
    t = [10, 25, 60, 95, 150, 230, 260, 262]  # MARKS order
    ns = phases.step_phase_ns(t)
    assert sum(ns[p] for p in phases.STEP_PHASES) == ns["step"] == 252
    assert ns["mlm_head_fwd"] == 35 and ns["mlm_head_bwd"] == 55
    assert ns["forward"] >= ns["mlm_head_fwd"] and ns["backward"] >= ns["mlm_head_bwd"]
    # A step without the trunk's marks (an LM, an MLP): its head phases are left out.
    t2 = [10, 25, 0, 95, 0, 230, 260, 262]
    ns2 = phases.step_phase_ns(t2)
    assert "mlm_head_fwd" not in ns2 and "mlm_head_bwd" not in ns2
    assert sum(ns2[p] for p in phases.STEP_PHASES) == ns2["step"]


def test_summary_reads_per_step_percentiles():
    base = 7_000_000  # a 0 reads as a mark the step did not reach
    rows = [[base + t for t in (0, 1_000_000, 2_000_000, 3_000_000 + k, 4_000_000, 5_000_000,
                                6_000_000, 10_000_000 + 1_000_000 * k)] for k in range(20)]
    s = phases.summarize_rows(rows, {"optimizer": 3})
    assert s["device_step_ms"]["p50"] == 19.0 and s["device_step_ms"]["max"] == 29.0
    assert s["device_step_ms"]["p95"] == 28.0 and s["device_step_ms"]["p99"] == 29.0
    assert set(s["device_phase_ms"]) == set(phases.DEVICE_PHASES)
    assert s["device_phase_ms"]["optimizer"] == {"p50": 1.0, "p95": 1.0}
    assert s["device_phase_ops"] == {"optimizer": 3}
    assert phases.summarize_rows([], None) is None
    assert phases.summarize_rows([[5] + [0] * (M - 1)], None) is None  # no end: no step


def test_bert_marks_come_in_order_through_a_real_backward(monkeypatch):
    """A BertMLM step with the stamps armed: every mark stamps once, in
    MARKS order; the trunk's gradient hook fires after the head's and the
    loss's backward (the trunk's output is the head's input) and before the
    backward ends, and the capture's node list would be filled in order."""
    from tf_operator_tpu_torch import optim
    from tf_operator_tpu_torch.models import transformer as tfm
    from tf_operator_tpu_torch.parallel import train_step as ts

    log = emulate(monkeypatch)
    stamps = phases.DeviceStamps(slots=8)
    monkeypatch.setattr(phases, "_STAMPS", stamps)
    cfg = tfm.TransformerConfig(vocab_size=128, hidden=32, num_heads=2, num_layers=2,
                                mlp_ratio=2, max_len=16, dtype=torch.float32)
    model = tfm.BertMLM(cfg, generator=torch.Generator().manual_seed(0))
    tx = optim.make_optimizer(optim.OptimizerConfig(name="adamw", learning_rate=1e-3))
    state = ts.create_train_state(model, tx)
    batch = tfm.make_mlm_batch(torch.Generator().manual_seed(1), 2, 16, 128)

    def loss_fn(m, b):
        return tfm.mlm_loss(m(b["tokens"]), b["targets"], b["mask"])

    for step in range(3):
        armed(stamps)
        phases.mark("batch")
        phases.mark("batch")  # a mark stamps once a step
        state, _ = ts.train_step(state, batch, loss_fn, tx)
        assert not stamps.armed  # `end` disarms
    assert [m for m, _ in log] == list(range(M)) * 3
    rows = stamps.rows(3)
    assert len(rows) == 3 and all(r == sorted(r) and all(r) for r in rows)
    # Disarmed, nothing stamps: the model's and the step's marks are inert.
    n = len(log)
    state, _ = ts.train_step(state, batch, loss_fn, tx)
    assert len(log) == n


def test_remat_stamps_the_trunk_once(monkeypatch):
    """Under remat the loss's forward runs again in the backward: the
    trunk's mark keeps its forward stamp."""
    from tf_operator_tpu_torch import optim
    from tf_operator_tpu_torch.models import transformer as tfm
    from tf_operator_tpu_torch.parallel import train_step as ts

    log = emulate(monkeypatch)
    stamps = phases.DeviceStamps(slots=8)
    monkeypatch.setattr(phases, "_STAMPS", stamps)
    cfg = tfm.TransformerConfig(vocab_size=128, hidden=32, num_heads=2, num_layers=1,
                                mlp_ratio=2, max_len=8, dtype=torch.float32)
    model = tfm.BertMLM(cfg, generator=torch.Generator().manual_seed(0))
    tx = optim.make_optimizer(optim.OptimizerConfig(name="adamw", learning_rate=1e-3))
    state = ts.create_train_state(model, tx)
    batch = tfm.make_mlm_batch(torch.Generator().manual_seed(1), 2, 8, 128)
    loss_fn = ts.remat_loss(lambda m, b: tfm.mlm_loss(m(b["tokens"]), b["targets"],
                                                      b["mask"]))
    armed(stamps)
    phases.mark("batch")
    ts.train_step(state, batch, loss_fn, tx)
    assert [m for m, _ in log] == list(range(M))


@pytest.mark.parametrize("nodes", [True, False], ids=["capture", "eager"])
def test_a_capture_collects_each_stamps_node(monkeypatch, nodes):
    """While `nodes` is a list, each stamp adds (mark, its node); the
    launch is asked for the node only then."""
    asked = []

    def launch(ring, mark, marks, slots, advance, node=None):
        asked.append(node is not None)
        if node is not None:
            node.value = 0x1000 + mark

    monkeypatch.setattr(phases, "_launch", launch)
    stamps = phases.DeviceStamps(slots=4)
    stamps.nodes = [] if nodes else None
    one_step(stamps)
    assert asked == [nodes] * M
    if nodes:
        assert stamps.nodes == [(m, 0x1000 + i) for i, m in enumerate(phases.MARKS)]


def test_phase_ops_counts_ancestors_on_a_dag_with_a_branch():
    """A graph with a branch: after `batch` the forward forks into two
    streams (k1 -> k2 and a copy c1) that join at the `forward` stamp; an
    empty node and an event node are never counted, nor are the stamps; a
    fill outside the step (f0, before `start`) belongs to no phase."""
    K, COPY, FILL, EMPTY, EVENT = 0, 1, 2, 5, 7
    kinds = {"f0": FILL, "s0": K, "b1": K, "s1": K, "k1": K, "k2": K, "c1": COPY,
             "e1": EMPTY, "s3": K, "g1": K, "g2": K, "s5": K, "o1": K, "o2": FILL,
             "ev": EVENT, "s6": K, "m1": K, "s7": K}
    deps = {"s0": ["f0"], "b1": ["s0"], "s1": ["b1"], "k1": ["s1"], "k2": ["k1"],
            "c1": ["s1"], "e1": ["k2", "c1"], "s3": ["e1"], "g1": ["s3"], "g2": ["s3"],
            "s5": ["g1", "g2"], "o1": ["s5"], "o2": ["o1"], "ev": ["o2"], "s6": ["ev"],
            "m1": ["s6"], "s7": ["m1"]}
    stamps = {"start": "s0", "batch": "s1", "forward": "s3", "backward": "s5",
              "optimizer": "s6", "end": "s7"}
    ops = phases.phase_ops(kinds, deps, stamps)
    assert ops == {"batch": 1, "forward": 3, "backward": 2, "optimizer": 2, "metrics": 1,
                   "graph": 10, "stamps": 6}
    # The phases that telescope count every operation between start and end.
    assert sum(ops[p] for p in phases.STEP_PHASES) == ops["graph"] - 1  # f0 lies before


def test_phase_ops_of_a_chain_with_the_head_marks():
    names = ["s0", "x", "s1", "t1", "s2", "h1", "h2", "s3", "hb1", "s4", "tb1", "tb2",
             "s5", "a1", "a2", "a3", "s6", "m1", "s7"]
    kinds = {n: 0 for n in names}
    deps = {b: [a] for a, b in zip(names, names[1:])}
    stamps = dict(zip(phases.MARKS, ["s0", "s1", "s2", "s3", "s4", "s5", "s6", "s7"]))
    ops = phases.phase_ops(kinds, deps, stamps)
    assert ops["mlm_head_fwd"] == 2 and ops["mlm_head_bwd"] == 1
    assert ops["forward"] == 3 and ops["backward"] == 3 and ops["optimizer"] == 3
    assert ops["stamps"] == 8 and ops["graph"] == len(names) - 8


def test_disabled_marks_launch_nothing_and_cost_an_attribute_read(monkeypatch):
    """Off (the tracer disabled, the default), start_step disarms and
    launches nothing, even for a CUDA device, and mark / mark_grad return
    after one attribute read: 200k calls well under a second."""
    def refuse(*a, **k):
        raise AssertionError("a stamp was launched while the stamps are off")

    monkeypatch.setattr(phases, "_launch", refuse)
    stamps = phases.DeviceStamps()
    monkeypatch.setattr(phases, "_STAMPS", stamps)
    assert not tracer.get_tracer().enabled
    phases.start_step(torch.device("cuda", 0))
    assert not stamps.armed and stamps.ring is None
    x = torch.ones(2, requires_grad=True)
    t0 = time.perf_counter()
    for _ in range(200_000):
        phases.mark("forward")
    assert time.perf_counter() - t0 < 1.0
    phases.mark_grad(x, "trunk_grad")
    assert x._backward_hooks is None and stamps.launches == 0


def test_enabled_tracer_on_the_cpu_stamps_nothing(monkeypatch):
    monkeypatch.setattr(phases, "_launch", lambda *a, **k: pytest.fail("launched"))
    stamps = phases.DeviceStamps()
    monkeypatch.setattr(phases, "_STAMPS", stamps)
    monkeypatch.setattr(tracer.get_tracer(), "enabled", True)
    phases.start_step(torch.device("cpu"))
    phases.mark("forward")
    assert not stamps.armed and stamps.ring is None
    assert phases.last_steps(10) == [] and phases.device_summary(10) is None
    assert stamps.chrome_events(0, 1, 2) == ([], {})


def test_the_chrome_track_holds_each_steps_device_phases(monkeypatch):
    emulate(monkeypatch)
    stamps = phases.DeviceStamps(slots=8)
    for _ in range(3):
        one_step(stamps)
    # The card's clock reads 5000 ns behind perf_counter_ns, to within 40 ns.
    monkeypatch.setattr(stamps, "clock_offset", lambda: (5000, 40))
    events, other = stamps.chrome_events(epoch_ns=2000, pid=7, tid=3)
    assert other == {"device_steps": 3, "device_clock_error_us": 0.04}
    assert events[0]["ph"] == "M" and events[0]["tid"] == 3
    xs = events[1:]
    assert {e["name"] for e in xs} == {"device/step"} | {f"device/{p}"
                                                         for p in phases.DEVICE_PHASES}
    assert all(e["tid"] == 3 and e["pid"] == 7 and e["dur"] > 0 for e in xs)
    first = [e for e in xs if e["name"] == "device/step"][0]
    assert first["ts"] == (1000 + 5000 - 2000) / 1000 and first["dur"] == 7.0


def test_the_default_tracers_trace_carries_the_device_track(monkeypatch):
    stamps = phases.DeviceStamps()
    monkeypatch.setattr(phases, "_STAMPS", stamps)
    ev = {"ph": "X", "name": "device/step", "cat": "device", "pid": 1, "tid": 1,
          "ts": 1.0, "dur": 2.0}
    monkeypatch.setattr(stamps, "chrome_events",
                        lambda epoch, pid, tid: ([ev], {"device_clock_error_us": 3.0}))
    t = tracer.get_tracer()
    trace = t.chrome_trace()
    assert ev in trace["traceEvents"] and trace["otherData"]["device_clock_error_us"] == 3.0
    # Left out when asked (a card that may never finish its queue), and a
    # tracer of its own has none.
    assert ev not in t.chrome_trace(device=False)["traceEvents"]
    assert ev not in tracer.Tracer(enabled=True).chrome_trace()["traceEvents"]


def test_spans_open_a_profiler_range_only_while_a_profiler_records(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    t = tracer.Tracer(enabled=True)
    with t.span("outside"):
        pass
    assert t._events[-1][0] == "outside"
    opened = []
    real = torch.autograd.profiler.record_function

    def counting(name, *a):
        opened.append(name)
        return real(name, *a)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    with t.span("outside_too"):
        pass
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.span("phase/dispatch"):
            torch.ones(4).sum()
        h = t.begin("step", step=3)
        t.end(h)
        with tracer.Tracer(enabled=False).span("disabled"):
            pass
    assert opened == ["phase/dispatch", "step"]
    names = [e.name for e in prof.events()]
    assert "phase/dispatch" in names and "step" in names and "disabled" not in names
    assert [e[0] for e in list(t._events)[-2:]] == ["phase/dispatch", "step"]


def test_the_trainers_done_event_on_the_cpu_has_no_device_fields(tmp_path, monkeypatch):
    from tf_operator_tpu_torch.models import train

    events = tmp_path / "events.jsonl"
    monkeypatch.setenv("TPUJOB_METRICS_FILE", str(events))
    monkeypatch.delenv("TPUJOB_REPLICA_TYPE", raising=False)
    try:
        rc = train.main(["--device", "cpu", "--model", "mnist-mlp", "--batch", "8",
                         "--steps", "6", "--log-every", "2", "--trace", "--trace-dir",
                         str(tmp_path / "traces")])
    finally:
        tracer.configure(enabled=False)
    assert rc == 0
    got = [json.loads(x) for x in events.read_text().splitlines()]
    done = [e for e in got if e["event"] == "done"][-1]
    assert done["step_time_s"] is not None and done["phase_breakdown"] is not None
    assert not {"device_step_ms", "device_phase_ms", "device_phase_ops"} & set(done)
    trace = json.loads((tmp_path / "traces" / "local-0.trace.json").read_text())
    assert not [e for e in trace["traceEvents"] if e.get("cat") == "device"]
    assert "device_steps" not in trace["otherData"]


def test_phase_cells_cuts_each_replay_at_its_stamps():
    """tools/phase_cells.py's split of a profile: each replay's operations
    (its graph launch's correlation id) between consecutive stamps, in
    order; a replay the profile kept only part of is left out; operations
    launched outside the replays count as "outside"."""
    from benchmarks import cells
    from tools import phase_cells

    stamp = "tpujob_phase_stamp(long long*, int, int, int, int)"
    device, runtime = [], []
    for step in range(4):
        t, corr = 1000 * step, 100 + step
        runtime += [("cudaGraphLaunch", t, t + 1, corr),
                    ("cudaMemsetAsync", t, t + 1, 900 + step)]
        device.append(("fill", t, t + 1, 900 + step))
        for k in range(8):
            if step == 3 and k == 0:
                continue  # the profile lost this replay's first stamp
            device.append((stamp, t + 100 * k + 2, t + 100 * k + 3, corr))
            for j in range(k + 1 if k < 7 else 0):
                name = "nvjet_tst_gemm" if j == 0 else "elementwise_kernel"
                device.append((name, t + 100 * k + 4 + j, t + 100 * k + 5 + j, corr))
    got = phase_cells.split_at_stamps({"device": device, "runtime": runtime},
                                      cells.kernel_groups())
    assert got["replays"] == 3
    spans = got["spans"]
    assert [spans[s]["ops"] for s in phase_cells.SPANS[:-1]] == [1, 2, 3, 4, 5, 6, 7]
    assert spans["optimizer"]["ms"] == {"gemm": 1e-6, "other": 5e-6}
    assert spans["outside"]["ops"] == 4 / 3 and spans["outside"]["ms"] == {"other": 4e-6 / 3}
