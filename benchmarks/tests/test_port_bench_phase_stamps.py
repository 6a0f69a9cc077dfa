"""The program's device phase stamps (tf_operator_tpu_torch/telemetry/
phases.py, csrc/phase_stamp.cu) in a cell's graphed step, on the card:

    python -m pytest benchmarks/tests -m card

The cell's step is built as run.py builds it, once with the tracer enabled
before the build (the capture then holds the stamps) and once without. With
the stamps, every phase of every replayed step is positive and the five
that telescope sum to within 1% of the step's CUDA-event time, and the walk
of the captured graph finds all eight stamps, the one launched by the
trunk's gradient hook included. Without them, a replay runs exactly the
stamped one's device operations less the eight stamps.
"""

from __future__ import annotations

import gc
import statistics

import pytest
import torch

from benchmarks import cells, run, weights
from benchmarks import trace as trace_lib

CELL = "bert-base.seq128"
STEPS = 8
STAMP = "tpujob_phase_stamp"


def _drive(cell: dict, device, stamped: bool) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    from tf_operator_tpu_torch.telemetry import phases, tracer

    tracer.configure(enabled=stamped)
    try:
        init = weights.make(cell["arch"], cell["cfg"]["init_std"], 5, device)
        state, step_fn, route = run.build(cell, 5, device, init)
        del init
        steps = run.Steps(step_fn, state, device)
        for _ in range(3):
            steps.step()
        steps.sync()
    finally:
        tracer.configure(enabled=False)
    window = run.Steps(step_fn, steps.state, device)
    window.mark()
    for _ in range(STEPS):
        window.step()
    window.sync()
    out = {"route": route, "step_ms": window.step_ms(),
           "rows": phases.last_steps(STEPS) if stamped else None,
           "ops": phases.device_stamps().ops if stamped else None}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        window.mark()
        for _ in range(STEPS + 2):
            with record_function(trace_lib.STEP_MARK):
                window.step()
        window.sync()
    ev = trace_lib.events(prof)
    summary = trace_lib.summarize(ev, cells.kernel_groups())
    # Each replay's device operations, by its launch's correlation id; the
    # median replay (the profiler's first cycle may miss some of its own).
    per_replay = {c: [0, 0] for name, _, _, c in ev["runtime"] if "GraphLaunch" in name}
    for name, _, _, c in ev["device"]:
        if c in per_replay:
            per_replay[c][0] += 1
            per_replay[c][1] += STAMP in name
    out.update(ops_per_step=summary["ops"] / summary["steps"],
               graph_ops_per_replay=statistics.median(n for n, _ in per_replay.values()),
               stamps_per_replay=statistics.median(k for _, k in per_replay.values()))
    del steps, window, state, step_fn
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


@pytest.fixture(scope="module")
def driven():
    """{stamped: the driven step's readings}, stamped first; skips without
    a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run `python -m pytest benchmarks/tests -m card` "
                    "on the chip")
    cell = cells.load(CELL)
    device = torch.device("cuda", 0)
    return {stamped: _drive(cell, device, stamped) for stamped in (True, False)}


@pytest.mark.card
def test_stamped_replays_read_positive_phases_that_sum_to_the_event_step(driven):
    from tf_operator_tpu_torch.telemetry import phases

    got = driven[True]
    assert got["route"] == "graph" and len(got["rows"]) == STEPS
    per = [phases.step_phase_ns(r) for r in got["rows"]]
    for p in per:
        assert set(p) == {"step", *phases.DEVICE_PHASES}, p
        assert all(ns > 0 for ns in p.values()), p
        assert sum(p[x] for x in phases.STEP_PHASES) == p["step"]
    device_ms = statistics.median(p["step"] / 1e6 for p in per)
    event_ms = statistics.median(got["step_ms"])
    assert abs(device_ms - event_ms) <= 0.01 * event_ms, (device_ms, event_ms)


@pytest.mark.card
def test_the_graph_walk_finds_all_eight_stamps(driven):
    from tf_operator_tpu_torch.telemetry import phases

    ops = driven[True]["ops"]
    assert ops is not None and ops["stamps"] == len(phases.MARKS) == 8
    assert all(ops[p] > 0 for p in phases.DEVICE_PHASES), ops
    # The walk's count is what a replay runs under its graph launch.
    assert driven[True]["stamps_per_replay"] == 8
    assert driven[True]["graph_ops_per_replay"] == ops["graph"] + 8


@pytest.mark.card
def test_without_stamps_a_replay_runs_the_same_operations_less_the_stamps(driven):
    on, off = driven[True], driven[False]
    assert off["stamps_per_replay"] == 0
    assert off["graph_ops_per_replay"] == on["graph_ops_per_replay"] - 8
    assert off["ops_per_step"] == on["ops_per_step"] - 8
