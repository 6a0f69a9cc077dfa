#!/usr/bin/env python3
"""The device phases of the port's training step in the benchmark's cells,
on one CUDA card: what the step's own stamps (telemetry/phases.py) read,
what they cost, and the trainer's done event and trace with them.

    python3 tools/phase_cells.py cells --cells bert-base.seq512,bert-base.seq128 \
        --runs 6 --seconds 20 --out chiprun_out/phase_cells.jsonl
    python3 tools/phase_cells.py trainer --cell bert-base.seq512 --steps 300 \
        --out chiprun_out/phase_trainer.jsonl

`cells`: for each cell, one process builds the cell's step as the benchmark
builds it (benchmarks/run.py's build, on the benchmark's weights from a
seed of its own each run) 2 x --runs times, stamps off and on in turns
(off, on, on, off, ...): the tracer is enabled before the build for a
stamped run, so the capture holds the stamps. Each run drives the
benchmark's set-up steps, then a --seconds window, one step a call, at most
two in flight (benchmarks/run.py's Steps), and records tokens/s (host clock
from a synchronize to a synchronize), the CUDA-event step ms and, stamped,
each step's device phases, the median of batch + forward + backward +
optimizer + metrics against the median event step, and the graph's
operations by phase (GraphedStep's walk). The first run of each kind then
profiles 16 steps (torch.profiler, cut at the benchmark's host ranges, as
benchmarks/trace.py cuts them): device operations a step and, stamped, the
device time of each span between two stamps by kernel group
(benchmarks/kernels), and the operations outside the graph.

`trainer`: one run of the trainer (`models/train.py`) at the cell's flags
with --trace for --steps steps: its done event (device_step_ms,
device_phase_ms, device_phase_ops) and, from its trace file's device track,
each step's device phases and their means by tenth of the run.

Each record is a JSON line in --out, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

STAMP = "tpujob_phase_stamp"
# The spans between a replay's consecutive stamps, then the operations
# launched outside the replays.
SPANS = ("batch", "trunk_fwd", "mlm_head_fwd", "mlm_head_bwd", "trunk_bwd", "optimizer",
         "metrics", "outside")


def card() -> dict:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return {"card": out.stdout.strip().splitlines()[0] if out.returncode == 0 else None}


def split_at_stamps(ev: dict, groups: dict) -> dict | None:
    """Device ns and operations a step of each SPANS entry, by kernel group,
    from a profiled window of stamped steps: each replay's operations (by
    its graph launch's correlation id) cut in seven at its eight stamps;
    "outside", the operations launched outside the replays. Replays whose
    stamps the profile did not all keep are left out; None without one."""
    from benchmarks import trace as trace_lib

    launches = {c for name, _, _, c in ev["runtime"] if "GraphLaunch" in name}
    by_replay: dict[int, list] = {c: [] for c in launches}
    outside = []
    for name, s, e, c in ev["device"]:
        (by_replay[c] if c in by_replay else outside).append((s, e, name))
    out = {span: {"ops": 0, "ns": {}} for span in SPANS}
    replays = 0
    for ops in by_replay.values():
        ops.sort()
        stamps = [i for i, (_, _, name) in enumerate(ops) if STAMP in name]
        if len(stamps) != len(SPANS):
            continue
        replays += 1
        for k, (a, b) in enumerate(zip(stamps, stamps[1:])):
            for s, e, name in ops[a + 1:b]:
                span = out[SPANS[k]]
                g = trace_lib.group_of(name, groups)
                span["ops"] += 1
                span["ns"][g] = span["ns"].get(g, 0) + e - s
    if not replays:
        return None
    for s, e, name in outside:
        g = trace_lib.group_of(name, groups)
        out["outside"]["ops"] += 1
        out["outside"]["ns"][g] = out["outside"]["ns"].get(g, 0) + e - s
    for span in out.values():
        span["ops"] /= replays
        span["ms"] = {g: ns / 1e6 / replays for g, ns in span.pop("ns").items()}
    return {"replays": replays, "spans": out}


def one_run(cell: dict, seed: int, seconds: float, stamped: bool, profile: bool) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    from benchmarks import cells, run as bench_run, weights
    from benchmarks import trace as trace_lib
    from tf_operator_tpu_torch.telemetry import phases, tracer

    device = torch.device("cuda", 0)
    tracer.configure(enabled=stamped).clear()
    torch.cuda.reset_peak_memory_stats()
    init = weights.make(cell["arch"], cell["cfg"]["init_std"], seed, device)
    state, run, route = bench_run.build(cell, seed, device, init)
    del init
    steps = bench_run.Steps(run, state, device)
    for _ in range(3 + cell["warmup_steps"]):
        steps.step()
    steps.sync()
    tracer.configure(enabled=False)  # the stamps are in the graph now
    ops = phases.device_stamps().ops if stamped else None
    window = bench_run.Steps(run, steps.state, device)
    t0 = time.perf_counter()
    window.mark()
    while time.perf_counter() - t0 < seconds:
        window.step()
    window.sync()
    wall = time.perf_counter() - t0
    n = len(window.marks) - 1
    step_ms = window.step_ms()
    rec = {"cell": cell["name"], "seed": seed, "stamped": stamped, "route": route,
           "steps": n, "tokens_per_s": n * cell["shape"]["batch"] * cell["shape"]["seq"] / wall,
           "step_ms_p50": statistics.median(step_ms),
           "step_ms_p95": sorted(step_ms)[min(n - 1, int(0.95 * n))],
           "failed": window.failed(), "peak_bytes": torch.cuda.max_memory_allocated()}
    if stamped:
        rows = phases.last_steps(n)
        rec.update(phases.summarize_rows(rows, ops) or {})
        per = [phases.step_phase_ns(r) for r in rows]
        telescoped = statistics.median(sum(p[x] for x in phases.STEP_PHASES) / 1e6 for p in per)
        rec["phase_sum_ms_p50"] = telescoped
        rec["phase_sum_over_event_step"] = telescoped / rec["step_ms_p50"]
        rec["phase_ms_p50"] = {x: statistics.median(p[x] / 1e6 for p in per if x in p)
                               for x in phases.DEVICE_PHASES}
    if profile:
        traced = bench_run.Steps(run, window.state, device)
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced.mark()
            for _ in range(cell["trace_steps"] + 2):
                with record_function(trace_lib.STEP_MARK):
                    traced.step()
            traced.sync()
        ev = trace_lib.events(prof)
        groups = cells.kernel_groups()
        summary = trace_lib.summarize(ev, groups)
        rec["trace_ops_per_step"] = summary["ops"] / summary["steps"] if summary else None
        rec["trace_group_ms"] = ({g: ns / 1e6 / summary["steps"]
                                  for g, ns in summary["group_ns"].items()} if summary else None)
        if stamped:
            rec["split"] = split_at_stamps(ev, groups)
        del traced
    del steps, window, state, run
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rec


def cells_main(args) -> int:
    from benchmarks import cells

    base = card()
    with open(args.out, "a") as out:
        for name in args.cells.split(","):
            cell = cells.load(name)
            profiled = set()
            for i in range(2 * args.runs):
                stamped = i % 4 in (1, 2)
                seed = args.seed + 7919 * i
                rec = dict(one_run(cell, seed, args.seconds, stamped,
                                   args.profile and stamped not in profiled), **base)
                profiled.add(stamped)
                out.write(json.dumps(rec) + "\n")
                out.flush()
                print(f"phase_cells: {name} stamped={stamped} seed={seed} "
                      f"{rec['tokens_per_s']:.1f} tokens/s p50 {rec['step_ms_p50']:.3f} ms"
                      + (f" phases {json.dumps(rec.get('phase_ms_p50'))}"
                         f" sum/step {rec.get('phase_sum_over_event_step'):.5f}"
                         f" ops {json.dumps(rec.get('device_phase_ops'))}" if stamped else "")
                      + (f" trace ops/step {rec['trace_ops_per_step']}"
                         if "trace_ops_per_step" in rec else ""), flush=True)
    return 0


def tenths(values: list[float]) -> list[float]:
    n = len(values)
    cuts = [round(i * n / 10) for i in range(11)]
    return [sum(values[a:b]) / (b - a) for a, b in zip(cuts, cuts[1:]) if b > a]


def trainer_main(args) -> int:
    from benchmarks import cells

    cell = cells.load(args.cell)
    with tempfile.TemporaryDirectory(dir=ROOT / "chiprun_out") as tmp:
        events = Path(tmp) / "events.jsonl"
        env = dict(os.environ, TPUJOB_METRICS_FILE=str(events))
        env.pop("TPUJOB_REPLICA_TYPE", None)
        cmd = [sys.executable, "-m", "tf_operator_tpu_torch.models.train", *cell["argv"],
               "--device", "cuda", "--steps", str(args.steps), "--log-every",
               str(args.log_every), "--trace", "--trace-dir", tmp]
        t0 = time.time()
        proc = subprocess.run(cmd, cwd=ROOT, env=env)
        got = [json.loads(x) for x in events.read_text().splitlines()] if events.exists() else []
        trace = json.loads((Path(tmp) / "local-0.trace.json").read_text())
    done = next((e for e in reversed(got) if e["event"] == "done"), None)
    device = [e for e in trace["traceEvents"] if e.get("cat") == "device"]
    by_name: dict[str, list] = {}
    for e in sorted(device, key=lambda e: e["ts"]):
        by_name.setdefault(e["name"], []).append(e)
    steps = by_name.get("device/step", [])
    gaps = [(b["ts"] - a["ts"] - a["dur"]) / 1e3 for a, b in zip(steps, steps[1:])]
    rec = {"cell": args.cell, "rc": proc.returncode, "seconds": time.time() - t0,
           "done": done, "other": trace["otherData"], "device_steps": len(steps),
           "window_s": (steps[-1]["ts"] - steps[0]["ts"]) / 1e6 if steps else None,
           "ms_by_tenth": {name.split("/")[1]: tenths([e["dur"] / 1e3 for e in evs])
                           for name, evs in by_name.items()},
           "gap_ms_by_tenth": tenths(gaps) if gaps else None,
           "ms": {name.split("/")[1]: [round(e["dur"] / 1e3, 4) for e in evs]
                  for name, evs in by_name.items()}, **card()}
    with open(args.out, "a") as out:
        out.write(json.dumps(rec) + "\n")
    print(f"phase_cells: trainer {args.cell} rc {proc.returncode}: "
          + json.dumps({k: rec[k] for k in ("device_steps", "window_s", "ms_by_tenth",
                                           "gap_ms_by_tenth", "other")}), flush=True)
    if done is not None:
        print("phase_cells: done " + json.dumps(
            {k: done.get(k) for k in ("examples_per_sec", "step_time_s", "device_step_ms",
                                      "device_phase_ms", "device_phase_ops")}), flush=True)
    return proc.returncode


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="what", required=True)
    c = sub.add_parser("cells")
    c.add_argument("--cells", default="bert-base.seq512,bert-base.seq128")
    c.add_argument("--runs", type=int, default=6, help="runs of each kind a cell")
    c.add_argument("--seconds", type=float, default=20.0)
    c.add_argument("--seed", type=int, default=2_000_003_011)
    c.add_argument("--no-profile", dest="profile", action="store_false")
    t = sub.add_parser("trainer")
    t.add_argument("--cell", default="bert-base.seq512")
    t.add_argument("--steps", type=int, default=300)
    t.add_argument("--log-every", type=int, default=10)
    for p in (c, t):
        p.add_argument("--out", default="chiprun_out/phase_cells.jsonl")
    args = ap.parse_args()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    return cells_main(args) if args.what == "cells" else trainer_main(args)


if __name__ == "__main__":
    sys.exit(main())
