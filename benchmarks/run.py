"""One run of one cell of the port's benchmark, on the card it starts on.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the trainer's step as `tf_operator_tpu_torch.models.train` builds it
(its flags from the cell's files, `_build_model`, `parallelize`, the
optimizer, `create_train_state`, `make_chunked_train_step(...,
graphed=True)` on the card), starting from weights the benchmark makes from
the seed. Set-up drives the first three steps through that same call and
keeps what the comparison needs; a few more steps warm up; then the window
drives one step a call, at most two in flight, for --seconds (with --trace
1: a few steps under torch.profiler instead). After the window the
program is freed and the plain reference (`reference/`) follows the first
three steps again; `correct` is their comparison (`compare.py`).

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and breakdown with --trace 1), then checks, each
compared number with its limit; the same numbers are the last lines of
standard error. No card, too few cards, a missing program or a JAX module
loaded in this process: a message on standard error, exit 2, no result.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmarks import cells, compare, reference, weights  # noqa: E402
from benchmarks import trace as trace_lib  # noqa: E402
from benchmarks.reference import train as ref_train  # noqa: E402

# Top-level module names that may not be loaded in a run (compared whole:
# the port's own name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "tf_operator_tpu")
IN_FLIGHT = 2


class Refused(Exception):
    """A run that must end without a result."""


def log(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.partition(".")[0] in FORBIDDEN)


def power_limit_w() -> float | None:
    """The first card's power limit as nvidia-smi reads it (a card set
    under its 700 W runs slower under load), or None where it cannot."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip())
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def build(cell: dict, seed: int, device, init: dict):
    """(state, run, route): the trainer's step, built as _run_trainer builds
    it, on the benchmark's weights `init`."""
    from tf_operator_tpu_torch import optim as optim_lib
    from tf_operator_tpu_torch.models import train
    from tf_operator_tpu_torch.parallel import distributed, graphed_step, train_step
    from tf_operator_tpu_torch.parallel import mesh as mesh_lib

    ap = train.build_parser()
    args = ap.parse_args([*cell["argv"], "--device", device.type])
    train.check_flags(ap, args)
    backend = distributed.initialize_from_env(device=device)
    mesh = mesh_lib.mesh_from_env()
    model, loss_fn, make_batch = train._build_model(args, device, mesh)
    params = dict(model.named_parameters())
    if set(params) != set(init):
        raise RuntimeError(f"the program's parameters are not the configuration's: "
                           f"{sorted(set(params) ^ set(init))[:6]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(init[name])
    plan = train_step.parallelize(model, mesh, train._sharding_rules(args), device)
    tx = optim_lib.make_optimizer(optim_lib.OptimizerConfig(
        name=args.optimizer, learning_rate=args.lr, moment_dtype=args.moment_dtype,
        master_weights=args.master_weights))
    state = train_step.create_train_state(model, tx, plan)
    route, why = graphed_step.step_route(device.type, mesh.world, backend, False)
    log(f"step route: {route} ({why})")
    run = train_step.make_chunked_train_step(loss_fn, tx, make_batch, device, seed=seed,
                                             remat=args.remat, plan=plan,
                                             graphed=route == "graph")
    return state, run, route


class Steps:
    """Drives run(state, 1) with a mark after each step: a CUDA event on the
    card (the host waits for the one before the last, so at most IN_FLIGHT
    steps are queued). A run measures only on the card (main refuses any
    other); the host-clock marks elsewhere serve the CPU tests that drive
    run_cell with a fault planted in the program."""

    def __init__(self, run, state, device):
        self.run, self.state = run, state
        self.cuda = device.type == "cuda"
        self.marks: list = []
        self.losses: list = []

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def step(self) -> None:
        if self.cuda and len(self.marks) >= IN_FLIGHT:
            self.marks[-IN_FLIGHT].synchronize()
        self.state, metrics = self.run(self.state, 1)
        self.losses.append(metrics["loss"])
        self.mark()

    def step_ms(self) -> list[float]:
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]

    def failed(self) -> int:
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.losses).float())).sum())


def on_host(leaves) -> list[torch.Tensor]:
    """A float32 copy on the host (a copy on the card would raise the run's
    memory peak)."""
    return [t.detach().to("cpu", torch.float32, copy=True) for t in leaves]


def held(state) -> list:
    """The optimizer's authoritative copy of the parameters: the f32 master
    under master weights, else the parameters."""
    return state.opt_state.master or state.params


def step_gradient(mu: list, before: list | None, b1: float, names: list[str], embed: str,
                  prefix: str = "") -> dict:
    """The readings of the gradient AdamW took at a step, from its first
    moment after the step and before it (None before the first: mu = b1
    mu_before + (1 - b1) g; exact for float32 moments)."""
    before = before or [None] * len(mu)
    g = {n: (m if b is None else m - b1 * b) / (1.0 - b1) for n, m, b in zip(names, mu, before)}
    return ref_train.grad_readings(g, embed, prefix)


def program_change(state, names: list[str], init: dict) -> dict:
    """Each leaf's change from `init` in the authoritative copy."""
    norms = torch.stack([(t.float() - init[n]).norm() for n, t in zip(names, held(state))])
    return dict(zip(names, norms.cpu().tolist()))


def by_tenths(step_ms: list[float]) -> list[float]:
    """The mean step ms of each tenth of the window, in the order run."""
    n = len(step_ms)
    cuts = [round(i * n / 10) for i in range(11)]
    return [sum(step_ms[a:b]) / (b - a) for a, b in zip(cuts, cuts[1:]) if b > a]


def traced_window(window: Steps, cell: dict, groups: dict) -> dict | None:
    """The cell's trace_steps (plus the profiler's first and the end mark)
    under torch.profiler, each step in a host range of its own; the
    window's summary (trace.summarize)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if window.cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        window.mark()
        for _ in range(cell["trace_steps"] + 2):
            with record_function(trace_lib.STEP_MARK):
                window.step()
        window.sync()
    summary = trace_lib.summarize(trace_lib.events(prof), groups)
    if summary is not None:
        log("device ms a step by group: " + ", ".join(
            f"{g} {ns / 1e6 / summary['steps']:.3f}"
            for g, ns in sorted(summary["group_ns"].items(), key=lambda kv: -kv[1])))
        log(f"{summary['ops'] / summary['steps']:.0f} device operations and "
            f"{summary['gaps'] / summary['steps']:.0f} idle gaps a step")
    return summary


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, device) -> dict:
    """One run of `cell` on `device`: the result's fields, without the checks
    for a chip (the caller makes them)."""
    arch, shape, opt = cell["arch"], cell["shape"], cell["optimizer"]
    e2e, layer = cells.metrics_of(cell["name"])
    marks = [("imports", time.time())]
    init = weights.make(arch, cell["cfg"]["init_std"], seed, device)
    state, run, route = build(cell, seed, device, init)
    names = [n for n, _ in state.model.named_parameters()]
    steps = Steps(run, state, device)
    marks.append(("weights and build", time.time()))
    embed = reference.family(arch["family"]).EMBED
    steps.step()
    marks.append((f"step 1 (warm-up{' and capture' if route == 'graph' else ''})", time.time()))
    got = step_gradient(on_host(steps.state.opt_state.mu), None, opt["b1"], names, embed)
    for _ in range(ref_train.STEPS - 2):
        steps.step()
    before = on_host(steps.state.opt_state.mu)
    last_state = dict(zip(names, on_host(held(steps.state))))
    steps.step()
    got.update(step_gradient(on_host(steps.state.opt_state.mu), before, opt["b1"], names,
                             embed, prefix="last_"))
    got["change_norms"] = program_change(steps.state, names, init)
    del before
    got["losses"] = [float(x) for x in steps.losses]
    del init
    for _ in range(cell["warmup_steps"]):
        steps.step()
    steps.sync()
    marks.append(("steps 2 on", time.time()))
    log("set-up: " + ", ".join(f"{name} {t - before:.2f} s" for (name, t), (_, before)
                               in zip(marks, [("start", T_START)] + marks)))

    groups = cells.kernel_groups()
    window = Steps(run, steps.state, device)
    if traced:
        setup_s, seconds_run, summary = None, None, traced_window(window, cell, groups)
    else:
        window.sync()
        t_open = time.perf_counter()
        setup_s, summary = time.time() - T_START, None
        window.mark()
        while time.perf_counter() - t_open < seconds:
            window.step()
        window.sync()
        seconds_run = time.perf_counter() - t_open
    n_steps = len(window.marks) - 1
    step_ms = window.step_ms()
    if step_ms:
        ms = sorted(step_ms)
        log("step ms: " + ", ".join(f"{q} {ms[min(len(ms) - 1, int(f * len(ms)))]:.3f}"
                                    for q, f in (("min", 0), ("p50", .5), ("p90", .9),
                                                 ("p95", .95), ("p99", .99), ("max", 1))))
        log("step ms by tenth of the window: "
            + " ".join(f"{x:.3f}" for x in by_tenths(step_ms)))
    failed = window.failed()
    peak = torch.cuda.max_memory_allocated(device) if window.cuda else 0
    rec = {"shape": shape, "groups": groups, "setup_s": setup_s,
           "window": {"seconds": seconds_run, "steps": n_steps,
                      "tokens_per_step": shape["batch"] * shape["seq"], "step_ms": step_ms},
           "trace": summary}
    del steps, window, state, run
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    t0 = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init = weights.make(arch, cell["cfg"]["init_std"], seed, device)
    ref = ref_train.observe(init, arch, shape, opt, seed, device)
    del init, ref["last_state"]
    ref.update(ref_train.last_gradient(last_state, arch, shape, seed, device))
    del last_state
    log(f"reference: {time.time() - t0:.2f} s")
    values = compare.readings(got, ref)
    for key in ("grad_gap", "embed_row_gap", "change_gap", "grad3_gap", "embed_row3_gap"):
        log(f"{key} worst at {values[key + '_leaf']}")
    log(f"change_gap leaves out {len(values['flat_leaves'])} flat leaves: "
        + " ".join(values["flat_leaves"]))
    log("losses: program " + " ".join(f"{x:.7f}" for x in got["losses"])
        + " reference " + " ".join(f"{x:.7f}" for x in ref["losses"]))
    ok, checks = compare.verdict(values, cell["limits"])
    for name in compare.NUMBERS:
        if name not in checks:
            log(f"{name} {values[name]!r} (not compared: no limit)")

    metrics = {}
    for m in (layer if traced else e2e):
        value = cells.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = device.type == "cuda"
    result = {"correct": ok and failed == 0 and n_steps > 0, "attempted": n_steps,
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                         "count": cell["chips"], "memory_peak_bytes": peak}}
    if cuda:
        result["device"]["power_limit_w"] = power_limit_w()
        log(f"card: {result['device']['kind']}, power limit "
            f"{result['device']['power_limit_w']} W")
    if traced and summary is not None:
        result["device"]["busy_s"] = summary["busy_ns"] / 1e9
        result["device"]["window_s"] = summary["window_ns"] / 1e9
        result["breakdown"] = {
            "device_ops": [[name, ns / 1e9] for name, ns in summary["top_ops"]],
            "idle_gaps": [[label, ns / 1e9] for label, ns in summary["idle_gaps"]]}
    result["checks"] = checks
    return result


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="the window's length")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse(argv)
    try:
        cell = cells.load(args.workload)
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is false: the benchmark measures the "
                          "card and runs nowhere else")
        if torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"{cell['name']} needs {cell['chips']} cards; "
                          f"{torch.cuda.device_count()} visible")
        try:
            import tf_operator_tpu_torch  # noqa: F401
        except ImportError as e:
            raise Refused(f"the program under test cannot be imported: {e}") from e
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0))
        loaded = forbidden_modules()
        if loaded:
            raise Refused(f"JAX modules loaded in this process: {', '.join(loaded[:10])}")
    except (Refused, FileNotFoundError) as e:
        log(str(e))
        return 2
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
