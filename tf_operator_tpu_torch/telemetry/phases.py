"""Per-step phase accounting: where every second of a training step went.

Own copy of tf_operator_tpu/telemetry/phases.py for the PyTorch package,
with its hook into the span tracer (telemetry/tracer.py): each step and
phase is also a `step` / `phase/<name>` span when --trace enables it. It
fills the done event's `step_time_s` and `phase_breakdown`.

The trainer's headline has been a single steady-state mean
(steady_steps_per_sec); a p99 stall — a checkpoint save, a transfer
hiccup, one slow host batch — is invisible in a mean. This layer
decomposes every step into named phases and keeps the per-step
wall-clock distribution, under the same telescoping discipline as the
staging ring's accounting (data/staging.py: wall == wait + busy by
construction):

    step wall-clock == sum(phases) + other     (exactly, by construction)

Phase taxonomy (PHASES):

    data_wait      blocked pulling the next batch from the input
                   pipeline (prefetch/staging ring). The pipeline's own
                   telemetry says how much of what hid under compute was
                   host production vs transfer.
    h2d_transfer   synchronous host->device transfer performed by the
                   step loop itself. Under the async ingest modes the
                   transfer rides a background thread (visible as tracer
                   spans + staging stats) and this phase is ~0.
    dispatch       handing the step to the runtime (async: the call
                   returns a future; on-device execution overlaps the
                   rest of the loop body).
    device_blocked time blocked on device results (loss fetches — the
                   window-closing host transfers).
    checkpoint     SYNCHRONOUS checkpoint saves made from the step loop
                   (--checkpoint-mode sync, and the preemption fast
                   path): snapshot + serialize + manifests, all blocking.
    ckpt_snapshot  the BLOCKING leg of an async save (--checkpoint-mode
                   async, the default): device->host snapshot of the
                   train state plus any backpressure wait for the
                   previous save's write leg to drain. The write leg
                   itself (ckpt_write) rides the dedicated writer thread
                   — it appears as tracer spans and in the done event's
                   `checkpoint` block (write_s / hidden_fraction /
                   drains), never as a step phase, because it does not
                   spend step wall-clock; the telescoping identity above
                   is preserved exactly.
    dcn_sync       the VISIBLE share of the cross-slice (DCN) gradient
                   exchange (multi-slice jobs, parallel/multislice.py):
                   time the step loop blocked in collect() waiting for
                   bucket transfers that did not hide under backward
                   compute. The exchange's own clock (dcn_busy_s in the
                   done event's `dcn` block) is the TOTAL; their ratio is
                   the measured hidden_fraction.
    eval           inline evaluation from the step loop (the separate
                   Evaluator replica accounts its own process).
    other          the telescoping residual: loop body time attributed
                   to no phase (event emission, bookkeeping).

Steps are recorded via context managers; a chunked on-device loop (one
dispatch per N steps) records one sample with n_steps=N and the
percentile math weights it as N per-step samples of wall/N — the
distribution stays per-STEP whatever the dispatch granularity.

TPUJOB_TELEMETRY=off returns a no-op accountant with the same API (the
baseline for tests/test_telemetry.py's overhead guard).

Device phase stamps (DeviceStamps). On the graph route a step is one
replay of a CUDA graph, and the host's phases time its enqueue, not its
work. While the tracer is enabled when a step's graph is captured, the
step stamps its own boundaries on the device (csrc/phase_stamp.cu: one
thread writing %globaltimer into a device ring, no host read, event or
sync), so every replay records them:

    start        step start, before the batch is made inside the graph
    batch        the batch made          (parallel/graphed_step.py)
    trunk        the trunk's output      (models/transformer.py, BertMLM)
    forward      the loss                (parallel/train_step.py)
    trunk_grad   the trunk's gradient ready (a hook on its output)
    backward     autograd.grad and reduce_grads
    optimizer    tx.update_in_place
    end          the metrics; advances the ring to the next step

DEVICE_PHASES are the spans between them: batch + forward + backward +
optimizer + metrics telescope to the step's device span exactly, as the
host phases above telescope to its wall clock; mlm_head_fwd lies inside
forward and mlm_head_bwd inside backward. A mark a model does not reach
(the trunk's, outside BertMLM) leaves its phases out. The capture also
walks the graph (GraphedStep, graph_ops) and counts each phase's device
operations. Off (the default), `mark` returns after one attribute read
and the captured graph is the same as without stamps; a step on a
non-CUDA device stamps nothing.
"""

from __future__ import annotations

import ctypes
import math
import os
import time

import torch

from tf_operator_tpu_torch.telemetry import tracer as _tracer_mod

__all__ = [
    "PHASES", "StepAccounting", "NullStepAccounting",
    "make_step_accounting", "weighted_percentile",
    "MARKS", "DEVICE_PHASES", "STEP_PHASES", "DeviceStamps", "device_stamps",
    "start_step", "mark", "mark_grad", "last_steps", "device_summary", "graph_ops",
]

PHASES = ("data_wait", "h2d_transfer", "dispatch", "device_blocked",
          "checkpoint", "ckpt_snapshot", "dcn_sync", "eval", "other")

QUANTILES = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def phase(self, name: str, **attrs):
        return self


_NULL_CTX = _NullCtx()


class _Step:
    """One step (or chunk of n_steps) being accounted. Not reentrant; one
    step at a time per accountant (the train loop is sequential)."""

    __slots__ = ("_acct", "_index", "_n", "_t0", "_attributed", "_span")

    def __init__(self, acct: "StepAccounting", index: int, n_steps: int):
        self._acct = acct
        self._index = index
        self._n = n_steps
        self._attributed = 0.0
        self._span = None

    def __enter__(self):
        self._span = self._acct._tracer.begin(
            "step", step=self._index, n_steps=self._n)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        wall = time.perf_counter() - self._t0
        self._acct._tracer.end(self._span)
        self._acct._close_step(wall, self._n, self._attributed)
        return False

    def phase(self, name: str, **attrs):
        """`with st.phase("data_wait"):` — times the block, attributes it
        to `name`, and emits a tracer span `phase/<name>`."""
        if name not in self._acct.phase_totals:
            raise ValueError(f"unknown phase {name!r} (not in {PHASES})")
        return _Phase(self, name, attrs)


class _Phase:
    __slots__ = ("_step", "_name", "_t0", "_span")

    def __init__(self, step: _Step, name: str, attrs: dict):
        self._step = step
        self._name = name
        self._span = step._acct._tracer.begin(f"phase/{name}", **attrs) \
            if step._acct._tracer.enabled else None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        acct = self._step._acct
        acct._tracer.end(self._span)
        acct.phase_totals[self._name] += dt
        self._step._attributed += dt
        return False


class StepAccounting:
    """Accumulates per-step wall-clock samples + phase totals; summary()
    renders the done-event payload (percentiles + phase_breakdown)."""

    def __init__(self, tracer: "_tracer_mod.Tracer | None" = None):
        self._tracer = tracer if tracer is not None else _tracer_mod.get_tracer()
        # (per-step wall seconds, weight in steps) — one entry per step()
        # call, so a chunked loop stays O(chunks) however long the run.
        self.samples: list[tuple[float, int]] = []
        self.phase_totals: dict[str, float] = {p: 0.0 for p in PHASES}
        self.wall_s = 0.0

    def step(self, index: int, n_steps: int = 1) -> _Step:
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        return _Step(self, index, n_steps)

    def _close_step(self, wall: float, n_steps: int, attributed: float) -> None:
        # The residual telescopes by construction; clock granularity can
        # put attributed a hair over wall, so clamp at 0 rather than
        # emit a negative "other" (the overshoot is bounded by one
        # perf_counter quantum per phase).
        self.phase_totals["other"] += max(0.0, wall - attributed)
        self.samples.append((wall / n_steps, n_steps))
        self.wall_s += wall

    @property
    def steps(self) -> int:
        return sum(n for _, n in self.samples)

    def summary(self, digits: int = 6) -> dict | None:
        """Done-event payload: {"step_time_s": {p50,p95,p99,max,mean},
        "phase_breakdown": {wall_s, steps, <phase>: seconds...}} — the
        phase entries (including "other") sum to wall_s exactly, so a
        reader can telescope the distribution back to the measured
        wall-clock. None when no steps were recorded."""
        n = self.steps
        if n == 0:
            return None
        dist = {k: round(weighted_percentile(self.samples, q), digits)
                for k, q in QUANTILES}
        dist["max"] = round(max(w for w, _ in self.samples), digits)
        dist["mean"] = round(self.wall_s / n, digits)
        breakdown = {"wall_s": round(self.wall_s, digits), "steps": n}
        for p in PHASES:
            v = self.phase_totals[p]
            if v > 0.0 or p == "other":
                breakdown[p] = round(v, digits)
        return {"step_time_s": dist, "phase_breakdown": breakdown}


class NullStepAccounting:
    """Same surface, no clocks, no state: the TPUJOB_TELEMETRY=off path
    and the un-instrumented baseline for the overhead guard test."""

    samples: list = []
    phase_totals: dict = {}
    wall_s = 0.0
    steps = 0

    def step(self, index: int, n_steps: int = 1):
        return _NULL_CTX

    def summary(self, digits: int = 6) -> None:
        return None


def make_step_accounting(tracer=None):
    """StepAccounting, or the no-op variant when TPUJOB_TELEMETRY=off."""
    if os.environ.get("TPUJOB_TELEMETRY", "").lower() in ("off", "0", "false"):
        return NullStepAccounting()
    return StepAccounting(tracer)


def weighted_percentile(samples: list[tuple[float, int]], q: float) -> float:
    """Nearest-rank percentile over weighted samples: (value, weight) with
    integer weights is the exact expansion of `weight` copies of `value`
    (how one chunk of N steps contributes N per-step samples) without
    materializing the expansion."""
    if not samples:
        raise ValueError("no samples")
    if not 0.0 < q <= 1.0:
        raise ValueError(f"q must be in (0, 1], got {q}")
    ordered = sorted(samples)
    total = sum(w for _, w in ordered)
    rank = max(1, math.ceil(q * total))  # 1-based nearest-rank
    seen = 0
    for v, w in ordered:
        seen += w
        if seen >= rank:
            return v
    return ordered[-1][0]


# ------------------------------------------------------ device phase stamps

MARKS = ("start", "batch", "trunk", "forward", "trunk_grad", "backward", "optimizer", "end")
_INDEX = {m: i for i, m in enumerate(MARKS)}
_END = len(MARKS) - 1
# phase: (the mark it starts at, the mark it ends at)
DEVICE_PHASES = {
    "batch": ("start", "batch"),
    "forward": ("batch", "forward"),
    "backward": ("forward", "backward"),
    "optimizer": ("backward", "optimizer"),
    "metrics": ("optimizer", "end"),
    "mlm_head_fwd": ("trunk", "forward"),
    "mlm_head_bwd": ("forward", "trunk_grad"),
}
# The phases that telescope to the step's device span ("step").
STEP_PHASES = ("batch", "forward", "backward", "optimizer", "metrics")
_SPANS = {"step": ("start", "end"), **DEVICE_PHASES}
# Steps the ring holds: 4096 x 8 int64, 256 KB.
SLOTS = 4096
# CUgraphNodeType of a kernel, a copy and a fill: the operations a phase counts.
COUNTED_NODES = (0, 1, 2)

_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        from tf_operator_tpu_torch.ops import _build

        lib = _build.load("phase_stamp")
        ptr, i32, size = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        lib.tpujob_phase_stamp_launch.argtypes = [ptr, i32, i32, i32, i32, ptr,
                                                  ctypes.POINTER(ptr)]
        lib.tpujob_graph_size.argtypes = [ptr, ctypes.POINTER(size), ctypes.POINTER(size)]
        lib.tpujob_graph_read.argtypes = [ptr, ctypes.POINTER(ptr), ctypes.POINTER(i32), size,
                                          ctypes.POINTER(ptr), ctypes.POINTER(ptr), size]
        for fn in (lib.tpujob_phase_stamp_launch, lib.tpujob_graph_size,
                   lib.tpujob_graph_read):
            fn.restype = i32
        _lib_handle = lib
    return _lib_handle


def _launch(ring: torch.Tensor, mark: int, marks: int, slots: int, advance: bool,
            node: ctypes.c_void_p | None = None) -> None:
    """One stamp into `ring` on the current stream (node: where to put the
    graph node it became, while the stream captures)."""
    stream = ctypes.c_void_p(torch.cuda.current_stream(ring.device).cuda_stream)
    err = _lib().tpujob_phase_stamp_launch(
        ctypes.c_void_p(ring.data_ptr()), mark, marks, slots, int(advance), stream,
        None if node is None else ctypes.byref(node))
    if err != 0:
        raise RuntimeError(f"phase stamp launch failed: error {err} (a cudaError, or "
                           "100000 + the CUresult of the capture query)")


class DeviceStamps:
    """The training step's device phase stamps (module docstring): a ring
    of int64 on the card, [1 + slots x len(MARKS)], element 0 the number of
    steps whose `end` ran, row `count % slots` the step in progress.

    start(device) opens a step: when the default tracer is enabled and the
    device is CUDA it arms the stamps and stamps `start`, else it disarms
    them. While armed, mark(name) stamps and mark_grad(tensor, name) puts a
    hook on the tensor that stamps when its gradient is ready; a mark
    stamps once a step (a rematerialised forward runs the model again in
    the backward); `end` disarms. While `nodes` is a list (GraphedStep's
    capture), each stamp adds (mark, the graph node it became); `ops` holds
    the last walked capture's counts (graph_ops)."""

    def __init__(self, slots: int = SLOTS):
        self.slots = slots
        self.armed = False
        self.seen: set[int] = set()
        self.ring: torch.Tensor | None = None
        self.launches = 0
        self.nodes: list | None = None
        self.ops: dict | None = None

    def start(self, device) -> None:
        device = torch.device(device)
        if not _tracer_mod.get_tracer().enabled or device.type != "cuda":
            self.armed = False
            return
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if self.ring is None or self.ring.device != device:
            self.ring = torch.zeros(1 + self.slots * len(MARKS), dtype=torch.int64,
                                    device=device)
        self.armed = True
        self.seen = set()
        self._stamp(0)

    def mark(self, name: str) -> None:
        if not self.armed:
            return
        self._stamp(_INDEX[name])

    def mark_grad(self, t: torch.Tensor, name: str) -> None:
        if not self.armed or not t.requires_grad:
            return
        i = _INDEX[name]
        t.register_hook(lambda grad: self._stamp(i))

    def _stamp(self, i: int) -> None:
        if i in self.seen:
            return
        self.seen.add(i)
        node = None if self.nodes is None else ctypes.c_void_p()
        _launch(self.ring, i, len(MARKS), self.slots, i == _END, node)
        self.launches += 1
        if node is not None and node.value:
            self.nodes.append((MARKS[i], node.value))
        if i == _END:
            self.armed = False

    def rows(self, n: int) -> list[list[int]]:
        """The stamps of the last n finished steps the ring holds, oldest
        first (one copy of the ring, which waits for the card)."""
        if self.ring is None:
            return []
        return last_rows(self.ring.cpu().tolist(), n, self.slots, len(MARKS))

    def clock_offset(self) -> tuple[int, int]:
        """(perf_counter_ns - %globaltimer, the bracket's width in ns): one
        stamp launched and waited for between two perf_counter_ns reads; the
        offset takes the bracket's middle, so it is off by at most half the
        width."""
        cal = torch.zeros(2, dtype=torch.int64, device=self.ring.device)
        torch.cuda.synchronize(self.ring.device)
        t0 = time.perf_counter_ns()
        _launch(cal, 0, 1, 1, False)
        torch.cuda.synchronize(self.ring.device)
        t1 = time.perf_counter_ns()
        return (t0 + t1) // 2 - int(cal[1]), t1 - t0

    def chrome_events(self, epoch_ns: int, pid: int, tid: int) -> tuple[list, dict]:
        """The held steps' device step and phases as Chrome "X" events on
        track `tid`, on the tracer's clock (perf_counter_ns from epoch_ns),
        and the trace's otherData entries; nothing without stamps."""
        try:
            rows = self.rows(self.slots)
            if not rows:
                return [], {}
            offset, width = self.clock_offset()
        except RuntimeError as e:  # a card left in error: the host trace still goes out
            return [], {"device_track_error": str(e)[:200]}
        out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": "device phases (stamps)"}}]
        for row in rows:
            for name, (a, b) in _SPANS.items():
                ta, tb = row[_INDEX[a]], row[_INDEX[b]]
                ts = (ta + offset - epoch_ns) / 1000.0
                if ta and tb and ts >= 0:
                    out.append({"ph": "X", "name": f"device/{name}", "cat": "device",
                                "pid": pid, "tid": tid, "ts": ts, "dur": (tb - ta) / 1000.0})
        return out, {"device_steps": len(rows), "device_clock_error_us": width / 1000.0}


def last_rows(ring: list[int], n: int, slots: int, marks: int) -> list[list[int]]:
    """The rows of the last n finished steps of a ring read as a list (at
    most slots - 1: the row after them is the next step's), oldest first."""
    count = ring[0]
    k = max(0, min(n, count, slots - 1))
    out = []
    for step in range(count - k, count):
        at = 1 + (step % slots) * marks
        out.append(ring[at:at + marks])
    return out


def step_phase_ns(row: list[int]) -> dict[str, int]:
    """One step's device span ("step") and phases in ns from its stamps; a
    phase with a mark the step did not reach is left out."""
    out = {}
    for name, (a, b) in _SPANS.items():
        ta, tb = row[_INDEX[a]], row[_INDEX[b]]
        if ta and tb:
            out[name] = tb - ta
    return out


def summarize_rows(rows: list[list[int]], ops: dict | None) -> dict | None:
    """The done event's device fields from the steps' stamps: device_step_ms
    (p50, p95, p99, max), device_phase_ms (p50, p95 of each phase) and
    device_phase_ops (`ops`); None without a step."""
    per_step = [step_phase_ns(r) for r in rows]
    per_step = [p for p in per_step if "step" in p]
    if not per_step:
        return None

    def ms(name):
        return [(p[name] / 1e6, 1) for p in per_step if name in p]

    step = ms("step")
    dist = {k: round(weighted_percentile(step, q), 4) for k, q in QUANTILES}
    dist["max"] = round(max(v for v, _ in step), 4)
    phase_ms = {}
    for name in DEVICE_PHASES:
        vals = ms(name)
        if vals:
            phase_ms[name] = {k: round(weighted_percentile(vals, q), 4)
                              for k, q in QUANTILES[:2]}
    return {"device_step_ms": dist, "device_phase_ms": phase_ms, "device_phase_ops": ops}


def phase_ops(kinds: dict, deps: dict, stamps: dict) -> dict[str, int]:
    """Each phase's device operations in a captured graph: the kernel, copy
    and fill nodes that are ancestors of the phase's end stamp and not of
    its start stamp, the stamps left out (any DAG, not only a chain); also
    "graph", every such node of the graph, and "stamps". kinds: node ->
    CUgraphNodeType; deps: node -> the nodes it depends on; stamps: mark ->
    its node."""
    memo: dict = {}

    def ancestors(node) -> set:
        if node not in memo:
            seen, todo = set(), [node]
            while todo:
                for d in deps.get(todo.pop(), ()):
                    if d not in seen:
                        seen.add(d)
                        todo.append(d)
            memo[node] = seen
        return memo[node]

    counted = {n for n, k in kinds.items() if k in COUNTED_NODES} - set(stamps.values())
    out = {}
    for name, (a, b) in DEVICE_PHASES.items():
        if a in stamps and b in stamps:
            out[name] = len((ancestors(stamps[b]) - ancestors(stamps[a])) & counted)
    out["graph"] = len(counted)
    out["stamps"] = len(stamps)
    return out


def graph_ops(graph: int, captured: list[tuple[str, int]]) -> dict[str, int]:
    """phase_ops of a captured graph (torch.cuda.CUDAGraph.raw_cuda_graph(),
    kept with keep_graph=True) whose stamps became the nodes `captured`."""
    lib = _lib()
    n_nodes, n_edges = ctypes.c_size_t(), ctypes.c_size_t()
    err = lib.tpujob_graph_size(ctypes.c_void_p(graph), ctypes.byref(n_nodes),
                                ctypes.byref(n_edges))
    nodes = (ctypes.c_void_p * n_nodes.value)()
    types = (ctypes.c_int * n_nodes.value)()
    src = (ctypes.c_void_p * n_edges.value)()
    dst = (ctypes.c_void_p * n_edges.value)()
    if err == 0:
        err = lib.tpujob_graph_read(ctypes.c_void_p(graph), nodes, types, n_nodes.value,
                                    src, dst, n_edges.value)
    if err != 0:
        raise RuntimeError(f"reading the captured graph failed: CUresult {err}")
    deps: dict = {}
    for a, b in zip(src, dst):
        deps.setdefault(b, []).append(a)
    return phase_ops(dict(zip(nodes, types)), deps, dict(captured))


# The stamps the trainer's step records into: the default tracer's.
_STAMPS = DeviceStamps()


def device_stamps() -> DeviceStamps:
    return _STAMPS


def start_step(device) -> None:
    """Open a step's stamps (DeviceStamps.start) on the default ring."""
    _STAMPS.start(device)


def mark(name: str) -> None:
    """Stamp `name` (one of MARKS) in the step, while the stamps are armed;
    one attribute read otherwise."""
    s = _STAMPS
    if not s.armed:
        return
    s.mark(name)


def mark_grad(t: torch.Tensor, name: str) -> None:
    """Stamp `name` when t's gradient is ready, while the stamps are armed."""
    s = _STAMPS
    if not s.armed:
        return
    s.mark_grad(t, name)


def last_steps(n: int) -> list[list[int]]:
    """The stamps (ns, in MARKS order, 0 where unreached) of the last n
    finished steps, oldest first."""
    return _STAMPS.rows(n)


def device_summary(n: int) -> dict | None:
    """summarize_rows over the last n finished steps and the last walked
    capture's counts; None when no step was stamped."""
    return summarize_rows(last_steps(n), _STAMPS.ops)
