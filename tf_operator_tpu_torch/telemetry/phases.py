"""Per-step phase accounting: where every second of a training step went.

Own copy of tf_operator_tpu/telemetry/phases.py for the PyTorch package,
without its hook into the span tracer (the --trace spans are not ported
yet). It fills the done event's `step_time_s` and `phase_breakdown`.

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
"""

from __future__ import annotations

import math
import os
import time

__all__ = [
    "PHASES", "StepAccounting", "NullStepAccounting",
    "make_step_accounting", "weighted_percentile",
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

    __slots__ = ("_acct", "_index", "_n", "_t0", "_attributed")

    def __init__(self, acct: "StepAccounting", index: int, n_steps: int):
        self._acct = acct
        self._index = index
        self._n = n_steps
        self._attributed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        wall = time.perf_counter() - self._t0
        self._acct._close_step(wall, self._n, self._attributed)
        return False

    def phase(self, name: str, **attrs):
        """`with st.phase("data_wait"):` — times the block and attributes
        it to `name`."""
        if name not in self._acct.phase_totals:
            raise ValueError(f"unknown phase {name!r} (not in {PHASES})")
        return _Phase(self, name)


class _Phase:
    __slots__ = ("_step", "_name", "_t0")

    def __init__(self, step: _Step, name: str):
        self._step = step
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        acct = self._step._acct
        acct.phase_totals[self._name] += dt
        self._step._attributed += dt
        return False


class StepAccounting:
    """Accumulates per-step wall-clock samples + phase totals; summary()
    renders the done-event payload (percentiles + phase_breakdown)."""

    def __init__(self):
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


def make_step_accounting():
    """StepAccounting, or the no-op variant when TPUJOB_TELEMETRY=off."""
    if os.environ.get("TPUJOB_TELEMETRY", "").lower() in ("off", "0", "false"):
        return NullStepAccounting()
    return StepAccounting()


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
