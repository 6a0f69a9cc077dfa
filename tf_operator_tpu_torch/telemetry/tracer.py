"""In-process span tracer with Chrome trace-event export: own copy of
tf_operator_tpu/telemetry/tracer.py.

The observability substrate every per-PR ad-hoc timer dict grew toward:
one low-overhead tracer that the trainer hot loop, the staging/prefetch
transfer threads, and checkpoint save/restore all record into, exported
as Chrome trace-event JSON (the format Perfetto and chrome://tracing
load natively — and the same family torch.profiler emits, so a tpujob
trace and a torch.profiler device trace can sit side by side).

Design constraints, in priority order:

  1. **Near-zero cost when disabled.** `span()` on a disabled tracer
     returns a shared no-op context manager after ONE attribute read —
     no allocation beyond the kwargs dict, no clock read, no lock. The
     hot paths (per-step loop, per-batch transfer thread) call it
     unconditionally; tests/test_telemetry.py pins the disabled cost.
  2. **Bounded memory.** Events land in a ring buffer
     (collections.deque(maxlen=capacity)); a long run overwrites its
     oldest events instead of growing. `dropped_events` reports how many
     were evicted so a truncated export is visible, not silent.
  3. **Thread-safe.** Spans may begin and end on different threads
     (`begin()`/`end()` — the staging ring stages on a producer thread
     that the consumer accounts for); `span()` context managers record
     on whatever thread runs them. Recording takes a short lock (append
     + drop counter move together, so dropped_events stays exact under
     concurrent recorders); export snapshots under the same lock. The
     DISABLED path takes no lock at all.
  4. **Monotonic clocks.** All timestamps are time.perf_counter_ns()
     deltas from the tracer's epoch — wall-clock steps (NTP, suspend)
     cannot produce negative durations or reordered events.

Chrome trace-event mapping: completed spans are "X" (complete) events
with microsecond `ts`/`dur`; `instant()` is an "i" event; process/thread
names are "M" metadata events. See the trace-event format spec
(docs/perf.md round-8 section explains how to read one).

The device, in two ways. While a torch.profiler records in this process,
every span also opens a torch.profiler range (record_function) of its
name, so the program's host spans land in the profiler's own trace, on
its clock, beside the device's operations. And the default tracer's
export adds a track of the training step's device phases
(telemetry/phases.py's stamps), moved onto this tracer's clock by one
stamp timed between two perf_counter_ns reads; otherData records the
bracket's width as `device_clock_error_us`.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from typing import Any

__all__ = [
    "Tracer", "get_tracer", "configure", "span", "begin", "end", "instant",
]


class _NullSpan:
    """Shared no-op context manager: the entire disabled-tracer fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """An open span; records one "X" event when closed. Carries the thread
    id it was OPENED on, so begin()/end() pairs that cross threads still
    render on the opening thread's track."""

    __slots__ = ("_tracer", "name", "attrs", "_t0", "_tid", "_range")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._tid = threading.get_ident()
        # Name the track NOW, on the opening thread: a cross-thread span
        # recorded at end() would otherwise stamp the CLOSING thread's
        # name onto the opening thread's track.
        tracer._note_thread(self._tid)
        self._range = _profiler_range(name)
        self._t0 = time.perf_counter_ns()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._tracer._record(self)
        return False


class Tracer:
    def __init__(self, capacity: int = 65536, enabled: bool = False):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.enabled = enabled
        self.capacity = capacity
        # Ring buffer of (name, t0_ns, dur_ns, tid, attrs) tuples; "i"
        # instants carry dur_ns = -1. Appends happen under _lock together
        # with the drop counter (see _record) — enabled-path cost only.
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._epoch_ns = time.perf_counter_ns()
        self._appended = 0
        self._lock = threading.Lock()
        # Thread names snapshotted at record time (threading.enumerate at
        # export would miss already-finished transfer threads).
        self._thread_names: dict[int, str] = {}

    # ------------------------------------------------------------ recording

    def span(self, name: str, /, **attrs: Any) -> "_Span | _NullSpan":
        """Context manager timing one block on the current thread."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def begin(self, name: str, /, **attrs: Any) -> "_Span | None":
        """Open a span explicitly (cross-thread: close with end())."""
        if not self.enabled:
            return None
        return _Span(self, name, attrs)

    def end(self, handle: "_Span | None", **attrs: Any) -> None:
        """Close a begin() handle (None-safe: begin() on a disabled tracer
        returns None and end() ignores it, so callers never branch)."""
        if handle is None:
            return
        if attrs:
            handle.attrs.update(attrs)
        self._record(handle)

    def instant(self, name: str, /, **attrs: Any) -> None:
        """Mark a point in time (Chrome "i" event)."""
        if not self.enabled:
            return
        tid = threading.get_ident()
        self._note_thread(tid)
        # Lock the append + count together: the step loop and the
        # staging/prefetch threads record concurrently, and an unguarded
        # `_appended += 1` loses increments — dropped_events would then
        # under-report, letting a truncated export claim completeness.
        # Enabled-path-only cost; the disabled path never gets here.
        with self._lock:
            self._events.append(
                (name, time.perf_counter_ns(), -1, tid, attrs or None))
            self._appended += 1

    def _record(self, sp: _Span) -> None:
        dur = time.perf_counter_ns() - sp._t0
        if sp._range is not None:
            sp._range.__exit__(None, None, None)
        with self._lock:
            self._events.append(
                (sp.name, sp._t0, dur, sp._tid, sp.attrs or None))
            self._appended += 1

    def _note_thread(self, tid: int) -> None:
        if tid not in self._thread_names:
            self._thread_names[tid] = threading.current_thread().name

    # ------------------------------------------------------------ inspection

    def __len__(self) -> int:
        return len(self._events)

    @property
    def dropped_events(self) -> int:
        """Events evicted by the ring (0 = the export is complete)."""
        return max(0, self._appended - len(self._events))

    def clear(self) -> None:
        """Drop recorded events and restart the timestamp epoch (a reused
        tracer's next trace starts at ts=0, like a fresh process)."""
        with self._lock:
            self._events.clear()
            self._appended = 0
            self._epoch_ns = time.perf_counter_ns()
            # Thread names too: Python reuses thread idents, and a stale
            # name from a previous trace window would label a NEW thread's
            # track with a dead thread's name.
            self._thread_names.clear()

    # --------------------------------------------------------------- export

    def chrome_trace(self, device: bool = True) -> dict:
        """The trace as a Chrome trace-event JSON object (dict form); the
        default tracer's adds the device phases' track unless `device` is
        false (a card that may never finish its queue cannot be read)."""
        with self._lock:
            events = list(self._events)
            names = dict(self._thread_names)
        pid = os.getpid()
        # Stable small tids: Chrome renders one track per (pid, tid), and
        # raw Python idents are unreadable 15-digit numbers.
        tid_map = {raw: i for i, raw in enumerate(
            sorted({e[3] for e in events} | set(names)))}
        out: list[dict] = [{
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": "tpujob-trainer"},
        }]
        for raw, small in sorted(tid_map.items(), key=lambda kv: kv[1]):
            out.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": small,
                "args": {"name": names.get(raw, f"thread-{small}")},
            })
        for name, t0, dur, tid, attrs in events:
            ev: dict = {
                "name": name,
                "cat": "tpujob",
                "pid": pid,
                "tid": tid_map[tid],
                "ts": (t0 - self._epoch_ns) / 1000.0,  # microseconds
            }
            if dur < 0:
                ev["ph"] = "i"
                ev["s"] = "t"  # instant scoped to its thread
            else:
                ev["ph"] = "X"
                ev["dur"] = dur / 1000.0
            if attrs:
                ev["args"] = {k: _jsonable(v) for k, v in attrs.items()}
            out.append(ev)
        other = {"dropped_events": self.dropped_events}
        if device and self is _DEFAULT:
            from tf_operator_tpu_torch.telemetry import phases

            track, track_other = phases.device_stamps().chrome_events(
                self._epoch_ns, pid, len(tid_map))
            out.extend(track)
            other.update(track_other)
        return {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": other,
        }

    def export(self, path: str, device: bool = True) -> int:
        """Write the Chrome trace JSON to `path` (dirs created); returns
        the number of non-metadata events written."""
        trace = self.chrome_trace(device)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(trace, f)
        return sum(1 for e in trace["traceEvents"] if e["ph"] != "M")


def _profiler_range(name: str):
    """An open torch.profiler range named `name` while a profiler records in
    this process (torch imported and profiling), else None."""
    torch = sys.modules.get("torch")
    if torch is None or not getattr(torch.autograd.profiler, "_is_profiler_enabled", False):
        return None
    rf = torch.autograd.profiler.record_function(name)
    rf.__enter__()
    return rf


def _jsonable(v: Any):
    return v if isinstance(v, (str, int, float, bool, type(None))) else str(v)


# Module-level default tracer: the zero-wiring path every subsystem
# (trainer loop, staging/prefetch threads, checkpoint IO) records into.
_DEFAULT = Tracer()


def get_tracer() -> Tracer:
    return _DEFAULT


def configure(enabled: bool | None = None, capacity: int | None = None) -> Tracer:
    """Configure the default tracer (the trainer's --trace flag lands
    here). Changing capacity re-allocates the ring, dropping recorded
    events — configure before tracing starts."""
    global _DEFAULT
    if capacity is not None and capacity != _DEFAULT.capacity:
        _DEFAULT = Tracer(capacity=capacity, enabled=_DEFAULT.enabled)
    if enabled is not None:
        _DEFAULT.enabled = enabled
    return _DEFAULT


def span(name: str, /, **attrs: Any):
    """`with telemetry.span("staging.h2d", bytes=n):` on the default
    tracer — one attribute read when disabled."""
    t = _DEFAULT
    if not t.enabled:
        return _NULL_SPAN
    return _Span(t, name, attrs)


def begin(name: str, /, **attrs: Any):
    return _DEFAULT.begin(name, **attrs)


def end(handle, **attrs: Any) -> None:
    _DEFAULT.end(handle, **attrs)


def instant(name: str, /, **attrs: Any) -> None:
    _DEFAULT.instant(name, **attrs)
