"""Graceful preemption and the progress heartbeat: own copy of the JAX
package's tf_operator_tpu/utils/preemption.py.

PreemptionGuard latches the first SIGTERM, SIGINT or SIGUSR1; the trainer
polls it at step boundaries, finishes the in-flight step, writes an
emergency checkpoint when the grace budget allows, emits `preempted` and
exits 128+signum (143, 130, 138), which utils/exit_codes.py classifies as
retryable, so the operator's ExitCode restart policy brings the pod back
and the resume walk continues from the emergency checkpoint. Only the
first signal is latched; the handler records (signum, monotonic time) and
returns.

The trainer also writes a tiny monotonic `{step, t, pid}` JSON file at step
boundaries (`TPUJOB_HEARTBEAT_FILE`, injected by the runtime like
`TPUJOB_METRICS_FILE`); the operator's hang watchdog treats a stale
heartbeat on a Running job as a hang.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time

HANDLED_SIGNALS = (signal.SIGTERM, signal.SIGINT, signal.SIGUSR1)

ENV_HEARTBEAT_FILE = "TPUJOB_HEARTBEAT_FILE"


class HeartbeatWriter:
    """Writes `{"step": N, "t": <epoch>, "pid": ...}` atomically (tmp +
    os.replace) so a reader never sees a torn JSON. `step` never goes
    backwards within a process. Writes closer together than
    `min_interval_s` are skipped unless forced; with no path every call is
    a no-op; IO errors degrade the signal and never reach the step loop."""

    def __init__(self, path: str | None, min_interval_s: float = 0.5):
        self.path = path or None
        self.min_interval_s = min_interval_s
        self._last_write = 0.0
        self._last_step = 0
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls, env: dict | None = None) -> "HeartbeatWriter":
        e = os.environ if env is None else env
        return cls(e.get(ENV_HEARTBEAT_FILE))

    def write(self, step: int, force: bool = False) -> bool:
        """Record `step` as completed; True when a write actually landed."""
        if self.path is None:
            return False
        with self._lock:
            now = time.monotonic()
            if not force and now - self._last_write < self.min_interval_s:
                return False
            step = max(int(step), self._last_step)
            tmp = f"{self.path}.tmp.{os.getpid()}"
            try:
                with open(tmp, "w") as f:
                    json.dump({"step": step, "t": time.time(),
                               "pid": os.getpid()}, f)
                os.replace(tmp, self.path)
            except OSError:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                return False
            self._last_write = now
            self._last_step = step
            return True


class PreemptionGuard:
    """Latches the first delivery of a handled signal; the training loop
    polls `triggered` at step boundaries."""

    def __init__(self) -> None:
        self._signum: int | None = None
        self._t: float | None = None
        self._saved: dict[int, object] = {}
        self.installed = False

    def install(self) -> bool:
        """Install handlers (main thread only — the interpreter rejects
        signal.signal elsewhere). Returns False when not installed; the
        trainer then runs without graceful preemption. The displaced
        handlers are remembered for uninstall()."""
        if threading.current_thread() is not threading.main_thread():
            return False
        try:
            for sig in HANDLED_SIGNALS:
                self._saved[sig] = signal.signal(sig, self._handler)
        except (ValueError, OSError):
            self.uninstall()  # partial install: roll back what landed
            return False
        self.installed = True
        return True

    def reassert(self) -> bool:
        """Re-take the handled signals if a library displaced the guard's
        handlers after install() (a distributed runtime's own SIGTERM
        handler would otherwise let the trainer step through a graceful
        eviction until it is SIGKILLed, losing the emergency checkpoint).
        Call after any distributed init. The originally displaced handlers
        stay remembered, so uninstall() still restores the pre-guard
        world."""
        if (not self.installed
                or threading.current_thread() is not threading.main_thread()):
            return False
        try:
            for sig in HANDLED_SIGNALS:
                # `==`, not `is`: self._handler is a bound method, and
                # every attribute access builds a fresh wrapper object.
                if signal.getsignal(sig) != self._handler:
                    signal.signal(sig, self._handler)
        except (ValueError, OSError):
            return False
        return True

    def uninstall(self) -> None:
        """Restore the displaced handlers. An in-process caller of the
        trainer's main() (tests, notebooks) must get its SIGINT semantics
        back — a stale guard latching Ctrl-C would make the host process
        uninterruptible."""
        for sig, h in list(self._saved.items()):
            try:
                signal.signal(sig, h)
            except (ValueError, OSError, TypeError):
                pass
            del self._saved[sig]
        self.installed = False

    def _handler(self, signum, frame) -> None:
        if self._signum is None:  # latch the first signal only
            self._signum = signum
            self._t = time.monotonic()

    @property
    def triggered(self) -> bool:
        return self._signum is not None

    @property
    def signum(self) -> int | None:
        return self._signum

    @property
    def signal_name(self) -> str | None:
        if self._signum is None:
            return None
        try:
            return signal.Signals(self._signum).name
        except ValueError:
            return str(self._signum)

    @property
    def exit_code(self) -> int:
        """128+signum, the shell convention the operator's exit-code
        policy classifies (143/130/138 are all retryable)."""
        return 128 + (self._signum or signal.SIGTERM)

    def elapsed(self) -> float:
        """Seconds since the latched signal arrived (0.0 if none)."""
        return 0.0 if self._t is None else time.monotonic() - self._t

    def within_grace(self, est_save_s: float, grace_s: float) -> bool:
        """Would an emergency save of ~est_save_s still fit the grace
        budget? The budget is measured from signal receipt (the kubelet
        SIGKILLs grace_s after SIGTERM, whatever we are doing), so time
        already burned finishing the in-flight step counts against it —
        including seconds spent DRAINING an in-flight async checkpoint
        write before this call (the drain happens-before the fast-path
        decision, so it flows through elapsed() with no extra
        bookkeeping). grace_s <= 0 means no budget: never attempt the
        save."""
        if grace_s <= 0:
            return False
        return self.elapsed() + max(0.0, est_save_s) < grace_s
