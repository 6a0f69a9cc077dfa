"""Trainer progress heartbeat: own copy of the JAX package's HeartbeatWriter.

The trainer writes a tiny monotonic `{step, t, pid}` JSON file at step
boundaries (`TPUJOB_HEARTBEAT_FILE`, injected by the runtime like
`TPUJOB_METRICS_FILE`); the operator's hang watchdog treats a stale
heartbeat on a Running job as a hang. The preemption guard is not ported
yet.
"""

from __future__ import annotations

import json
import os
import threading
import time

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
