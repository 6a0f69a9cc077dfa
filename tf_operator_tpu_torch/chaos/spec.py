"""Deterministic fault-spec parsing: own copy of tf_operator_tpu/chaos/spec.py.

The PyTorch trainer parses the whole grammar, so a spec the operator passes
to every pod never fails it; it acts only on the trainer's own kinds (kill,
hang, torn and stall:ckpt=N), see chaos/__init__.py.

One string — the `TPUJOB_CHAOS` env var or the trainer's `--chaos` flag —
declares every fault a run should suffer, so a failure scenario is
reproducible from the job spec alone (the same philosophy as the fake
workload's `/exit?exitCode=N` hook, scaled to the whole stack).

Grammar (whitespace-insensitive):

    spec       := directive (";" directive)*
    directive  := kind (":" kv ("," kv)*)?
    kv         := key "=" value

Directive kinds and their keys (all integers/floats unless noted):

    kill       step=N signal=NAME     SIGTERM the trainer once it completes
               [replica=TYPE]         step N (signal: TERM/INT/USR1/KILL/
               [index=I]              SEGV..., bare name, SIG-prefixed, or
               [slice=K]              a number). Without a one-shot state
                                      dir the directive only fires in a
                                      process that STARTED before step N,
                                      so a resumed run past N never
                                      re-fires. replica/index restrict the
                                      directive to the pod whose
                                      TPUJOB_REPLICA_TYPE / _INDEX match —
                                      how a multi-worker job kills exactly
                                      one gang member. slice=K matches
                                      TPUJOB_SLICE_ID (multi-slice jobs:
                                      fail exactly one slice's gang;
                                      composes with replica/index to name
                                      one member of that slice).
    hang       step=N [duration=S]    stop stepping WITHOUT exiting after
               [replica=TYPE]         step N (the wedged-collective
               [index=I]              failure mode exit codes can never
                                      see — drives the heartbeat hang
                                      watchdog). No duration = hang until
                                      killed; with duration=S stepping
                                      resumes after S seconds. Same
                                      one-shot/replica semantics as kill.
    torn       step=N mode=truncate   corrupt the just-written checkpoint
                    |unlink           for step N (truncate the largest
                                      file to half, or unlink a leaf) —
                                      the resume-fallback scenario.
    stall      delay=S batch=N        sleep S seconds in the staging
                    | every=K         ring's transfer leg for batch N
               [lane=L]               (or every Kth batch). lane=L
                    | ckpt=N          restricts the stall to transfer
                                      lane L of the multi-lane engine
                                      (how a test wedges ONE lane and
                                      proves the others keep the ring
                                      ordered and live); lane=L alone
                                      (no batch/every) stalls every
                                      batch that lane carries. ckpt=N
                                      targets the CHECKPOINT WRITER
                                      instead of the staging ring: the
                                      save of step N sleeps S seconds
                                      between its finished tmp write
                                      and the publishing rename —
                                      deterministically holds the async
                                      write leg mid-write so a kill:
                                      landing there strands exactly one
                                      tmp publish dir. ckpt= composes with
                                      nothing else (no batch/every/
                                      lane) and is one-shot like kill
                                      (per process without a
                                      TPUJOB_CHAOS_STATE dir, across
                                      restarts with one — a resumed
                                      generation re-saving step N must
                                      not re-stall).
    apiserver  errors=N code=C        the fake apiserver fails the next N
               latency=S match=SUB    matched requests with HTTP C
                                      (code=0: latency only), sleeping S
                                      first; match is a substring of
                                      "METHOD /path".
    preempt    step=N job=NAME        OPERATOR-side: the controller
               [namespace=NS]         gracefully evicts the named job
                                      (SIGTERM -> emergency checkpoint ->
                                      requeue, Preempted condition, tally
                                      untouched) once its progress
                                      heartbeat reaches step N — the
                                      deterministic stand-in for a
                                      higher-priority arrival, so
                                      preemption e2es fire at an exact
                                      step boundary like kill/hang.
                                      Requires a heartbeat source
                                      (operator --log-dir). namespace
                                      defaults to "default". One-shot
                                      like kill/hang.

    capacity   slices=N               OPERATOR-side: dial the fake slice
               [at_step=S job=NAME]   inventory to its first N entries
               [namespace=NS]         (slices at index >= N go offline;
                                      a later directive with a larger N
                                      brings them back — the
                                      deterministic stand-in for node
                                      loss/return in degraded-capacity
                                      e2es). Held slices are not
                                      revoked; the holder notices at
                                      its next gang roll (elastic
                                      recovery then reshapes onto
                                      whatever fits). Without at_step
                                      the dial describes inventory
                                      STATE and re-applies at EVERY
                                      operator start (a failover must
                                      not restore capacity the scenario
                                      lost); with at_step=S it fires
                                      once job=NAME's heartbeat reaches
                                      S (one-shot, like preempt).

One-shot semantics across restarts: when `TPUJOB_CHAOS_STATE` names a
directory, each fired directive drops a marker file there and never fires
again — `kill:step=5;kill:step=12` then kills a job exactly twice across
three process generations.

Parsing is strict (unknown kinds/keys and malformed values raise
ValueError with the offending token) so a typo'd fault spec fails the run
immediately instead of silently injecting nothing.
"""

from __future__ import annotations

import os
import signal as _signal
from dataclasses import dataclass, field

ENV_CHAOS = "TPUJOB_CHAOS"
ENV_CHAOS_STATE = "TPUJOB_CHAOS_STATE"

KINDS = ("kill", "hang", "torn", "stall", "apiserver", "preempt",
         "capacity")

_KEYS: dict[str, dict[str, type]] = {
    "kill": {"step": int, "signal": str, "replica": str, "index": int,
             "slice": int},
    "hang": {"step": int, "duration": float, "replica": str, "index": int,
             "slice": int},
    "torn": {"step": int, "mode": str},
    "stall": {"delay": float, "batch": int, "every": int, "lane": int,
              "ckpt": int},
    "apiserver": {"errors": int, "code": int, "latency": float,
                  "match": str},
    "preempt": {"step": int, "job": str, "namespace": str},
    "capacity": {"slices": int, "at_step": int, "job": str,
                 "namespace": str},
}

TORN_MODES = ("truncate", "unlink")


def parse_signal(name: str) -> int:
    """'TERM' / 'SIGTERM' / '15' -> 15. Raises ValueError on unknowns."""
    s = name.strip().upper()
    if s.isdigit():
        return int(s)
    if not s.startswith("SIG"):
        s = "SIG" + s
    try:
        return int(getattr(_signal, s))
    except AttributeError:
        raise ValueError(f"unknown signal {name!r}") from None


@dataclass(frozen=True)
class Directive:
    kind: str
    params: dict = field(default_factory=dict)

    @property
    def id(self) -> str:
        """Stable identity for one-shot markers: kind plus its sorted
        params ('kill.signal=TERM.step=5')."""
        parts = [self.kind] + [
            f"{k}={self.params[k]}" for k in sorted(self.params)
        ]
        return ".".join(parts)


def parse_chaos(text: str) -> list[Directive]:
    """Parse a chaos spec string; [] for empty/blank input."""
    out: list[Directive] = []
    for raw in (text or "").split(";"):
        raw = raw.strip()
        if not raw:
            continue
        kind, _, rest = raw.partition(":")
        kind = kind.strip()
        if kind not in KINDS:
            raise ValueError(
                f"chaos: unknown directive kind {kind!r} (not in {KINDS})"
            )
        params: dict = {}
        for kv in rest.split(","):
            kv = kv.strip()
            if not kv:
                continue
            key, sep, value = kv.partition("=")
            key = key.strip()
            if not sep:
                raise ValueError(f"chaos: {kind}: expected key=value, got {kv!r}")
            typ = _KEYS[kind].get(key)
            if typ is None:
                raise ValueError(
                    f"chaos: {kind}: unknown key {key!r} "
                    f"(valid: {sorted(_KEYS[kind])})"
                )
            try:
                params[key] = typ(value.strip())
            except ValueError:
                raise ValueError(
                    f"chaos: {kind}: {key}={value.strip()!r} is not a "
                    f"valid {typ.__name__}"
                ) from None
        _validate(kind, params)
        out.append(Directive(kind, params))
    return out


def _validate(kind: str, params: dict) -> None:
    if kind in ("kill", "hang") and params.get("index", 0) < 0:
        raise ValueError(f"chaos: {kind}: index must be >= 0")
    if kind in ("kill", "hang") and params.get("slice", 0) < 0:
        raise ValueError(f"chaos: {kind}: slice must be >= 0")
    if kind == "kill":
        if "step" not in params:
            raise ValueError("chaos: kill requires step=N")
        parse_signal(params.get("signal", "TERM"))  # fail fast on typos
    elif kind == "hang":
        if "step" not in params:
            raise ValueError("chaos: hang requires step=N")
        if params.get("duration", 1.0) <= 0:
            raise ValueError("chaos: hang: duration must be > 0")
    elif kind == "torn":
        if "step" not in params:
            raise ValueError("chaos: torn requires step=N")
        mode = params.get("mode", "truncate")
        if mode not in TORN_MODES:
            raise ValueError(
                f"chaos: torn: mode {mode!r} not in {TORN_MODES}"
            )
    elif kind == "stall":
        if "delay" not in params or params["delay"] < 0:
            raise ValueError("chaos: stall requires delay=SECONDS >= 0")
        if "batch" in params and "every" in params:
            raise ValueError(
                "chaos: stall takes at most one of batch=N or every=K"
            )
        if "ckpt" in params and any(
                k in params for k in ("batch", "every", "lane")):
            raise ValueError(
                "chaos: stall: ckpt=N targets the checkpoint writer and "
                "composes with none of batch/every/lane"
            )
        if ("batch" not in params and "every" not in params
                and "lane" not in params and "ckpt" not in params):
            raise ValueError(
                "chaos: stall needs a target: batch=N, every=K, lane=L, "
                "or ckpt=N"
            )
        if params.get("every", 1) < 1:
            raise ValueError("chaos: stall: every must be >= 1")
        if params.get("lane", 0) < 0:
            raise ValueError("chaos: stall: lane must be >= 0")
        if params.get("ckpt", 1) < 1:
            raise ValueError("chaos: stall: ckpt must be >= 1 (saves "
                             "happen at completed-step boundaries)")
    elif kind == "apiserver":
        if params.get("errors", 1) < 0:
            raise ValueError("chaos: apiserver: errors must be >= 0")
        if params.get("latency", 0.0) < 0:
            raise ValueError("chaos: apiserver: latency must be >= 0")
    elif kind == "preempt":
        if "step" not in params:
            raise ValueError("chaos: preempt requires step=N")
        if not params.get("job"):
            raise ValueError("chaos: preempt requires job=NAME")
    elif kind == "capacity":
        if "slices" not in params or params["slices"] < 0:
            raise ValueError("chaos: capacity requires slices=N >= 0")
        if "at_step" in params and not params.get("job"):
            raise ValueError(
                "chaos: capacity: at_step=S needs job=NAME (the step is "
                "observed on that job's progress heartbeat)"
            )


def from_env(env: dict | None = None) -> list[Directive]:
    """Directives from TPUJOB_CHAOS; [] when unset. Strict parse: a bad
    spec raises rather than running the job un-faulted."""
    e = os.environ if env is None else env
    return parse_chaos(e.get(ENV_CHAOS, ""))


class OneShotState:
    """Marker-file store making directives fire once across process
    restarts (TPUJOB_CHAOS_STATE). Without a configured directory, fired()
    is process-local memory — each new process starts fresh."""

    def __init__(self, state_dir: str | None = None):
        self.state_dir = state_dir
        self._fired: set[str] = set()
        if state_dir:
            os.makedirs(state_dir, exist_ok=True)

    @classmethod
    def from_env(cls, env: dict | None = None) -> "OneShotState":
        e = os.environ if env is None else env
        return cls(e.get(ENV_CHAOS_STATE) or None)

    def _path(self, directive_id: str) -> str:
        # Marker names must be filesystem-safe; directive ids are
        # [a-z0-9.=_-] by construction (kind + key=value tokens).
        return os.path.join(self.state_dir or "", directive_id + ".fired")

    def fired(self, directive: Directive) -> bool:
        if directive.id in self._fired:
            return True
        return bool(self.state_dir) and os.path.exists(
            self._path(directive.id)
        )

    def mark(self, directive: Directive) -> None:
        self._fired.add(directive.id)
        if self.state_dir:
            with open(self._path(directive.id), "w") as f:
                f.write("1")
