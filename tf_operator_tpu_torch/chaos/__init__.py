"""Trainer-side fault injection: own copy of the JAX package's chaos hooks.

One spec string (`TPUJOB_CHAOS`, or the trainer's `--chaos`, which
overrides it) declares every fault of a run; the grammar is chaos/spec.py,
parsed whole. The PyTorch trainer acts on its own kinds only:

    TPUJOB_CHAOS="kill:step=12,signal=TERM"            # preempt at step 12
    TPUJOB_CHAOS="hang:step=4,duration=2"              # go quiet at step 4
    TPUJOB_CHAOS="torn:step=8;kill:step=8,signal=KILL" # tear then die
    TPUJOB_CHAOS="stall:ckpt=4,delay=5"                # hold the save of step 4
    TPUJOB_CHAOS="stall:lane=0,delay=0.05"             # slow staging lane 0

Injection points, each one hook at its subsystem's boundary and free when
the spec is unset:

  * trainer step boundary     models/train.py -> TrainerChaos.hang_at, maybe_kill
  * checkpoint write leg      models/train.py -> tear_checkpoint
  * checkpoint publish        models/checkpoint.py -> ckpt_stall_delay
  * staging-ring transfer leg data/staging.py -> staging_stall_delay

The other kinds (apiserver, preempt, capacity) are the operator's; the
trainer parses and ignores them.
"""

from __future__ import annotations

import os

from tf_operator_tpu_torch.chaos.spec import (
    ENV_CHAOS,
    ENV_CHAOS_STATE,
    Directive,
    OneShotState,
    from_env,
    parse_chaos,
    parse_signal,
)

__all__ = [
    "ENV_CHAOS", "ENV_CHAOS_STATE", "Directive", "OneShotState",
    "from_env", "parse_chaos", "parse_signal", "replica_matches",
    "TrainerChaos", "hang", "tear_checkpoint", "staging_stalls_from_env",
    "staging_stall_delay", "ckpt_stalls_from_env", "ckpt_stall_delay",
    "reset_ckpt_stall_state",
]


def replica_matches(directive: Directive, env: dict | None = None) -> bool:
    """Whether a kill/hang directive targets this replica: `replica=TYPE`,
    `index=I` and `slice=K` must match TPUJOB_REPLICA_TYPE,
    TPUJOB_REPLICA_INDEX and TPUJOB_SLICE_ID; a directive without them
    matches every process, and one that names them never fires in a
    process the operator did not label."""
    e = os.environ if env is None else env
    want_type = directive.params.get("replica")
    if want_type is not None:
        if e.get("TPUJOB_REPLICA_TYPE", "").lower() != want_type.lower():
            return False
    for key, var in (("index", "TPUJOB_REPLICA_INDEX"), ("slice", "TPUJOB_SLICE_ID")):
        want = directive.params.get(key)
        if want is None:
            continue
        try:
            if int(e.get(var, "")) != want:
                return False
        except ValueError:
            return False
    return True


def hang(duration: float | None) -> None:
    """Stop making progress without exiting (the wedged-collective
    simulation): sleep in short slices, until `duration` seconds have
    passed or, with None, until killed from outside. A latched SIGTERM does
    not end it: a real wedge never reaches the graceful path either."""
    import time as _time

    deadline = None if duration is None else _time.monotonic() + duration
    while deadline is None or _time.monotonic() < deadline:
        _time.sleep(0.25)


class TrainerChaos:
    """The trainer's directives (kill / hang / torn), evaluated at step
    boundaries. Without a one-shot state dir a kill or hang fires in a
    process that started before its step and has now completed it
    (start_step < step <= done), so a run resumed at or past the step never
    fires it again; with TPUJOB_CHAOS_STATE, fired directives drop markers
    and fire once across restarts."""

    def __init__(self, directives: list[Directive], state: OneShotState | None = None):
        self.kills = [d for d in directives if d.kind == "kill"]
        self.hangs = [d for d in directives if d.kind == "hang"]
        self.tears = [d for d in directives if d.kind == "torn"]
        self.state = state or OneShotState()

    @classmethod
    def from_env(cls, env: dict | None = None) -> "TrainerChaos | None":
        """None when the spec has no kill, hang or torn directive."""
        directives = from_env(env)
        if not any(d.kind in ("kill", "hang", "torn") for d in directives):
            return None
        return cls(directives, OneShotState.from_env(env))

    def _due(self, directives: list[Directive], done: int,
             start_step: int) -> Directive | None:
        """The first unfired directive whose step this boundary crossed and
        whose replica filter matches; marked fired."""
        for d in directives:
            step = d.params["step"]
            if done < step or self.state.fired(d):
                continue
            if not self.state.state_dir and start_step >= step:
                continue  # resumed past the target point: never fire again
            if not replica_matches(d):
                continue
            self.state.mark(d)
            return d
        return None

    def maybe_kill(self, done: int, start_step: int) -> None:
        """Send the directive's signal to this process once step `done`
        reaches its step. A signal the preemption guard latches returns
        here and the caller's boundary check handles it; SIGKILL never
        returns."""
        d = self._due(self.kills, done, start_step)
        if d is not None:
            os.kill(os.getpid(), parse_signal(d.params.get("signal", "TERM")))

    def hang_at(self, done: int, start_step: int) -> Directive | None:
        """The hang directive this boundary triggers, if any (marked fired);
        the caller emits `chaos_hang` and then calls hang()."""
        return self._due(self.hangs, done, start_step)

    def tear_for_step(self, step: int) -> Directive | None:
        """The unfired torn-checkpoint directive for `step`, if any."""
        for d in self.tears:
            if d.params["step"] == step and not self.state.fired(d):
                return d
        return None


def tear_checkpoint(ckpt_dir: str, step: int, mode: str = "truncate") -> str:
    """Damage the finished checkpoint of `step` as storage failures do:
    `truncate` halves its tensor file (step_<N>/tree.safetensors, a torn
    write that the manifest's size census catches), `unlink` removes it (a
    lost object). Returns the damaged path."""
    from tf_operator_tpu_torch.models.checkpoint import TREE_FILE

    target = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}", TREE_FILE)
    if not os.path.isfile(target):
        raise FileNotFoundError(target)
    if mode == "unlink":
        os.unlink(target)
    else:
        with open(target, "r+b") as f:
            f.truncate(os.path.getsize(target) // 2)
    return target


def staging_stalls_from_env(env: dict | None = None) -> list[Directive]:
    """`stall:` directives for the staging ring's transfer lanes; [] without
    a spec. ckpt-targeted stalls belong to the checkpoint publish."""
    e = os.environ if env is None else env
    if not e.get(ENV_CHAOS):
        return []
    return [d for d in from_env(e) if d.kind == "stall" and "ckpt" not in d.params]


def staging_stall_delay(index: int, stalls: list[Directive],
                        lane: int | None = None) -> float:
    """Seconds to hold staged batch `index` (0-based) carried by transfer
    lane `lane`: a `lane=L` directive fires only in that lane (every batch
    it carries unless it names batch= or every=); batch=N holds batch N,
    every=K every K-th batch."""
    total = 0.0
    for d in stalls:
        want_lane = d.params.get("lane")
        if want_lane is not None and lane != want_lane:
            continue
        if "batch" in d.params:
            if index == d.params["batch"]:
                total += d.params["delay"]
        elif "every" in d.params:
            if index % d.params["every"] == 0:
                total += d.params["delay"]
        else:
            total += d.params["delay"]
    return total


def ckpt_stalls_from_env(env: dict | None = None) -> list[Directive]:
    """`stall:ckpt=N` directives: the checkpoint publish's deterministic
    hold (models/checkpoint.py sleeps between the finished tmp write and
    the publishing rename); [] without a spec."""
    e = os.environ if env is None else env
    if not e.get(ENV_CHAOS):
        return []
    return [d for d in from_env(e) if d.kind == "stall" and "ckpt" in d.params]


# Run-lifetime one-shot memory of ckpt stalls (a TPUJOB_CHAOS_STATE dir
# persists across restarts on its own). The trainer's teardown resets it so
# an in-process caller's next run starts fresh.
_ckpt_stall_state: OneShotState | None = None


def reset_ckpt_stall_state() -> None:
    global _ckpt_stall_state
    _ckpt_stall_state = None


def ckpt_stall_delay(step: int, stalls: list[Directive],
                     state: OneShotState | None = None) -> float:
    """Seconds to hold the publish of the checkpoint of `step`. One-shot
    like kill and hang: a resumed generation saving the same step again is
    not held again."""
    global _ckpt_stall_state
    if not stalls:
        return 0.0
    if state is None:
        if _ckpt_stall_state is None:
            _ckpt_stall_state = OneShotState.from_env()
        state = _ckpt_stall_state
    total = 0.0
    for d in stalls:
        if d.params.get("ckpt") != step or state.fired(d):
            continue
        state.mark(d)
        total += d.params["delay"]
    return total
