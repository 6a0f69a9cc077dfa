"""Multi-slice training: counterpart of tf_operator_tpu/parallel/multislice.py.

One TrainJob spanning N slices (spec.tpu.slices) has two collective
domains. Within a slice, each slice is its own torch.distributed world
(the operator's per-slice coordinator env), and the slice's ParallelPlan
reduces the gradients over it as one-slice training does. Across slices,
this module's `DcnExchange` is a bucketed all-reduce over a shared
directory (TPUJOB_DCN_DIR) that the step loop feeds one microbatch at a
time, so the transfer of microbatch m rides under the backward of m+1.

The discipline is the JAX module's:

  * one engine thread per process does all the slow work (wire emulation,
    file IO, numpy reduction) and launches no CUDA work: the step loop
    copies each microbatch's gradients into host buffers on its own thread
    and submits numpy arrays;
  * accounting telescopes: the visible share of the exchange is the step
    loop's `dcn_sync` phase (telemetry/phases.py), the engine's own clock
    (`dcn_busy_s`) the total, and hidden_fraction = 1 - visible/busy.

The wire is the JAX package's byte for byte (the same file names, npz
payloads and status JSON), so a JAX slice and a port slice can share one
directory. TPUJOB_DCN_LATENCY_S / TPUJOB_DCN_GBPS emulate a slower link.

Per-slice recovery: when one slice's gang is rolled, the surviving slices
hold at this exchange's barrier (their heartbeats stay fresh through the
collect tick), and when the restarted slice announces a resume from the
shared checkpoint at an older step, `collect` raises `SliceRewind`: the
survivor re-restores that checkpoint in process and both replay forward.
"""

from __future__ import annotations

import json
import itertools
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np

# The operator's multi-slice env (own copy of tf_operator_tpu/cluster_spec/tpu_env.py).
ENV_SLICE_ID = "TPUJOB_SLICE_ID"
ENV_NUM_SLICES = "TPUJOB_NUM_SLICES"
ENV_DCN_COORDINATOR = "TPUJOB_DCN_COORDINATOR"
ENV_DCN_DIR = "TPUJOB_DCN_DIR"
# One job instance's rendezvous, apart from a later resubmission under the
# same name: the runtime folds it into the TPUJOB_DCN_DIR path.
ENV_DCN_EPOCH = "TPUJOB_DCN_EPOCH"

ENV_DCN_LATENCY = "TPUJOB_DCN_LATENCY_S"
ENV_DCN_GBPS = "TPUJOB_DCN_GBPS"

__all__ = [
    "ENV_DCN_LATENCY", "ENV_DCN_GBPS", "SliceWorld", "SliceRewind",
    "DcnPeerTimeout", "DcnInterrupted", "DcnExchange", "partition_buckets",
]


@dataclass
class SliceWorld:
    """This process's place in the multi-slice topology, from the
    operator-injected env (None from_env when the job is single-slice)."""

    slice_id: int
    num_slices: int
    dcn_dir: str
    # Emulated wire dial: per-bucket-transfer latency plus an optional
    # bandwidth charge on the 1/ici_degree DCN-resident fraction.
    latency_s: float = 0.0
    gbps: float = 0.0  # gigaBYTES/s per link; 0 = no bandwidth charge
    ici_degree: int = 1  # within-slice chips sharing the DCN transfer

    @classmethod
    def from_env(cls, env: dict | None = None) -> "SliceWorld | None":
        e = os.environ if env is None else env
        n = int(e.get(ENV_NUM_SLICES, "1") or 1)
        if n <= 1:
            return None
        dcn_dir = e.get(ENV_DCN_DIR, "")
        if not dcn_dir:
            raise RuntimeError(
                f"{ENV_NUM_SLICES}={n} but {ENV_DCN_DIR} is unset: the "
                f"cross-slice exchange needs a shared rendezvous directory "
                f"(the runtime injects one under its log dir)"
            )
        return cls(
            slice_id=int(e.get(ENV_SLICE_ID, "0") or 0),
            num_slices=n,
            dcn_dir=dcn_dir,
            latency_s=float(e.get(ENV_DCN_LATENCY, "0") or 0.0),
            gbps=float(e.get(ENV_DCN_GBPS, "0") or 0.0),
        )


class SliceRewind(Exception):
    """A peer slice restarted and resumed from the shared checkpoint at an
    older step: the surviving caller must re-restore that checkpoint in
    process and replay forward (its pods never restart)."""

    def __init__(self, to_step: int, peer: int):
        self.to_step = to_step
        self.peer = peer
        super().__init__(
            f"slice {peer} restarted and resumed from step {to_step}"
        )


class DcnPeerTimeout(Exception):
    pass


class DcnInterrupted(Exception):
    """collect() observed the caller's should_stop (a latched preemption
    signal): the hold is abandoned so the trainer can run its graceful
    SIGTERM path instead of wedging at the barrier until SIGKILL."""


def partition_buckets(nbytes: list[int], num_buckets: int) -> list[list[int]]:
    """Partition leaf indices into <= num_buckets CONTIGUOUS groups of
    roughly equal byte size (contiguous keeps bucket membership stable and
    cheap to reassemble; gradient leaves have no locality to exploit on an
    emulated wire). Every leaf lands in exactly one bucket."""
    if num_buckets < 1:
        raise ValueError(f"num_buckets must be >= 1, got {num_buckets}")
    total = sum(nbytes)
    if not nbytes:
        return []
    target = max(1, total // num_buckets)
    out: list[list[int]] = [[]]
    acc = 0
    for i, b in enumerate(nbytes):
        if out[-1] and len(out) < num_buckets and acc + b > target:
            out.append([])
            acc = 0
        out[-1].append(i)
        acc += b
    return out


@dataclass
class _Pending:
    """One step's in-flight exchange: the running sum of every
    (slice x microbatch) contribution plus which have landed."""

    step: int
    acc: list | None = None  # list[np.ndarray], sum of contributions
    init: list | None = None  # per-leaf: accumulator seeded yet?
    got: set = field(default_factory=set)  # (slice_id, microbatch, bucket)
    submitted: int = 0  # own microbatches handed to the engine


# Per-process generation sequence (see DcnExchange._gen).
_GEN_SEQ = itertools.count(1)


class DcnExchange:
    """Bucketed cross-slice gradient all-reduce over the emulated DCN.

    Protocol (all under `dcn_dir`, atomic tmp+rename writes):
      s{K}.status.json        slice K's liveness: {gen, resume_step, step, t}
      s{K}_t{N}_m{M}_b{B}.npz slice K's bucket B of microbatch M, step N
                              (within-slice-reduced; f32 wire)

    Contributions are accepted from ANY generation of a peer — a dead
    generation's partial step is bit-identical to its restart's replay of
    it (deterministic RNG keyed off the global step, same checkpoint), so
    stale files are valid and regeneration may skip rewriting them.
    Restart detection rides the status file alone: a peer whose `gen`
    changed AND whose announced resume_step is older than our current
    step triggers SliceRewind."""

    def __init__(self, world: SliceWorld, resume_step: int,
                 microbatches: int = 1, buckets: int = 4,
                 peer_timeout_s: float = 600.0,
                 start_engine: bool = True):
        self.world = world
        self.microbatches = max(1, microbatches)
        self.num_buckets = max(1, buckets)
        self.peer_timeout_s = peer_timeout_s
        # Generation token: unique ACROSS processes (pid + wall ms) and —
        # via the per-process counter — across constructions inside one
        # process. Millisecond resolution alone collided on a warm host
        # (two exchanges built < 1 ms apart read as the SAME generation,
        # so the peers' restart detection never fired and the survivor
        # held until the peer timeout).
        self._gen = (f"{os.getpid():x}-{next(_GEN_SEQ):x}-"
                     f"{int(time.time() * 1e3) & 0xffffffff:x}")
        self._resume_step = resume_step
        self._cond = threading.Condition()
        self._queue: list[tuple[int, int, list]] = []  # (step, m, leaves)
        self._pending: _Pending | None = None
        self._buckets: list[list[int]] | None = None  # leaf idx per bucket
        self._n_leaves: int | None = None
        self._peer_gen: dict[int, str] = {}
        self._rewind: SliceRewind | None = None
        self._error: BaseException | None = None
        self._stop = False
        self._queue_prune: int | None = None
        # Accounting (engine-thread clocks; read under the condition).
        self.dcn_busy_s = 0.0      # wire sleep + file IO + reduce
        self.visible_s = 0.0       # time the step loop blocked in collect()
        self.bytes_out = 0         # payload bytes this slice sent
        self.transfers = 0         # bucket files written
        self.rewinds = 0
        os.makedirs(world.dcn_dir, exist_ok=True)
        self.announce(resume_step)
        # start_engine=False: a caller drives the engine body
        # (_recv, _check_peers) itself, as a protocol model does.
        self._thread = None
        if start_engine:
            self._thread = threading.Thread(
                target=self._engine_main, name="dcn-exchange", daemon=True)
            self._thread.start()

    # ------------------------------------------------------------ protocol

    def _status_path(self, sid: int) -> str:
        return os.path.join(self.world.dcn_dir, f"s{sid}.status.json")

    def _data_path(self, sid: int, step: int, m: int, b: int) -> str:
        return os.path.join(
            self.world.dcn_dir, f"s{sid}_t{step}_m{m}_b{b}.npz")

    def announce(self, step: int, resume_step: int | None = None) -> None:
        """Publish this slice's liveness/progress (atomic replace). Called
        at startup (with the resume step — what a surviving peer rewinds
        to when it sees a NEW generation announce an OLD step), after each
        completed step, and on rewind."""
        if resume_step is not None:
            self._resume_step = resume_step
        payload = json.dumps({
            "gen": self._gen,
            "resume_step": self._resume_step,
            "step": step,
            "t": time.time(),
        })
        tmp = self._status_path(self.world.slice_id) + ".tmp"
        with open(tmp, "w") as f:
            f.write(payload)
        os.replace(tmp, self._status_path(self.world.slice_id))

    def _read_status(self, sid: int) -> dict | None:
        try:
            with open(self._status_path(sid)) as f:
                return json.loads(f.read())
        except (OSError, ValueError):
            return None  # absent (starting) or torn: treat as no signal

    # ----------------------------------------------------------- step loop

    def begin_step(self, step: int) -> None:
        """Arm the exchange for one global step (the loop is sequential:
        exactly one step in flight)."""
        with self._cond:
            self._raise_pending_locked()
            self._pending = _Pending(step=step)
            self._cond.notify_all()

    def submit(self, step: int, microbatch: int, leaves: list) -> None:
        """Hand one microbatch's within-slice-reduced gradient leaves
        (host arrays: the caller copies them off the device on its own
        thread) to
        the engine: it accumulates them locally and streams each bucket
        over the emulated wire while the caller's next microbatch backward
        computes. Non-f32 floating leaves are cast to f32 for the wire
        (gradient reduction in f32 — and numpy cannot serialize bf16)."""
        host = [np.asarray(x) for x in leaves]
        # Anything that is not a numpy-native int/bool/f32/f64 goes over
        # the wire as f32: f16 for precision, and a bf16 leaf of the JAX
        # side (dtype.kind 'V', which numpy would serialize as raw void
        # bytes the receiving side cannot reduce).
        host = [x if (x.dtype.kind in "iub"
                      or x.dtype in (np.float32, np.float64))
                else x.astype(np.float32)
                for x in host]
        with self._cond:
            self._raise_pending_locked()
            assert self._pending is not None and self._pending.step == step
            if self._buckets is None:
                self._n_leaves = len(host)
                self._buckets = partition_buckets(
                    [x.nbytes for x in host], self.num_buckets)
            self._pending.submitted += 1
            self._queue.append((step, microbatch, host))
            self._cond.notify_all()

    def collect(self, step: int, tick=None, should_stop=None) -> list:
        """Block until every (slice x microbatch) contribution for `step`
        has been accumulated; returns the MEAN leaves (sum / (S * M)).
        `tick()` runs ~2x/s while waiting — the caller's heartbeat ping,
        which is what keeps a HOLDING slice alive to the operator while a
        failed peer is rolled. `should_stop()` (the preemption guard) is
        polled on the same cadence: a latched SIGTERM raises
        DcnInterrupted so the trainer runs its graceful-preemption path
        instead of wedging at the barrier until the drain SIGKILL — in a
        whole-job eviction EVERY slice holds here, and none would ever
        reach a step boundary otherwise. Raises SliceRewind when a peer
        restarted behind us, DcnPeerTimeout after peer_timeout_s."""
        t0 = time.monotonic()
        deadline = t0 + self.peer_timeout_s
        need = self.world.num_slices * self.microbatches * len(
            self._buckets or [None])
        try:
            with self._cond:
                while True:
                    self._raise_pending_locked()
                    if self._rewind is not None:
                        rw = self._rewind
                        self._rewind = None
                        raise rw
                    p = self._pending
                    if (p is not None and p.step == step
                            and self._buckets is not None
                            and len(p.got) >= self.world.num_slices
                            * self.microbatches * len(self._buckets)
                            and p.submitted >= self.microbatches):
                        scale = 1.0 / (self.world.num_slices
                                       * self.microbatches)
                        return [a * scale for a in p.acc]
                    if time.monotonic() > deadline:
                        raise DcnPeerTimeout(
                            f"step {step}: peers incomplete after "
                            f"{self.peer_timeout_s:g}s "
                            f"({len(p.got) if p else 0}/{need} contributions)")
                    self._cond.wait(timeout=0.5)
                    if tick is not None:
                        tick()
                    if should_stop is not None and should_stop():
                        raise DcnInterrupted(f"step {step}")
        finally:
            with self._cond:
                self.visible_s += time.monotonic() - t0

    def step_done(self, completed_step: int) -> None:
        """The apply landed: publish progress and let the engine prune
        this slice's files older than the replay horizon."""
        self.announce(completed_step)
        with self._cond:
            self._pending = None
            self._queue_prune = completed_step - 2
            self._cond.notify_all()

    def rewind_to(self, step: int) -> None:
        """Caller re-restored the shared checkpoint at `step` after a
        SliceRewind: drop in-flight state and re-announce. Own files for
        replayed steps are left in place — the replay regenerates
        bit-identical content, and peers may already have consumed them."""
        with self._cond:
            self.rewinds += 1
            self._pending = None
            self._queue.clear()
            self._cond.notify_all()
        self.announce(step, resume_step=step)

    # ------------------------------------------------------------- engine

    def _wire_s(self, nbytes: int) -> float:
        """Emulated DCN wall-clock for one bucket transfer: fixed latency
        + the bandwidth charge on the 1/ici_degree fraction each chip
        carries after the within-slice reduce-scatter (the hierarchical-
        collective arithmetic)."""
        t = self.world.latency_s
        if self.world.gbps > 0:
            t += (nbytes / max(1, self.world.ici_degree)) / (
                self.world.gbps * 1e9)
        return t

    def _engine_main(self) -> None:
        try:
            while True:
                with self._cond:
                    if self._stop:
                        return
                    job = self._queue.pop(0) if self._queue else None
                    pending = self._pending
                    prune_to = self._queue_prune
                    self._queue_prune = None
                if job is not None:
                    self._send(*job)
                    continue
                if prune_to is not None:
                    self._prune(prune_to)
                if pending is not None and self._buckets is not None:
                    progressed = self._recv(pending)
                    self._check_peers(pending)
                    if progressed:
                        continue
                with self._cond:
                    if self._stop or self._queue:
                        continue
                    # Peer files land silently (no cross-process notify):
                    # poll fast while a step is incomplete — every idle
                    # millisecond here is VISIBLE dcn_sync wait for the
                    # collecting step loop — and lazily when idle.
                    self._cond.wait(
                        timeout=0.005 if self._pending is not None else 0.05)
        except BaseException as e:  # noqa: BLE001 — latched, re-raised on the loop
            with self._cond:
                self._error = e
                self._cond.notify_all()

    def _send(self, step: int, m: int, host: list) -> None:
        """Own contribution: accumulate locally, then stream each bucket
        over the emulated wire (sleep, then atomic file publish)."""
        t0 = time.monotonic()
        me = self.world.slice_id
        with self._cond:
            p = self._pending
            if p is not None and p.step == step:
                self._accumulate(p, me, m,
                                 list(range(len(self._buckets or []))), host)
                self._cond.notify_all()
        for b, idxs in enumerate(self._buckets or []):
            arrays = [host[i] for i in idxs]
            nbytes = sum(a.nbytes for a in arrays)
            path = self._data_path(me, step, m, b)
            wire = self._wire_s(nbytes)
            if wire > 0:
                time.sleep(wire)
            if not os.path.exists(path):
                # Replayed steps regenerate bit-identical content; the
                # original file (possibly already consumed by a peer)
                # stands.
                tmp = path + f".tmp{os.getpid()}"
                with open(tmp, "wb") as f:
                    np.savez(f, *arrays)
                os.replace(tmp, path)
            with self._cond:
                self.bytes_out += nbytes
                self.transfers += 1
        with self._cond:
            self.dcn_busy_s += time.monotonic() - t0
            self._cond.notify_all()

    def _accumulate(self, p: _Pending, sid: int, m: int, bucket_ids: list,
                    host_by_bucket) -> None:
        """Add a contribution into the step's running sum (engine thread
        only; caller holds the condition lock). host_by_bucket is either
        the full leaf list (own sends) or {bucket: arrays} from peer
        files."""
        if p.acc is None:
            p.acc = [None] * (self._n_leaves or 0)
            p.init = [False] * (self._n_leaves or 0)
        for b in bucket_ids:
            idxs = (self._buckets or [])[b]
            arrays = (host_by_bucket[b] if isinstance(host_by_bucket, dict)
                      else [host_by_bucket[i] for i in idxs])
            for i, arr in zip(idxs, arrays):
                if not p.init[i]:
                    p.acc[i] = arr.astype(np.float64
                                          if arr.dtype == np.float64
                                          else np.float32).copy()
                    p.init[i] = True
                else:
                    p.acc[i] += arr
            p.got.add((sid, m, b))

    def _recv(self, p: _Pending) -> bool:
        """Consume any peer bucket files for the current step that have
        not been accumulated yet. Returns True when progress was made."""
        progressed = False
        t0 = time.monotonic()
        for sid in range(self.world.num_slices):
            if sid == self.world.slice_id:
                continue
            for m in range(self.microbatches):
                for b in range(len(self._buckets or [])):
                    if (sid, m, b) in p.got:
                        continue
                    path = self._data_path(sid, p.step, m, b)
                    if not os.path.exists(path):
                        continue
                    try:
                        with np.load(path) as z:
                            arrays = [z[k] for k in z.files]
                    except (OSError, ValueError):
                        continue  # mid-rename/torn: next scan re-reads
                    with self._cond:
                        if self._pending is p:
                            self._accumulate(p, sid, m, [b], {b: arrays})
                            progressed = True
                            self._cond.notify_all()
        if progressed:
            with self._cond:
                self.dcn_busy_s += time.monotonic() - t0
        return progressed

    def _check_peers(self, p: _Pending) -> None:
        """Restart detection: a peer whose status generation CHANGED and
        whose announced resume step is behind our current step means its
        gang was rolled and it resumed from the shared checkpoint — we
        must rewind to meet it. First observation of a peer only records
        its generation (startup is not a restart)."""
        for sid in range(self.world.num_slices):
            if sid == self.world.slice_id:
                continue
            st = self._read_status(sid)
            if st is None or not st.get("gen"):
                continue
            prev = self._peer_gen.get(sid)
            self._peer_gen[sid] = st["gen"]
            if prev is None or prev == st["gen"]:
                continue
            resume = int(st.get("resume_step") or 0)
            # <= , not <: a peer can resume AT our pending step — the
            # checkpoint for step N goes durable once the SAVER completes
            # N, while we may still be waiting on the dead generation's
            # unpublished step-N files (the engine publishes a microbatch
            # AFTER its wire sleep, so a kill at a just-checkpointed
            # boundary can strand them). Rewinding to N is correct: the
            # checkpoint already contains N's result, we re-restore it and
            # continue at N+1 — waiting instead would stall both sides
            # until the peer timeout and roll the whole job.
            #
            # Judged against the LIVE pending step, not the engine's `p`
            # snapshot: the step loop can begin_step(N+1) while this scan
            # still works the completed step-N object, and evaluating the
            # one-shot generation change against the stale step swallows
            # it (`resume > p.step` looks like a restart AHEAD of us, the
            # new gen becomes the baseline, and the real `resume <= N+1`
            # comparison never happens — the survivor then holds until
            # the peer timeout).
            with self._cond:
                live = self._pending
                step_ref = live.step if live is not None else p.step
                if resume <= step_ref and self._rewind is None:
                    self._rewind = SliceRewind(resume, sid)
                    self._cond.notify_all()

    def _prune(self, older_than_step: int) -> None:
        """Bound the rendezvous dir: drop OWN bucket files for steps well
        behind the replay horizon (a rewinding peer regenerates anything
        it still needs — the rewind protocol is what makes eager pruning
        safe)."""
        if older_than_step < 0:
            return
        me = self.world.slice_id
        prefix = f"s{me}_t"
        try:
            names = os.listdir(self.world.dcn_dir)
        except OSError:
            return
        for fn in names:
            if not (fn.startswith(prefix) and fn.endswith(".npz")):
                continue
            try:
                step = int(fn[len(prefix):].split("_", 1)[0])
            except ValueError:
                continue
            if step <= older_than_step:
                try:
                    os.unlink(os.path.join(self.world.dcn_dir, fn))
                except OSError:
                    pass

    # ---------------------------------------------------------- accounting

    def _raise_pending_locked(self) -> None:
        if self._error is not None:
            raise RuntimeError(
                f"dcn exchange engine failed: "
                f"{type(self._error).__name__}: {self._error}"
            ) from self._error

    def stats(self) -> dict:
        """The done event's `dcn` block. hidden_fraction is the share of
        total DCN work (wire + IO + reduce) the step loop did NOT visibly
        wait for — the overlap win, measured."""
        with self._cond:
            busy = self.dcn_busy_s
            visible = self.visible_s
            hidden = (max(0.0, min(1.0, 1.0 - visible / busy))
                      if busy > 0 else None)
            return {
                "slices": self.world.num_slices,
                "slice_id": self.world.slice_id,
                "microbatches": self.microbatches,
                "buckets": len(self._buckets) if self._buckets else
                           self.num_buckets,
                "latency_s": self.world.latency_s,
                "gbps": self.world.gbps,
                "dcn_busy_s": round(busy, 6),
                "dcn_sync_s": round(visible, 6),
                "hidden_fraction": (round(hidden, 4)
                                    if hidden is not None else None),
                "bytes_out_mb": round(self.bytes_out / 1e6, 3),
                "transfers": self.transfers,
                "rewinds": self.rewinds,
            }

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
