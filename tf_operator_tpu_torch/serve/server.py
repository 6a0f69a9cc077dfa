"""The in-pod batch inference server on PyTorch: `python -m
tf_operator_tpu_torch.serve.server`. Counterpart of
tf_operator_tpu/serve/server.py, with its pod contract: the TPUJOB_SERVE_*
env and flags, the HTTP API (`POST /predict`, `GET /healthz`, `GET
/metrics`), the stats file, the heartbeat, the metric families, the
start/serve_ready/ckpt_follow/done events, the exit codes and checkpoint
following. An InferenceService chooses it by its template's command.

One serving replica:

  HTTP handler threads --(queue)--> ASSEMBLER --(slot)--> DISPATCH --(events)--> handlers

  * handlers parse `POST /predict {"instances": [[...], ...]}` rows,
    enqueue them, and block on a per-request event;
  * the ASSEMBLER thread waits up to `--batch-timeout-ms` after the FIRST
    queued row for peers to coalesce, caps at `--batch-max-size` rows,
    pads to the smallest power-of-two BUCKET that fits (every bucket shape
    is warmed before readiness), and hands the padded batch to a depth-1
    staging slot, whose put() blocks while it is full;
  * the DISPATCH thread, the ONLY thread that launches device compute,
    takes staged batches, runs the forward and demuxes per-request
    results. Grad mode is thread-local, so it enters
    `torch.inference_mode()` itself.

Checkpoints: the port trainer's safetensors checkpoints
(models/checkpoint.py). The newest VALIDATED step under --checkpoint-dir
is restored on the host and placed on the device; a torn newest save falls
back to the previous valid step as the trainer's resume walk would.

Checkpoint FOLLOWING (--follow): a follower thread polls
latest_valid_checkpoint every --follow-poll-s; when a strictly newer step
validates it restores it on the host, rejects a drifted param tree (another
name, shape or dtype per leaf), casts the LM's dense weights to the
compute dtype on the host, copies the tensors to the device on its own
CUDA stream, waits for an event recorded after the copies, and only then
swaps the served (params, step) pair, so a tick never reads half-copied
weights. The follower launches copies only, never compute. A failed
restore keeps the old params and retries next poll; in follow mode an
EMPTY checkpoint dir at startup waits (ticking the heartbeat) for the
trainer's first valid save.

Liveness and load: the heartbeat (TPUJOB_HEARTBEAT_FILE, step =
dispatched batches), the stats file (TPUJOB_SERVE_STATS_FILE, atomic JSON
of inflight, requests, pad efficiency, p50/p99 ms, ...), /metrics with the
tpujob_serve_* families (status/metrics.py, one child series per replica)
and the events file (TPUJOB_METRICS_FILE).

Generative serving (--model transformer-lm): a CONTINUOUS-BATCHING decode
loop over models/decode.py.

  * a 2-D (rows x seq-len) bucket grid: prompts pad to the smallest grid
    point that fits, every point warmed before readiness;
  * the KV cache is device state owned by the dispatch thread:
    --max-concurrent-seqs slots (+1 scratch) of [layers, slots, heads,
    max-seq-len, head_dim];
  * the dispatch thread PREFILLS new requests into free slots, runs one
    decode step over ALL slots a tick, retires finished rows at once and
    admits queued rows between ticks; --continuous 0 is the
    run-to-completion baseline;
  * after a checkpoint swap it RE-PREFILLS every in-flight sequence's
    context under the new params before the next tick;
  * a retired slot's position and token are parked at 0: its tick output
    is thrown away and a reused slot is re-prefilled from 0, so no answer
    changes, and no inactive slot can carry a position past the cache.

The compute dtype's copies of the dense weights are made once at load and
once at each swap (decode.prepare_params), not at each call: the same bits.

On CUDA the forwards run as CUDA graphs (serve/decode_graphs.py, the
counterpart of the JAX server's jit): load warms and captures prefill at
every grid point and the tick at its one shape, or a classifier's forward
and argmax at every row bucket, and serving only replays them. A swap's new
weights are copied into the captured parameters by the dispatch thread
between ticks (before the re-prefill) or batches. The CPU runs eagerly
(`decode_graphs.serve_route`, reported in the serve_ready event).

--device cuda (the default) or cpu; with cuda and no CUDA device the
server exits 1 with a message, it never runs on the CPU instead.

Graceful shutdown: SIGTERM latches a stop flag; the assembler drains the
queued requests into the slot, the dispatcher answers them all (decode
mode: finishes every in-flight sequence), a final stats snapshot and
`done` event are written, and the process exits 0. Chaos
`kill:step=N[,replica=server]` fires after N dispatched batches (decode
mode: prefill calls + decode ticks).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
from http.server import ThreadingHTTPServer

import numpy as np
import torch

from tf_operator_tpu_torch.serve.decode_graphs import (
    GraphedDecode,
    GraphedForward,
    serve_route,
)
from tf_operator_tpu_torch.status import metrics as metrics_mod
from tf_operator_tpu_torch.utils.preemption import HeartbeatWriter

ENV_STATS_FILE = "TPUJOB_SERVE_STATS_FILE"


class _HTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog of 128: socketserver's 5
    can refuse a burst of clients with a reset instead of queueing them."""

    request_queue_size = 128


def _host(x) -> np.ndarray:
    """A device result as a host array (waits for the device)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _emit(event: dict) -> None:
    """Append one JSON event line to TPUJOB_METRICS_FILE (the trainer's
    event-stream contract; the collector reads it back)."""
    path = os.environ.get("TPUJOB_METRICS_FILE")
    if not path:
        return
    try:
        with open(path, "a") as f:
            f.write(json.dumps(event) + "\n")
    except OSError:
        pass


# ------------------------------------------------------------------ buckets


def bucket_sizes(batch_max: int) -> tuple[int, ...]:
    """The shape-bucket ladder for a batchMaxSize: every power of two
    below it, then the max itself — a small, fixed set of shapes
    (log2(max)+1 of them), each warmed before readiness."""
    if batch_max < 1:
        raise ValueError(f"batch_max must be >= 1, got {batch_max}")
    sizes = []
    b = 1
    while b < batch_max:
        sizes.append(b)
        b *= 2
    sizes.append(batch_max)
    return tuple(sizes)


def select_bucket(n: int, buckets: tuple[int, ...]) -> int:
    """The smallest bucket that fits n rows (buckets ascend and end at
    batchMaxSize, so any legal batch fits)."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"{n} rows exceed the largest bucket {buckets[-1]}")


# The seq-len ladder starts here, not at 1: token buckets below it would
# multiply the warmed-shape grid for shapes whose whole forward costs
# less than its dispatch overhead.
SEQ_BUCKET_FLOOR = 16


def seq_bucket_sizes(max_len: int) -> tuple[int, ...]:
    """The token-dimension ladder of the 2-D bucket grid: the power-of-two
    ladder floored at SEQ_BUCKET_FLOOR (tiny token shapes are not worth a
    shape of their own), capped by maxSequenceLength."""
    floor = min(SEQ_BUCKET_FLOOR, max_len)
    return tuple(b for b in bucket_sizes(max_len) if b >= floor)


def select_grid_bucket(
    rows: int, tokens: int,
    row_buckets: tuple[int, ...], seq_buckets: tuple[int, ...],
) -> tuple[int, int]:
    """The smallest (rows, seq-len) grid point that fits — per-dimension
    smallest fit, since the ladders are independent."""
    return select_bucket(rows, row_buckets), select_bucket(tokens, seq_buckets)


class _Pending:
    """One queued request: rows in, predictions out via the event.
    Generative requests additionally carry their (clamped) maxNewTokens
    and an unfinished-row countdown — each row is one decode sequence and
    the event fires when the LAST of them retires."""

    __slots__ = ("rows", "event", "result", "error", "t_in", "step",
                 "max_new", "unfinished")

    def __init__(self, rows, max_new: int | None = None):
        self.rows = rows
        self.event = threading.Event()
        self.result = None
        self.error: str | None = None
        self.t_in = time.monotonic()
        self.step: int | None = None  # checkpoint step that served it
        self.max_new = max_new
        self.unfinished = 0


class _Staged:
    """One assembled micro-batch parked in the staging slot: the padded
    device-ready array plus the requests it demuxes back into."""

    __slots__ = ("items", "padded", "n", "bucket")

    def __init__(self, items, padded, n: int, bucket: int):
        self.items = items
        self.padded = padded
        self.n = n
        self.bucket = bucket


class _StagedDecode:
    """Assembled decode work parked in the staging slot: validated prompt
    rows token-packed to a seq bucket, SORTED ascending by length (so the
    dispatcher's admission chunks re-tighten their token bucket). The
    dispatcher consumes it row-by-row as KV slots free up — `tokens` is a
    host array precisely so partial admission can slice it."""

    __slots__ = ("tokens", "lengths", "max_new", "row_refs", "n", "tb")

    def __init__(self, tokens, lengths, max_new, row_refs, tb: int):
        self.tokens = tokens      # np [n, tb] int32, zero-padded
        self.lengths = lengths    # np [n] int32 — true prompt lengths
        self.max_new = max_new    # np [n] int32 — per-row generation cap
        self.row_refs = row_refs  # [(item, row_index)] aligned with rows
        self.n = int(tokens.shape[0])
        self.tb = tb


class _Seq:
    """One in-flight decode sequence bound to a KV-cache slot."""

    __slots__ = ("item", "row", "prompt", "generated", "remaining")

    def __init__(self, item, row: int, prompt: list[int], first: int,
                 max_new: int):
        self.item = item
        self.row = row
        self.prompt = prompt
        self.generated = [first]
        self.remaining = max_new - 1


class StagingSlot:
    """Depth-1 staging between the assembler and dispatch stages (a
    staging ring of depth 1). put() BLOCKS while the slot is
    full — backpressure reaches the assembler instead of growing an
    unbounded intermediate queue. Only the assembler closes the slot
    (after draining the request queue), so the dispatcher's drain is
    race-free."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._item: _Staged | None = None
        self._closed = False

    def put(self, staged: _Staged) -> bool:
        with self._cond:
            while self._item is not None and not self._closed:
                self._cond.wait()
            if self._closed:
                return False
            self._item = staged
            self._cond.notify_all()
            return True

    def take(self, timeout_s: float = 0.05) -> _Staged | None:
        """The next staged batch, or None on timeout (idle tick) or when
        closed and drained — check is_closed() to tell the two apart."""
        with self._cond:
            deadline = time.monotonic() + timeout_s
            while self._item is None and not self._closed:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cond.wait(timeout=left)
            staged, self._item = self._item, None
            if staged is not None:
                self._cond.notify_all()  # wake a blocked put()
            return staged

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def is_closed(self) -> bool:
        with self._lock:
            return self._closed


class BatchQueue:
    """The handler->assembler queue plus the micro-batch assembly wait.

    take_batch blocks until at least one request is queued, then waits up
    to `timeout_s` (from the FIRST row's arrival) for more, returning at
    most `max_rows` ROWS' worth of requests. A request whose row count
    exceeds max_rows is rejected at submit (the caller 413s)."""

    def __init__(self, max_rows: int, timeout_s: float):
        self.max_rows = max_rows
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._items: list[_Pending] = []
        self._closed = False

    def submit(self, item: _Pending) -> bool:
        if len(item.rows) > self.max_rows:
            return False
        with self._cond:
            if self._closed:
                return False
            self._items.append(item)
            self._cond.notify()
        return True

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def pending(self) -> int:
        with self._lock:
            return len(self._items)

    def take_batch(self, poll_s: float = 0.05) -> list[_Pending] | None:
        """The next micro-batch (None when closed AND drained). Without
        traffic, wakes every `poll_s` so the caller can tick liveness."""
        with self._cond:
            # Arrival wait: bounded by poll_s so the idle assembler still
            # reaches its stop-flag check.
            poll_deadline = time.monotonic() + poll_s
            while (not self._items and not self._closed
                   and poll_deadline - time.monotonic() > 0):
                self._cond.wait(timeout=poll_deadline - time.monotonic())
            if not self._items:
                return None if self._closed else []
            # Assembly wait: from the FIRST row's arrival, up to the
            # batch timeout, for peers to coalesce.
            deadline = self._items[0].t_in + self.timeout_s
            while (sum(len(i.rows) for i in self._items) < self.max_rows
                   and not self._closed
                   and deadline - time.monotonic() > 0):
                self._cond.wait(timeout=deadline - time.monotonic())
            batch: list[_Pending] = []
            taken = 0
            while self._items and taken + len(self._items[0].rows) <= self.max_rows:
                item = self._items.pop(0)
                taken += len(item.rows)
                batch.append(item)
            return batch


# Model names served by the decode scheduler (the trainer's --model
# vocabulary, like the classifier list in load()).
GENERATIVE_MODELS = ("transformer-lm",)


class InferenceServer:
    def __init__(self, model_name: str, ckpt_dir: str, port: int,
                 batch_max: int, batch_timeout_ms: float,
                 replica: str = "", bucketing: bool = True,
                 follow: bool = False, follow_poll_s: float = 2.0,
                 max_seq_len: int = 256, max_new_tokens: int = 64,
                 max_slots: int = 8, continuous: bool = True,
                 device: str = "cuda"):
        self.model_name = model_name
        self.device = torch.device(device)
        self.ckpt_dir = ckpt_dir
        self.port = port
        self.replica = replica or "{}-{}".format(
            os.environ.get("TPUJOB_REPLICA_TYPE", "server"),
            os.environ.get("TPUJOB_REPLICA_INDEX", "0"))
        self.queue = BatchQueue(batch_max, batch_timeout_ms / 1000.0)
        self.slot = StagingSlot()
        self.batch_max = batch_max
        self.bucketing = bucketing
        self.generative = model_name in GENERATIVE_MODELS
        self.route, self.route_why = serve_route(self.device.type, self.generative)
        self.max_seq_len = max_seq_len
        self.max_new_tokens = max_new_tokens
        self.max_slots = max_slots
        # False = the run-to-completion baseline: an admitted batch must
        # fully retire before the next admission (continuous batching is
        # measured against it).
        self.continuous = continuous
        if self.generative:
            # Row buckets are capped by the KV slot count — a prefill
            # chunk can never exceed the free slots it lands in.
            row_max = min(batch_max, max_slots)
            self.buckets = (bucket_sizes(row_max) if bucketing
                            else (row_max,))
            self.seq_buckets = (seq_bucket_sizes(max_seq_len)
                                if bucketing else (max_seq_len,))
        else:
            self.buckets = (bucket_sizes(batch_max) if bucketing
                            else (batch_max,))
            self.seq_buckets = ()
        self.follow = follow
        self.follow_poll_s = follow_poll_s
        self.stop = threading.Event()
        self.ready = threading.Event()
        self._hb = HeartbeatWriter.from_env()
        self._stats_path = os.environ.get(ENV_STATS_FILE)
        # Chaos/bench knob (the JAX server's): sleep this long in the
        # request handler before queueing — a deterministically SLOW
        # replica for the router's hedging. 0 = off (production); never
        # set by the controller.
        self._inject_delay_ms = float(
            os.environ.get("TPUJOB_SERVE_INJECT_DELAY_MS", "0") or 0)
        self._stats_lock = threading.Lock()
        self._latencies_ms: list[float] = []  # bounded ring, see _note
        self._requests = 0
        self._served = 0
        self._batches = 0
        self._inflight = 0
        # Pad accounting (cumulative): useful rows vs padded-slot rows
        # actually dispatched. pad_efficiency = useful/padded is the
        # bucketing win signal (pad-to-max single-row = 1/batchMaxSize).
        # The token pair is the 2-D grid's second dimension: prompt
        # tokens vs padded prefill cells, plus active slots vs total
        # slots per decode tick.
        self._rows_useful = 0
        self._rows_padded = 0
        self._tokens_useful = 0
        self._tokens_padded = 0
        # Decode-loop counters (generative models only).
        self._tokens_total = 0
        self._decode_steps = 0
        self._reprefills = 0
        self._active_now = 0
        # Time-averaged inflight over the current stats window: an
        # instantaneous snapshot right after a batch drains reads ~0
        # under steady open-loop load (the queue empties every window),
        # so the autoscaler would never see the Little's-law load. The
        # integral of inflight*dt between stats writes is the honest
        # signal.
        self._infl_integral = 0.0
        self._infl_last_t = time.monotonic()
        self._infl_window_t0 = self._infl_last_t
        labels = {"replica": self.replica}
        self.m_requests = metrics_mod.serve_requests_total.labels(**labels)
        self.m_inflight = metrics_mod.serve_inflight.labels(**labels)
        self.m_batch = metrics_mod.serve_batch_size.labels(**labels)
        self.m_latency = metrics_mod.serve_latency_seconds.labels(**labels)
        self.m_pad_eff = metrics_mod.serve_pad_efficiency.labels(**labels)
        self.m_tokens = metrics_mod.serve_tokens_total.labels(**labels)
        self.m_decode_steps = metrics_mod.serve_decode_steps_total.labels(
            **labels)
        self.m_active = metrics_mod.serve_active_slots.labels(**labels)
        self.m_tok_pad = metrics_mod.serve_token_pad_efficiency.labels(
            **labels)
        from tf_operator_tpu_torch import chaos as chaos_lib

        self._chaos = chaos_lib.TrainerChaos.from_env()
        # The served model: an ATOMICALLY-swapped (params, step) pair —
        # the dispatch thread reads it ONCE per batch, the follower
        # replaces the whole tuple, so a mid-swap batch serves entirely
        # from the old params (never torn).
        self._live: tuple[object, int | None] = (None, None)
        # The follower's swap and the dispatch thread's hand-back of the
        # captured dict (_swap_in) write _live under this lock.
        self._live_lock = threading.Lock()
        self._apply = None
        self._input_shape: tuple[int, ...] = ()
        # (name, shape, dtype) of every leaf of the served checkpoint: the
        # follower rejects a newer step whose signature differs.
        self._signature: tuple | None = None
        # Decode-loop state (generative models; owned by the dispatch
        # thread after load()): prefill-into-slots and the decode step, the
        # KV cache pair, and per-slot feed position / last-token host arrays.
        self._decode_cfg = None
        self._graphs: GraphedDecode | GraphedForward | None = None  # the graph route's
        self._prefill_fn = None
        self._decode_fn = None
        self._kv = None
        self._positions = None
        self._last_tokens = None
        self._vocab: int | None = None

    @property
    def loaded_step(self) -> int | None:
        return self._live[1]

    # ------------------------------------------------------------- model

    def _restore_host(self, step: int):
        """Host-side restore of `step`, walking back to older VALIDATED
        steps when the restore itself raises (census-valid but
        unreadable), like the trainer does. Returns (params, step) or
        (None, None) when nothing restores."""
        from tf_operator_tpu_torch.models import checkpoint as ckpt

        while step is not None:
            try:
                return ckpt.restore(self.ckpt_dir, step), step
            except Exception as e:  # noqa: BLE001 — torn trees raise anything
                _emit({"event": "serve_fallback", "skipped_step": step,
                       "reason": f"restore_error: {type(e).__name__}: {e}"})
                older = [s for s in ckpt.list_steps(self.ckpt_dir)
                         if s < step]
                step = None
                for s in reversed(older):
                    if ckpt.validate_step(self.ckpt_dir, s):
                        step = s
                        break
        return None, None

    @staticmethod
    def _tree_signature(host) -> tuple:
        return tuple((k, tuple(v.shape), str(v.dtype)) for k, v in host.items())

    def _host_ready(self, host):
        """The host tree as the device will hold it: the LM's dense
        weights cast to the compute dtype once (decode.prepare_params)."""
        if self._decode_cfg is None:
            return host
        from tf_operator_tpu_torch.models import decode as decode_mod

        return decode_mod.prepare_params(host, self._decode_cfg)

    def _to_device(self, host: dict) -> dict:
        """Copy a host tree to the serving device. On CUDA the copies run
        from pinned memory on a stream of their own; the call returns
        after an event recorded behind them has completed, and every
        tensor is recorded on the default stream (the dispatch thread's),
        so the allocator never hands its memory to another allocation
        while a tick may still read it. Launches copies only."""
        if self.device.type != "cuda":
            return {k: v.to(self.device) for k, v in host.items()}
        stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(stream):
            out = {k: v.pin_memory().to(self.device, non_blocking=True)
                   for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(stream)
        done.synchronize()
        consumer = torch.cuda.default_stream(self.device)
        for t in out.values():
            t.record_stream(consumer)
        return out

    def load(self) -> None:
        """Resolve the newest VALIDATED checkpoint, restore it host-side,
        place it on the device, and warm the bucketed forwards."""
        from tf_operator_tpu_torch.models import checkpoint as ckpt

        step = ckpt.latest_valid_checkpoint(self.ckpt_dir)
        while step is None and self.follow and not self.stop.is_set():
            # Follow mode tracks a LIVE trainer: its first periodic save
            # may not exist yet. Wait for it, ticking liveness so the
            # serving watchdog knows we are alive, not wedged.
            self._hb.write(0, force=True)
            self.stop.wait(timeout=min(0.5, self.follow_poll_s))
            step = ckpt.latest_valid_checkpoint(self.ckpt_dir)
        if step is None and self.follow and self.stop.is_set():
            # Preempted while waiting for the trainer's first save: a
            # graceful eviction, not a failure — run() sees the stop
            # flag with no model loaded and drains to exit 0.
            return
        if step is None:
            raise FileNotFoundError(
                f"no valid checkpoint under {self.ckpt_dir} (torn/empty "
                f"dirs are skipped exactly as the trainer's resume walk "
                f"would)")
        if self.generative:
            return self._load_decode(step)
        if self.model_name in ("mnist-mlp", "mnist-conv"):
            from tf_operator_tpu_torch.models import mnist as M

            model = (M.MLP if self.model_name == "mnist-mlp" else M.ConvNet)(device="meta")
            self._input_shape = (28, 28)
        else:
            raise ValueError(
                f"serving model {self.model_name!r} not supported (mnist-"
                f"mlp / mnist-conv / {' / '.join(GENERATIVE_MODELS)} "
                f"today; the contract is the trainer's --model "
                f"vocabulary)")
        host, step = self._restore_host(step)
        if host is None:
            raise FileNotFoundError(
                f"every checkpoint under {self.ckpt_dir} failed to restore")
        self._signature = self._tree_signature(host)
        params = self._to_device(host)
        if self.route == "graph":
            self._graphs = GraphedForward(model, params, self._input_shape, self.device)
            apply = self._graphs
        else:
            def apply(p, x_np):
                x = torch.from_numpy(x_np).to(self.device)
                logits = torch.func.functional_call(model, p, (x,))
                return logits.argmax(-1).cpu().numpy()

        # Warm EVERY bucket shape (a small, fixed set: log2(batchMaxSize)+1
        # shapes) so no real request pays a first call's setup; on the graph
        # route each first call also captures its bucket's graph, and the
        # buckets are then sealed.
        with torch.inference_mode():
            for b in self.buckets:
                apply(params, np.zeros((b, *self._input_shape), np.float32))
                # Per-bucket liveness: a silent warmup can trip the serving
                # watchdog (which measures from pod start).
                self._hb.write(0, force=True)
        if self._graphs is not None:
            self._graphs.seal()
        self._apply = apply
        self._live = (params, step)

    def _load_decode(self, step: int) -> None:
        """Generative-model load: restore, derive the decode config from
        the state dict, allocate the slot-addressed KV cache, and warm
        prefill over the whole (rows x seq-len) bucket grid plus the one
        decode-tick shape; on the graph route each of those first calls
        also captures its graph, and the grid is then sealed."""
        import functools

        from tf_operator_tpu_torch.models import decode as decode_mod

        host, step = self._restore_host(step)
        if host is None:
            raise FileNotFoundError(
                f"every checkpoint under {self.ckpt_dir} failed to restore")
        cfg = decode_mod.config_from_params(host)
        self._decode_cfg = cfg
        self._vocab = cfg.vocab_size
        # The context window can never outrun the trained position table.
        if cfg.max_len < self.max_seq_len:
            self.max_seq_len = cfg.max_len
            self.seq_buckets = (seq_bucket_sizes(cfg.max_len)
                                if self.bucketing else (cfg.max_len,))
        self.max_new_tokens = min(self.max_new_tokens,
                                  self.max_seq_len - 1)
        self._signature = self._tree_signature(host)
        params = self._to_device(self._host_ready(host))
        # Slot max_slots is SCRATCH: admission chunks pad their slot-id
        # vector with it so every row bucket writes one fixed shape;
        # nothing is ever scheduled there.
        self._kv = decode_mod.init_kv_cache(cfg, self.max_slots + 1,
                                            self.max_seq_len, self.device)
        if self.route == "graph":
            self._graphs = GraphedDecode(params, self._kv, cfg)
            self._prefill_fn = self._graphs.prefill
            self._decode_fn = self._graphs.decode
        else:
            self._prefill_fn = functools.partial(
                decode_mod.prefill_into_slots, cfg=cfg)
            self._decode_fn = functools.partial(decode_mod.decode_step,
                                                cfg=cfg)
        s_total = self.max_slots + 1
        with torch.inference_mode():
            for rb in self.buckets:
                for tb in self.seq_buckets:
                    tok = np.zeros((rb, tb), np.int32)
                    lens = np.ones((rb,), np.int32)
                    ids = np.full((rb,), self.max_slots, np.int32)
                    k, v, first, _ = self._prefill_fn(
                        params, self._kv[0], self._kv[1], tok, lens, ids)
                    _host(first)
                    self._kv = (k, v)
                    # Per-grid-point liveness: rows x seq-len first calls
                    # (warm-up and capture) can take long enough to trip
                    # the serving watchdog.
                    self._hb.write(0, force=True)
            k, v, nxt, _ = self._decode_fn(
                params, self._kv[0], self._kv[1],
                np.zeros((s_total,), np.int32), np.zeros((s_total,), np.int32))
            _host(nxt)
        if self._graphs is not None:
            self._graphs.seal()
        self._kv = (k, v)
        self._hb.write(0, force=True)
        self._positions = np.zeros((s_total,), np.int32)
        self._last_tokens = np.zeros((s_total,), np.int32)
        # run()'s preempt-before-first-load check keys on _apply: mark
        # the decode path loaded (never called — dispatch goes through
        # _prefill_fn/_decode_fn).
        self._apply = self._decode_fn
        self._live = (params, step)

    def _swap_in(self, fresh: dict, step: int | None) -> dict:
        """On the graph route, a swapped-in parameter dict is copied into
        the captured tensors (decode_graphs.adopt: in place, on the
        dispatch thread's stream, so no replay reads the old weights after
        it or a half-copied set), and _live is handed the captured dict
        back unless the follower swapped again meanwhile. Returns the dict
        to serve from."""
        if self._graphs is None:
            return fresh
        captured = self._graphs.adopt(fresh)
        with self._live_lock:
            if self._live[0] is fresh:
                self._live = (captured, step)
        return captured

    # ----------------------------------------------------------- follower

    def _follow_loop(self) -> None:
        """Checkpoint following: poll for a strictly newer VALIDATED
        step; restore it on the host and copy it to the device OFF the
        dispatch thread (copies only, never compute: `_to_device`), then
        swap the (params, step) pair atomically. The dispatch thread picks
        the new pair up at its next batch; the step served monotonically
        advances and old params are never torn mid-batch."""
        from tf_operator_tpu_torch.models import checkpoint as ckpt

        # Last step rejected for param-signature drift: a drifted
        # checkpoint is PERMANENTLY incompatible (the mismatch is
        # deterministic), so re-restoring it every poll would re-read
        # the whole tree from disk ~every follow_poll_s forever. Each
        # drifted step costs exactly one host restore; a NEWER step is
        # still attempted (the trainer may have reverted its config).
        # Transient failures (torn save, GC race) deliberately do NOT
        # land here — those may heal and should retry.
        drift_rejected: int | None = None
        while not self.stop.is_set():
            self.stop.wait(timeout=self.follow_poll_s)
            if self.stop.is_set():
                return
            cur = self.loaded_step
            try:
                step = ckpt.latest_valid_checkpoint(self.ckpt_dir)
            except OSError:  # checkpoint GC racing the walk: retry
                continue
            if (step is None or (cur is not None and step <= cur)
                    or (drift_rejected is not None
                        and step <= drift_rejected)):
                continue
            try:
                host = ckpt.restore(self.ckpt_dir, step)
                sig = self._tree_signature(host)
                if self._signature is not None and sig != self._signature:
                    # Reject model-config drift BEFORE paying the
                    # host->device copy: same names, same per-leaf shape
                    # AND dtype (a renamed layer, a changed width or a
                    # dtype flip would otherwise go live and break every
                    # subsequent batch).
                    drift_rejected = step
                    raise ValueError(
                        f"checkpoint step {step} has a different "
                        f"param signature: model config drift — "
                        f"keeping step {cur}")
                new_params = self._to_device(self._host_ready(host))
            except Exception as e:  # noqa: BLE001 — keep serving old params
                metrics_mod.serve_ckpt_follow_total.labels(
                    result="error").inc()
                _emit({"event": "ckpt_follow", "result": "error",
                       "step": step,
                       "reason": f"{type(e).__name__}: {e}"})
                continue
            with self._live_lock:
                self._live = (new_params, step)
            metrics_mod.serve_ckpt_follow_total.labels(
                result="swapped").inc()
            _emit({"event": "ckpt_follow", "result": "swapped",
                   "t": time.time(), "from_step": cur, "step": step})

    # ------------------------------------------------------------ batcher

    def _note_latency(self, ms: float) -> None:
        with self._stats_lock:
            self._latencies_ms.append(ms)
            if len(self._latencies_ms) > 2048:
                del self._latencies_ms[:1024]

    def _shift_inflight(self, delta: int) -> int:
        """Adjust the inflight count, accumulating the time integral
        (caller does NOT hold the stats lock). Returns the new count."""
        with self._stats_lock:
            now = time.monotonic()
            self._infl_integral += self._inflight * (now - self._infl_last_t)
            self._infl_last_t = now
            self._inflight += delta
            return self._inflight

    def pad_efficiency(self) -> float | None:
        """Combined useful/dispatched cells over BOTH grid dimensions:
        rows for classifiers (token counters stay zero, so this is the
        row ratio), rows + tokens for the decode
        path (prefill cells and decode-tick slot occupancy)."""
        with self._stats_lock:
            denom = self._rows_padded + self._tokens_padded
            if not denom:
                return None
            return (self._rows_useful + self._tokens_useful) / denom

    def _pad_split(self) -> tuple[float | None, float | None]:
        """(row-padding efficiency, token-padding efficiency) — the 2-D
        ladder's two wins, separately visible."""
        with self._stats_lock:
            rows = (self._rows_useful / self._rows_padded
                    if self._rows_padded else None)
            toks = (self._tokens_useful / self._tokens_padded
                    if self._tokens_padded else None)
            return rows, toks

    def _write_stats(self) -> None:
        if not self._stats_path:
            return
        with self._stats_lock:
            now = time.monotonic()
            self._infl_integral += self._inflight * (now - self._infl_last_t)
            self._infl_last_t = now
            window = now - self._infl_window_t0
            # `inflight` is the TIME-AVERAGED count over the window since
            # the last write (the autoscaler's signal); `inflight_now` is
            # the instantaneous queue depth (debugging).
            avg = (self._infl_integral / window if window > 1e-6
                   else float(self._inflight))
            self._infl_integral = 0.0
            self._infl_window_t0 = now
            lat = sorted(self._latencies_ms[-512:])
            snap = {
                "t": time.time(),
                "inflight": round(avg, 3),
                "inflight_now": self._inflight,
                "requests_total": self._requests,
                "served_total": self._served,
                "batches_total": self._batches,
                "rows_useful": self._rows_useful,
                "rows_padded": self._rows_padded,
                "tokens_useful": self._tokens_useful,
                "tokens_padded": self._tokens_padded,
                "pad_efficiency": (
                    round((self._rows_useful + self._tokens_useful)
                          / (self._rows_padded + self._tokens_padded), 4)
                    if self._rows_padded + self._tokens_padded else None),
                "pad_efficiency_rows": (
                    round(self._rows_useful / self._rows_padded, 4)
                    if self._rows_padded else None),
                "pad_efficiency_tokens": (
                    round(self._tokens_useful / self._tokens_padded, 4)
                    if self._tokens_padded else None),
                "tokens_total": self._tokens_total,
                "decode_steps": self._decode_steps,
                "reprefills": self._reprefills,
                "active_slots": self._active_now,
                "max_slots": (self.max_slots if self.generative else 0),
                "loaded_step": self.loaded_step,
                "latency_p50_ms": lat[len(lat) // 2] if lat else None,
                "latency_p99_ms": lat[int(len(lat) * 0.99)] if lat else None,
            }
        tmp = f"{self._stats_path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(snap, f)
            os.replace(tmp, self._stats_path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _assemble_loop(self) -> None:
        """Stage 1 (host-only, never the device): dequeue + validate + pad into
        the bucket shape, then park in the depth-1 slot. Runs CONCURRENT
        with stage 2's device time — double-buffering."""
        while True:
            batch = self.queue.take_batch()
            if batch is None:
                # Closed and drained: stage 2 drains the slot then exits.
                self.slot.close()
                return
            if not batch:
                if self.stop.is_set():
                    self.queue.close()
                continue
            try:
                # Assembly INSIDE the per-batch guard: a ragged or
                # wrong-shaped row raises in concatenate/reshape, and a
                # single malformed request must 500 its own batch, never
                # take the pipeline down.
                rows = np.concatenate(
                    [np.asarray(i.rows, np.float32) for i in batch])
                n = rows.shape[0]
                bucket = select_bucket(n, self.buckets)
                padded = np.zeros((bucket, *self._input_shape), np.float32)
                padded[:n] = rows.reshape((n, *self._input_shape))
            except Exception as e:  # noqa: BLE001 — reported per request
                for item in batch:
                    item.error = f"{type(e).__name__}: {e}"
                    item.event.set()
                # Errored requests leave the inflight count (they are
                # answered) but never count as served.
                self._shift_inflight(-len(batch))
                continue
            self.slot.put(_Staged(batch, padded, n, bucket))

    # -------------------------------------------------------- decode loop

    def _assemble_decode_loop(self) -> None:
        """Stage 1 for generative models (host-only): validate prompt
        rows, SORT them ascending by length (admission chunks re-tighten
        their token bucket, so short prompts never pay a long peer's
        padding), and pack the token dimension to the smallest seq
        bucket. The depth-1 slot discipline is unchanged."""
        while True:
            batch = self.queue.take_batch()
            if batch is None:
                self.slot.close()
                return
            if not batch:
                if self.stop.is_set():
                    self.queue.close()
                continue
            try:
                refs = []
                for item in batch:
                    item.result = [None] * len(item.rows)
                    item.unfinished = len(item.rows)
                    for r, row in enumerate(item.rows):
                        refs.append((item, r, row))
                refs.sort(key=lambda x: len(x[2]))
                longest = max(len(row) for _, _, row in refs)
                tb = select_bucket(longest, self.seq_buckets)
                n = len(refs)
                tokens = np.zeros((n, tb), np.int32)
                lengths = np.zeros((n,), np.int32)
                max_new = np.zeros((n,), np.int32)
                for j, (item, _r, row) in enumerate(refs):
                    arr = np.asarray(row, np.int32)
                    if arr.ndim != 1 or arr.size == 0:
                        raise ValueError(
                            "each instance must be a non-empty token list")
                    tokens[j, :arr.size] = arr
                    lengths[j] = arr.size
                    max_new[j] = item.max_new
            except Exception as e:  # noqa: BLE001 — reported per request
                for item in batch:
                    item.error = f"{type(e).__name__}: {e}"
                    item.event.set()
                self._shift_inflight(-len(batch))
                continue
            self.slot.put(_StagedDecode(
                tokens, lengths, max_new,
                [(item, r) for item, r, _row in refs], tb))

    def _retire_seq(self, slot_id: int, seq: _Seq, active: dict,
                    free: list[int], step: int | None) -> None:
        """Free the slot and fold the finished row into its request;
        the LAST row of a request answers it (latency, inflight,
        served)."""
        item = seq.item
        item.result[seq.row] = list(seq.generated)
        item.unfinished -= 1
        del active[slot_id]
        free.append(slot_id)
        # Park the slot: its tick outputs are thrown away until a reuse
        # re-prefills it from 0, and a parked position never runs past
        # the cache.
        self._positions[slot_id] = 0
        self._last_tokens[slot_id] = 0
        if item.unfinished <= 0:
            item.step = step
            ms = (time.monotonic() - item.t_in) * 1000.0
            self.m_latency.observe(ms / 1000.0)
            self._note_latency(ms)
            with self._stats_lock:
                self._served += 1
            inflight = self._shift_inflight(-1)
            self.m_inflight.set(float(max(0, inflight)))
            item.event.set()

    def _admit(self, staged: _StagedDecode, cursor: int, free: list[int],
               active: dict, params, step: int | None) -> int:
        """Prefill staged rows into free KV slots, chunked at row-bucket
        granularity (each chunk re-selects its token bucket — the
        assembler sorted rows by length). Returns the new row cursor.
        Single-token requests retire at prefill."""
        while cursor < staged.n and free:
            chunk = min(len(free), staged.n - cursor, self.buckets[-1])
            rb = select_bucket(chunk, self.buckets)
            lens_chunk = staged.lengths[cursor:cursor + chunk]
            tb = select_bucket(int(lens_chunk.max()), self.seq_buckets)
            tok = np.zeros((rb, tb), np.int32)
            tok[:chunk] = staged.tokens[cursor:cursor + chunk, :tb]
            lens = np.ones((rb,), np.int32)
            lens[:chunk] = lens_chunk
            # Pad the slot-id vector with the scratch slot: one write
            # shape per row bucket, and repeated scratch writes are
            # harmless (nothing is ever scheduled there; write_slots lets
            # only that slot repeat).
            ids = np.full((rb,), self.max_slots, np.int32)
            taken = free[:chunk]
            ids[:chunk] = taken
            k, v, first, _ = self._prefill_fn(params, self._kv[0],
                                              self._kv[1], tok, lens, ids)
            self._kv = (k, v)
            first = _host(first)
            del free[:chunk]
            self._batches += 1
            self.m_batch.observe(float(chunk))
            with self._stats_lock:
                self._rows_useful += chunk
                self._rows_padded += rb
                self._tokens_useful += int(lens_chunk.sum())
                self._tokens_padded += rb * tb
                self._tokens_total += chunk
            self.m_tokens.inc(float(chunk))
            for j, s in enumerate(taken):
                item, row = staged.row_refs[cursor + j]
                prompt_len = int(lens_chunk[j])
                prompt = staged.tokens[cursor + j, :prompt_len].tolist()
                seq = _Seq(item, row, prompt, int(first[j]),
                           int(staged.max_new[cursor + j]))
                self._positions[s] = prompt_len
                self._last_tokens[s] = int(first[j])
                active[s] = seq
                if seq.remaining <= 0:
                    self._retire_seq(s, seq, active, free, step)
            cursor += chunk
            if not self.continuous:
                break  # run-to-completion: one admission per drain
        return cursor

    def _reprefill_active(self, params, active: dict) -> None:
        """Rebuild every in-flight sequence's KV state under freshly
        swapped params: prefill (prompt + generated so far, minus the
        still-unfed last token) back into the SAME slots. Committed
        tokens stand; the attention state restarts cleanly — a sequence
        never decodes over KV another params version wrote."""
        slots = sorted(active)
        i = 0
        while i < len(slots):
            group = slots[i:i + self.buckets[-1]]
            rb = select_bucket(len(group), self.buckets)
            ctx_lens = [len(active[s].prompt) + len(active[s].generated) - 1
                        for s in group]
            tb = select_bucket(max(ctx_lens), self.seq_buckets)
            tok = np.zeros((rb, tb), np.int32)
            lens = np.ones((rb,), np.int32)
            ids = np.full((rb,), self.max_slots, np.int32)
            for j, s in enumerate(group):
                seq = active[s]
                ctx = seq.prompt + seq.generated[:-1]
                tok[j, :len(ctx)] = ctx
                lens[j] = len(ctx)
                ids[j] = s
            k, v, _first, _ = self._prefill_fn(params, self._kv[0],
                                               self._kv[1], tok, lens, ids)
            self._kv = (k, v)
            self._batches += 1
            with self._stats_lock:
                self._tokens_useful += sum(ctx_lens)
                self._tokens_padded += rb * tb
            i += len(group)
        with self._stats_lock:
            self._reprefills += 1

    def _decode_tick(self, params, step: int | None, active: dict,
                     free: list[int]) -> None:
        """One decode step over all slots: feed each slot's last token at
        its position, append the greedy next token to every ACTIVE
        sequence, retire the ones that hit their cap."""
        k, v, nxt, _ = self._decode_fn(params, self._kv[0], self._kv[1],
                                       self._last_tokens, self._positions)
        self._kv = (k, v)
        # The host read of nxt waits for the tick; only then does the loop
        # below rewrite _positions and _last_tokens. The tick has taken its
        # own copy of them (on the graph route into its pinned staging
        # buffer, whose copy to the device has run by now).
        nxt = _host(nxt)
        self._batches += 1
        n_active = len(active)
        with self._stats_lock:
            self._decode_steps += 1
            self._tokens_total += n_active
            self._tokens_useful += n_active
            self._tokens_padded += self.max_slots + 1
        self.m_decode_steps.inc()
        self.m_tokens.inc(float(n_active))
        for s in sorted(active):
            seq = active[s]
            tok = int(nxt[s])
            seq.generated.append(tok)
            seq.remaining -= 1
            self._positions[s] += 1
            self._last_tokens[s] = tok
            if seq.remaining <= 0:
                self._retire_seq(s, seq, active, free, step)

    def _fail_rows(self, rows: list[tuple], e: Exception) -> None:
        """Report a scheduler error to every (item, ...) row ref exactly
        once, answering each request when its last row fails."""
        msg = f"{type(e).__name__}: {e}"
        done = []
        for ref in rows:
            item = ref[0]
            if item.error is None:
                item.error = msg
            item.unfinished -= 1
            if item.unfinished <= 0 and not item.event.is_set():
                done.append(item)
        for item in done:
            self._shift_inflight(-1)
            item.event.set()

    # Grad mode is thread-local: the dispatch thread enters inference mode
    # itself (the decorator runs in the thread that calls the loop).
    @torch.inference_mode()
    def _dispatch_decode_loop(self) -> None:
        """Stage 2 for generative models — the persistent decode
        scheduler on the ONE device-dispatching thread. Per iteration:
        pick up staged work, land a pending params swap (re-prefilling
        in-flight state first), admit rows into free slots, then one
        decode tick over all active slots. Continuous batching is
        exactly this loop shape: admission happens BETWEEN ticks, so a
        retiring short request's slot is refilled while long peers keep
        decoding. The (params, step) pair is read once per iteration —
        a follower swap can never tear a tick."""
        last_stats = 0.0
        staged: _StagedDecode | None = None
        cursor = 0
        active: dict[int, _Seq] = {}
        free = list(range(self.max_slots))
        params, step = self._live
        while True:
            if staged is None:
                got = self.slot.take(timeout_s=0.0 if active else 0.05)
                if got is not None:
                    staged, cursor = got, 0
                elif self.slot.is_closed() and not active:
                    break
            new_params, new_step = self._live
            if new_params is not params:
                try:
                    new_params = self._swap_in(new_params, new_step)
                    if active:
                        self._reprefill_active(new_params, active)
                except Exception as e:  # noqa: BLE001 — per-request report
                    self._fail_rows([(seq.item,) for seq in
                                     active.values()], e)
                    for s in list(active):
                        del active[s]
                        free.append(s)
                params, step = new_params, new_step
            if (staged is not None and free
                    and (self.continuous or not active)):
                try:
                    cursor = self._admit(staged, cursor, free, active,
                                         params, step)
                except Exception as e:  # noqa: BLE001 — per-request report
                    self._fail_rows(staged.row_refs[cursor:], e)
                    staged = None
                else:
                    if cursor >= staged.n:
                        staged = None
            if active:
                try:
                    self._decode_tick(params, step, active, free)
                except Exception as e:  # noqa: BLE001 — per-request report
                    self._fail_rows([(seq.item,) for seq in
                                     active.values()], e)
                    for s in list(active):
                        del active[s]
                        free.append(s)
                if self._chaos is not None:
                    self._chaos.maybe_kill(self._batches, 0)
            with self._stats_lock:
                self._active_now = len(active)
            self.m_active.set(float(len(active)))
            pad_eff = self.pad_efficiency()
            if pad_eff is not None:
                self.m_pad_eff.set(round(pad_eff, 4))
            _rows_eff, tok_eff = self._pad_split()
            if tok_eff is not None:
                self.m_tok_pad.set(round(tok_eff, 4))
            self._hb.write(self._batches)
            now = time.monotonic()
            if now - last_stats > 0.25:
                self._write_stats()
                last_stats = now

    @torch.inference_mode()
    def _dispatch_loop(self) -> None:
        """Stage 2 — the ONE device-dispatching thread: the forward at
        the staged bucket shape, demux, liveness. The (params, step)
        pair is read once per batch, so a follower swap lands cleanly
        between batches."""
        last_stats = 0.0
        while True:
            staged = self.slot.take()
            if staged is None:
                if self.slot.is_closed():
                    break  # assembler closed after draining the queue
                # Idle: tick liveness so the watchdog sees us.
                self._hb.write(self._batches)
                now = time.monotonic()
                if now - last_stats > 0.25:
                    self._write_stats()
                    last_stats = now
                continue
            batch, n = staged.items, staged.n
            params, step = self._live
            try:
                if self._graphs is not None and params is not self._graphs.params:
                    params = self._swap_in(params, step)
                preds = self._apply(params, staged.padded)[:n]
            except Exception as e:  # noqa: BLE001 — reported per request
                for item in batch:
                    item.error = f"{type(e).__name__}: {e}"
                    item.event.set()
                self._shift_inflight(-len(batch))
                continue
            self._batches += 1
            self.m_batch.observe(float(n))
            with self._stats_lock:
                self._rows_useful += n
                self._rows_padded += staged.bucket
                pad_eff = self._rows_useful / self._rows_padded
            self.m_pad_eff.set(round(pad_eff, 4))
            off = 0
            now = time.monotonic()
            for item in batch:
                k = len(item.rows)
                item.result = [int(v) for v in preds[off:off + k]]
                item.step = step
                off += k
                ms = (now - item.t_in) * 1000.0
                self.m_latency.observe(ms / 1000.0)
                self._note_latency(ms)
            with self._stats_lock:
                self._served += len(batch)
            inflight = self._shift_inflight(-len(batch))
            self.m_inflight.set(float(max(0, inflight)))
            for item in batch:
                item.event.set()
            if self._chaos is not None:
                # `kill:step=N[,replica=server]`: deterministic
                # serve-replica faults, N = dispatched batches.
                self._chaos.maybe_kill(self._batches, 0)
            self._hb.write(self._batches)
            now = time.monotonic()
            if now - last_stats > 0.25:
                self._write_stats()
                last_stats = now

    # --------------------------------------------------------------- http

    def _make_handler(server):  # noqa: N805 — closure over the server
        from http.server import BaseHTTPRequestHandler

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: N802
                pass

            def _send(self, payload: dict, code: int = 200,
                      raw: str | None = None) -> None:
                body = (raw if raw is not None
                        else json.dumps(payload)).encode()
                self.send_response(code)
                ctype = ("text/plain; version=0.0.4" if raw is not None
                         else "application/json")
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                if self.path == "/healthz":
                    rows_eff, tok_eff = server._pad_split()
                    self._send({
                        "ok": server.ready.is_set(),
                        "model": server.model_name,
                        "checkpoint_step": server.loaded_step,
                        "inflight": server._inflight,
                        "follow": server.follow,
                        "buckets": list(server.buckets),
                        "rows_useful": server._rows_useful,
                        "rows_padded": server._rows_padded,
                        "pad_efficiency": server.pad_efficiency(),
                        "pad_efficiency_rows": rows_eff,
                        "pad_efficiency_tokens": tok_eff,
                        "generative": server.generative,
                        "seq_buckets": list(server.seq_buckets),
                        "active_slots": server._active_now,
                        "max_slots": (server.max_slots
                                      if server.generative else 0),
                        "tokens_total": server._tokens_total,
                        "decode_steps": server._decode_steps,
                    }, 200 if server.ready.is_set() else 503)
                elif self.path == "/metrics":
                    self._send({}, raw=metrics_mod.DEFAULT.expose())
                else:
                    self._send({"error": "not found"}, 404)

            def do_POST(self):  # noqa: N802
                if self.path != "/predict":
                    return self._send({"error": "not found"}, 404)
                if not server.ready.is_set() or server.stop.is_set():
                    return self._send({"error": "not serving"}, 503)
                if server._inject_delay_ms > 0:
                    time.sleep(server._inject_delay_ms / 1000.0)
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n))
                    rows = req["instances"]
                    assert isinstance(rows, list) and rows
                except Exception:
                    return self._send(
                        {"error": "body must be "
                                  '{"instances": [[...], ...]}'}, 400)
                if server.generative:
                    raw_new = req.get("maxNewTokens")
                    try:
                        max_new = (server.max_new_tokens if raw_new is None
                                   else max(1, min(int(raw_new),
                                                   server.max_new_tokens)))
                    except (TypeError, ValueError):
                        return self._send(
                            {"error": "maxNewTokens must be an integer"},
                            400)
                    vocab = server._vocab or 1
                    for row in rows:
                        if (not isinstance(row, list) or not row
                                or not all(isinstance(t, int)
                                           and 0 <= t < vocab
                                           for t in row)):
                            return self._send(
                                {"error": "each instance must be a "
                                          "non-empty list of token ids in "
                                          f"[0, {vocab})"}, 400)
                        if len(row) + max_new > server.max_seq_len:
                            return self._send(
                                {"error": f"prompt of {len(row)} tokens + "
                                          f"maxNewTokens {max_new} exceeds "
                                          "maxSequenceLength "
                                          f"{server.max_seq_len}"}, 400)
                    item = _Pending(rows, max_new=max_new)
                else:
                    item = _Pending(rows)
                with server._stats_lock:
                    server._requests += 1
                inflight = server._shift_inflight(+1)
                server.m_requests.inc()
                server.m_inflight.set(float(inflight))
                if not server.queue.submit(item):
                    server._shift_inflight(-1)
                    return self._send(
                        {"error": f"batch of {len(rows)} rows exceeds "
                                  f"batchMaxSize {server.batch_max} (or "
                                  f"the server is draining)"}, 413)
                if not item.event.wait(timeout=30.0):
                    return self._send({"error": "timed out"}, 504)
                if item.error is not None:
                    return self._send({"error": item.error}, 500)
                self._send({"predictions": item.result,
                            "model": server.model_name,
                            "checkpoint_step": item.step})

        return Handler

    # ---------------------------------------------------------------- run

    def start_pipeline(self) -> list[threading.Thread]:
        """Start the two pipeline stages (and the follower, in follow
        mode). Split out of run() so tests can drive the real pipeline
        with a stubbed _apply."""
        threads = [
            threading.Thread(target=(self._assemble_decode_loop
                                     if self.generative
                                     else self._assemble_loop),
                             name="serve-assembler", daemon=True),
            threading.Thread(target=(self._dispatch_decode_loop
                                     if self.generative
                                     else self._dispatch_loop),
                             name="serve-dispatch", daemon=True),
        ]
        if self.follow:
            threads.append(
                threading.Thread(target=self._follow_loop,
                                 name="serve-follower", daemon=True))
        for t in threads:
            t.start()
        return threads

    def run(self) -> int:
        _emit({"event": "start", "t": time.time(), "role": "serve",
               "model": self.model_name})
        self._hb.write(0, force=True)

        def _sigterm(*_a):
            self.stop.set()
            self.queue.close()

        # Installed BEFORE load(): follow mode can wait in load() for the
        # trainer's first checkpoint, and a preemption during that wait
        # must still drain cleanly.
        signal.signal(signal.SIGTERM, _sigterm)
        signal.signal(signal.SIGINT, _sigterm)
        self.load()
        if self._apply is None and self.stop.is_set():
            # Preempted during the follow-mode wait for the trainer's
            # first checkpoint: nothing was served, nothing is queued —
            # graceful exit, not a Failed pod.
            self._write_stats()
            _emit({"event": "done", "t": time.time(), "served": 0,
                   "batches": 0, "reason": "stopped_before_first_load"})
            return 0
        threads = self.start_pipeline()

        # The runtime allocates this replica's localhost listen port from
        # its DNS identity (TPUJOB_SERVE_ENDPOINT); standalone runs bind
        # the declared port directly.
        port = int(os.environ.get("TPUJOB_SERVE_LISTEN_PORT", self.port))
        httpd = _HTTPServer(("127.0.0.1", port), self._make_handler())
        httpd.daemon_threads = True
        threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="serve-http").start()
        self.ready.set()
        self._hb.write(0, force=True)
        self._write_stats()
        _emit({"event": "serve_ready", "t": time.time(),
               "checkpoint_step": self.loaded_step, "port": port,
               "buckets": list(self.buckets),
               "seq_buckets": list(self.seq_buckets),
               "max_slots": self.max_slots if self.generative else 0,
               "continuous": self.continuous if self.generative else None,
               "follow": self.follow, "route": self.route,
               "route_why": self.route_why})
        decode_note = (f", seq_buckets={list(self.seq_buckets)}, "
                       f"slots={self.max_slots}, "
                       f"continuous={int(self.continuous)}"
                       if self.generative else "")
        print(f"serving {self.model_name} step {self.loaded_step} on "
              f"127.0.0.1:{port} (buckets={list(self.buckets)}"
              f"{decode_note}"
              f"{', following' if self.follow else ''})", flush=True)
        while not self.stop.is_set():
            self.stop.wait(timeout=0.5)
        # Drain: the assembler flushes the queue into the slot, the
        # dispatcher answers everything, then both exit.
        self.queue.close()
        for t in threads:
            t.join(timeout=10.0)
        httpd.shutdown()
        self._write_stats()
        _emit({"event": "done", "t": time.time(),
               "served": self._served, "batches": self._batches,
               "pad_efficiency": self.pad_efficiency()})
        return 0


def main(argv: list[str] | None = None) -> int:
    env = os.environ
    ap = argparse.ArgumentParser(prog="tf_operator_tpu_torch.serve.server",
                                 description=__doc__)
    ap.add_argument("--model",
                    default=env.get("TPUJOB_SERVE_MODEL", "mnist-mlp"))
    ap.add_argument("--checkpoint-dir",
                    default=env.get("TPUJOB_SERVE_CHECKPOINT_DIR", ""))
    ap.add_argument("--port", type=int,
                    default=int(env.get("TPUJOB_SERVE_PORT", "8500")))
    ap.add_argument("--batch-max-size", type=int,
                    default=int(env.get("TPUJOB_SERVE_BATCH_MAX", "8")))
    ap.add_argument("--batch-timeout-ms", type=float,
                    default=float(env.get("TPUJOB_SERVE_BATCH_TIMEOUT_MS",
                                          "5.0")))
    ap.add_argument("--bucketing", type=int, choices=(0, 1),
                    default=int(env.get("TPUJOB_SERVE_BUCKETING", "1")),
                    help="1 = shape-bucketed padding (default), 0 = the "
                         "pad-to-max baseline")
    ap.add_argument("--follow", type=int, choices=(0, 1),
                    default=int(env.get("TPUJOB_SERVE_FOLLOW", "0")),
                    help="1 = poll the checkpoint dir and hot-swap "
                         "params as newer valid steps appear")
    ap.add_argument("--follow-poll-s", type=float,
                    default=float(env.get("TPUJOB_SERVE_FOLLOW_POLL_S",
                                          "2.0")))
    ap.add_argument("--max-seq-len", type=int,
                    default=int(env.get("TPUJOB_SERVE_MAX_SEQ_LEN", "256")),
                    help="context window (prompt + generated) for "
                         "generative models; clamped to the checkpoint's "
                         "position table")
    ap.add_argument("--max-new-tokens", type=int,
                    default=int(env.get("TPUJOB_SERVE_MAX_NEW_TOKENS",
                                        "64")),
                    help="per-request generation ceiling (generative "
                         "models)")
    ap.add_argument("--max-concurrent-seqs", type=int,
                    default=int(env.get("TPUJOB_SERVE_MAX_CONCURRENT_SEQS",
                                        "8")),
                    help="KV-cache slots per replica — the decode "
                         "scheduler's admission capacity")
    ap.add_argument("--continuous", type=int, choices=(0, 1),
                    default=int(env.get("TPUJOB_SERVE_CONTINUOUS", "1")),
                    help="1 = continuous batching (admit between decode "
                         "ticks, default), 0 = the run-to-completion "
                         "baseline")
    ap.add_argument("--device", choices=("cuda", "cpu"),
                    default=env.get("TPUJOB_SERVE_DEVICE", "cuda"),
                    help="cuda (default) or cpu; no fallback between them")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda was asked for but no CUDA device is "
              "available; pass --device cpu to serve on the CPU",
              file=sys.stderr)
        return 1
    if not args.checkpoint_dir:
        print("error: --checkpoint-dir (or TPUJOB_SERVE_CHECKPOINT_DIR) "
              "is required", file=sys.stderr)
        return 2
    server = InferenceServer(
        args.model, args.checkpoint_dir, args.port,
        args.batch_max_size, args.batch_timeout_ms,
        replica=env.get("TPUJOB_POD_NAME", ""),
        bucketing=bool(args.bucketing), follow=bool(args.follow),
        follow_poll_s=args.follow_poll_s,
        max_seq_len=args.max_seq_len,
        max_new_tokens=args.max_new_tokens,
        max_slots=args.max_concurrent_seqs,
        continuous=bool(args.continuous), device=args.device)
    try:
        return server.run()
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
