"""Host->device input staging: counterpart of tf_operator_tpu/data/staging.py.

Three layers, as in the JAX module, in torch terms:

  1. **Wire format** (`to_wire`, `make_preprocess_fn`): images cross to the
     device as uint8 and are normalised there, on the consumer thread, by
     the trainer's preprocess step: 4x fewer bytes than f32. `--wire-dtype
     f32` normalises on the host instead, with the same f32-rounded
     reciprocal and the same op order (`normalize_uint8` is one function for
     numpy arrays and tensors).

  2. **Staging ring** (`stage_to_device`): `depth` batch slots fed by
     `lanes` transfer threads. A lane takes the next host batch from one
     ordered reader (each take tagged with a sequence number), copies it
     into a host slot of a pool made once (depth + lanes slots, pinned on a
     CUDA device, reused while a key's shape and dtype hold), then makes
     `.to(device, non_blocking=True)` copies on its own `torch.cuda.Stream`
     (C chunk copies per array with `chunks`), records a `torch.cuda.Event`
     and waits for it, so its timer measures the wire. That is all a lane
     does. The consumer takes slots in sequence order whatever order the
     lanes finish in; its current stream waits on the slot's event, every
     tensor is `record_stream`ed there (the caching allocator must not hand
     a tensor made on a lane's stream to another allocation while the step
     reads it), and chunks are reassembled (`torch.cat`) there, on the
     consumer thread. A slot's permit frees when the consumer takes it, its
     host slot when the consumer asks for the next batch. On the CPU the
     "copy" is a clone of the slot: a delivered batch is always the
     consumer's own.

  3. **Wire codecs** (`encode_batch`/`decode_batch`): lossless zlib at level
     1, encoded on the producer leg and decoded by the lane before its copy,
     so the device sees the uncompressed bytes; the accounting measures what
     a compressed remote wire would carry and what the codec costs.

Accounting is the JAX module's: `transfer_mb_per_s` is bytes over the union
of wire-busy intervals, `input_overlap_fraction` the share of the steady
input leg hidden under compute, and the consumer's stamps telescope
(wall_s == consumer_wait_s + consumer_busy_s). `autotune_staging` probes
{lanes x chunks} against the live link and returns its table and pick.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from tf_operator_tpu_torch.data.prefetch import overlap_efficiency
from tf_operator_tpu_torch.telemetry import tracer

# f32-rounded reciprocal, multiplied (not divided) on host and device alike:
# the same single-precision ops in the same order.
U8_SCALE = np.float32(1.0) / np.float32(127.5)
U8_SHIFT = np.float32(1.0)

WIRE_DTYPES = ("auto", "uint8", "f32")

# Batch keys carrying images, the arrays the uint8 wire and its
# normalisation apply to. uint8 elsewhere (labels under 256 classes, 0/1
# masks) is data and never normalised.
IMAGE_KEYS = ("x",)


def normalize_uint8(x):
    """uint8 pixels -> f32 in [-1, 1]: a numpy array on the host (the f32
    wire), a tensor on its own device (the consumer's preprocess), with the
    same constant and op order."""
    if isinstance(x, np.ndarray):
        return x.astype(np.float32) * U8_SCALE - U8_SHIFT
    return x.to(torch.float32) * float(U8_SCALE) - float(U8_SHIFT)


def to_wire(batch: dict, wire_dtype: str = "auto",
            image_keys: tuple[str, ...] = IMAGE_KEYS) -> dict:
    """Host-side wire conversion of one dict batch; only `image_keys` are
    ever converted.

    auto  — ship every array as stored (uint8 stays uint8: the cheap wire).
    uint8 — contract check: image keys must already be uint8.
    f32   — normalise uint8 image keys to f32 on the host.
    """
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"wire_dtype {wire_dtype!r} not in {WIRE_DTYPES}")
    if wire_dtype == "auto":
        return batch
    out = {}
    for k, v in batch.items():
        if k not in image_keys:
            out[k] = v
        elif wire_dtype == "f32" and v.dtype == np.uint8:
            out[k] = normalize_uint8(v)
        elif wire_dtype == "uint8" and np.issubdtype(v.dtype, np.floating):
            raise ValueError(
                f"--wire-dtype uint8 needs uint8-stored images, but key "
                f"{k!r} is {v.dtype} — re-shard the dataset as uint8 or "
                f"use --wire-dtype auto/f32")
        else:
            out[k] = v
    return out


def make_preprocess_fn(image_keys: tuple[str, ...] = IMAGE_KEYS) -> Callable[[dict], dict]:
    """The consumer's preprocess of a device batch: normalises uint8 image
    entries (the uint8 wire) and passes everything else through."""

    def preprocess(batch: dict) -> dict:
        return {k: normalize_uint8(v) if k in image_keys and v.dtype == torch.uint8 else v
                for k, v in batch.items()}

    return preprocess


WIRE_CODECS = ("none", "zlib")
# Leaves under this size ship uncompressed whatever the codec.
MIN_ENCODE_BYTES = 1 << 10
# Speed-biased deflate: level 1 compresses uint8 images within a few percent
# of level 6 at several times the throughput.
_ZLIB_LEVEL = 1


class Encoded:
    """One array leaf as it would cross a compressed wire: the codec
    payload plus the dtype and shape needed to inflate it."""

    __slots__ = ("payload", "dtype", "shape", "codec", "raw_nbytes")

    def __init__(self, payload: bytes, dtype, shape, codec: str, raw_nbytes: int):
        self.payload = payload
        self.dtype = dtype
        self.shape = shape
        self.codec = codec
        self.raw_nbytes = raw_nbytes

    @property
    def nbytes(self) -> int:
        return len(self.payload)


def encode_batch(batch: dict, codec: str) -> dict:
    """Host-side compression of one dict batch: every array leaf of at
    least MIN_ENCODE_BYTES becomes an `Encoded` payload; lossless for any
    dtype."""
    if codec not in WIRE_CODECS:
        raise ValueError(f"wire codec {codec!r} not in {WIRE_CODECS}")
    if codec == "none":
        return batch
    import zlib

    out = {}
    for k, v in batch.items():
        if getattr(v, "nbytes", 0) < MIN_ENCODE_BYTES:
            out[k] = v
            continue
        out[k] = Encoded(zlib.compress(np.ascontiguousarray(v).tobytes(), _ZLIB_LEVEL),
                         v.dtype, v.shape, codec, v.nbytes)
    return out


def decode_batch(batch: dict) -> dict:
    """Inflate `Encoded` leaves back to the exact source arrays."""
    import zlib

    return {k: np.frombuffer(zlib.decompress(v.payload), dtype=v.dtype).reshape(v.shape)
            if isinstance(v, Encoded) else v for k, v in batch.items()}


def encoded_nbytes(batch: dict) -> int:
    """Wire bytes of an encoded batch (codec payloads + raw small leaves)."""
    return sum(v.nbytes for v in batch.values())


class _Chunks:
    """One array staged as C chunk copies, awaiting the consumer's
    reassembly."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = parts


# Arrays under this size transfer in one copy whatever the chunks knob says.
MIN_CHUNK_BYTES = 1 << 20


def effective_chunks(x, chunks: int = 1) -> int:
    """The largest feasible chunk count <= `chunks` for this array (numpy
    or tensor): 1 under MIN_CHUNK_BYTES or without a leading dim to split,
    else the largest count dividing the leading dim. A transfer-rate knob
    degrades; it never fails."""
    if chunks <= 1 or x.ndim == 0 or x.shape[0] < chunks or x.nbytes < MIN_CHUNK_BYTES:
        return 1
    for c in range(chunks, 1, -1):
        if x.shape[0] % c == 0:
            return c
    return 1


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty((0,), dtype)).dtype


class _SlotPool:
    """Host slots made once and reused: each a dict key -> tensor, pinned
    when the copies go to a CUDA device. A slot's tensor for a key is
    remade only when the key's shape or dtype changes."""

    def __init__(self, n: int, pin: bool):
        self.pin = pin
        self._free = [{} for _ in range(n)]
        self._cond = threading.Condition()

    def take(self, stop: threading.Event) -> dict | None:
        with self._cond:
            while not self._free:
                if stop.is_set():
                    return None
                self._cond.wait(0.1)
            return self._free.pop()

    def give(self, slot: dict) -> None:
        with self._cond:
            self._free.append(slot)
            self._cond.notify()

    def fill(self, slot: dict, batch: dict) -> dict:
        """Copy the host arrays of `batch` into the slot; returns the slot's
        tensors for the batch's keys."""
        out = {}
        for k, v in batch.items():
            t = slot.get(k)
            dtype = _torch_dtype(v.dtype)
            if t is None or tuple(t.shape) != tuple(v.shape) or t.dtype != dtype:
                t = slot[k] = torch.empty(v.shape, dtype=dtype, pin_memory=self.pin)
            t.numpy()[...] = v
            out[k] = t
        return out


def _copy_to(host: dict, device: torch.device, chunks: int, stream) -> tuple[dict, Any]:
    """COPIES ONLY (a lane's leg): each slot tensor to `device` on `stream`
    (a clone on the CPU), split into effective_chunks copies along dim 0 (a
    _Chunks); on a CUDA device also an event recorded after the copies,
    which the caller waits for."""

    def copy(t):
        return t.clone() if stream is None else t.to(device, non_blocking=True)

    def leaf(t):
        c = effective_chunks(t, chunks)
        if c <= 1:
            return copy(t)
        step = t.shape[0] // c
        return _Chunks([copy(t[i * step:(i + 1) * step]) for i in range(c)])

    if stream is None:
        return {k: leaf(t) for k, t in host.items()}, None
    with torch.cuda.stream(stream):
        dev = {k: leaf(t) for k, t in host.items()}
        event = torch.cuda.Event()
        event.record(stream)
    return dev, event


def _assemble(dev: dict, event, device: torch.device) -> dict:
    """The consumer's side of a staged slot: its stream waits on the slot's
    event, every tensor is recorded as used there, and chunks are
    reassembled (torch.cat runs a kernel: only on the consumer thread)."""
    if event is not None:
        cur = torch.cuda.current_stream(device)
        cur.wait_event(event)
        for v in dev.values():
            for t in v.parts if isinstance(v, _Chunks) else (v,):
                t.record_stream(cur)
    return {k: torch.cat(v.parts) if isinstance(v, _Chunks) else v for k, v in dev.items()}


def transfer_mb_per_s(stats: dict) -> float | None:
    """Effective host->device rate from the lanes' own copy timers: bytes
    over the union of wire-busy intervals (`transfer_busy_s`)."""
    s = stats.get("transfer_busy_s") or stats.get("transfer_s", 0.0)
    b = stats.get("bytes_staged", 0)
    if s <= 0 or b <= 0:
        return None
    return b / 1e6 / s


def input_overlap_fraction(stats: dict) -> float | None:
    """Share of the steady-state input path (host production, wire codec,
    transfer) that hid under compute: prefetch's estimator over the ring's
    union input clock."""
    return overlap_efficiency(stats)


def stage_to_device(
    it: Iterator[Any],
    depth: int = 2,
    device=None,
    chunks: int = 1,
    wire_dtype: str = "auto",
    stats: dict | None = None,
    lanes: int = 1,
    codec: str = "none",
) -> Iterator[dict]:
    """Wrap a host-batch iterator; yields dicts of tensors on `device`
    (default the CPU), staged through a ring of `depth` slots fed by
    `lanes` transfer threads.

    depth      — how many batches may be staged ahead of the consumer; each
                 lane holds a slot permit while it transfers, so this bounds
                 device read-ahead however many lanes run.
    chunks     — copies per array, degraded per array (effective_chunks).
    wire_dtype — host-side wire conversion (to_wire); the uint8 wire's
                 normalisation is the consumer's preprocess, not the ring's.
    lanes      — transfer threads; capped at depth (a lane above it could
                 never hold a permit). Batches keep their exact order.
    codec      — lossless wire compression (WIRE_CODECS).
    stats      — optional dict updated in place, with the JAX module's keys:
        batches_staged, bytes_staged (decoded wire bytes), bytes_encoded,
        host_s (lane seconds in next(it) + to_wire), encode_s, decode_s,
        transfer_s (lane seconds in the copy, waited for), transfer_busy_s
        (union wall-clock with a lane in its copy), input_s (the lanes' whole
        leg), steady_input_s (union wall-clock with a lane anywhere in its
        leg, between the consumer's first and last take), batches_consumed,
        consumer_wait_s, consumer_busy_s, wall_s (== wait + busy), lanes,
        lanes_effective, chunks_effective, codec.
    """
    if depth < 1:
        raise ValueError("depth must be >= 1")
    if chunks < 1:
        raise ValueError("chunks must be >= 1")
    if lanes < 1:
        raise ValueError("lanes must be >= 1")
    if codec not in WIRE_CODECS:
        raise ValueError(f"wire codec {codec!r} not in {WIRE_CODECS}")
    from tf_operator_tpu_torch.chaos import staging_stall_delay, staging_stalls_from_env

    device = torch.device(device or "cpu")
    cuda = device.type == "cuda"
    n_lanes = max(1, min(lanes, depth))
    if stats is not None:
        for k in ("batches_staged", "batches_consumed", "bytes_staged", "bytes_encoded"):
            stats.setdefault(k, 0)
        for k in ("host_s", "encode_s", "decode_s", "transfer_s", "transfer_busy_s",
                  "input_s", "steady_input_s", "consumer_wait_s", "consumer_busy_s",
                  "wall_s"):
            stats.setdefault(k, 0.0)
        stats["lanes"] = lanes
        stats["lanes_effective"] = n_lanes
        stats["codec"] = codec

    pool = _SlotPool(depth + n_lanes, pin=cuda)
    free = threading.Semaphore(depth)
    stop = threading.Event()
    # Two locks: read_lock serialises the sequenced reader (next(it) can be
    # a disk read, which must not hold up a finished lane's deposit or the
    # consumer's take); lock/cond guard the stats, the union clocks and the
    # ordered delivery buffer. Lock order: read_lock -> cond.
    read_lock = threading.Lock()
    lock = threading.Lock()
    cond = threading.Condition(lock)
    ready: dict[int, tuple] = {}  # seq -> (slot, batch, event)
    err: list[BaseException] = []
    src = {"next_seq": 0, "total": None}
    wire = {"active": 0, "t0": 0.0}
    inp = {"active": 0, "t0": 0.0, "acc": 0.0}
    stalls = staging_stalls_from_env()

    def _enter(clock):
        if stats is not None:
            with lock:
                if clock["active"] == 0:
                    clock["t0"] = time.perf_counter()
                clock["active"] += 1

    def _exit(clock, key):
        if stats is not None:
            with lock:
                clock["active"] -= 1
                if clock["active"] == 0:
                    dt = time.perf_counter() - clock["t0"]
                    if key:
                        stats[key] += dt
                    else:
                        clock["acc"] += dt

    def _input_busy_now():  # caller holds `lock`
        if inp["active"]:
            return inp["acc"] + (time.perf_counter() - inp["t0"])
        return inp["acc"]

    def worker(lane: int):
        stream = torch.cuda.Stream(device) if cuda else None
        try:
            while True:
                while not free.acquire(timeout=0.1):
                    if stop.is_set():
                        return
                t0 = time.perf_counter()
                _enter(inp)
                try:
                    with tracer.span("staging/host_next", lane=lane):
                        exhausted = False
                        with read_lock:
                            if src["total"] is not None or err:
                                free.release()
                                return
                            try:
                                batch = next(it)
                            except StopIteration:
                                src["total"] = src["next_seq"]
                                exhausted = True
                            else:
                                seq = src["next_seq"]
                                src["next_seq"] = seq + 1
                        if exhausted:
                            free.release()
                            with cond:
                                cond.notify_all()
                            return
                        if stop.is_set():
                            return
                        batch = to_wire(batch, wire_dtype)
                    enc_bytes, t_enc, t_dec = 0, 0.0, 0.0
                    if codec != "none":
                        te0 = time.perf_counter()
                        batch = encode_batch(batch, codec)
                        enc_bytes = encoded_nbytes(batch)
                        te1 = time.perf_counter()
                        batch = decode_batch(batch)
                        t_enc = te1 - te0
                        t_dec = time.perf_counter() - te1
                    nbytes = sum(v.nbytes for v in batch.values())
                    if stats is not None and "chunks_effective" not in stats:
                        with lock:
                            stats.setdefault("chunks_effective", max(
                                (effective_chunks(v, chunks) for v in batch.values()),
                                default=1))
                    slot = pool.take(stop)
                    if slot is None:
                        return
                    host = pool.fill(slot, batch)
                    attrs = {"lane": lane, "bytes": nbytes} if tracer.get_tracer().enabled \
                        else {}
                    t1 = time.perf_counter()
                    with tracer.span("staging/h2d_transfer", **attrs):
                        _enter(wire)
                        try:
                            if stalls:
                                delay = staging_stall_delay(seq, stalls, lane=lane)
                                if delay > 0:
                                    time.sleep(delay)
                            dev, event = _copy_to(host, device, chunks, stream)
                            if event is not None:
                                # The slot must be resident when delivered,
                                # and transfer_s times the wire.
                                event.synchronize()
                        finally:
                            _exit(wire, "transfer_busy_s")
                    t2 = time.perf_counter()
                finally:
                    _exit(inp, None)
                with cond:
                    if stats is not None:
                        stats["batches_staged"] += 1
                        stats["bytes_staged"] += nbytes
                        stats["bytes_encoded"] += enc_bytes
                        stats["host_s"] += t1 - t0 - t_enc - t_dec
                        stats["encode_s"] += t_enc
                        stats["decode_s"] += t_dec
                        stats["transfer_s"] += t2 - t1
                        stats["input_s"] += t2 - t0
                    # Ordered delivery: the slot waits here, keyed by its
                    # sequence number, until the consumer's cursor reaches it.
                    ready[seq] = (slot, dev, event)
                    cond.notify_all()
        except BaseException as e:  # noqa: BLE001 — surfaced to the consumer
            with cond:
                err.append(e)
                cond.notify_all()

    threads = [threading.Thread(target=worker, args=(i,), daemon=True, name=f"staging-{i}")
               for i in range(n_lanes)]
    for t in threads:
        t.start()
    # The consumer's stamps telescope: busy_i = t_get_i - t_take_{i-1},
    # wait_i = t_item_i - t_get_i, so wall_s = sum(busy) + sum(wait).
    t_prev_take = None
    inp_prev = 0.0
    expected = 0
    held = None  # the host slot of the batch the consumer holds
    try:
        while True:
            t_get = time.perf_counter()
            if held is not None:
                # Asking for the next batch ends the consumer's use of the
                # last one (on the CPU its slot tensors were the batch).
                pool.give(held)
                held = None
            with cond:
                while (expected not in ready and not err
                       and not (src["total"] is not None and expected >= src["total"])):
                    cond.wait()
                if expected in ready:
                    # Delivered slots drain before an error or the end.
                    slot, dev, event = ready.pop(expected)
                elif err:
                    raise err[0]
                else:
                    return
            expected += 1
            t_item = time.perf_counter()
            if stats is not None:
                with lock:
                    inp_now = _input_busy_now()
                    if t_prev_take is not None:
                        stats["consumer_busy_s"] += t_get - t_prev_take
                        stats["consumer_wait_s"] += t_item - t_get
                        stats["wall_s"] += t_item - t_prev_take
                        stats["steady_input_s"] += inp_now - inp_prev
                    inp_prev = inp_now
                    stats["batches_consumed"] += 1
            t_prev_take = t_item
            # Taking batch i frees its permit: a lane may stage i + depth.
            free.release()
            held = slot
            yield _assemble(dev, event, device)
    finally:
        stop.set()
        with cond:
            ready.clear()
            cond.notify_all()
        for t in threads:
            t.join(timeout=5.0)


# Probe grids of the auto-tuner (the JAX module's).
TUNE_LANES = (1, 2, 4)
TUNE_CHUNKS = (1, 2, 4)


def autotune_staging(
    sample_batch: dict,
    device=None,
    lanes_grid: tuple[int, ...] = TUNE_LANES,
    chunks_grid: tuple[int, ...] = TUNE_CHUNKS,
    reps: int = 3,
    depth: int | None = None,
    wire_dtype: str = "auto",
    codec: str = "none",
) -> dict:
    """Probe {lanes x chunks} against the live link and pick the best: each
    geometry stages `reps` copies of `sample_batch` through a real ring
    with a consumer that only synchronises, scored by the ring's own wire
    clock (transfer_mb_per_s; the lanes wait for their copies before they
    read a timer). Rows are unique effective geometries (lanes capped at
    `depth`, chunks degraded per array), `requested` lists the grid combos
    that collapsed onto each; ties go to fewer lanes, then fewer chunks.
    The caller keeps `sample_batch` (probes only read it).

    Returns {"lanes", "chunks", "mb_per_s", "table", "reps", "probe_s"}."""
    if not lanes_grid or not chunks_grid:
        raise ValueError("autotune_staging: empty probe grid")
    device = torch.device(device or "cpu")
    t_probe0 = time.perf_counter()
    wire_leaves = list(to_wire(sample_batch, wire_dtype).values())

    def _effective(lanes: int, chunks: int) -> tuple[int, int]:
        d = depth if depth is not None else max(2, lanes)
        return (max(1, min(lanes, d)),
                max((effective_chunks(leaf, chunks) for leaf in wire_leaves), default=1))

    table: list[dict] = []
    probed: dict[tuple[int, int], dict] = {}
    best = None
    for lanes in lanes_grid:
        for chunks in chunks_grid:
            eff = _effective(lanes, chunks)
            if eff in probed:
                probed[eff]["requested"].append([lanes, chunks])
                continue
            stats: dict = {}
            t0 = time.perf_counter()
            for _ in stage_to_device(iter([sample_batch] * reps),
                                     depth=depth if depth is not None else max(2, lanes),
                                     device=device, chunks=chunks, wire_dtype=wire_dtype,
                                     stats=stats, lanes=lanes, codec=codec):
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            rate = transfer_mb_per_s(stats) or 0.0
            row = {
                "lanes": stats.get("lanes_effective", eff[0]),
                "chunks": stats.get("chunks_effective", eff[1]),
                "requested": [[lanes, chunks]],
                "mb_per_s": round(rate, 2),
                "delivered_mb_per_s": (round(stats.get("bytes_staged", 0) / 1e6 / dt, 2)
                                       if dt > 0 else None),
            }
            table.append(row)
            probed[eff] = row
            if best is None or rate > best[0]:
                best = (rate, row["lanes"], row["chunks"])
    return {"lanes": best[1], "chunks": best[2], "mb_per_s": round(best[0], 2),
            "table": table, "reps": reps, "probe_s": round(time.perf_counter() - t_probe0, 3)}
