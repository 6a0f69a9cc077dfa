"""Host->device prefetch: counterpart of tf_operator_tpu/data/prefetch.py.

One copy thread keeps `depth` batches ahead of the step loop, so the
transfer of batch i+depth rides under the compute of batch i. The thread
takes a host batch (a dict of numpy arrays) and, on a CUDA device, copies
each array onto its own side stream (`.to(device, non_blocking=True)`) and
records an event; the consumer makes its current stream wait on that event
and marks the tensors as used there (`record_stream`), so the caching
allocator never hands their memory to a later batch while a step still
reads them. On the CPU a batch becomes CPU tensors. The thread only
copies: whatever computes on a batch (the uint8 wire's normalisation, the
step) runs on the consumer thread.

The stats are the JAX module's, and `overlap_efficiency` turns them into
the share of the input path that hid under compute; the staging ring
(data/staging.py) fills the same keys. This prefetcher is the trainer's
`--input-staging prefetch`, the continuity baseline of the ring.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Any, Iterator

import numpy as np
import torch

from tf_operator_tpu_torch.telemetry import tracer


class _Stop:
    pass


def overlap_efficiency(stats: dict) -> float | None:
    """Fraction of the input path (host batch production + host->device
    transfer) that hid under device compute: 1.0 = the consumer never
    waited past the pipeline-fill batch, 0.0 = every input second stalled
    the step loop. None until at least one steady-state batch was consumed.

    The denominator is the producer time of exactly the consumed
    steady-state batches (`steady_input_s`), consumer_wait_s the unhidden
    remainder."""
    consumed = stats.get("batches_consumed", 0)
    steady_input = stats.get("steady_input_s", 0.0)
    if consumed <= 1 or steady_input <= 0:
        return None
    hidden = max(0.0, steady_input - stats.get("consumer_wait_s", 0.0))
    return min(1.0, hidden / steady_input)


def host_tensor(x) -> torch.Tensor:
    """A CPU tensor over a numpy array's memory (a copy when the array is
    read-only, which torch may not alias), or the tensor itself."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    if not x.flags.writeable:
        x = x.copy()
    return torch.from_numpy(x)


def accept_on_consumer(batch: dict, event, device: torch.device) -> dict:
    """The consumer's side of a side-stream copy: its current stream waits
    on `event` (None for CPU batches) and each tensor is recorded as used
    on that stream, so the allocator keeps its memory until the work
    queued there is done."""
    if event is not None:
        cur = torch.cuda.current_stream(device)
        cur.wait_event(event)
        for t in batch.values():
            t.record_stream(cur)
    return batch


def prefetch_to_device(
    it: Iterator[Any], depth: int = 2, device=None, stats: dict | None = None,
) -> Iterator[dict]:
    """Wrap a host-batch iterator; yields dicts of tensors on `device`
    (default the CPU).

    stats: optional dict, updated IN PLACE as batches flow (readable while
    the iterator is live; the trainer reports it in its `done` event):
      batches_consumed — batches the consumer has taken
      input_s          — TOTAL producer seconds in next(it) + the copy
                         (fill and read-ahead included)
      steady_input_s   — producer seconds of just the CONSUMED batches past
                         the fill batch (overlap_efficiency's denominator;
                         the queue is FIFO, so the consumer pairs each
                         batch it takes with the oldest pending time)
      consumer_wait_s  — consumer seconds blocked waiting for a batch after
                         the first (the fill batch and the end-of-stream
                         sentinel excluded: neither has compute to hide
                         under)
    """
    if depth < 1:
        raise ValueError("depth must be >= 1")
    device = torch.device(device or "cpu")
    pending_times: collections.deque = collections.deque()
    if stats is not None:
        stats.setdefault("batches_consumed", 0)
        stats.setdefault("input_s", 0.0)
        stats.setdefault("steady_input_s", 0.0)
        stats.setdefault("consumer_wait_s", 0.0)
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list[BaseException] = []
    stop = threading.Event()
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def to_device(batch):
        host = {k: host_tensor(v) for k, v in batch.items()}
        if side is None:
            return host, None
        with torch.cuda.stream(side):
            out = {k: t.to(device, non_blocking=True) for k, t in host.items()}
            event = torch.cuda.Event()
            event.record(side)
        return out, event

    def worker():
        try:
            while True:
                t0 = time.perf_counter()
                # One span per batch on the producer's own track (--trace):
                # production and copy, the leg the double buffering hides.
                with tracer.span("prefetch/input"):
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                    if stop.is_set():
                        return
                    item = to_device(batch)
                if stats is not None:
                    # One producer thread: plain += is safe. The time is
                    # queued before the batch, so the consumer's popleft
                    # pairs with the batch it just took.
                    dt = time.perf_counter() - t0
                    stats["input_s"] += dt
                    pending_times.append(dt)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — surfaced to the consumer
            err.append(e)
        finally:
            # The sentinel must be delivered on normal completion; bail only
            # when the consumer has abandoned the iterator.
            while not stop.is_set():
                try:
                    q.put(_Stop, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=worker, daemon=True, name="prefetch")
    t.start()
    try:
        while True:
            t0 = time.perf_counter()
            item = q.get()
            if stats is not None and item is not _Stop:
                produced_s = pending_times.popleft() if pending_times else 0.0
                if stats["batches_consumed"] > 0:
                    stats["consumer_wait_s"] += time.perf_counter() - t0
                    stats["steady_input_s"] += produced_s
                stats["batches_consumed"] += 1
            if item is _Stop:
                if err:
                    raise err[0]
                return
            yield accept_on_consumer(*item, device)
    finally:
        # The consumer abandoned the iterator (the trainer takes exactly
        # `steps` batches of an endless dataset): end the worker so it pins
        # no device memory.
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=5.0)
