"""The trainer's own watchdog over its host waits in an NCCL world.

In a world of several processes over NCCL, a lost peer shows in no call:
its survivors' collectives wait on the card for ever, and so does every
host call behind them (a read of the step's loss, a full launch queue).
gloo's collectives wait on the host and raise at the group's timeout
themselves (collectives.peer_lost); this module is for NCCL.

Every host wait of a multi-process step goes through `wait` (or `read`,
`synchronize`): it records a CUDA event behind the work queued on the
current stream and polls it against a deadline of distributed.TIMEOUT
(300 s). Past the deadline it aborts the world's communicators
(torch.distributed's `_abort_process_group`: every group, in one NCCL group
call, which ends every NCCL kernel still waiting on them) and raises
collectives.PeerLostError, which the trainer turns into a `peer_lost`
event and exit 138: a retryable code, so the operator rolls the gang. The
host waits, each of which can meet a lost peer's collective:

  - the metrics read after a replay or a step (`read`);
  - world_watch's all-reduce after each replay: GraphedStep then waits for
    the replay before the last (graphed_step.world_watch), so the host is
    never more than one step ahead of the card;
  - every collective the host issues outside a capture (collectives._call
    waits for it): an eager step never queues work behind a collective
    that may not end, since behind one the launch queue fills and the host
    blocks inside a kernel launch, where no watchdog reaches it;
  - the preemption flag's agreement and the checkpoint snapshot's wait.

An abort that does not return within ABORT_WAIT_S (seen behind a CUDA
graph's captured collectives) leaves the world wedged: the trainer then
emits `peer_lost` and leaves at once with 138, since nothing of that world
can be torn down (`wedged`). A sound world never trips the watchdog: a step
slower than the timeout is a hang by definition. ProcessGroupNCCL's own watchdog would otherwise abort the
process (SIGABRT) at the group's timeout, with no event: the world is made
with TORCH_NCCL_ASYNC_ERROR_HANDLING=0, as torch asks beside
`_abort_process_group`, and a group timeout of twice distributed.TIMEOUT
(parallel/distributed.py), so that watchdog only logs, after this one.

Off an NCCL world (one process, gloo, the CPU) and inside a capture, a
wait is the plain one.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from typing import Callable

import torch
import torch.distributed as dist

from tf_operator_tpu_torch.parallel import distributed
from tf_operator_tpu_torch.parallel.collectives import PeerLostError

# The poll's first and longest pause: the host wakes at most this late
# after the card finishes (a few per cent of the shortest steps' time).
POLL_MIN_S = 5e-5
POLL_MAX_S = 5e-4
# How long abort_world waits for the abort.
ABORT_WAIT_S = 10.0

_local = threading.local()
_wedged = threading.Event()


@contextlib.contextmanager
def deferred():
    """`wait` returns at once inside: the caller waits for the work later
    itself (world_watch, one replay behind)."""
    _local.deferred = True
    try:
        yield
    finally:
        _local.deferred = False


def waits_deferred() -> bool:
    return getattr(_local, "deferred", False)


def active() -> bool:
    """Whether this process is a rank of a world of several processes over
    NCCL (where a lost peer blocks the host instead of raising)."""
    return (dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
            and dist.get_backend() == "nccl")


def abort_world() -> None:
    """Abort every communicator of every group of this process's world, on
    a thread of its own, waiting ABORT_WAIT_S for it: behind kernels that a
    CUDA graph captured the abort itself can wait for ever, and then the
    world is wedged (`wedged`)."""
    def abort() -> None:
        try:
            dist.distributed_c10d._abort_process_group()
        except Exception as e:  # noqa: BLE001 - the error raised after it names the wait
            print(f"peer watch: aborting the world's communicators failed: {e}",
                  file=sys.stderr)

    t = threading.Thread(target=abort, daemon=True, name="peer-watch-abort")
    t.start()
    t.join(ABORT_WAIT_S)
    if t.is_alive():
        print(f"peer watch: the world's communicators did not abort in {ABORT_WAIT_S:g} s",
              file=sys.stderr)
        _wedged.set()


def wedged() -> bool:
    """Whether an abort of this process's world never returned: its
    communicators and the kernels waiting on them cannot be torn down, so
    the process must leave without its exit handlers (the trainer's main)."""
    return _wedged.is_set()


def poll(ready: Callable[[], bool], what: str, timeout_s: float | None = None,
         abort: Callable[[], None] | None = None) -> None:
    """Return once ready() is true; when it is still false `timeout_s`
    (distributed.TIMEOUT by default) after the call, abort() (abort_world
    by default) and raise PeerLostError naming `what`."""
    limit = distributed.TIMEOUT.total_seconds() if timeout_s is None else timeout_s
    t0 = time.monotonic()
    pause = POLL_MIN_S
    while not ready():
        if time.monotonic() - t0 > limit:
            (abort or abort_world)()
            after = ("the abort of its communicators did not return" if wedged() else
                     "its communicators were aborted")
            raise PeerLostError(f"{what} did not complete in {limit:g} s: a peer of the "
                                f"world is gone or wedged ({after})")
        time.sleep(pause)
        pause = min(2 * pause, POLL_MAX_S)


def synchronize(event, what: str) -> None:
    """event.synchronize(), polled against the deadline in an NCCL world."""
    if active():
        poll(event.query, what)
    else:
        event.synchronize()


def wait(what: str) -> None:
    """In an NCCL world, outside a capture: wait (polled, against the
    deadline) for the work queued so far on the current stream."""
    if waits_deferred() or not active() or torch.cuda.is_current_stream_capturing():
        return
    done = torch.cuda.Event()
    done.record()
    poll(done.query, what)


def read(t: torch.Tensor, what: str) -> float:
    """float(t), its wait watched in an NCCL world."""
    wait(what)
    return float(t)
