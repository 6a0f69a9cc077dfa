"""The trainer's own watchdog over its host waits in an NCCL world
(parallel/peer_watch.py), on CPU.

- `poll`: a stand-in host wait that never completes becomes PeerLostError
  within the deadline, after one abort of the world; one that completes
  never trips it.
- A trainer whose watched read never completes emits `peer_lost` and
  returns 138 (the operator's retryable code); one whose reads complete
  trains to its end. The reads are made watched by standing in for an NCCL
  world (`active`) and for the CUDA event they poll.
- world_watch over NCCL: after each replay an empty all-reduce that the
  host does not wait for (peer_watch.deferred), then a watched wait for the
  replay before the last; off NCCL no wait.
- The NCCL world's group: TORCH_NCCL_ASYNC_ERROR_HANDLING set to 0 (and
  another value refused), the group's timeout twice distributed.TIMEOUT,
  so ProcessGroupNCCL's watchdog comes after this one; gloo's untouched.
- Off an NCCL world every wait is the plain one (no event, no poll).
- An abort that never returns leaves the world wedged, and a trainer in
  such a world leaves from main at once with 138 and its peer_lost event
  (a subprocess).
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from tf_operator_tpu_torch.models import train
from tf_operator_tpu_torch.parallel import collectives, distributed, graphed_step, peer_watch
from tf_operator_tpu_torch.parallel.collectives import PeerLostError

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Event:
    """A stand-in CUDA event: query() is true from its `after`-th call on
    (never with after=None)."""

    made: list = []

    def __init__(self, after: int | None = 0):
        self.after, self.queries, self.recorded = after, 0, False
        _Event.made.append(self)

    def record(self, stream=None):
        self.recorded = True

    def query(self) -> bool:
        self.queries += 1
        return self.after is not None and self.queries > self.after

    def synchronize(self):
        raise AssertionError("a watched wait polls, it never blocks")


@pytest.mark.parametrize("timeout_s", [0.05, 0.3])
def test_a_wait_that_never_completes_raises_within_the_deadline(timeout_s):
    aborts = []
    t0 = time.monotonic()
    with pytest.raises(PeerLostError, match="the step's loss did not complete"):
        peer_watch.poll(lambda: False, "the step's loss", timeout_s, abort=lambda: aborts.append(1))
    took = time.monotonic() - t0
    assert aborts == [1] and timeout_s <= took < timeout_s + 0.25


def test_a_wait_that_completes_never_trips_it():
    calls, aborts = [], []

    def ready():
        calls.append(1)
        return len(calls) > 20

    peer_watch.poll(ready, "x", 5.0, abort=lambda: aborts.append(1))
    assert len(calls) == 21 and aborts == []


def test_the_deadline_is_distributeds_timeout(monkeypatch):
    monkeypatch.setattr(distributed, "TIMEOUT", datetime.timedelta(seconds=0.1))
    aborts = []
    t0 = time.monotonic()
    with pytest.raises(PeerLostError, match="in 0.1 s"):
        peer_watch.poll(lambda: False, "y", abort=lambda: aborts.append(1))
    assert time.monotonic() - t0 < 0.5 and aborts == [1]


def _nccl_world(monkeypatch, after):
    """Stand in for an NCCL world whose CUDA events complete after `after`
    queries (never with None); returns the aborts made."""
    aborts: list = []
    _Event.made = []
    monkeypatch.setattr(peer_watch, "active", lambda: True)
    monkeypatch.setattr(peer_watch, "abort_world", lambda: aborts.append(1))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "Event", lambda: _Event(after))
    monkeypatch.setattr(distributed, "TIMEOUT", datetime.timedelta(seconds=0.2))
    return aborts


MNIST = ["--model", "mnist-mlp", "--device", "cpu", "--steps", "4", "--batch", "8",
         "--log-every", "1"]


def _events(path):
    return [json.loads(x) for x in path.read_text().splitlines()]


def test_a_trainer_whose_wait_never_completes_exits_138_with_peer_lost(
        tmp_path, monkeypatch):
    path = tmp_path / "events.jsonl"
    monkeypatch.setenv("TPUJOB_METRICS_FILE", str(path))
    aborts = _nccl_world(monkeypatch, after=None)
    t0 = time.monotonic()
    assert train.main(MNIST) == 138
    assert time.monotonic() - t0 < 30
    events = _events(path)
    lost = [e for e in events if e["event"] == "peer_lost"]
    assert len(lost) == 1 and lost[0]["exit_code"] == 138
    assert "the step's loss did not complete in 0.2 s" in lost[0]["error"]
    assert aborts == [1] and not any(e["event"] == "done" for e in events)
    assert all(e.recorded for e in _Event.made)


def test_a_trainer_whose_waits_complete_trains_to_its_end(tmp_path, monkeypatch):
    path = tmp_path / "events.jsonl"
    monkeypatch.setenv("TPUJOB_METRICS_FILE", str(path))
    aborts = _nccl_world(monkeypatch, after=3)
    assert train.main(MNIST) == 0
    events = _events(path)
    assert [e["step"] for e in events if e["event"] == "progress"] == [2, 3, 4]
    assert aborts == [] and not any(e["event"] == "peer_lost" for e in events)
    assert _Event.made and all(e.queries == 4 for e in _Event.made)


def test_an_abort_that_never_returns_leaves_the_world_wedged(monkeypatch):
    monkeypatch.setattr(peer_watch, "_wedged", threading.Event())
    monkeypatch.setattr(peer_watch, "ABORT_WAIT_S", 0.2)
    done = []
    monkeypatch.setattr(dist.distributed_c10d, "_abort_process_group", lambda: done.append(1))
    peer_watch.abort_world()
    assert done == [1] and not peer_watch.wedged()
    stuck = threading.Event()
    monkeypatch.setattr(dist.distributed_c10d, "_abort_process_group", stuck.wait)
    t0 = time.monotonic()
    peer_watch.abort_world()
    assert peer_watch.wedged() and time.monotonic() - t0 < 2
    stuck.set()


_WEDGED_TRAINER = """
import datetime, sys, threading, torch, torch.distributed as dist
from tf_operator_tpu_torch.models import train
from tf_operator_tpu_torch.parallel import distributed, peer_watch


class Never:
    def record(self, stream=None):
        pass

    def query(self):
        return False


peer_watch.active = lambda: True
torch.cuda.is_current_stream_capturing = lambda: False
torch.cuda.Event = Never
distributed.TIMEOUT = datetime.timedelta(seconds=0.2)
peer_watch.ABORT_WAIT_S = 0.2
dist.distributed_c10d._abort_process_group = threading.Event().wait
rc = train.main(sys.argv[1:])
print("main returned", rc)
sys.exit(0)
"""


def test_a_wedged_world_exits_138_at_once_with_peer_lost(tmp_path):
    """A trainer whose world's abort never returns (as behind a CUDA graph's
    captured collectives) emits peer_lost and leaves with 138 from main,
    without its exit handlers."""
    path = tmp_path / "events.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT), TPUJOB_METRICS_FILE=str(path),
               OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", _WEDGED_TRAINER, *MNIST], env=env,
                          capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode == 138, proc.stderr[-2000:]
    assert "main returned" not in proc.stdout and time.monotonic() - t0 < 60
    assert "did not abort in 0.2 s" in proc.stderr
    lost = [e for e in _events(path) if e["event"] == "peer_lost"]
    assert len(lost) == 1 and lost[0]["exit_code"] == 138


def test_off_an_nccl_world_a_wait_is_the_plain_one(monkeypatch):
    assert not peer_watch.active()
    monkeypatch.setattr(torch.cuda, "Event", lambda: pytest.fail("no event off NCCL"))
    peer_watch.wait("z")
    assert peer_watch.read(torch.tensor(2.5), "z") == 2.5

    class Plain:
        synced = False

        def synchronize(self):
            Plain.synced = True

    peer_watch.synchronize(Plain(), "z")
    assert Plain.synced


def test_world_watch_waits_for_the_replay_before_the_last(monkeypatch):
    reduced, waited = [], []
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(collectives, "all_reduce",
                        lambda t, group: reduced.append(peer_watch.waits_deferred()))
    monkeypatch.setattr(torch.cuda, "Event", lambda: _Event(0))
    monkeypatch.setattr(peer_watch, "synchronize", lambda event, what: waited.append(event))
    _Event.made = []
    watch = graphed_step.world_watch("meta")  # a device off the CPU, as the card is
    for _ in range(3):
        watch()
    assert reduced == [True, True, True] and not peer_watch.waits_deferred()
    assert waited == _Event.made[:2]


def test_world_watch_off_nccl_never_waits(monkeypatch):
    reduced = []
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    monkeypatch.setattr(collectives, "all_reduce",
                        lambda t, group: reduced.append(peer_watch.waits_deferred()))
    monkeypatch.setattr(torch.cuda, "Event", lambda: pytest.fail("no event off NCCL"))
    watch = graphed_step.world_watch("meta")
    watch()
    watch()
    assert reduced == [True, True]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("backend,handling,factor", [("nccl", None, 2), ("nccl", "0", 2),
                                                      ("gloo", None, 1)])
def test_the_nccl_group_leaves_the_lost_peer_to_the_watchdog(monkeypatch, backend, handling,
                                                             factor):
    made = {}
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    if handling is None:
        monkeypatch.delenv(distributed.NCCL_ASYNC_ERROR_ENV, raising=False)
    else:
        monkeypatch.setenv(distributed.NCCL_ASYNC_ERROR_ENV, handling)
    monkeypatch.setattr(distributed, "choose_backend", lambda *a: backend)
    monkeypatch.setattr(dist, "init_process_group", lambda b, **kw: made.update(kw, backend=b))
    assert distributed.initialize_from_env(force=True) == backend
    assert made["timeout"] == distributed.TIMEOUT * factor
    if backend == "nccl":
        assert os.environ[distributed.NCCL_ASYNC_ERROR_ENV] == "0"


def test_an_nccl_group_refuses_process_group_nccls_own_handling(monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    monkeypatch.setenv(distributed.NCCL_ASYNC_ERROR_ENV, "3")
    monkeypatch.setattr(distributed, "choose_backend", lambda *a: "nccl")
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: pytest.fail("made"))
    with pytest.raises(RuntimeError, match="TORCH_NCCL_ASYNC_ERROR_HANDLING=3"):
        distributed.initialize_from_env(force=True)


def test_ring_buffers_persist_a_shape(monkeypatch):
    monkeypatch.setattr(collectives, "_RING_BUFFERS", {})
    a = collectives._ring_buffer("send", 12, torch.bfloat16, "cpu")
    assert collectives._ring_buffer("send", 12, torch.bfloat16, "cpu") is a
    assert collectives._ring_buffer("recv", 12, torch.bfloat16, "cpu") is not a
    assert collectives._ring_buffer("send", 16, torch.bfloat16, "cpu") is not a
    assert a.shape == (12,) and a.dtype == torch.bfloat16
