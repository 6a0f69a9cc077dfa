"""Graceful preemption in the PyTorch port, on CPU.

The port's PreemptionGuard (utils/preemption.py) is held to the JAX
guard's tests (tests/test_chaos.py's TestPreemptionGuard), and its exit-code
table (utils/exit_codes.py) to the JAX one. Then the port trainer runs as a
pod runs it, in a subprocess, and SIGTERMs itself at step 4 through
`--chaos kill:step=4,signal=TERM`: it exits 143 with one `preempted` event
whose keys are the JAX trainer's on the same flags; the async save of step
4 (held mid-write by `stall:ckpt=4`) is drained and adopted; with a grace of
0 the emergency save is skipped; and the restarted run resumes from step 4
and ends on the uninterrupted run's parameters and loss, bit for bit.
Trainer subprocesses run with OMP_NUM_THREADS=1: on the CPU a torch process's
first multi-threaded exp is sometimes off by up to 1.5e-4 relative (see
tests/test_torch_flash_attention.py), which moves a resumed trajectory
(whose first exp comes at another step than the uninterrupted run's) by
~3e-4 in the loss at 8 threads and never at one.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

from tf_operator_tpu.utils import exit_codes as jexit
from tf_operator_tpu.utils import preemption as jpreemption
from tf_operator_tpu_torch.models import checkpoint as ckpt
from tf_operator_tpu_torch.utils import exit_codes, preemption

ROOT = Path(__file__).resolve().parents[1]
MNIST = ["--model", "mnist-mlp", "--batch", "16", "--steps", "8", "--log-every", "2"]


class TestPreemptionGuard:
    def test_latches_first_signal_only(self):
        saved = {s: signal.getsignal(s) for s in preemption.HANDLED_SIGNALS}
        try:
            g = preemption.PreemptionGuard()
            assert g.install()
            assert not g.triggered
            os.kill(os.getpid(), signal.SIGUSR1)
            deadline = time.monotonic() + 5
            while not g.triggered and time.monotonic() < deadline:
                time.sleep(0.01)
            assert g.triggered and g.signal_name == "SIGUSR1"
            assert g.exit_code == 138  # the user-declared-retryable code
            os.kill(os.getpid(), signal.SIGTERM)  # latched: must not re-arm
            time.sleep(0.05)
            assert g.exit_code == 138
        finally:
            for s, h in saved.items():
                signal.signal(s, h)

    def test_uninstall_restores_displaced_handlers(self):
        saved = {s: signal.getsignal(s) for s in preemption.HANDLED_SIGNALS}
        g = preemption.PreemptionGuard()
        assert g.install()
        assert signal.getsignal(signal.SIGTERM) == g._handler
        g.uninstall()
        for s in preemption.HANDLED_SIGNALS:
            assert signal.getsignal(s) == saved[s]
        assert not g.installed

    def test_reassert_takes_the_signals_back(self):
        saved = {s: signal.getsignal(s) for s in preemption.HANDLED_SIGNALS}
        g = preemption.PreemptionGuard()
        try:
            assert g.install()
            signal.signal(signal.SIGTERM, signal.SIG_DFL)  # a library took it
            assert g.reassert()
            assert signal.getsignal(signal.SIGTERM) == g._handler
        finally:
            g.uninstall()
        assert {s: signal.getsignal(s) for s in preemption.HANDLED_SIGNALS} == saved

    def test_grace_budget(self):
        g = preemption.PreemptionGuard()
        g._signum = signal.SIGTERM
        g._t = time.monotonic()
        assert g.within_grace(est_save_s=0.1, grace_s=30.0)
        assert not g.within_grace(est_save_s=1000.0, grace_s=30.0)
        assert not g.within_grace(est_save_s=0.0, grace_s=0.0)  # no budget
        assert g.exit_code == 143

    def test_signals_and_codes_are_the_jax_guards(self):
        assert preemption.HANDLED_SIGNALS == jpreemption.HANDLED_SIGNALS
        for signum in preemption.HANDLED_SIGNALS:
            port, ref = preemption.PreemptionGuard(), jpreemption.PreemptionGuard()
            port._signum = ref._signum = signum
            assert (port.exit_code, port.signal_name) == (ref.exit_code, ref.signal_name)


def test_exit_codes_are_the_jax_table():
    for code in range(256):
        assert exit_codes.is_retryable_exit_code(code) == jexit.is_retryable_exit_code(code)
        assert exit_codes.signal_of(code) == jexit.signal_of(code)
        assert exit_codes.is_signal_exit(code) == jexit.is_signal_exit(code)
    assert exit_codes.RETRYABLE_EXIT_CODES == jexit.RETRYABLE_EXIT_CODES


def run(tmp_path, module: str, args: list[str], tag: str) -> tuple[int, list[dict]]:
    """`python -m module args` as a pod runs it; (exit code, events)."""
    events = tmp_path / f"{tag}.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT), TPUJOB_METRICS_FILE=str(events),
               JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=1",
               OMP_NUM_THREADS="1")
    for key in ("TPUJOB_CHAOS", "TPUJOB_CHAOS_STATE", "TPUJOB_REPLICA_TYPE"):
        env.pop(key, None)
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=240)
    lines = events.read_text().splitlines() if events.exists() else []
    return proc.returncode, [json.loads(x) for x in lines]


def port(tmp_path, args, tag):
    return run(tmp_path, "tf_operator_tpu_torch.models.train", ["--device", "cpu", *args], tag)


def preempted(events):
    pre = [e for e in events if e["event"] == "preempted"]
    assert len(pre) == 1, pre
    return pre[0]


KILL = ["--preempt-grace", "60", "--chaos", "kill:step=4,signal=TERM"]


def test_sigterm_exits_143_with_the_jax_events_keys(tmp_path):
    flags = MNIST + ["--checkpoint-every", "2"] + KILL
    rc, events = port(tmp_path, flags + ["--checkpoint-dir", str(tmp_path / "p")], "port")
    rc_j, events_j = run(tmp_path, "tf_operator_tpu.models.train",
                         flags + ["--checkpoint-dir", str(tmp_path / "j")], "jax")
    assert rc == rc_j == 143
    got, want = preempted(events), preempted(events_j)
    assert set(got) == set(want)
    for key in ("step", "signal", "exit_code", "emergency_checkpoint", "grace_s"):
        assert got[key] == want[key], key
    assert got["step"] == 4 and got["emergency_checkpoint"] is True
    assert ckpt.latest_valid_checkpoint(str(tmp_path / "p")) == 4
    assert not any(e["event"] == "done" for e in events)


def test_an_inflight_async_save_is_drained_and_adopted(tmp_path):
    """stall:ckpt=4 holds step 4's write leg for 1.5 s, so the boundary
    finds it in flight: the teardown waits it out and adopts it."""
    d = tmp_path / "ckpt"
    rc, events = port(tmp_path, MNIST + ["--checkpoint-dir", str(d), "--checkpoint-every",
                                         "2", "--preempt-grace", "60", "--chaos",
                                         "stall:ckpt=4,delay=1.5;kill:step=4,signal=TERM"],
                      "adopt")
    assert rc == 143
    pre = preempted(events)
    assert pre["adopted_async_save"] is True and pre["emergency_checkpoint"] is True
    assert pre["drain_s"] >= 1.0 and pre["elapsed_s"] >= pre["drain_s"]
    saves = [e["step"] for e in events if e["event"] == "checkpoint"]
    assert saves == [2, 4]  # the adopted save, and no second one
    assert ckpt.latest_valid_checkpoint(str(d)) == 4


def test_no_grace_skips_the_emergency_save(tmp_path):
    d = tmp_path / "ckpt"
    rc, events = port(tmp_path, MNIST + ["--checkpoint-dir", str(d), "--preempt-grace", "0",
                                         "--chaos", "kill:step=4,signal=TERM"], "skip")
    assert rc == 143
    pre = preempted(events)
    assert pre["emergency_checkpoint"] is False and pre["save_skipped"] == "grace_budget"
    assert ckpt.list_steps(str(d)) == []


def test_the_restart_resumes_and_ends_on_the_uninterrupted_run(tmp_path):
    d = tmp_path / "ckpt"
    flags = MNIST + ["--checkpoint-dir", str(d), "--checkpoint-every", "2"] + KILL
    rc, first = port(tmp_path, flags, "first")
    assert rc == 143
    rc, second = port(tmp_path, flags, "second")  # the same command, restarted
    assert rc == 0
    resumed = [e for e in second if e["event"] == "resumed"]
    assert len(resumed) == 1 and resumed[0]["from_step"] == 4
    assert resumed[0]["digest"] == resumed[0]["saved_digest"]
    rc, ref = port(tmp_path, MNIST + ["--checkpoint-dir", str(tmp_path / "ref")], "ref")
    assert rc == 0

    def losses(events):
        return {e["step"]: e["loss"] for e in events if e["event"] == "progress"}

    got, want = losses(second), losses(ref)
    assert 8 in got and all(got[s] == want[s] for s in got)
    done = [e for e in second if e["event"] == "done"][-1]
    assert done["final_loss"] == [e for e in ref if e["event"] == "done"][-1]["final_loss"]
    a = ckpt.restore(str(d), 8)
    b = ckpt.restore(str(tmp_path / "ref"), 8)
    assert a.keys() == b.keys() and all((a[k] == b[k]).all() for k in a)
