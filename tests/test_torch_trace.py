"""Tracing and profiling in the PyTorch port (--trace, --trace-dir,
--trace-steps, --profile-dir), on CPU.

`--trace` records the host spans of the JAX trainer at the same sites
(telemetry/phases.py's `step` and `phase/<name>`, `checkpoint/ckpt_write`
on the write leg, `checkpoint/save` and `checkpoint/restore` in
models/checkpoint.py, `eval` in the evaluator) and writes
`<rank>.trace.json` in Chrome trace-event form at exit. On the same flags
(mnist-mlp, checkpoints every 2 steps, then a resumed run) the port's trace
holds the same span names as the JAX trainer's, each as many times; no name
is the JAX trainer's alone on this path (JAX_ONLY).
`--trace-steps` closes the window after as many steady steps as asked.
`--profile-dir` keeps a torch.profiler trace of the last steady chunk and
emits profile_done.
"""

import collections
import concurrent.futures
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# Span names that only the JAX trainer records on this path (none: both
# trainers trace the step phases and the checkpoint IO at the same sites).
JAX_ONLY: set = set()


def run(tmp_path, module, args, tag):
    events = tmp_path / f"{tag}.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT), TPUJOB_METRICS_FILE=str(events),
               JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=1",
               OMP_NUM_THREADS="1")
    env.pop("TPUJOB_REPLICA_TYPE", None)
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return [json.loads(x) for x in events.read_text().splitlines()]


def spans(path) -> collections.Counter:
    trace = json.loads(Path(path).read_text())
    return collections.Counter(e["name"] for e in trace["traceEvents"] if e["ph"] != "M")


def traced(tmp_path, module, tag, extra=()):
    """Two runs under --trace: to step 4 with saves at 2 and 4, then resumed
    to 6. Returns each run's span counts and trace_done events."""
    out = []
    for steps in (4, 6):
        trace_dir = tmp_path / f"{tag}_trace_{steps}"
        events = run(tmp_path, module, [
            "--model", "mnist-mlp", "--batch", "8", "--log-every", "1", "--steps",
            str(steps), "--trace", "--trace-dir", str(trace_dir), "--checkpoint-dir",
            str(tmp_path / f"{tag}_ckpt"), "--checkpoint-every", "2", *extra], f"{tag}{steps}")
        done = [e for e in events if e["event"] == "trace_done"]
        assert len(done) == 1 and done[0]["path"] == str(trace_dir / "local-0.trace.json")
        out.append((spans(done[0]["path"]), done[0]))
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(port runs, JAX runs); the two trainers' sequences run side by side."""
    tmp = tmp_path_factory.mktemp("trace")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        port = pool.submit(traced, tmp, "tf_operator_tpu_torch.models.train", "port",
                           ["--device", "cpu"])
        jax_runs = pool.submit(traced, tmp, "tf_operator_tpu.models.train", "jax")
        return port.result(), jax_runs.result()


def test_trace_is_chrome_trace_events(both):
    (_, done), _ = both[0]
    trace = json.loads(Path(done["path"]).read_text())
    assert set(trace) == {"traceEvents", "displayTimeUnit", "otherData"}
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert xs and all(e["dur"] >= 0 and e["ts"] >= 0 and "tid" in e for e in xs)
    names = {e["args"]["name"] for e in trace["traceEvents"] if e["name"] == "thread_name"}
    assert "ckpt-writer" in names  # the write leg rides its own track
    assert done["events"] == len([e for e in trace["traceEvents"] if e["ph"] != "M"])
    assert done["dropped_events"] == 0


@pytest.mark.parametrize("run_index", [0, 1], ids=["fresh", "resumed"])
def test_span_names_and_counts_are_the_jax_trainers(both, run_index):
    port, jax_runs = both
    got, want = port[run_index][0], jax_runs[run_index][0]
    want = collections.Counter({k: n for k, n in want.items() if k not in JAX_ONLY})
    assert got == want
    assert set(port[run_index][1]) == set(jax_runs[run_index][1])  # trace_done's keys


def test_trace_steps_bounds_the_window(tmp_path):
    """8 steps in chunks of 1: the first chunk is startup, the 7 steady ones
    are `step` spans; --trace-steps 3 keeps the first 3 (the JAX trainer's
    _trace_window_check, which closes the window once 3 are recorded)."""
    counts = {}
    for n in (0, 3):
        trace_dir = tmp_path / f"t{n}"
        run(tmp_path, "tf_operator_tpu_torch.models.train", [
            "--device", "cpu", "--model", "mnist-mlp", "--batch", "8", "--log-every", "1",
            "--steps", "8", "--trace", "--trace-dir", str(trace_dir), "--trace-steps",
            str(n)], f"w{n}")
        counts[n] = spans(trace_dir / "local-0.trace.json")["step"]
    assert counts == {0: 7, 3: 3}


def test_trace_flags_without_trace_exit_2(capsys):
    from tf_operator_tpu_torch.models import train

    for flags in (["--trace-dir", "x"], ["--trace-steps", "2"]):
        with pytest.raises(SystemExit) as e:
            train.main(["--device", "cpu", *flags])
        assert e.value.code == 2 and "pass --trace" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        train.main(["--device", "cpu", "--trace", "--trace-steps", "-1"])


@pytest.mark.parametrize("steps,in_window", [(6, False), (4, True)])
def test_profile_dir_writes_a_trace_and_emits_profile_done(tmp_path, steps, in_window):
    """Two or more steady chunks: the last is profiled outside the timed
    window; one: the profile covers it, and says so."""
    prof = tmp_path / "profile"
    events = run(tmp_path, "tf_operator_tpu_torch.models.train", [
        "--device", "cpu", "--model", "mnist-mlp", "--batch", "8", "--log-every", "2",
        "--steps", str(steps), "--profile-dir", str(prof)], "p")
    done = [e for e in events if e["event"] == "profile_done"]
    assert len(done) == 1 and done[0]["dir"] == str(prof)
    assert done[0]["in_timed_window"] is in_window and done[0]["steps_traced"] == 2
    start = [e for e in events if e["event"] == "profile_start"]
    assert start == [{"event": "profile_start", "dir": str(prof / "local-0")}]
    trace = json.loads((prof / "local-0" / "trace.json").read_text())
    assert trace["traceEvents"]
    names = [e["event"] for e in events]
    assert names.index("profile_done") < names.index("done")
