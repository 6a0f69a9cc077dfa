"""Fault injection in the PyTorch port (chaos/), on CPU.

The port keeps its own copy of the chaos grammar: on a table of valid
specs its parse_chaos gives the JAX one's directives, and both refuse the
same invalid specs with the same message. One-shot markers hold across
processes. In the port trainer, `torn:step=N` damages the save of step N so
that the restart's resume walk skips it (`resume_fallback`), `hang:step=N`
emits `chaos_hang`, and the operator's own kinds leave a run untouched.

The A6 gate, ported from tests/test_chaos.py's kill -> restart -> resume
capstone: a LocalSession TrainJob whose Worker runs the port trainer
(`--device cpu`) under `--chaos kill:step=12,signal=TERM` and the ExitCode
restart policy reaches Succeeded; the first pod exits 143 after one
`preempted` event, the second resumes from step 12, retention holds, and
the loss trajectory is the uninterrupted port run's, bit for bit. Trainer
pods run at one thread (OMP_NUM_THREADS=1; tests/test_torch_preemption.py
says why).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tf_operator_tpu import chaos as jchaos
from tf_operator_tpu.api import defaults
from tf_operator_tpu.api.types import (
    ContainerSpec,
    JobConditionType,
    ObjectMeta,
    PodTemplateSpec,
    ReplicaSpec,
    RestartPolicy,
    TrainJob,
    TrainJobSpec,
    is_succeeded,
)
from tf_operator_tpu.runtime.session import LocalSession
from tf_operator_tpu_torch import chaos
from tf_operator_tpu_torch.models import checkpoint as ckpt
from tf_operator_tpu_torch.models import train


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module's tests and fixtures
    (tests/test_torch_flash_attention.py
    says why: a first multi-threaded torch.exp can be off by 1.5e-4, which
    bit-for-bit checks would see)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
PY = sys.executable

VALID = [
    "",
    "kill:step=12,signal=TERM",
    "kill:step=5,signal=SIGKILL,replica=worker,index=1",
    "kill:step=3,signal=9,slice=1",
    "hang:step=4",
    "hang:step=4,duration=2.5,replica=chief",
    "torn:step=8",
    "torn:step=8,mode=unlink",
    "stall:batch=3,delay=0.2",
    "stall:every=2,delay=0.1,lane=1",
    "stall:lane=0,delay=0.5",
    "stall:ckpt=4,delay=1",
    "apiserver:errors=2,code=503,latency=0.1,match=PATCH /apis",
    "preempt:step=10,job=lm,namespace=team",
    "capacity:slices=2",
    "capacity:slices=1,at_step=5,job=lm",
    " kill:step=1 ; torn:step=2,mode=truncate ;stall:ckpt=2,delay=0.5",
]
INVALID = [
    "explode:step=1", "kill", "kill:step=x", "kill:step=1,signal=NOPE", "kill:step=1,bogus=2",
    "kill:step", "hang:step=1,duration=0", "kill:step=1,index=-1", "torn:step=1,mode=shred",
    "torn:mode=unlink", "stall:delay=1", "stall:batch=1,every=2,delay=1",
    "stall:ckpt=1,lane=0,delay=1", "stall:ckpt=0,delay=1", "stall:every=0,delay=1",
    "stall:batch=1", "apiserver:errors=-1", "preempt:step=1", "capacity:at_step=2,slices=1",
    "capacity:slices=-1",
]


@pytest.mark.parametrize("spec", VALID)
def test_parse_agrees_with_jax(spec):
    got = [(d.kind, d.params, d.id) for d in chaos.parse_chaos(spec)]
    want = [(d.kind, d.params, d.id) for d in jchaos.parse_chaos(spec)]
    assert got == want


@pytest.mark.parametrize("spec", INVALID)
def test_both_refuse_an_invalid_spec(spec):
    with pytest.raises(ValueError) as port_err:
        chaos.parse_chaos(spec)
    with pytest.raises(ValueError) as jax_err:
        jchaos.parse_chaos(spec)
    assert str(port_err.value) == str(jax_err.value)


def test_signals_parse_as_jax():
    for name in ("TERM", "SIGTERM", "15", "kill", "USR1", "INT"):
        assert chaos.parse_signal(name) == jchaos.parse_signal(name)


def test_replica_filters_match_as_jax():
    env = {"TPUJOB_REPLICA_TYPE": "Worker", "TPUJOB_REPLICA_INDEX": "1",
           "TPUJOB_SLICE_ID": "0"}
    for spec in VALID[1:7]:
        for d_port, d_jax in zip(chaos.parse_chaos(spec), jchaos.parse_chaos(spec)):
            for e in (env, {}):
                assert chaos.replica_matches(d_port, e) == jchaos.replica_matches(d_jax, e)


def test_one_shot_state_holds_across_processes(tmp_path):
    state_dir = tmp_path / "state"
    code = ("import sys; sys.path.insert(0, sys.argv[1])\n"
            "from tf_operator_tpu_torch import chaos\n"
            "d = chaos.parse_chaos('kill:step=5,signal=TERM')[0]\n"
            "s = chaos.OneShotState(sys.argv[2])\n"
            "assert not s.fired(d)\n"
            "s.mark(d)\n")
    subprocess.run([PY, "-c", code, str(ROOT), str(state_dir)], check=True, timeout=60)
    d = chaos.parse_chaos("kill:step=5,signal=TERM")[0]
    assert chaos.OneShotState(str(state_dir)).fired(d)
    assert not chaos.OneShotState(str(tmp_path / "other")).fired(d)
    # The marker is the JAX package's: either side sees the other's.
    assert jchaos.OneShotState(str(state_dir)).fired(jchaos.parse_chaos(
        "kill:step=5,signal=TERM")[0])
    # TrainerChaos with a state dir fires a kill once across generations.
    env = {"TPUJOB_CHAOS": "hang:step=2", "TPUJOB_CHAOS_STATE": str(state_dir)}
    first = chaos.TrainerChaos.from_env(env)
    assert first.hang_at(2, 0) is not None
    assert chaos.TrainerChaos.from_env(env).hang_at(2, 0) is None


def test_trainer_chaos_fires_once_and_not_past_a_resume():
    tc = chaos.TrainerChaos(chaos.parse_chaos("hang:step=4;torn:step=6"))
    assert tc.hang_at(3, 0) is None
    assert tc.hang_at(4, 0) is not None and tc.hang_at(6, 0) is None
    assert chaos.TrainerChaos(chaos.parse_chaos("hang:step=4")).hang_at(8, 4) is None
    assert tc.tear_for_step(6) is not None and tc.tear_for_step(4) is None
    assert chaos.TrainerChaos.from_env({"TPUJOB_CHAOS": "apiserver:errors=1"}) is None


LM = ["--device", "cpu", "--model", "transformer-lm", "--batch", "2", "--seq", "32",
      "--layers", "2", "--hidden", "64", "--heads", "2", "--log-every", "2"]


def _events(tmp_path, monkeypatch, argv, tag):
    path = tmp_path / f"{tag}.jsonl"
    monkeypatch.setenv("TPUJOB_METRICS_FILE", str(path))
    monkeypatch.delenv("TPUJOB_CHAOS", raising=False)
    rc = train.main(argv)
    return rc, [json.loads(x) for x in path.read_text().splitlines()]


@pytest.mark.parametrize("mode", ["truncate", "unlink"])
def test_torn_step_leads_to_resume_fallback(tmp_path, monkeypatch, mode):
    d = str(tmp_path / "ckpt")
    flags = LM + ["--checkpoint-dir", d, "--checkpoint-every", "2"]
    rc, events = _events(tmp_path, monkeypatch, flags + ["--steps", "4", "--chaos",
                                                         f"torn:step=4,mode={mode}"], "a")
    assert rc == 0
    torn = [e for e in events if e["event"] == "chaos_torn_checkpoint"]
    assert [e["step"] for e in torn] == [4]
    assert not ckpt.validate_step(d, 4) and ckpt.validate_step(d, 2)
    rc, events = _events(tmp_path, monkeypatch, flags + ["--steps", "6"], "b")
    assert rc == 0
    fallback = [e for e in events if e["event"] == "resume_fallback"]
    assert fallback == [{"event": "resume_fallback", "skipped_step": 4,
                         "reason": "invalid_checkpoint"}]
    assert [e["from_step"] for e in events if e["event"] == "resumed"] == [2]
    assert os.environ.get("TPUJOB_CHAOS") is None  # main restored the env


def test_hang_emits_chaos_hang_and_goes_on(tmp_path, monkeypatch):
    rc, events = _events(tmp_path, monkeypatch,
                         LM + ["--steps", "4", "--chaos", "hang:step=2,duration=0.3"], "h")
    assert rc == 0
    assert [e for e in events if e["event"] == "chaos_hang"] == [
        {"event": "chaos_hang", "step": 2, "duration": 0.3}]
    assert events[-1]["event"] == "done" and events[-1]["steps"] == 4


def test_operator_kinds_leave_the_trainer_alone(tmp_path, monkeypatch):
    spec = "apiserver:errors=2,code=503;preempt:step=1,job=x;capacity:slices=1;stall:every=1,delay=5"
    rc, events = _events(tmp_path, monkeypatch, LM + ["--steps", "2", "--chaos", spec], "o")
    assert rc == 0 and events[-1]["event"] == "done"


def test_a_typo_in_the_spec_exits_2(capsys):
    with pytest.raises(SystemExit) as e:
        train.main(LM + ["--steps", "2", "--chaos", "kill:stpe=2"])
    assert e.value.code == 2 and "unknown key 'stpe'" in capsys.readouterr().err


# ------------------------------------------------------------ the A6 gate

STEPS = 24
POD_ENV = {"PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}


def trainer_cmd(*extra: str) -> list[str]:
    return [PY, "-m", "tf_operator_tpu_torch.models.train", "--device", "cpu", "--model",
            "mnist-mlp", "--steps", str(STEPS), "--batch", "16", "--log-every", "4", *extra]


def read_events(path) -> list[dict]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def progress_losses(events: list[dict]) -> dict[int, float]:
    return {e["step"]: e["loss"] for e in events if e["event"] == "progress"}


def make_job(name: str, cmd: list[str]) -> TrainJob:
    job = TrainJob(
        metadata=ObjectMeta(name=name),
        spec=TrainJobSpec(replica_specs={
            defaults.canonical_replica_type("worker"): ReplicaSpec(
                replicas=1, restart_policy=RestartPolicy.EXIT_CODE,
                template=PodTemplateSpec(containers=[
                    ContainerSpec(name="tensorflow", image="local", command=cmd)]),
            ),
        }),
    )
    job.spec.run_policy.scheduling.gang = False
    return defaults.set_defaults(job)


@pytest.fixture
def session(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUJOB_PRESPAWN", "0")
    s = LocalSession(env_overrides=dict(POD_ENV), log_dir=str(tmp_path / "logs"))
    yield s
    s.close()


def test_kill_restart_resume_through_the_operator(session, tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    job = make_job("torch-chaos", trainer_cmd(
        "--checkpoint-dir", ckpt_dir, "--checkpoint-every", "8", "--keep-checkpoints", "2",
        "--preempt-grace", "60", "--chaos", "kill:step=12,signal=TERM"))
    session.submit(job)
    job = session.wait_for_condition(
        "default", "torch-chaos", (JobConditionType.SUCCEEDED, JobConditionType.FAILED),
        timeout=240)
    assert is_succeeded(job.status), [(str(c.type), c.reason, c.message)
                                      for c in job.status.conditions]
    ev = read_events(tmp_path / "logs" / "default_torch-chaos-worker-0.metrics.jsonl")
    pre = [e for e in ev if e["event"] == "preempted"]
    assert len(pre) == 1
    assert (pre[0]["step"], pre[0]["exit_code"], pre[0]["signal"]) == (12, 143, "SIGTERM")
    assert pre[0]["emergency_checkpoint"] is True
    resumed = [e for e in ev if e["event"] == "resumed"]
    assert len(resumed) == 1 and resumed[0]["from_step"] == 12
    dones = [e for e in ev if e["event"] == "done"]
    assert dones and dones[-1]["steps"] == STEPS
    events = session.cluster.events_for("TrainJob", "default", "torch-chaos")
    assert any(e.reason == "ExitedWithCode" and "143" in e.message for e in events)
    kept = ckpt.list_steps(ckpt_dir)
    assert len(kept) <= 2 and kept[-1] == STEPS and ckpt.final_step(ckpt_dir) == STEPS

    metrics = tmp_path / "reference.jsonl"
    env = dict(os.environ, **POD_ENV, TPUJOB_METRICS_FILE=str(metrics))
    env.pop("TPUJOB_CHAOS", None)
    r = subprocess.run(trainer_cmd(), capture_output=True, text=True, timeout=240, env=env,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    ref_events = read_events(metrics)
    ref, got = progress_losses(ref_events), progress_losses(ev)
    common = sorted(set(ref) & set(got))
    assert STEPS in common and len(common) >= 2, (ref, got)
    assert all(got[s] == ref[s] for s in common), (got, ref)
    assert dones[-1]["final_loss"] == [e for e in ref_events if e["event"] == "done"][-1][
        "final_loss"]
