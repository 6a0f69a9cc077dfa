"""A9's gate, part 2: a gang of the PyTorch port's trainer through the operator.

The port's counterpart of tests/test_gang_recovery.py's
TestGangKillRestartResumeE2E: a LocalSession TrainJob of two Workers, mesh
{dp: 2}, each pod running the port trainer (`--device cpu`, mnist-mlp,
checkpoints every 8 steps) under `kill:step=12,signal=KILL,index=1`. The
operator injects JAX_COORDINATOR_ADDRESS, JAX_PROCESS_ID, JAX_NUM_PROCESSES
and TPUJOB_MESH; the two pods join one gloo world. Worker 1 is SIGKILLed at
step 12; worker 0 exits 138 (retryable) when its next collective fails, or
is stopped by the roll first. The controller rolls both pods exactly once,
both resume from the step-8 checkpoint worker 0 wrote, and the job finishes
on the losses of an uninterrupted 2-Worker job run beside it (rtol 1e-3).
The test's time limit is the 240 s it waits for each job.
"""

import os
import sys
from pathlib import Path

import pytest
from torch_dist import progress_losses, read_events

from tf_operator_tpu.api import defaults
from tf_operator_tpu.api.types import (
    ContainerSpec,
    JobConditionType,
    MeshSpec,
    ObjectMeta,
    PodTemplateSpec,
    ReplicaSpec,
    ReplicaType,
    RestartPolicy,
    TrainJob,
    TrainJobSpec,
    is_succeeded,
)
from tf_operator_tpu.runtime.session import LocalSession

ROOT = Path(__file__).resolve().parents[1]
STEPS = 24
DONE = (JobConditionType.SUCCEEDED, JobConditionType.FAILED)


def trainer_cmd(ckpt: str, *extra: str) -> list[str]:
    return [sys.executable, "-m", "tf_operator_tpu_torch.models.train", "--device", "cpu",
            "--model", "mnist-mlp", "--steps", str(STEPS), "--batch", "16", "--log-every",
            "4", "--checkpoint-dir", ckpt, "--checkpoint-every", "8", *extra]


def make_job(name: str, cmd: list[str]) -> TrainJob:
    job = TrainJob(metadata=ObjectMeta(name=name), spec=TrainJobSpec(replica_specs={
        ReplicaType.WORKER: ReplicaSpec(
            replicas=2, restart_policy=RestartPolicy.EXIT_CODE,
            template=PodTemplateSpec(containers=[
                ContainerSpec(name="tensorflow", image="local", command=cmd)])),
    }))
    job.spec.run_policy.scheduling.gang = False
    job.spec.run_policy.recovery.policy = "gang"
    job.spec.mesh = MeshSpec(axes={"dp": 2})
    return defaults.set_defaults(job)


@pytest.fixture
def session(tmp_path, monkeypatch):
    # Subprocess pods (no prespawned image); the chaos state dir keeps the
    # kill one-shot across the roll, which resumes before step 12.
    monkeypatch.setenv("TPUJOB_PRESPAWN", "0")
    s = LocalSession(env_overrides={"PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
                                    "TPUJOB_CHAOS_STATE": str(tmp_path / "chaos-state")},
                     log_dir=str(tmp_path / "logs"))
    yield s
    s.close()


def pod_events(tmp_path, pod: str) -> list[dict]:
    return read_events(os.path.join(tmp_path, "logs", f"default_{pod}.metrics.jsonl"))


def test_kill_one_worker_rolls_both(session, tmp_path):
    session.submit(make_job("tgangkill", trainer_cmd(
        str(tmp_path / "ckpt"), "--chaos", "kill:step=12,signal=KILL,index=1")))
    session.submit(make_job("tgangref", trainer_cmd(str(tmp_path / "ref-ckpt"))))
    job = session.wait_for_condition("default", "tgangkill", DONE, timeout=240)
    assert is_succeeded(job.status), [(str(c.type), c.reason, c.message)
                                      for c in job.status.conditions]
    ref = session.wait_for_condition("default", "tgangref", DONE, timeout=240)
    assert is_succeeded(ref.status), [(str(c.type), c.reason) for c in ref.status.conditions]

    # Both pods rolled exactly once: two process generations each, one gang
    # restart. Worker 0's first generation, if it saw its peer die before
    # the roll stopped it, left retryably (138).
    for idx in (0, 1):
        ev = pod_events(tmp_path, f"tgangkill-worker-{idx}")
        assert [e["event"] for e in ev].count("start") == 2, (idx, [e["event"] for e in ev])
        first = next(e for e in ev if e["event"] == "first_step")
        assert first["mesh"] == {"dp": 2} and first["n_devices"] == 2
    assert len([e for e in session.cluster.events_for("TrainJob", "default", "tgangkill")
                if e.reason == "GangRestart"]) == 1
    assert job.status.gang_restarts == 1
    ev0 = pod_events(tmp_path, "tgangkill-worker-0")
    lost = [e for e in ev0 if e["event"] == "peer_lost"]
    assert len(lost) <= 1 and all(e["exit_code"] == 138 for e in lost)

    # Both resumed from the step-8 checkpoint and finished at the exact step.
    for idx in (0, 1):
        ev = pod_events(tmp_path, f"tgangkill-worker-{idx}")
        resumed = [e for e in ev if e["event"] == "resumed"]
        assert len(resumed) == 1 and resumed[0]["from_step"] == 8, idx
        dones = [e for e in ev if e["event"] == "done"]
        assert len(dones) == 1 and dones[0]["steps"] == STEPS, idx

    # The loss trajectory is the uninterrupted 2-Worker job's.
    ref0 = pod_events(tmp_path, "tgangref-worker-0")
    want, got = progress_losses(ref0), progress_losses(ev0)
    common = sorted(set(want) & set(got))
    assert STEPS in common and len(common) >= 2, (want, got)
    for s in common:
        assert got[s] == pytest.approx(want[s], rel=1e-3), (s, got, want)
    ref_done = [e for e in ref0 if e["event"] == "done"][-1]
    done = [e for e in ev0 if e["event"] == "done"][-1]
    assert done["final_loss"] == pytest.approx(ref_done["final_loss"], rel=1e-3)


def test_sp_job_through_the_operator(session, tmp_path):
    """A TrainJob of two Workers at mesh {sp: 2}: the operator injects
    TPUJOB_MESH, the pods join one world and train the tiny LM with its
    sequence split over the two (ring attention, 3 heads), and the job
    reaches Succeeded with both ranks on the same losses."""
    cmd = [sys.executable, "-m", "tf_operator_tpu_torch.models.train", "--device", "cpu",
           "--model", "transformer-lm", "--layers", "2", "--hidden", "48", "--heads", "3",
           "--seq", "32", "--batch", "2", "--steps", "4", "--log-every", "2"]
    job = make_job("tgangsp", cmd)
    job.spec.mesh = MeshSpec(axes={"sp": 2})
    session.submit(job)
    job = session.wait_for_condition("default", "tgangsp", DONE, timeout=240)
    assert is_succeeded(job.status), [(str(c.type), c.reason, c.message)
                                      for c in job.status.conditions]
    events = [pod_events(tmp_path, f"tgangsp-worker-{idx}") for idx in (0, 1)]
    for ev in events:
        first = next(e for e in ev if e["event"] == "first_step")
        assert first["mesh"] == {"sp": 2} and first["n_devices"] == 2
        assert [e["steps"] for e in ev if e["event"] == "done"] == [4]
    assert progress_losses(events[0]) == progress_losses(events[1])
