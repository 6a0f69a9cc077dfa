"""A port pod drives every device it is given (parallel/launch.py), on CPU.

The JAX trainer is one process a pod over `jax.local_devices()`; a port
pod of N local ranks is N processes under the pod supervisor, ranked
p * N + i in a world of P * N. Here the supervisor is given its count
through the explicit API (tests/torch_dist.py's run_pods; on the CPU the
visible count is 1), the ranks share the CPU over gloo, torch runs one
thread and the LM at f32, as the other multi-process tests do. Held:

  (a) the rank map, the devices round-robin and the mesh: a {"dp": 2,
      "tp": 2} grid over 2 pods x 2 ranks keeps each tp group in one pod;
  (b) 2 pods x 2 ranks equal 4 pods x 1 rank bit for bit (loss and global
      gradient norm at every step): they are the same ranks;
  (c) one pod x 4 ranks follows the JAX package's SPMD step on a 4-device
      CPU mesh at {"dp": 2, "tp": 2} (tests/test_torch_dist_jax.py's
      comparison and tolerances);
  (d) under --data-dir each rank trains on the rows the JAX reader of its
      pod places on the pod's device of the same index;
  (e) one event stream a pod: one jax_ready, first_step (n_devices 4) and
      done in its metrics file, no event on the other ranks' output;
  (f) a SIGTERM to the supervisor exits 143 with one `preempted` event and
      one emergency checkpoint, and the restart ends on the uninterrupted
      losses;
  (g) a SIGKILL of local rank 1 exits the pod 137 and leaves no rank, and
      the ranks of a SIGKILLed supervisor die with it;
  (h) pods that see different counts are refused, naming both;
  (i) a 2-slice job of one pod x 2 ranks a slice follows one process.

Then the manifest that asks for GPUs (examples/torch-gpu-pods-lm.yaml)
through the operator's controller, and prespawn for port pods: the
port's preload list calls no CUDA function, and a LocalSession pod forked
from a zygote that preloaded it trains to its done event.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP
from test_torch_dist_jax import BATCH, CHANGE_GAP, LR, STEPS, T, _batches, _jax_run, _PORT_RANK
from torch_dist import (
    PY,
    ROOT,
    assert_ok,
    assert_same_tensors,
    change_gap,
    free_port,
    progress_losses,
    read_events,
    run_pods,
    run_world,
    start_pod,
)

from tf_operator_tpu.api import compat, validation
from tf_operator_tpu.data import dataset as jdataset
from tf_operator_tpu.models import transformer as jtfm
from tf_operator_tpu_torch.models import checkpoint as ckpt
from tf_operator_tpu_torch.models import transformer as tfm
from tf_operator_tpu_torch.parallel import distributed, launch
from tf_operator_tpu_torch.parallel import mesh as mesh_lib

MNIST = ["--model", "mnist-mlp", "--device", "cpu", "--steps", "4", "--batch", "8",
         "--log-every", "1"]
LM = ["--model", "transformer-lm", "--device", "cpu", "--steps", "3", "--batch", "4",
      "--seq", "32", "--layers", "2", "--hidden", "32", "--heads", "2", "--log-every", "1"]


def steps(argv: list[str], n: int) -> list[str]:
    """argv with --steps n."""
    i = argv.index("--steps")
    return argv[:i + 1] + [str(n)] + argv[i + 2:]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- (a) the rank map


def test_rank_map_and_mesh_keep_tp_groups_inside_pods():
    pod_env = {"JAX_NUM_PROCESSES": "2", "TPUJOB_METRICS_FILE": "m.jsonl",
               "TPUJOB_HEARTBEAT_FILE": "hb", "JAX_COORDINATOR_ADDRESS": "c:1"}
    ranks = {}
    for p in range(2):
        for i in range(2):
            env = launch.rank_env({**pod_env, "JAX_PROCESS_ID": str(p)}, i, 2, ["GPU-a", "GPU-b"])
            assert (env["JAX_NUM_PROCESSES"], env["TPUJOB_POD_NUM_PROCESSES"]) == ("4", "2")
            assert (env["TPUJOB_POD_PROCESS_ID"], env["TPUJOB_LOCAL_RANK"],
                    env["TPUJOB_LOCAL_RANKS"]) == (str(p), str(i), "2")
            assert env["CUDA_VISIBLE_DEVICES"] == ["GPU-a", "GPU-b"][i]
            assert env["JAX_COORDINATOR_ADDRESS"] == "c:1"
            # One event stream a pod: local rank 0's.
            assert ("TPUJOB_METRICS_FILE" in env, "TPUJOB_HEARTBEAT_FILE" in env) == (i == 0,) * 2
            ranks[int(env["JAX_PROCESS_ID"])] = p
    assert ranks == {0: 0, 1: 0, 2: 1, 3: 1}
    grid = mesh_lib.Mesh(mesh_lib.check_axes({"tp": 2, "dp": 2}, 4)).grid
    assert grid.tolist() == [[0, 1], [2, 3]]
    for tp_group in grid:  # the ranks that differ only along tp
        assert len({ranks[int(r)] for r in tp_group}) == 1
    for dp_group in grid.T:
        assert len({ranks[int(r)] for r in dp_group}) == 2
    # An explicit count past the visible devices shares them round-robin.
    assert [launch.rank_env({}, i, 3, ["0"])["CUDA_VISIBLE_DEVICES"] for i in range(3)] == \
        ["0"] * 3
    assert "CUDA_VISIBLE_DEVICES" not in launch.rank_env({}, 1, 2, [])


def test_visible_devices_honour_cuda_visible_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert distributed.visible_devices() == ["0", "1"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3, GPU-x ,1")
    assert distributed.visible_devices() == ["3", "GPU-x"]
    assert distributed.local_device_count("cuda") == 2
    assert distributed.local_device_count("cpu") == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert distributed.local_device_count("cuda") == 1  # fails later, on its own


def test_one_device_pod_trains_in_process(monkeypatch):
    """With one local rank (the CPU's count), main never enters the
    supervisor."""
    from tf_operator_tpu_torch.models import train

    def refuse(*_args, **_kwargs):
        raise AssertionError("the supervisor ran")

    monkeypatch.setattr(launch, "run_pod", refuse)
    for key in ("JAX_PROCESS_ID", "JAX_NUM_PROCESSES", "JAX_COORDINATOR_ADDRESS",
                "TPUJOB_MESH", "TPUJOB_METRICS_FILE", "TPUJOB_HEARTBEAT_FILE"):
        monkeypatch.delenv(key, raising=False)
    assert train.main(steps(MNIST, 1)) == 0


def test_local_ranks_name_their_traces_and_the_evaluator_stays_one(monkeypatch):
    """Local rank 0 keeps the pod's trace/profile name, the others add
    their own suffix; --eval (and a process that is already a rank) runs
    one process whatever count it is given."""
    from tf_operator_tpu_torch.models import train

    monkeypatch.setenv("TPUJOB_REPLICA_TYPE", "worker")
    monkeypatch.setenv("TPUJOB_REPLICA_INDEX", "1")
    monkeypatch.delenv("TPUJOB_LOCAL_RANK", raising=False)
    assert train._rank() == "worker-1"
    ap = train.build_parser()
    assert train._local_ranks(ap.parse_args(MNIST), 4) == 4
    assert train._local_ranks(ap.parse_args(MNIST + ["--eval"]), 4) == 1
    monkeypatch.setenv("TPUJOB_LOCAL_RANK", "0")
    assert train._rank() == "worker-1"
    assert train._local_ranks(ap.parse_args(MNIST), 4) == 1
    monkeypatch.setenv("TPUJOB_LOCAL_RANK", "3")
    assert train._rank() == "worker-1-local3"


# ---------------------------------------- (b) pods are renumbered ranks

# A rank of the trainer at f32 that records every step's global gradient
# norm and writes it, with its exit code, to argv[1].<global rank>.
_NORMS = """
import json, os, sys, torch
from tf_operator_tpu_torch.models import train
from tf_operator_tpu_torch.parallel import train_step as ts
train.COMPUTE_DTYPE = torch.float32
norms, real = [], ts.train_step
def train_step(*args, **kwargs):
    state, metrics = real(*args, **kwargs)
    norms.append(float(metrics["grad_norm"]))
    return state, metrics
ts.train_step = train_step
rc = train.main(sys.argv[2:])
with open(sys.argv[1] + "." + os.environ.get("JAX_PROCESS_ID", "0"), "w") as f:
    json.dump({"rc": rc, "norms": norms}, f)
sys.exit(rc)
"""


def test_two_pods_of_two_equal_four_pods_of_one(tmp_path):
    mesh = {"dp": 2, "tp": 2}
    pods = run_pods(tmp_path, [str(tmp_path / "pods"), *LM], 2, 2, mesh, code=_NORMS)
    world = run_world(tmp_path, [str(tmp_path / "world"), *LM], 4, mesh, tag="world",
                      code=_NORMS)
    assert_ok(pods + world)
    want = progress_losses(world[0]["events"])
    assert sorted(want) == [2, 3]
    for r in pods + world:
        assert progress_losses(r["events"]) == want  # bit for bit
    norms = [json.loads((tmp_path / f"{tag}.{rank}").read_text())["norms"]
             for tag in ("pods", "world") for rank in range(4)]
    assert len(norms[0]) == 3 and all(n == norms[0] for n in norms)


# ------------------------------------------------ (c) against the JAX step


def test_pod_of_four_ranks_follows_the_jax_spmd_step(tmp_path):
    mesh = {"dp": 2, "tp": 2}
    jmodel = jtfm.TransformerLM(dataclasses.replace(jtfm.TINY_LM, dtype=jnp.float32))
    params = jax.tree.map(np.array, jmodel.init(jax.random.key(0),
                                                jnp.zeros((1, T), jnp.int32))["params"])
    start = tfm.params_from_flax(params)
    torch.save(start, tmp_path / "init.pt")
    np.save(tmp_path / "batches.npy", _batches())
    pod = run_pods(tmp_path, [str(tmp_path / "init.pt"), str(tmp_path / "batches.npy"),
                              str(tmp_path / "port.pt"), str(LR)], 1, 4, mesh,
                   code=_PORT_RANK)
    assert_ok(pod)
    port = torch.load(tmp_path / "port.pt", weights_only=False)
    losses, norms, final = _jax_run(jmodel, params, mesh)
    assert BATCH % 2 == 0 and losses[-1] < losses[0]
    np.testing.assert_allclose(port["losses"], losses, rtol=1e-4)
    np.testing.assert_allclose(port["norms"], norms, rtol=1e-4)
    assert_same_tensors(port["params"], final, LR, STEPS, in_norm=False)
    assert change_gap(port["params"], final,
                      {k: v.double().numpy() for k, v in start.items()}) <= CHANGE_GAP


# --------------------------------------------------------- (d) --data-dir

# A rank of the trainer that saves the images of every step's batch to
# argv[1].<global rank>.npy.
_ROWS = """
import os, sys, numpy as np, torch
from tf_operator_tpu_torch.models import train
from tf_operator_tpu_torch.parallel import train_step as ts
rows, real = [], ts.train_step
def train_step(state, batch, *args, **kwargs):
    rows.append(batch["x"].numpy().copy())
    return real(state, batch, *args, **kwargs)
ts.train_step = train_step
rc = train.main(sys.argv[2:])
np.save(sys.argv[1] + "." + os.environ["JAX_PROCESS_ID"] + ".npy", np.stack(rows))
sys.exit(rc)
"""


def test_data_dir_ranks_take_their_pods_rows_in_device_order(tmp_path):
    rng = np.random.default_rng(0)
    d = str(tmp_path / "ds")
    jdataset.write_array_shards(d, {
        "x": rng.normal(size=(64, 28, 28)).astype(np.float32),
        "y": rng.integers(0, 10, size=(64,)).astype(np.int32)}, 4)
    n, batch = 3, int(MNIST[MNIST.index("--batch") + 1])
    argv = steps(MNIST, n) + ["--data-dir", d]
    assert_ok(run_pods(tmp_path, [str(tmp_path / "rows"), *argv], 2, 2, code=_ROWS))
    devices = JMesh(np.array(jax.devices()[:2]), ("dp",))
    for p in range(2):
        it = jdataset.ShardedDataset(d, p, 2).batches(batch // 2, seed=0, start_batch=0)
        placed = [jax.device_put(next(it)["x"], NamedSharding(devices, JP("dp")))
                  for _ in range(n)]
        for i, device in enumerate(devices.devices.flat):
            got = np.load(tmp_path / f"rows.{p * 2 + i}.npy")
            want = np.stack([np.asarray(next(s.data for s in a.addressable_shards
                                             if s.device == device)) for a in placed])
            assert got.shape == (n, batch // 4, 28, 28)
            np.testing.assert_array_equal(got, want)


# ------------------------------------------------ (e) one event stream


def test_one_event_stream_a_pod(tmp_path):
    pods = run_pods(tmp_path, LM, 2, 2, {"dp": 2, "tp": 2})
    assert_ok(pods)
    for p, r in enumerate(pods):
        names = [e["event"] for e in r["events"]]
        for name in ("start", "jax_ready", "first_step", "done"):
            assert names.count(name) == 1, names
        first = next(e for e in r["events"] if e["event"] == "first_step")
        assert (first["n_devices"], first["mesh"]) == (4, {"dp": 2, "tp": 2})
        # stdout is local rank 0's events alone; the other rank's lines
        # reach stderr tagged, never as an event.
        lines = [json.loads(x) for x in r["stdout"].splitlines() if x.startswith("{")]
        assert lines == r["events"]
        assert not any(x.startswith("[local rank 1] {") for x in r["stderr"].splitlines())
        assert (tmp_path / f"pod-{p}.heartbeat").exists()


# ----------------------------------------------------- (f) preemption


def test_sigterm_to_the_supervisor_exits_143_with_one_emergency_save(tmp_path):
    ckpt_dir = tmp_path / "ckpt"
    argv = steps(LM, 5) + ["--checkpoint-dir", str(ckpt_dir), "--preempt-grace", "60"]
    proc, metrics = start_pod(tmp_path, argv + ["--chaos", "hang:step=2,duration=6"], 0, 1,
                              2, 0, {"dp": 2}, tag="pre")
    try:
        deadline = time.monotonic() + 120
        while not any(e["event"] == "chaos_hang" for e in read_events(metrics)):
            assert proc.poll() is None and time.monotonic() < deadline, proc.communicate()
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 143, err[-3000:]
    events = read_events(metrics)
    pre = [e for e in events if e["event"] == "preempted"]
    assert len(pre) == 1 and (pre[0]["step"], pre[0]["signal"]) == (2, "SIGTERM")
    assert pre[0]["emergency_checkpoint"] is True
    assert ckpt.list_steps(str(ckpt_dir)) == [2]
    assert [e["event"] for e in events].count("checkpoint") == 1
    proc, metrics = start_pod(tmp_path, argv, 0, 1, 2, 0, {"dp": 2}, tag="restart")
    _, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-3000:]
    restart = read_events(metrics)
    assert next(e for e in restart if e["event"] == "resumed")["from_step"] == 2
    ref = run_pods(tmp_path, steps(LM, 5), 1, 2, {"dp": 2}, tag="ref")
    assert_ok(ref)
    got, want = progress_losses(restart), progress_losses(ref[0]["events"])
    got[3] = next(e for e in restart if e["event"] == "first_step")["loss"]
    assert sorted(got) == [3, 4, 5] and all(got[s] == want[s] for s in got), (got, want)


# ------------------------------------------------------ (g) a rank's death

# The trainer pod of _F32_POD whose ranks write their pids to
# $POD_PIDS/<local rank>; local rank $POD_KILL_RANK SIGKILLs itself at step 2.
_PIDS_POD = """
import os, sys, torch
from tf_operator_tpu_torch.models import train
train.COMPUTE_DTYPE = torch.float32
rank = os.environ.get("TPUJOB_LOCAL_RANK")
if rank is not None:
    with open(os.path.join(os.environ["POD_PIDS"], rank), "w") as f:
        f.write(str(os.getpid()))
    if rank == os.environ.get("POD_KILL_RANK"):
        os.environ["TPUJOB_CHAOS"] = "kill:step=2,signal=KILL"
sys.exit(train.main(sys.argv[2:], local_ranks=int(sys.argv[1])))
"""


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_sigkill_of_local_rank_1_exits_the_pod_137_and_leaves_no_rank(tmp_path):
    pids = tmp_path / "pids"
    pids.mkdir()
    proc, metrics = start_pod(tmp_path, steps(MNIST, 40), 0, 1, 2, 0,
                              {"dp": 2}, tag="kill",
                              env={"POD_PIDS": str(pids), "POD_KILL_RANK": "1"},
                              pod_code=_PIDS_POD)
    try:
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 137, err[-3000:]
    ranks = {p.name: int(p.read_text()) for p in pids.iterdir()}
    assert sorted(ranks) == ["0", "1"]
    deadline = time.monotonic() + 10
    while any(_alive(pid) for pid in ranks.values()) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not any(_alive(pid) for pid in ranks.values())
    assert not any(e["event"] == "done" for e in read_events(metrics))


def test_ranks_die_with_their_supervisor(tmp_path):
    """A SIGKILL of the supervisor (which forwards nothing) takes its ranks
    with it: PR_SET_PDEATHSIG, set by each rank as it joins the world."""
    pids = tmp_path / "pids"
    pids.mkdir()
    proc, metrics = start_pod(tmp_path, steps(MNIST, 10000), 0, 1, 2, 0, {"dp": 2},
                              tag="orphan", env={"POD_PIDS": str(pids)}, pod_code=_PIDS_POD)
    try:
        deadline = time.monotonic() + 120
        while not any(e["event"] == "first_step" for e in read_events(metrics)):
            assert proc.poll() is None and time.monotonic() < deadline, proc.communicate()
            time.sleep(0.05)
        proc.kill()
        proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    ranks = [int(p.read_text()) for p in pids.iterdir()]
    assert len(ranks) == 2
    deadline = time.monotonic() + 10
    while any(_alive(pid) for pid in ranks) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not any(_alive(pid) for pid in ranks)


# ------------------------------------------------- (h) counts must agree


def test_pods_that_see_different_counts_are_refused(tmp_path):
    port = free_port()
    procs = [start_pod(tmp_path, MNIST, p, 2, n, port, tag="mismatch")
             for p, n in ((0, 2), (1, 1))]
    out = []
    try:
        for proc, _ in procs:
            out.append(proc.communicate(timeout=120))
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert all(proc.returncode not in (0, None) for proc, _ in procs)
    assert "pod 1 runs 1 local rank(s) and pod 0 runs 2" in out[0][1], out[0][1][-3000:]


# ------------------------------------------------------ (i) multi-slice


def test_two_slices_of_one_pod_of_two_ranks_follow_one_process(tmp_path):
    dcn = tmp_path / "dcn"
    dcn.mkdir()
    argv = steps(LM, 4)
    argv[argv.index("--batch") + 1] = "8"  # 2 slices x 2 microbatches x dp 2
    procs = [start_pod(tmp_path, argv, 0, 1, 2, 0, {"dp": 2}, tag=f"slice{sid}", env={
        "TPUJOB_NUM_SLICES": "2", "TPUJOB_SLICE_ID": str(sid), "TPUJOB_DCN_DIR": str(dcn),
        "TPUJOB_REPLICA_TYPE": "worker", "TPUJOB_REPLICA_INDEX": str(sid)})
        for sid in range(2)]
    slices = []
    try:
        for proc, metrics in procs:
            _, err = proc.communicate(timeout=240)
            slices.append({"rc": proc.returncode, "events": read_events(metrics),
                           "stderr": err})
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    one = run_world(tmp_path, argv, 1, tag="one")
    assert_ok(slices + one)
    want = progress_losses(one[0]["events"])
    assert sorted(want) == [2, 3, 4]
    for sid, r in enumerate(slices):
        got = progress_losses(r["events"])
        np.testing.assert_allclose([got[s] for s in want], list(want.values()), rtol=1e-5)
        first = next(e for e in r["events"] if e["event"] == "first_step")
        assert (first["slices"], first["slice_id"], first["n_devices"]) == (2, sid, 2)
    # One exchange a rank pair, named by the slice-local global rank.
    assert sorted(os.listdir(dcn)) == ["rank0", "rank1"]


# ------------------------------------------------ the GPU-requesting manifest


def test_gpu_manifest_renders_gpu_pods_without_a_tpu_request():
    from tf_operator_tpu.core.cluster import InMemoryCluster
    from tf_operator_tpu.core.trainjob_controller import TrainJobController

    job = compat.job_from_yaml((ROOT / "examples" / "torch-gpu-pods-lm.yaml").read_text())
    assert validation.validate_job(job) == []
    cluster = InMemoryCluster()
    controller = TrainJobController(cluster, enable_gang=False)
    cluster.create_job(job)
    assert controller.run_until_idle(10.0)
    pods = sorted(cluster.list_pods("default"), key=lambda p: p.name)
    assert [p.name for p in pods] == ["torch-gpu-pods-lm-worker-0",
                                      "torch-gpu-pods-lm-worker-1"]
    for p, pod in enumerate(pods):
        container = pod.spec.containers[0]
        assert container.resources == {"nvidia.com/gpu": 4}
        env = container.env_dict()
        assert (env["JAX_NUM_PROCESSES"], env["JAX_PROCESS_ID"]) == ("2", str(p))
        mesh = json.loads(env["TPUJOB_MESH"])
        assert mesh == {"dp": 2, "tp": 4} and int(np.prod(list(mesh.values()))) == 2 * 4
        assert container.command[:3] == ["python", "-m", "tf_operator_tpu_torch.models.train"]


# ------------------------------------------------------------- prespawn


def test_port_preload_list_calls_no_cuda_function():
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "def refuse(*a, **k):\n"
        "    raise RuntimeError('a CUDA function was called')\n"
        "for name in ('is_available', 'device_count', '_lazy_init'):\n"
        "    setattr(torch.cuda, name, refuse)\n"
        "from tf_operator_tpu_torch.parallel.launch import PRESPAWN_PRELOAD\n"
        "mods = PRESPAWN_PRELOAD.split(',')\n"
        "assert mods[:2] == ['torch', 'numpy'], mods\n"
        "for mod in mods:\n"
        "    __import__(mod)\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('clean')\n")
    proc = subprocess.run([PY, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "clean", proc.stderr[-3000:]


def test_local_session_pod_forked_from_the_port_zygote_trains(tmp_path, monkeypatch):
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

    monkeypatch.setenv("TPUJOB_PRESPAWN", "1")
    monkeypatch.setenv("TPUJOB_PRESPAWN_PRELOAD", launch.PRESPAWN_PRELOAD)
    session = LocalSession(env_overrides={"PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"},
                           log_dir=str(tmp_path / "logs"))
    try:
        assert session.runtime.prewarm(timeout=120), "the zygote did not warm"
        ping = session.runtime._supervisor.client.request({"ping": True})
        assert ping["preloaded"] == launch.PRESPAWN_PRELOAD.split(",")
        container = ContainerSpec(
            name="tensorflow", image="local",
            command=[sys.executable, "-m", "tf_operator_tpu_torch.models.train", *MNIST])
        job = TrainJob(metadata=ObjectMeta(name="torch-prespawn"), spec=TrainJobSpec(
            replica_specs={defaults.canonical_replica_type("worker"): ReplicaSpec(
                replicas=1, restart_policy=RestartPolicy.EXIT_CODE,
                template=PodTemplateSpec(containers=[container]))}))
        job.spec.run_policy.scheduling.gang = False
        session.submit(defaults.set_defaults(job))
        done = session.wait_for_condition(
            "default", "torch-prespawn",
            (JobConditionType.SUCCEEDED, JobConditionType.FAILED), timeout=180)
    finally:
        session.close()
    assert is_succeeded(done.status), [(str(c.type), c.reason, c.message)
                                       for c in done.status.conditions]
    events = read_events(tmp_path / "logs" / "default_torch-prespawn-worker-0.metrics.jsonl")
    assert [e["event"] for e in events].count("done") == 1
