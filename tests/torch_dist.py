"""Helpers of the PyTorch port's multi-process tests (tests/test_torch_dist_*.py,
tests/test_torch_pod.py).

`run_world` starts the port trainer as the operator starts a gang's pods:
one process per rank, each with JAX_COORDINATOR_ADDRESS, JAX_PROCESS_ID,
JAX_NUM_PROCESSES and TPUJOB_MESH in its env, at one intra-op thread. With
f32=True the child runs the trainer's entry point with its COMPUTE_DTYPE
set to f32: a 2-process run then differs from one process only in the
order of its f32 sums, which the rtol 1e-4 gates need (in bf16 the two
round partial sums at other places). `change_gap` holds a run's final
parameters against a reference's where the elementwise gates cannot bind
(ResNet; bf16), and a planted fault shows where its limit sits.
`run_pods` starts pods of several local ranks each through the pod
supervisor (parallel/launch.py) with an explicit local rank count.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
PY = sys.executable
_F32_CHILD = ("import sys, torch\n"
              "from tf_operator_tpu_torch.models import train\n"
              "train.COMPUTE_DTYPE = torch.float32\n"
              "sys.exit(train.main(sys.argv[1:]))\n")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def read_events(path) -> list[dict]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def progress_losses(events: list[dict]) -> dict[int, float]:
    return {e["step"]: e["loss"] for e in events if e["event"] == "progress"}


def run_world(tmp: Path, argv: list[str], n: int, mesh: dict | None = None,
              tag: str = "run", f32: bool = True, env: dict | None = None,
              per_rank_env: list[dict] | None = None, timeout: float = 240,
              code: str | None = None, rank_argv: list[list[str]] | None = None) -> list[dict]:
    """The trainer with `argv` in n processes (n = 1: no JAX_* env, as a
    one-process job), or `python -c code argv` when code is given, each rank
    with its `rank_argv` after: [{"rc", "events", "stderr"}] by rank."""
    port = free_port()
    procs = []
    for rank in range(n):
        metrics = tmp / f"{tag}-{rank}.jsonl"
        metrics.unlink(missing_ok=True)
        child_env = {k: v for k, v in os.environ.items()
                     if not k.startswith(("JAX_", "TPUJOB_"))}
        child_env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                         TPUJOB_METRICS_FILE=str(metrics), **(env or {}))
        if n > 1:
            child_env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                             JAX_PROCESS_ID=str(rank), JAX_NUM_PROCESSES=str(n))
        if mesh is not None:
            child_env["TPUJOB_MESH"] = json.dumps(mesh)
        if per_rank_env:
            child_env.update(per_rank_env[rank])
        head = ([PY, "-c", code] if code else [PY, "-c", _F32_CHILD] if f32
                else [PY, "-m", "tf_operator_tpu_torch.models.train"])
        extra = rank_argv[rank] if rank_argv else []
        procs.append((subprocess.Popen(head + list(argv) + extra, cwd=tmp, env=child_env,
                                       stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                                       text=True), metrics))
    out = []
    try:
        for proc, metrics in procs:
            _, err = proc.communicate(timeout=timeout)
            out.append({"rc": proc.returncode, "events": read_events(metrics), "stderr": err})
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


# A pod through the trainer's own entry: main with an explicit local rank
# count (argv[1]), at f32; each rank the supervisor starts replays this
# command line and trains as a rank.
_F32_POD = ("import sys, torch\n"
            "from tf_operator_tpu_torch.models import train\n"
            "train.COMPUTE_DTYPE = torch.float32\n"
            "sys.exit(train.main(sys.argv[2:], local_ranks=int(sys.argv[1])))\n")
# A pod of argv[1] local ranks each running `python -c argv[2] argv[3:]`.
_CODE_POD = ("import sys\n"
             "from tf_operator_tpu_torch.parallel import launch\n"
             "sys.exit(launch.run_pod([sys.executable, '-c', *sys.argv[2:]], "
             "int(sys.argv[1])))\n")


def start_pod(tmp: Path, argv: list[str], pod: int, pods: int, local: int, port: int,
              mesh: dict | None = None, tag: str = "pod", env: dict | None = None,
              code: str | None = None, pod_code: str = _F32_POD):
    """Pod `pod` of `pods` as the operator starts one (JAX_* env when
    pods > 1, TPUJOB_MESH, its own metrics and heartbeat files), whose
    supervisor is given `local` ranks through the explicit count: the
    trainer at f32 on `argv` (`pod_code`, called as _F32_POD is), or
    `python -c code argv` in each rank. Returns (Popen, metrics path)."""
    metrics = tmp / f"{tag}-{pod}.jsonl"
    metrics.unlink(missing_ok=True)
    child_env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "TPUJOB_"))}
    child_env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                     TPUJOB_METRICS_FILE=str(metrics),
                     TPUJOB_HEARTBEAT_FILE=str(tmp / f"{tag}-{pod}.heartbeat"), **(env or {}))
    if pods > 1:
        child_env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                         JAX_PROCESS_ID=str(pod), JAX_NUM_PROCESSES=str(pods))
    if mesh is not None:
        child_env["TPUJOB_MESH"] = json.dumps(mesh)
    head = ([PY, "-c", _CODE_POD, str(local), code] if code
            else [PY, "-c", pod_code, str(local)])
    return subprocess.Popen(head + list(argv), cwd=tmp, env=child_env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True), metrics


def run_pods(tmp: Path, argv: list[str], pods: int, local: int, mesh: dict | None = None,
             tag: str = "pod", env: dict | None = None, code: str | None = None,
             timeout: float = 240) -> list[dict]:
    """`pods` pods of `local` ranks each (start_pod), run to their end:
    [{"rc", "events", "stdout", "stderr"}] by pod."""
    port = free_port()
    procs = [start_pod(tmp, argv, p, pods, local, port, mesh, tag, env, code)
             for p in range(pods)]
    out = []
    try:
        for proc, metrics in procs:
            stdout, err = proc.communicate(timeout=timeout)
            out.append({"rc": proc.returncode, "events": read_events(metrics),
                        "stdout": stdout, "stderr": err})
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


def start_slice(tmp: Path, argv: list[str], sid: int, slices: int = 2, rank: int = 0,
                ranks: int = 1, port: int = 0, mesh: dict | None = None, tag: str = "slice",
                f32: bool = True, env: dict | None = None):
    """One pod of a multi-slice job as the operator starts it: worker `sid`
    (of a job without a chief, so worker 0 writes the checkpoints) of slice
    `sid`'s world of `ranks` processes (coordinator on `port`), with
    TPUJOB_NUM_SLICES, TPUJOB_SLICE_ID and the shared TPUJOB_DCN_DIR
    (tmp/dcn). Returns (Popen, metrics path)."""
    dcn = tmp / "dcn"
    dcn.mkdir(exist_ok=True)
    metrics = tmp / f"{tag}-s{sid}-{rank}.jsonl"
    metrics.unlink(missing_ok=True)
    child_env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "TPUJOB_"))}
    child_env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", TPUJOB_METRICS_FILE=str(metrics),
                     TPUJOB_NUM_SLICES=str(slices), TPUJOB_SLICE_ID=str(sid),
                     TPUJOB_DCN_DIR=str(dcn), TPUJOB_REPLICA_TYPE="worker",
                     TPUJOB_REPLICA_INDEX=str(sid * ranks + rank), **(env or {}))
    if ranks > 1:
        child_env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                         JAX_PROCESS_ID=str(rank), JAX_NUM_PROCESSES=str(ranks))
    if mesh is not None:
        child_env["TPUJOB_MESH"] = json.dumps(mesh)
    head = [PY, "-c", _F32_CHILD] if f32 else [PY, "-m", "tf_operator_tpu_torch.models.train"]
    return subprocess.Popen(head + list(argv), cwd=tmp, env=child_env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True), metrics


def finish(procs: list, timeout: float = 240) -> list[dict]:
    """Wait for start_slice's (Popen, metrics) pairs: [{"rc", "events",
    "stderr"}] in order; any left running is killed."""
    out = []
    try:
        for proc, metrics in procs:
            _, err = proc.communicate(timeout=timeout)
            out.append({"rc": proc.returncode, "events": read_events(metrics), "stderr": err})
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


def run_slices(tmp: Path, argv: list[str], slices: int = 2, ranks: int = 1,
               mesh: dict | None = None, tag: str = "slice", f32: bool = True,
               env: dict | None = None, timeout: float = 240) -> list[dict]:
    """A multi-slice job: `slices` worlds of `ranks` processes each
    (start_slice), run to their end: results slice by slice, rank by rank."""
    procs = []
    for sid in range(slices):
        port = free_port()
        procs += [start_slice(tmp, argv, sid, slices, rank, ranks, port, mesh, tag, f32, env)
                  for rank in range(ranks)]
    return finish(procs, timeout)


def assert_ok(runs: list[dict]) -> None:
    for rank, r in enumerate(runs):
        assert r["rc"] == 0, f"rank {rank} exited {r['rc']}: {r['stderr'][-3000:]}"


def assert_same_losses(got: list[dict], ref: list[dict], rtol: float) -> None:
    """Every rank's progress losses equal the reference's at every step."""
    want = progress_losses(ref[0]["events"])
    assert len(want) >= 2, want
    for r in got:
        have = progress_losses(r["events"])
        assert sorted(have) == sorted(want), (have, want)
        np.testing.assert_allclose([have[s] for s in sorted(want)],
                                   [want[s] for s in sorted(want)], rtol=rtol)


def assert_same_tensors(got: dict, ref: dict, lr: float, steps: int, noise=(),
                        in_norm: bool = True) -> None:
    """Final parameters of two runs. Adam normalises each element's
    gradient, so an element whose gradient is at the level of the f32
    summation noise moves by up to lr a step in a direction the noise
    picks: every element must stay within 2 * lr * steps of the
    reference's (Adam's reach), and, with `in_norm`, each tensor within
    rtol 1e-4 of the reference's in norm (|a - b| <= 1e-4 |b|), which a few
    such elements do not move. Tensors named in `noise` have a gradient
    that is zero in exact arithmetic (a key bias: softmax is invariant to
    it), so all their elements are noise and only the reach holds for them.
    A ResNet at these sizes gets the reach alone: its batch norms over 1x1
    and 2x2 maps leave most weights of the last stages with gradients at
    the noise level (gradients equal at 2e-5 of each tensor's scale, losses
    at 4e-6, yet 3-8% of the elements moved by noise)."""
    assert sorted(got) == sorted(ref)
    for name, want in ref.items():
        if not hasattr(want, "shape"):
            assert got[name] == want, name
            continue
        a, b = np.asarray(got[name], np.float64), np.asarray(want, np.float64)
        assert a.shape == b.shape, name
        diff = np.abs(a - b)
        assert diff.max(initial=0.0) <= 2 * lr * steps, (name, diff.max())
        if in_norm and not any(n in name for n in noise):
            assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b), (
                name, np.linalg.norm(a - b) / np.linalg.norm(b))


def initial_params(argv: list[str], dtype=torch.float32) -> dict:
    """The seeded initial parameters the trainer starts from with `argv`,
    built in this process with its compute dtype set to `dtype`."""
    from tf_operator_tpu_torch.models import train

    prev, train.COMPUTE_DTYPE = train.COMPUTE_DTYPE, dtype
    try:
        model, _, _ = train._build_model(train.build_parser().parse_args(argv),
                                         torch.device("cpu"))
    finally:
        train.COMPUTE_DTYPE = prev
    return {n: p.detach().double().numpy() for n, p in model.named_parameters()}


def change_gap(got: dict, ref: dict, init: dict) -> float:
    """|got - ref| / |ref - init| over every parameter (names of `init`):
    how far a run's update strays from the reference's, in units of the
    reference's whole update (a rank that never updated reads 1)."""
    num = sum(np.sum((np.asarray(got[k], np.float64) - np.asarray(ref[k], np.float64)) ** 2)
              for k in init)
    den = sum(np.sum((np.asarray(ref[k], np.float64) - init[k]) ** 2) for k in init)
    return float(np.sqrt(num / den))
