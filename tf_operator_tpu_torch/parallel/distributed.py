"""Multi-process initialisation from the operator's env: counterpart of tf_operator_tpu/parallel/distributed.py.

A trainer calls `initialize_from_env()` first thing. It reads the env the
operator injects into every Chief, Master and Worker (JAX_COORDINATOR_ADDRESS,
JAX_PROCESS_ID, JAX_NUM_PROCESSES: the names are the JAX contract's, kept so
one manifest drives either trainer) and joins one torch.distributed world:
a TCPStore on the coordinator address (process 0 serves it) and a process
group of the job's size.

The backend is chosen by a rule, never by catching a failure:

  - gloo when the process runs on the CPU;
  - NCCL on CUDA when every process has a GPU of its own;
  - gloo on CUDA tensors when two processes share one GPU (NCCL refuses
    two ranks on one device). Each process publishes its device's UUID
    through the store before the group exists, so every process reaches
    the same verdict.

One process uses one GPU, its first visible device. A pod that sees N > 1
GPUs runs N such processes, its local ranks (parallel/launch.py, the JAX
package's one process over `jax.local_devices()`): the supervisor gives
local rank i of pod p (of P pods) the global rank p * N + i in a world of
P * N, and CUDA_VISIBLE_DEVICES = the pod's i-th device, so the rule above
holds unchanged. The pod's own identity stays in the env beside the
rewritten one (TPUJOB_POD_PROCESS_ID, TPUJOB_POD_NUM_PROCESSES), and every
process publishes its pod's N to the store before the group exists: pods
that see different counts are refused, naming both.
"""

from __future__ import annotations

import datetime
import os
import signal
import sys
import threading

import torch
import torch.distributed as dist

# The operator's env contract (own copy of tf_operator_tpu/cluster_spec/tpu_env.py).
ENV_COORDINATOR_ADDRESS = "JAX_COORDINATOR_ADDRESS"
ENV_PROCESS_ID = "JAX_PROCESS_ID"
ENV_NUM_PROCESSES = "JAX_NUM_PROCESSES"
ENV_TPU_WORKER_ID = "TPU_WORKER_ID"
ENV_TPU_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"
ENV_TPU_ENDPOINTS = "KUBE_GOOGLE_CLOUD_TPU_ENDPOINTS"
ENV_TOPOLOGY = "TPUJOB_TOPOLOGY"
ENV_MESH = "TPUJOB_MESH"
ENV_NUM_SLICES = "TPUJOB_NUM_SLICES"
# The coordinator's own listen port where the local runtime maps it.
ENV_COORD_LISTEN_PORT = "TPUJOB_COORD_LISTEN_PORT"
# Set by the pod supervisor (parallel/launch.py) in each local rank it
# starts, never by the operator: this process is local rank i of the pod's
# N, the pod being process p of P, started by the supervisor's pid.
ENV_LOCAL_RANK = "TPUJOB_LOCAL_RANK"
ENV_LOCAL_RANKS = "TPUJOB_LOCAL_RANKS"
ENV_POD_PROCESS_ID = "TPUJOB_POD_PROCESS_ID"
ENV_POD_NUM_PROCESSES = "TPUJOB_POD_NUM_PROCESSES"
ENV_SUPERVISOR_PID = "TPUJOB_POD_SUPERVISOR_PID"
ENV_VISIBLE_DEVICES = "CUDA_VISIBLE_DEVICES"

# How long the store waits for every process to join, and a collective for
# its peers: a dead peer closes its sockets and fails a collective at once,
# a wedged one fails it here. In an NCCL world it is the deadline of the
# trainer's own watchdog (parallel/peer_watch.py), and the group's timeout
# is NCCL_TIMEOUT_FACTOR times it, so ProcessGroupNCCL's watchdog, which
# only logs there (NCCL_ASYNC_ERROR_ENV), comes after it.
TIMEOUT = datetime.timedelta(seconds=300)
NCCL_TIMEOUT_FACTOR = 2
# ProcessGroupNCCL's handling of a failed or timed-out collective: 0 leaves
# it to the caller, which the watchdog's _abort_process_group asks for; its
# default (3) ends the process by SIGABRT with no event.
NCCL_ASYNC_ERROR_ENV = "TORCH_NCCL_ASYNC_ERROR_HANDLING"
# distributed_goodbye's bound on the closing barrier, in seconds.
GOODBYE_TIMEOUT_S = 300.0


def distributed_env() -> tuple[str | None, int, int]:
    """(coordinator_address, process_id, num_processes) from the injected
    env. The local runtime rewrites the coordinator DNS name to
    127.0.0.1:port."""
    coord = os.environ.get(ENV_COORDINATOR_ADDRESS) or None
    pid = int(os.environ.get(ENV_PROCESS_ID, "0"))
    nprocs = int(os.environ.get(ENV_NUM_PROCESSES, "1"))
    return coord, pid, nprocs


def local_rank() -> int | None:
    """This process's local rank when a pod supervisor started it, else
    None (a pod of one process, or the supervisor itself)."""
    value = os.environ.get(ENV_LOCAL_RANK)
    return None if value is None else int(value)


def pod_identity() -> tuple[int, int, int, int]:
    """(pod, pods, local rank, local ranks): the pod's own JAX_PROCESS_ID
    and JAX_NUM_PROCESSES and this process's place among its local ranks;
    (JAX_PROCESS_ID, JAX_NUM_PROCESSES, 0, 1) in a pod of one process."""
    if local_rank() is None:
        _, pid, nprocs = distributed_env()
        return pid, nprocs, 0, 1
    return (int(os.environ[ENV_POD_PROCESS_ID]), int(os.environ[ENV_POD_NUM_PROCESSES]),
            int(os.environ[ENV_LOCAL_RANK]), int(os.environ[ENV_LOCAL_RANKS]))


def visible_devices() -> list[str]:
    """The CUDA devices this process sees, as CUDA_VISIBLE_DEVICES names
    them (indices or UUIDs; 0..n-1 when it is unset), as the NVIDIA device
    plugin sets it for a pod. torch.cuda.device_count() counts them through
    NVML (or cudaGetDeviceCount) and creates no CUDA context, so a process
    that will start children may ask. Empty on a CPU-only build."""
    n = torch.cuda.device_count()
    listed = os.environ.get(ENV_VISIBLE_DEVICES)
    if listed is None:
        return [str(i) for i in range(n)]
    return [d.strip() for d in listed.split(",") if d.strip()][:n]


def local_device_count(device_type: str) -> int:
    """The pod's local device count: the visible CUDA devices for a pod on
    CUDA (at least 1: a pod without one fails on its own), 1 on the CPU."""
    if device_type != "cuda":
        return 1
    return max(1, len(visible_devices()))


def agree_local_ranks(store: dist.Store) -> None:
    """Every pod of the world publishes its local rank count and reads
    every other pod's (blocking gets): pods that see different counts would
    number their ranks differently, so the world is refused, naming both."""
    pod, pods, _, n = pod_identity()
    store.set(f"tfo/local_ranks/{pod}", str(n))
    for other in range(pods):
        m = int(store.get(f"tfo/local_ranks/{other}").decode())
        if m != n:
            raise RuntimeError(
                f"pod {other} runs {m} local rank(s) and pod {pod} runs {n}: every pod "
                f"of a job must see the same number of devices")


def bind_to_supervisor() -> None:
    """A local rank dies with its supervisor: PR_SET_PDEATHSIG (SIGKILL), set
    after the exec, then a check that the supervisor had not died before
    it was set. No-op outside a supervised pod."""
    sup = os.environ.get(ENV_SUPERVISOR_PID)
    if sup is None or not sys.platform.startswith("linux"):
        return
    import ctypes

    pr_set_pdeathsig = 1
    ctypes.CDLL(None, use_errno=True).prctl(pr_set_pdeathsig, signal.SIGKILL, 0, 0, 0)
    if os.getppid() != int(sup):
        os._exit(128 + signal.SIGKILL)


def choose_backend(store: dist.Store, pid: int, nprocs: int, device: torch.device) -> str:
    """The backend rule of the module docstring. On CUDA every process
    writes its device's UUID to the store and reads everyone's (a blocking
    get), so all reach the same answer."""
    if device.type != "cuda":
        return "gloo"
    uuid = str(torch.cuda.get_device_properties(device).uuid)
    store.set(f"tfo/device_uuid/{pid}", uuid)
    uuids = {store.get(f"tfo/device_uuid/{r}").decode() for r in range(nprocs)}
    return "nccl" if len(uuids) == nprocs else "gloo"


def initialize_from_env(force: bool = False,
                        device: torch.device | None = None) -> str | None:
    """Join the job's torch.distributed world when the operator wired more
    than one process (or when `force`, at any size); returns the backend,
    or None for a one-process job. `device` is where this process computes
    (the CPU unless given); on CUDA it becomes the current device."""
    coord, pid, nprocs = distributed_env()
    if nprocs <= 1 and not force:
        return None
    device = device or torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not coord:
        raise RuntimeError(f"{ENV_NUM_PROCESSES}={nprocs} but {ENV_COORDINATOR_ADDRESS} "
                           f"is not set: the processes cannot find each other")
    host, _, port = coord.rpartition(":")
    # Process 0 serves the store on its own listen port, which the local
    # runtime maps; in a real cluster the DNS name is its own.
    listen = os.environ.get(ENV_COORD_LISTEN_PORT)
    if pid == 0 and listen:
        host, port = "127.0.0.1", listen
    bind_to_supervisor()
    # The agreement on the local rank count comes before the world size is
    # trusted, so the store does not wait for `nprocs` clients.
    store = dist.TCPStore(host, int(port), world_size=nprocs, is_master=pid == 0,
                          timeout=TIMEOUT, wait_for_workers=False)
    agree_local_ranks(store)
    backend = choose_backend(store, pid, nprocs, device)
    timeout = TIMEOUT
    if backend == "nccl":
        handling = os.environ.get(NCCL_ASYNC_ERROR_ENV, "")
        if handling not in ("", "0"):
            raise RuntimeError(f"{NCCL_ASYNC_ERROR_ENV}={handling} lets ProcessGroupNCCL end "
                               f"the process on a lost peer before the trainer's watchdog "
                               f"reports it (exit 138); leave it unset or 0")
        os.environ[NCCL_ASYNC_ERROR_ENV] = "0"
        timeout = TIMEOUT * NCCL_TIMEOUT_FACTOR
    dist.init_process_group(backend, store=store, rank=pid, world_size=nprocs,
                            timeout=timeout)
    return backend


def _barrier(device: torch.device) -> None:
    """A barrier that every backend takes: an all_reduce of one element on
    the backend's device."""
    flag = torch.ones(1, device=device)
    dist.all_reduce(flag)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def distributed_goodbye() -> None:
    """Synchronized clean exit for multi-process jobs, then the group's
    teardown.

    Without it the first process to finish (usually process 0, which
    serves the store) exits and closes the store's socket while slower
    peers are still milliseconds from their own exit; their next store or
    collective call then fails AFTER training completed, and a clean job
    reads as a failed replica.

    Call at CLEAN completion only: every peer is provably alive and heading
    to the same barrier (a peer that died earlier would have broken this
    process's collectives first), so the barrier cannot hang. The wait is
    bounded all the same (a peer may die between its last collective and
    the barrier): on expiry return WITHOUT destroying the group, since the
    daemon thread may still be inside the barrier on it.
    """
    if not dist.is_initialized():
        return
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = threading.Thread(target=_barrier, args=(device,), daemon=True,
                         name="distributed-goodbye")
    t.start()
    t.join(timeout=GOODBYE_TIMEOUT_S)
    if t.is_alive():
        return
    dist.destroy_process_group()
