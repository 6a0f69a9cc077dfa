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

One process uses one GPU, the pod's first visible device.
"""

from __future__ import annotations

import datetime
import os
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

# How long the store waits for every process to join, and a collective for
# its peers: a dead peer closes its sockets and fails a collective at once,
# a wedged one fails it here.
TIMEOUT = datetime.timedelta(seconds=300)
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
    store = dist.TCPStore(host, int(port), world_size=nprocs, is_master=pid == 0,
                          timeout=TIMEOUT)
    backend = choose_backend(store, pid, nprocs, device)
    dist.init_process_group(backend, store=store, rank=pid, world_size=nprocs,
                            timeout=TIMEOUT)
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
