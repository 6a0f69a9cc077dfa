"""The pod supervisor: one pod drives every GPU it is given.

A JAX pod is one process, and that process drives every chip the pod is
given (`jax.local_devices()`). A torch process drives one GPU, so a pod
that sees N > 1 CUDA devices runs N processes, its local ranks, under this
supervisor (the trainer enters it from `main`, before any CUDA call; the
pod command is unchanged). torchrun's per-node agent is the idiom, but the
contract here is the operator's:

  - local rank i of the pod that is process p of P (the operator's
    JAX_PROCESS_ID and JAX_NUM_PROCESSES) runs the pod's own command with
    JAX_PROCESS_ID = p * N + i, JAX_NUM_PROCESSES = P * N and
    CUDA_VISIBLE_DEVICES = the pod's i-th device (round-robin when an
    explicit count exceeds them: ranks then share a card), the pod's own
    identity kept in TPUJOB_POD_PROCESS_ID / TPUJOB_POD_NUM_PROCESSES and
    TPUJOB_LOCAL_RANK / TPUJOB_LOCAL_RANKS marking it a rank. Global rank 0,
    pod 0's local rank 0, serves the coordinator's store; a pod of one
    process without a coordinator gets one on a free local port;
  - the ranks are started with an exec (subprocess), never a bare fork:
    the supervisor may itself be a forked prespawn child, and CUDA is not
    touched before an exec;
  - SIGTERM, SIGINT and SIGUSR1 are forwarded to every rank (under the
    local runtime the ranks also get the process group's signal; the
    trainer's PreemptionGuard latches the first, so both are harmless);
  - a rank dies with its supervisor (PR_SET_PDEATHSIG, set by the rank in
    distributed.initialize_from_env);
  - the pod exits with the first non-zero code in order of exit (a signal
    death as 128 + signum). Once a rank fails the others are killed, except
    after a preemption exit (128 + a forwarded signal, returned by the rank
    itself): the ranks leave such a boundary together, and rank 0 may still
    be writing the emergency checkpoint, so they are waited for;
  - the pod keeps one event stream: local rank 0 alone writes
    TPUJOB_METRICS_FILE, TPUJOB_HEARTBEAT_FILE and events on stdout, which
    it inherits; the other ranks' stdout and stderr reach the pod's stderr,
    each line tagged with the rank, and carry no event.
"""

from __future__ import annotations

import os
import queue
import signal
import socket
import subprocess
import sys
import threading

from tf_operator_tpu_torch.parallel import distributed as d

# The prespawn zygote's preload for port pods (the local runtime reads
# TPUJOB_PRESPAWN_PRELOAD; its default is the JAX list). Importing these
# calls no CUDA function, so a pod forked from the zygote may start ranks.
PRESPAWN_PRELOAD = ("torch,numpy,tf_operator_tpu_torch.models.train,"
                    "tf_operator_tpu_torch.parallel.train_step")
FORWARDED = (signal.SIGTERM, signal.SIGINT, signal.SIGUSR1)
# A rank that leaves through the preemption path returns one of these itself.
PREEMPTION_EXITS = frozenset(128 + s for s in FORWARDED)
# Local rank 0's alone: the pod's one event stream.
RANK0_ONLY_ENV = ("TPUJOB_METRICS_FILE", "TPUJOB_HEARTBEAT_FILE")


def rank_env(env: dict, local: int, n: int, devices: list[str]) -> dict:
    """The env of local rank `local` of `n` from the pod's `env` (see the
    module docstring)."""
    pod = int(env.get(d.ENV_PROCESS_ID) or 0)
    pods = int(env.get(d.ENV_NUM_PROCESSES) or 1)
    out = dict(env)
    out.update({d.ENV_PROCESS_ID: str(pod * n + local), d.ENV_NUM_PROCESSES: str(pods * n),
                d.ENV_POD_PROCESS_ID: str(pod), d.ENV_POD_NUM_PROCESSES: str(pods),
                d.ENV_LOCAL_RANK: str(local), d.ENV_LOCAL_RANKS: str(n)})
    if devices:
        out[d.ENV_VISIBLE_DEVICES] = devices[local % len(devices)]
    if local:
        for key in RANK0_ONLY_ENV:
            out.pop(key, None)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _exit_code(returncode: int) -> int:
    return 128 - returncode if returncode < 0 else returncode


def _pump(pipe, tag: bytes) -> None:
    """Copy a rank's output to the pod's stderr, a line at a time, tagged."""
    with pipe:
        for line in iter(pipe.readline, b""):
            os.write(2, tag + line)


def _wait(procs: list[subprocess.Popen]) -> int:
    """Wait for every rank (a thread each blocks on its rank's exit, so the
    exits queue up in their order; signal handlers still run in this
    thread); the first non-zero code, killing the rest after a failure."""
    exits: queue.SimpleQueue = queue.SimpleQueue()
    for p in procs:
        threading.Thread(target=lambda p=p: exits.put((p, p.wait())), daemon=True,
                         name=f"wait-{p.pid}").start()
    code = 0
    for _ in procs:
        _, rc = exits.get()
        if rc and not code:
            code = _exit_code(rc)
            if rc < 0 or code not in PREEMPTION_EXITS:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
    return code


def run_pod(command: list[str], local_ranks: int) -> int:
    """Run `command` as the pod's `local_ranks` local ranks over its visible
    CUDA devices and return the pod's exit code."""
    devices = d.visible_devices()
    env = dict(os.environ, **{d.ENV_SUPERVISOR_PID: str(os.getpid())})
    if int(env.get(d.ENV_NUM_PROCESSES) or 1) <= 1 and not env.get(d.ENV_COORDINATOR_ADDRESS):
        env[d.ENV_COORDINATOR_ADDRESS] = f"127.0.0.1:{_free_port()}"
    procs: list[subprocess.Popen] = []
    pumps: list[threading.Thread] = []

    def forward(signum, _frame):
        for p in procs:
            p.send_signal(signum)

    previous = {s: signal.signal(s, forward) for s in FORWARDED}
    try:
        for i in range(local_ranks):
            if i == 0:
                procs.append(subprocess.Popen(command, env=rank_env(env, 0, local_ranks,
                                                                    devices)))
                continue
            proc = subprocess.Popen(command, env=rank_env(env, i, local_ranks, devices),
                                    stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT)
            procs.append(proc)
            pumps.append(threading.Thread(target=_pump, args=(proc.stdout,
                                                              f"[local rank {i}] ".encode()),
                                          daemon=True, name=f"rank{i}-output"))
            pumps[-1].start()
        return _wait(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for t in pumps:
            t.join(timeout=5)
        for s, h in previous.items():
            signal.signal(s, h)


def rank_command(argv: list[str]) -> list[str]:
    """The command each local rank of a trainer pod execs: the pod's own.
    A pod started as `python -c CODE ARGS` (a wrapper around the trainer's
    main) replays that command line; any other runs the trainer's module on
    `argv` (a pod forked from the prespawn zygote carries the zygote's
    command line, not its own)."""
    if sys.argv and sys.argv[0] == "-c":
        return [sys.executable, *sys.orig_argv[1:]]
    return [sys.executable, "-m", "tf_operator_tpu_torch.models.train", *argv]
