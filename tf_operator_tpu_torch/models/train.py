"""Trainer of the PyTorch port — the workload binary a TrainJob pod runs.

    python -m tf_operator_tpu_torch.models.train --model transformer-lm \\
        --steps 6 --batch 4 --seq 8192 --layers 12 --hidden 768 --heads 6 \\
        --moment-dtype bf16 --master-weights --log-every 2
    python -m tf_operator_tpu_torch.models.train --model resnet50 \\
        --batch 256 --image-size 224 --steps 6 --log-every 2

    python -m tf_operator_tpu_torch.models.train --model bert-base \
        --seq 128 --batch 8 --steps 6 --checkpoint-dir /ckpt
    python -m tf_operator_tpu_torch.models.train --model resnet50 \
        --data-dir /data --input-staging staged --staging-lanes 2
    python -m tf_operator_tpu_torch.models.train --model moe-lm --moe-dispatch sparse \
        --seq 2048 --batch 8 --layers 12 --hidden 768 --heads 6

Counterpart of tf_operator_tpu/models/train.py for its models:
`mnist-mlp` (the default, as there), `mnist-conv`, `resnet18`,
`resnet50`, `transformer-lm`, BERT's masked LM (`bert-base`,
`bert-tiny`: their own widths, --layers/--hidden/--heads ignored, full
attention, max_len max(seq, 8)) and the MoE LM (`moe-lm`: 8 experts,
top-2, every 2nd block, `--moe-dispatch` dense or sparse, models/moe.py).
Synthetic batches are made on the device (x ~ N(0, 1) images of [B, 28,
28] or [B, S, S, 3] with uniform labels; uniform tokens for the LMs;
BERT's 15% [MASK] batches), attention runs through the flash kernels, the
optimizer is mixed-precision Adam/AdamW, and the JSON events are the JAX
trainer's (`start`, `jax_ready` — kept by name for the bench's segment
reader, `model_ready`, `first_step`, `progress`, `done`) on stdout and
appended to `TPUJOB_METRICS_FILE`, plus the `TPUJOB_HEARTBEAT_FILE`
heartbeat. ResNet's batch-norm running statistics are updated once per
step and stay f32 under `--master-weights`.

One process on CUDA, and every rank of a world whose ranks each have a
GPU of their own (NCCL), runs each optimizer step as a replay of a CUDA
graph (parallel/graphed_step.py), as the JAX trainer compiles its chunk
and its dataset step over the whole mesh: the first step runs eagerly and
is then captured, batches and collectives included, and `model_ready`
names the route (`step_route`, and why). In a multi-slice job each half of
the step replays a graph (the batch, each microbatch's backward, the
apply), the DCN exchange on the host between them. The CPU and a gloo
world step eagerly.

Checkpoints (`--checkpoint-dir`, models/checkpoint.py) follow the JAX
trainer: step_<N> holds the parameters and trainstate_<N> the resume
payload (buffers, optimizer state, step); the chief (or worker 0) saves at
the chunk boundaries where `done // --checkpoint-every` advances and once
at the end (marked FINAL). In async mode (the default) a save blocks the
step loop only for the device->host snapshot (phase `ckpt_snapshot`), and
a writer thread, which only writes files, publishes it; one save is in
flight and the next waits for it. A restarted run walks the checkpoints
newest first past torn or foreign ones (`resume_fallback`), resumes at the
step it finds (`resumed`), and replays the batch stream from there, since
batches are a function of (seed, global step).

The rest of the JAX trainer's pod contract: `--remat` rematerialises the
loss and each LM block, `--remat-save-flash[-layers]` keeps the flash
forward's (o, lse) in all (or the first K) blocks; a SIGTERM, SIGINT or
SIGUSR1 is latched (utils/preemption.py) and handled at the next chunk
boundary: drain the in-flight async save and adopt it when it is this
step's, else save synchronously when `--preempt-grace` still covers it,
emit `preempted` and exit 128+signum. `--chaos` (or TPUJOB_CHAOS) injects
kill / hang / torn / stall:ckpt faults (chaos/). `--trace` records host
spans and writes `<rank>.trace.json` under `--trace-dir`; `--profile-dir`
keeps a torch.profiler trace of the last steady chunk, outside the
throughput window. `--eval` makes this process the Evaluator: it follows
`--checkpoint-dir` to FINAL and evaluates each step on fixed batches (on
CUDA by replaying one captured graph of the loss, `eval_ready` naming the
route).

`--data-dir` trains on a sharded on-disk dataset (data/dataset.py) one
step at a time, its batches fed by the copy thread of data/prefetch.py
(`--input-staging prefetch`) or the staging ring of data/staging.py
(`staged`, with `--staging-{depth,chunks,lanes,tune}` and
`--wire-codec`); `--wire-dtype` picks the wire (uint8 images are
normalised on the device, on the step's thread). A resumed run continues
the batch sequence, and the done event carries the ingest's `prefetch` or
`staging` block.

A job of more than one process (the operator's JAX_NUM_PROCESSES) joins
one torch.distributed world (parallel/distributed.py: gloo on the CPU, NCCL
when every process has its own GPU, gloo on CUDA tensors when processes
share one) and trains one model on the global batch over TPUJOB_MESH's
dp/fsdp/sp/tp/ep mesh (parallel/mesh.py, the JAX rule tables of
parallel/sharding_rules.py, parallel/train_step.py's plan; the LM and BERT
split their sequence over sp through ring attention or Ulysses,
TPUJOB_SP_MODE, TPUJOB_RING_BLOCK and TPUJOB_ULYSSES_MAX_SEQ choosing as
in the JAX package, while MNIST and ResNet run the same rows on every sp
rank, as the JAX step replicates their batch there). Rank 0 writes
the checkpoints, gathered to full tensors; the replicas agree on the resume
step, on a preemption, and exit together (distributed_goodbye) on clean
completion only. A collective that fails because a peer died exits 138
(retryable); in an NCCL world, where a lost peer shows in no call, every
host wait (the metrics read, the collectives issued outside a graph, the
replay behind world_watch's all-reduce, the preemption flag, the
checkpoint snapshot) is polled against distributed.TIMEOUT by the
trainer's own watchdog (parallel/peer_watch.py), which aborts the
communicators and exits 138 with a `peer_lost` event too.
The data axis splits the batch as dp does; pp is replicated,
as the JAX trainer makes it (the GPipe schedule, parallel/pipeline.py, is
on no trainer path there either).

A multi-slice job (TPUJOB_NUM_SLICES > 1, `_train_multislice`): each
slice is its own world, and the slices meet in parallel/multislice.py's
DCN exchange under TPUJOB_DCN_DIR (one exchange a rank pair when a slice
has several ranks). Each step's global batch is cut into slices x
--dcn-microbatches row blocks; each block's gradients stream to the
exchange while the next block's backward runs (`dcn_sync` is the visible
wait; the done event's `dcn` block the exchange's accounting). The global
worker 0 alone writes checkpoints; a slice whose peer was rolled holds at
the barrier and rewinds in process to the checkpoint the peer resumed
from (`dcn_rewind`); a peer that never comes exits 138. A model with
mutable state (ResNet) and --data-dir are refused, as in the JAX trainer.

It runs on CUDA unless `--device cpu` asks for the CPU, and exits nonzero
when CUDA is asked for and absent. Flags and models of the JAX trainer
that this one does not handle yet are refused, never ignored.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import threading
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

from tf_operator_tpu_torch.parallel.collectives import PeerLostError
from tf_operator_tpu_torch.parallel.distributed import ENV_LOCAL_RANK

MODELS = ("mnist-mlp", "mnist-conv", "resnet18", "resnet50", "transformer-lm",
          "bert-base", "bert-tiny", "moe-lm")
# The models whose state holds more than parameters (batch-norm statistics).
STATEFUL_MODELS = ("resnet18", "resnet50")
# The layers' compute dtype, the JAX trainer's bf16. The CPU tests that hold
# a multi-process run against one process at f32 tolerances set f32 here in
# their child processes.
COMPUTE_DTYPE = torch.bfloat16
# Per-device f32 logits bytes at which the loss switches to the chunked head
# (the JAX trainer's cutover; see use_chunked_loss).
CHUNKED_LOSS_BYTES = 6e9
VOCAB = 32000

_emit_lock = threading.Lock()


def _emit(event: dict) -> None:
    if os.environ.get(ENV_LOCAL_RANK, "0") != "0":
        return  # a pod's one event stream is its local rank 0's
    line = json.dumps(event)
    with _emit_lock:
        print(line, flush=True)
        path = os.environ.get("TPUJOB_METRICS_FILE")
        if path:
            with open(path, "a") as f:
                f.write(line + "\n")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m tf_operator_tpu_torch.models.train")
    ap.add_argument("--model", default="mnist-mlp", choices=MODELS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4, help="transformer-lm depth")
    ap.add_argument("--hidden", type=int, default=512, help="transformer-lm width")
    ap.add_argument("--heads", type=int, default=8,
                    help="transformer-lm attention heads")
    ap.add_argument("--moe-dispatch", default="dense", choices=["dense", "sparse"],
                    help="moe-lm token dispatch: dense = GShard capacity einsums; "
                         "sparse = dropless sorted grouped matmul (K5 on the card)")
    ap.add_argument("--image-size", type=int, default=224, help="resnet input size")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adamw", choices=["adam", "adamw"])
    ap.add_argument("--moment-dtype", default="f32", choices=["f32", "bf16"],
                    help="Adam moment storage dtype; the update math is f32")
    ap.add_argument("--master-weights", action="store_true",
                    help="keep f32 master parameters in the optimizer state "
                         "and train on a bf16 compute copy re-derived each step")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) or cpu; no fallback between them")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="chief/worker-0 writes checkpoints here; the "
                         "Evaluator replica follows them (--eval)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save every N steps (default: once at the end)")
    ap.add_argument("--checkpoint-mode", default="async",
                    choices=["async", "sync"],
                    help="async (default): a save blocks the step loop "
                         "only for the device->host snapshot; the write "
                         "+ manifests + digests + retention ride a "
                         "dedicated writer thread (one in-flight save, "
                         "backpressure on the next). sync: the fully-"
                         "blocking save, the bit-equality reference for "
                         "the async pipeline")
    ap.add_argument("--allow-reshape", action="store_true",
                    help="accept a checkpoint saved at a DIFFERENT gang "
                         "shape (process count / mesh), checking per-leaf "
                         "global shapes against this model first. Without "
                         "this flag a foreign-shape checkpoint is skipped "
                         "by the resume walk like a corrupt one. The "
                         "operator sets TPUJOB_ALLOW_RESHAPE=1 on pods of "
                         "jobs with recovery.elastic.reshapeOnRecovery")
    ap.add_argument("--keep-checkpoints", type=int, default=0,
                    help="retention: after each save keep only the newest K "
                         "step checkpoints (params + trainstate + manifests) "
                         "and prune the rest; 0 (default) keeps everything. "
                         "Orphaned tmp dirs are swept at startup either way")
    ap.add_argument("--remat", action="store_true",
                    help="activation checkpointing: rematerialize the loss, "
                         "and (transformer-lm) each block; the forward keeps "
                         "only block inputs for the backward")
    ap.add_argument("--remat-save-flash", action="store_true",
                    help="with --remat (transformer-lm): keep the flash "
                         "kernel's (o, lse) in every block so the backward "
                         "replays only linear ops, never the O(T^2) kernel")
    ap.add_argument("--remat-save-flash-layers", type=int, default=0,
                    help="with --remat (transformer-lm): keep the flash "
                         "residuals in the FIRST K blocks only (memory->speed "
                         "dial where saving all layers does not fit)")
    ap.add_argument("--preempt-grace", type=float, default=30.0,
                    help="graceful-preemption budget in seconds from "
                         "SIGTERM/SIGINT/SIGUSR1: the trainer finishes the "
                         "in-flight chunk and writes an emergency checkpoint "
                         "only when the estimated save still fits; 0 never "
                         "attempts it. Exit is 128+signum either way "
                         "(143/130/138, retryable under ExitCode)")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="fault-injection spec (grammar of TPUJOB_CHAOS, "
                         "which it overrides): e.g. 'kill:step=12,signal=TERM' "
                         "or 'torn:step=8;stall:ckpt=4,delay=0.2'")
    ap.add_argument("--eval", action="store_true",
                    help="evaluator mode: poll --checkpoint-dir, restore and "
                         "evaluate each new checkpoint until FINAL")
    ap.add_argument("--eval-timeout", type=float, default=600.0)
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the last steady "
                         "chunk (outside the throughput window) under "
                         "this directory")
    ap.add_argument("--trace", action="store_true",
                    help="record spans (step phases, checkpoint IO, eval) and, "
                         "on the graph route, the step's device phases "
                         "(stamped inside the CUDA graph), and write Chrome "
                         "trace-event JSON at exit")
    ap.add_argument("--trace-dir", default=None,
                    help="directory for the trace file (<replica rank>"
                         ".trace.json; default ./traces)")
    ap.add_argument("--trace-steps", type=int, default=0,
                    help="stop recording after this many steady steps "
                         "(0 = the whole run, bounded by the tracer's ring)")
    ap.add_argument("--data-dir", default=None,
                    help="train on a sharded on-disk dataset (data/dataset.py "
                         "layout; keys must match the model's batch keys) "
                         "instead of synthetic data")
    ap.add_argument("--input-staging", default="prefetch", choices=["prefetch", "staged"],
                    help="with --data-dir: host->device ingest. 'prefetch' = "
                         "one copy thread on a side stream (the continuity "
                         "baseline); 'staged' = the staging ring "
                         "(data/staging.py): K batch slots, chunked copies, "
                         "N lanes and transfer/overlap accounting")
    ap.add_argument("--staging-depth", type=int, default=2,
                    help="staging ring size K: batches staged ahead of the "
                         "consumer (2 = double buffering)")
    ap.add_argument("--staging-chunks", type=int, default=1,
                    help="copies per staged array (split along the batch "
                         "dim, reassembled on the device); degraded per "
                         "array, see the done event's staging.chunks_effective")
    ap.add_argument("--staging-lanes", type=int, default=1,
                    help="transfer threads feeding the ring concurrently, each "
                         "on its own CUDA stream; exact batch order kept; "
                         "capped at --staging-depth")
    ap.add_argument("--staging-tune", action="store_true",
                    help="probe {lanes x chunks} against the live link on one "
                         "batch at startup and lock the best (overrides "
                         "--staging-lanes/--staging-chunks); the batch is "
                         "chained back, so the trajectory is an untuned run's")
    ap.add_argument("--wire-codec", default="none", choices=["none", "zlib"],
                    help="lossless wire compression for staged ingest: encoded "
                         "on the producer leg, decoded by the lane before its "
                         "copy (numerics bit-identical); measures what a "
                         "compressed remote wire would save")
    ap.add_argument("--dcn-microbatches", type=int, default=2,
                    help="multi-slice jobs (TPUJOB_NUM_SLICES > 1): split each step's "
                         "backward into M microbatches so the cross-slice (DCN) gradient "
                         "exchange of microbatch m streams while m+1 computes; the done "
                         "event's dcn.hidden_fraction measures the overlap. 1 = one "
                         "backward, the exchange fully visible. Ignored single-slice")
    ap.add_argument("--dcn-buckets", type=int, default=4,
                    help="gradient buckets per microbatch for the cross-slice exchange "
                         "(transfer granularity; byte-balanced over the leaves). Ignored "
                         "single-slice")
    ap.add_argument("--dcn-peer-timeout", type=float, default=600.0,
                    help="multi-slice: how long a slice holds at the DCN barrier waiting "
                         "for its peers before exiting retryable (a rolled peer announces "
                         "its resume well inside this; the timeout is the net under "
                         "double failures)")
    ap.add_argument("--wire-dtype", default="auto", choices=["auto", "uint8", "f32"],
                    help="with --data-dir: the host->device wire. auto = arrays "
                         "as stored (uint8 images normalised on the device); "
                         "uint8 = assert the cheap wire; f32 = normalise on "
                         "the host (the parity reference)")
    return ap


def check_flags(ap: argparse.ArgumentParser, args, local_ranks: int = 1) -> None:
    """The JAX trainer's flag-only checks, with its messages (ap.error:
    exit 2), then the gang the operator's env describes (check_gang) with
    the pod's `local_ranks`."""
    if ((args.remat_save_flash or args.remat_save_flash_layers)
            and not args.remat):
        ap.error("--remat-save-flash[-layers] requires --remat (it selects "
                 "WHICH residuals per-layer remat keeps)")
    if args.remat_save_flash and args.remat_save_flash_layers:
        ap.error("--remat-save-flash (all layers) conflicts with "
                 "--remat-save-flash-layers K (a subset): pick one — the "
                 "all-layers flag would silently win and can OOM exactly "
                 "where the K dial was chosen to fit")
    if args.remat_save_flash_layers < 0:
        ap.error("--remat-save-flash-layers must be >= 0")
    if args.staging_depth < 1:
        ap.error("--staging-depth must be >= 1")
    if args.staging_chunks < 1:
        ap.error("--staging-chunks must be >= 1")
    if args.staging_lanes < 1:
        ap.error("--staging-lanes must be >= 1")
    if args.dcn_microbatches < 1:
        ap.error("--dcn-microbatches must be >= 1")
    if args.dcn_buckets < 1:
        ap.error("--dcn-buckets must be >= 1")
    if args.dcn_peer_timeout <= 0:
        ap.error("--dcn-peer-timeout must be > 0")
    if not args.data_dir and (args.input_staging != "prefetch"
                              or args.wire_dtype != "auto"
                              or args.wire_codec != "none"
                              or args.staging_depth != 2
                              or args.staging_chunks != 1
                              or args.staging_lanes != 1
                              or args.staging_tune):
        ap.error("--input-staging/--wire-dtype/--wire-codec/"
                 "--staging-depth/--staging-chunks/--staging-lanes/"
                 "--staging-tune shape the --data-dir ingest path; "
                 "without --data-dir batches are synthesized on device "
                 "and there is no wire to shape")
    if (args.input_staging == "prefetch"
            and (args.staging_depth != 2 or args.staging_chunks != 1
                 or args.staging_lanes != 1 or args.staging_tune
                 or args.wire_codec != "none")):
        ap.error("--staging-depth/--staging-chunks/--staging-lanes/"
                 "--staging-tune/--wire-codec configure the staging "
                 "RING; with --input-staging prefetch they would be "
                 "silently ignored — pass --input-staging staged")
    if (args.trace_dir is not None or args.trace_steps) and not args.trace:
        ap.error("--trace-dir/--trace-steps shape the span trace; pass "
                 "--trace to enable it (they would otherwise be silently "
                 "ignored)")
    if args.trace_steps < 0:
        ap.error("--trace-steps must be >= 0")
    if args.preempt_grace < 0:
        ap.error("--preempt-grace must be >= 0")
    if args.keep_checkpoints < 0:
        ap.error("--keep-checkpoints must be >= 0")
    if args.keep_checkpoints and not args.checkpoint_dir:
        ap.error("--keep-checkpoints prunes --checkpoint-dir; without one "
                 "there is nothing to retain")
    if args.allow_reshape and not args.checkpoint_dir:
        ap.error("--allow-reshape shapes the --checkpoint-dir resume walk; "
                 "without one there is nothing to restore")
    if not args.eval:
        check_gang(ap, args, local_ranks)
    for name in ("steps", "batch", "seq", "layers", "hidden", "heads", "log_every",
                 "image_size"):
        if getattr(args, name) < 1:
            ap.error(f"--{name.replace('_', '-')} must be >= 1")
    if args.checkpoint_every < 0:
        ap.error("--checkpoint-every must be >= 0")
    if args.hidden % args.heads:
        ap.error("--hidden must be a multiple of --heads")


def _env_count(ap: argparse.ArgumentParser, name: str) -> int:
    value = os.environ.get(name, "").strip()
    try:
        return int(value or "1")
    except ValueError:
        ap.error(f"{name}={value!r} is not a process count")


def check_gang(ap: argparse.ArgumentParser, args, local_ranks: int = 1) -> None:
    """The operator's env against what the trainer runs, before any event
    (ap.error, exit 2): a multi-slice job's exchange directory, a stateless
    model, no --data-dir and a batch the slices x microbatches divide (the
    JAX messages), a TPUJOB_MESH whose axes the port knows and whose sizes
    multiply to the world (the JAX message: JAX_NUM_PROCESSES x the pod's
    `local_ranks`, as the JAX mesh spans every process's local chips), under
    --data-dir a batch whose pod rows the local ranks divide, a global batch (of a
    multi-slice job: each microbatch's rows) the data axes divide,
    attention heads the tp axis divides, a transformer's sequence the sp
    axis divides, local heads that sp divides when TPUJOB_SP_MODE forces
    Ulysses (the JAX message), and no --data-dir under tp or sp (each
    process reads its own shards, so the tp or sp peers of a data shard
    would see different rows)."""
    from tf_operator_tpu_torch.models import transformer as tfm
    from tf_operator_tpu_torch.parallel import distributed
    from tf_operator_tpu_torch.parallel import mesh as mesh_lib
    from tf_operator_tpu_torch.parallel import multislice

    try:
        world = multislice.SliceWorld.from_env()
    except (RuntimeError, ValueError) as e:
        ap.error(str(e))
    rows = args.batch
    if world is not None:
        if args.data_dir:
            ap.error("multi-slice training (TPUJOB_NUM_SLICES > 1) drives the synthetic "
                     "on-device batch path; --data-dir is not supported yet")
        if args.model in STATEFUL_MODELS:
            ap.error(f"--model {args.model} carries mutable model state (batch stats), "
                     f"which does not cross the DCN exchange; pick a stateless model "
                     f"for multi-slice")
        blocks = world.num_slices * args.dcn_microbatches
        if args.batch % blocks:
            ap.error(f"--batch {args.batch} not divisible by slices x microbatches "
                     f"({world.num_slices} x {args.dcn_microbatches})")
        rows = args.batch // blocks
    nprocs = _env_count(ap, distributed.ENV_NUM_PROCESSES) * local_ranks
    if args.data_dir and args.batch % nprocs:
        ap.error(f"--batch {args.batch} not divisible by {nprocs} processes")
    try:
        axes = mesh_lib.check_axes(mesh_lib.env_axes() or {}, nprocs)
        mesh_lib.local_batch_size(mesh_lib.Mesh(axes), rows)
    except ValueError as e:
        ap.error(str(e))
    tp = axes.get("tp", 1)
    heads = {"transformer-lm": args.heads, "moe-lm": args.heads,
             "bert-base": tfm.BERT_BASE.num_heads,
             "bert-tiny": tfm.TINY.num_heads}.get(args.model)
    if tp > 1 and heads is not None and heads % tp:
        ap.error(f"tp={tp} does not divide the {heads} attention heads of --model "
                 f"{args.model}")
    sp = axes.get("sp", 1)
    if sp > 1 and heads is not None:
        if args.seq % sp:
            ap.error(f"sp={sp} does not divide --seq {args.seq} of --model {args.model}")
        if (os.environ.get("TPUJOB_SP_MODE", "").lower() == "ulysses"
                and (heads // tp) % sp):
            ap.error(f"ulysses needs local heads ({heads // tp}) divisible by sp={sp}; "
                     f"use ring attention for this shape")
    for axis, size in (("tp", tp), ("sp", sp)):
        if size > 1 and args.data_dir:
            ap.error(f"--data-dir under {axis}={size}: each process reads its own shards, "
                     f"so the {axis} peers of a data shard would train on different rows")


def _local_ranks(args, explicit: int | None) -> int:
    """How many local ranks this pod runs: 1 in a local rank and in the
    Evaluator (one process a pod), else `explicit` when the caller gives it
    (ranks then share the visible devices round-robin), else the pod's
    visible CUDA devices (1 on the CPU)."""
    from tf_operator_tpu_torch.parallel import distributed

    if args.eval or distributed.local_rank() is not None:
        return 1
    if explicit is not None:
        return explicit
    return distributed.local_device_count(args.device)


def main(argv: list[str] | None = None, state_out: dict | None = None,
         local_ranks: int | None = None) -> int:
    """Parse, check and train (or evaluate). When `state_out` is a dict, the
    final TrainState is left in it under "state" for an in-process caller.
    A pod that sees N > 1 CUDA devices (or is given `local_ranks` > 1) runs
    as N local ranks under the pod supervisor (parallel/launch.py) and
    returns the pod's exit code; with one it trains in this process."""
    argv = sys.argv[1:] if argv is None else argv
    ap = build_parser()
    args = ap.parse_args(argv)
    n_local = _local_ranks(args, local_ranks)
    check_flags(ap, args, n_local)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda was asked for but no CUDA device is "
              "available; pass --device cpu to run on the CPU", file=sys.stderr)
        return 1
    if n_local > 1:
        from tf_operator_tpu_torch.parallel import launch

        return launch.run_pod(launch.rank_command(argv), n_local)

    from tf_operator_tpu_torch import chaos as chaos_lib
    from tf_operator_tpu_torch.telemetry import tracer
    from tf_operator_tpu_torch.utils.preemption import HeartbeatWriter, PreemptionGuard

    chaos_env_prev = os.environ.get(chaos_lib.ENV_CHAOS)
    try:
        if args.chaos is not None:
            # Validate before touching the env: a typo'd spec fails here.
            chaos_lib.parse_chaos(args.chaos)
            os.environ[chaos_lib.ENV_CHAOS] = args.chaos
        chaos = chaos_lib.TrainerChaos.from_env()
    except ValueError as e:
        ap.error(str(e))
    if args.trace:
        # A fresh window: clear() also restarts the ts epoch, so an
        # in-process re-run does not carry a previous run's spans.
        tracer.configure(enabled=True).clear()
    # Installed after the flag checks, so ap.error never touches the
    # process's signal disposition; restored in the finally below.
    guard = PreemptionGuard()
    guard.install()
    heartbeat = HeartbeatWriter.from_env()
    heartbeat.write(0, force=True)
    try:
        rc = _run_trainer(args, torch.device(args.device), heartbeat, guard, chaos,
                          state_out)
        if rc == 0:
            # Clean completion only: a preempted or failing gang must not
            # wait on a barrier its dying peers never reach.
            from tf_operator_tpu_torch.parallel.distributed import distributed_goodbye

            distributed_goodbye()
        return rc
    except PeerLostError as e:
        # A peer died (or wedged past the group's timeout): exit retryably,
        # so the operator rolls the gang instead of failing the job.
        from tf_operator_tpu_torch.utils.exit_codes import EXIT_USER_RETRYABLE

        print(f"error: {e}", file=sys.stderr)
        _emit({"event": "peer_lost", "error": str(e)[:500],
               "exit_code": EXIT_USER_RETRYABLE})
        return EXIT_USER_RETRYABLE
    finally:
        # The trace goes out on every exit path (done, preempted, the
        # evaluator's returns, an exception), after the writer's spans.
        _maybe_export_trace(args)
        guard.uninstall()
        chaos_lib.reset_ckpt_stall_state()
        if args.chaos is not None:
            if chaos_env_prev is None:
                os.environ.pop(chaos_lib.ENV_CHAOS, None)
            else:
                os.environ[chaos_lib.ENV_CHAOS] = chaos_env_prev
        from tf_operator_tpu_torch.parallel import peer_watch

        if peer_watch.wedged():
            # A world whose communicators would not abort (its CUDA graph's
            # kernels still wait on the lost peer) cannot be torn down:
            # leave at once, retryable, the peer_lost event written.
            from tf_operator_tpu_torch.utils.exit_codes import EXIT_USER_RETRYABLE

            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(EXIT_USER_RETRYABLE)


def _rank() -> str:
    """Replica identity for per-pod trace and profile files; a pod's local
    ranks past 0 add their own suffix."""
    name = (f"{os.environ.get('TPUJOB_REPLICA_TYPE') or 'local'}-"
            f"{os.environ.get('TPUJOB_REPLICA_INDEX', '0')}")
    local = os.environ.get(ENV_LOCAL_RANK, "0")
    return name if local == "0" else f"{name}-local{local}"


def _trace_window_check(args, steps_done: int) -> None:
    """Close the --trace-steps window: once N steps are recorded the tracer
    disables, so the ring holds the window and not the run's tail."""
    if args.trace and args.trace_steps and steps_done >= args.trace_steps:
        from tf_operator_tpu_torch.telemetry import tracer

        tracer.get_tracer().enabled = False


def _maybe_export_trace(args) -> None:
    """Write the Chrome trace-event JSON (Perfetto, chrome://tracing) and
    emit trace_done with its path. The device phases' track is left out of
    a world whose card never finishes its queue (peer_watch.wedged)."""
    if not args.trace:
        return
    from tf_operator_tpu_torch.parallel import peer_watch
    from tf_operator_tpu_torch.telemetry import tracer

    t = tracer.get_tracer()
    t.enabled = False  # the export is not part of the trace
    path = os.path.join(args.trace_dir or "traces", f"{_rank()}.trace.json")
    n = t.export(path, device=not peer_watch.wedged())
    _emit({"event": "trace_done", "path": path, "events": n,
           "dropped_events": t.dropped_events})


class _Profile:
    """A torch.profiler trace of the host and (on CUDA) the device, written
    as Chrome trace JSON under <profile_dir>/<rank>/ when stopped."""

    def __init__(self, profile_dir: str, device: torch.device) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.dir = os.path.join(profile_dir, _rank())
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()
        _emit({"event": "profile_start", "dir": self.dir})

    def stop(self) -> str:
        self._prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, "trace.json")
        self._prof.export_chrome_trace(path)
        return path


def use_chunked_loss(args, mesh, vocab_size: int) -> bool:
    """Whether the LM losses take the chunked head: the JAX trainer's
    cutover, _logits_bytes(args, mesh, vocab) >= 6e9. The f32 logits
    [batch, seq, vocab] are divided by dp x fsdp, the axes that split the
    batch. tp and sp stay out on purpose, as there: tp splits the vocab, but
    the loss's gather along it may bring back the whole row a device, and
    sp's split of the sequence is not one the JAX trainer makes itself, so
    the estimate errs on the side of the chunked head."""
    from tf_operator_tpu_torch.parallel.mesh import axis_size

    shards = 1 if mesh is None else max(1, axis_size(mesh, "dp") * axis_size(mesh, "fsdp"))
    return 4.0 * args.batch * args.seq * vocab_size / shards >= CHUNKED_LOSS_BYTES


def _build_model(args, device: torch.device, mesh=None):
    """(model, loss_fn(model, batch), make_batch(generator)) of --model,
    with weights from a seeded flax-like init; the transformers' attention
    over `mesh` (parallel.mesh.Mesh: ring attention or Ulysses where it
    has sp > 1). The loss functions take the whole rows of the batch and
    run the model's sequence shard of them (model.trunk.seq_shard)."""
    from tf_operator_tpu_torch.parallel.train_step import seq_slice

    gen = torch.Generator(device=device).manual_seed(0)
    if args.model == "transformer-lm":
        from tf_operator_tpu_torch.models import transformer as tfm
        from tf_operator_tpu_torch.parallel.ring_attention import make_attention_fn

        cfg = tfm.TransformerConfig(
            vocab_size=VOCAB, num_layers=args.layers, hidden=args.hidden,
            num_heads=args.heads, max_len=args.seq, causal=True, dtype=COMPUTE_DTYPE,
            # --remat also remats per block; save-flash keeps the flash
            # residuals of every block (or of the first K).
            remat_layers=args.remat, remat_save_flash=args.remat_save_flash,
            remat_save_flash_layers=args.remat_save_flash_layers,
        )
        model = tfm.TransformerLM(cfg, attn_fn=make_attention_fn(mesh, causal=True),
                                  device=device, generator=gen)
        # Past ~6 GB of f32 logits a device the head and softmax run per
        # sequence chunk.
        chunked_loss = use_chunked_loss(args, mesh, cfg.vocab_size)

        def loss_fn(model, batch):
            tokens, seq = batch["tokens"], model.trunk.seq_shard
            local = seq_slice(tokens, seq)
            if chunked_loss:
                return tfm.lm_loss_chunked(model.hidden(local), _full_head(model), tokens,
                                           seq=seq)
            return tfm.lm_loss(model(local), tokens, seq)

        def make_batch(g):
            return {"tokens": torch.randint(0, cfg.vocab_size, (args.batch, args.seq),
                                            generator=g, device=device)}

        return model, loss_fn, make_batch

    if args.model == "moe-lm":
        from tf_operator_tpu_torch.models import moe
        from tf_operator_tpu_torch.parallel.ring_attention import make_attention_fn

        # The JAX trainer's branch: 8 experts, top-2, every 2nd block, the
        # chunked head at the LM's cutover, only the loss-level --remat.
        cfg = moe.MoEConfig(vocab_size=VOCAB, num_layers=args.layers, hidden=args.hidden,
                            num_heads=args.heads, max_len=args.seq, num_experts=8, top_k=2,
                            moe_every=2, dispatch=args.moe_dispatch, dtype=COMPUTE_DTYPE)
        model = moe.MoETransformerLM(cfg, attn_fn=make_attention_fn(mesh, causal=True),
                                     device=device, generator=gen)
        chunked_loss = use_chunked_loss(args, mesh, cfg.vocab_size)

        def loss_fn(model, batch):
            head = _full_head(model) if chunked_loss else None
            return moe.moe_lm_loss(model, batch["tokens"], chunked=chunked_loss,
                                   seq=model.trunk.seq_shard, head_weight=head)

        def make_batch(g):
            return {"tokens": torch.randint(0, cfg.vocab_size, (args.batch, args.seq),
                                            generator=g, device=device)}

        return model, loss_fn, make_batch

    if args.model in ("bert-base", "bert-tiny"):
        from tf_operator_tpu_torch.models import transformer as tfm
        from tf_operator_tpu_torch.parallel.ring_attention import make_attention_fn

        # The JAX trainer's branch: the config's own widths (--layers,
        # --hidden and --heads do not apply), full attention, and only the
        # loss-level --remat.
        base = tfm.BERT_BASE if args.model == "bert-base" else tfm.TINY
        cfg = tfm.TransformerConfig(
            vocab_size=base.vocab_size, num_layers=base.num_layers, hidden=base.hidden,
            num_heads=base.num_heads, max_len=max(args.seq, 8), causal=False,
            dtype=COMPUTE_DTYPE)
        model = tfm.BertMLM(cfg, attn_fn=make_attention_fn(mesh, causal=False), device=device,
                            generator=gen)

        def loss_fn(model, batch):
            seq = model.trunk.seq_shard
            tokens, targets, mask = (seq_slice(batch[k], seq)
                                     for k in ("tokens", "targets", "mask"))
            return tfm.mlm_loss(model(tokens), targets, mask)

        def make_batch(g):
            return tfm.make_mlm_batch(g, args.batch, args.seq, cfg.vocab_size)

        return model, loss_fn, make_batch

    from tf_operator_tpu_torch.models import mnist

    if args.model in ("mnist-mlp", "mnist-conv"):
        classes, shape = 10, (args.batch, 28, 28)
        cls = mnist.MLP if args.model == "mnist-mlp" else mnist.ConvNet
        model = cls(dtype=COMPUTE_DTYPE, device=device, generator=gen)
    else:
        from tf_operator_tpu_torch.models import resnet

        classes = 1000
        shape = (args.batch, args.image_size, args.image_size, 3)
        cls = resnet.ResNet50 if args.model == "resnet50" else resnet.ResNet18
        model = cls(num_classes=classes, dtype=COMPUTE_DTYPE, device=device, generator=gen)
    resnet_loss = args.model.startswith("resnet")

    def loss_fn(model, batch):
        x = batch["x"]
        if resnet_loss and x.dtype == torch.uint8:
            # The JAX ResNet loss's branch for callers that hand it raw
            # uint8 pixels (the --data-dir path normalises before the loss).
            from tf_operator_tpu_torch.data.staging import normalize_uint8

            x = normalize_uint8(x)
        return mnist.cross_entropy_loss(model(x), batch["y"])

    def make_batch(g):
        return {"x": torch.randn(shape, generator=g, device=device),
                "y": torch.randint(0, classes, (args.batch,), generator=g, device=device)}

    return model, loss_fn, make_batch


def _full_head(model):
    """The LM head's whole [vocab, hidden] weight for the chunked loss: its
    fsdp shards gathered, then its vocabulary's tp shards."""
    from tf_operator_tpu_torch.parallel import collectives
    from tf_operator_tpu_torch.parallel.train_step import full_params

    with full_params(model.lm_head):
        head = model.lm_head.weight
    if model.lm_head.tp is not None:
        head = collectives.gather_from(head, 0, model.lm_head.tp.group)
    return head


def _sharding_rules(args):
    """The JAX trainer's rule table for --model: the MoE rules (the
    experts over ep and tp, then the transformer's), the transformer
    family's tensor-parallel rules, none (replicated, then fsdp) for the
    rest."""
    from tf_operator_tpu_torch.parallel import sharding_rules

    if args.model == "moe-lm":
        return sharding_rules.MOE_RULES
    if args.model in ("transformer-lm", "bert-base", "bert-tiny"):
        return sharding_rules.TRANSFORMER_TP_RULES
    return None


def _is_checkpoint_writer() -> bool:
    """Chief (or worker-0 when no chief exists) writes checkpoints. A
    standalone run (no operator env) always writes."""
    rtype = os.environ.get("TPUJOB_REPLICA_TYPE", "").lower()
    if not rtype:
        return True
    if rtype in ("chief", "master"):
        return True
    if rtype != "worker" or os.environ.get("TPUJOB_REPLICA_INDEX", "0") != "0":
        return False
    # Worker-0 writes only when the job has no chief/master (one writer per
    # checkpoint dir); the injected ClusterSpec says whether one exists.
    try:
        cluster = json.loads(os.environ.get("TF_CONFIG", "{}")).get("cluster", {})
    except ValueError:
        cluster = {}
    return not ("chief" in cluster or "master" in cluster)


@dataclasses.dataclass
class _SaveItem:
    """One checkpoint save, detached from the device: host copies of both
    trees that the item owns, and the sharding-manifest payload."""

    ckpt_dir: str
    step: int
    host_params: dict
    host_aux: dict
    info: dict
    final: bool
    keep: int


class _PinnedPool:
    """Two sets of pinned host buffers, one per leaf, used in turn by the
    snapshots. A set is reused only after the writer is done with it: the
    snapshot of save N + 2 runs after save N + 1 was handed over, and the
    hand-over waits until save N was written."""

    def __init__(self) -> None:
        self._sets: list[dict] = [{}, {}]
        self._turn = 0

    def take(self) -> dict:
        self._turn ^= 1
        return self._sets[self._turn]


def _host_tree(tree: dict, buffers: dict) -> dict:
    """Host copies of a flat tree's tensors that the copy owns: a CUDA
    tensor goes into its pinned buffer (non_blocking; the caller waits on
    the stream before handing the copies over), a CPU tensor is cloned.
    Scalars pass through."""
    out = {}
    for key, leaf in tree.items():
        if not isinstance(leaf, torch.Tensor):
            out[key] = leaf
        elif leaf.device.type == "cuda":
            buf = buffers.get(key)
            if buf is None or buf.shape != leaf.shape or buf.dtype != leaf.dtype:
                buf = buffers[key] = torch.empty(leaf.shape, dtype=leaf.dtype,
                                                 pin_memory=True)
            out[key] = buf.copy_(leaf, non_blocking=True)
        else:
            out[key] = leaf.detach().to("cpu", copy=True)
    return out


def _split_state(state, plan=None) -> tuple[dict, dict]:
    """(params {name: tensor}, the resume payload: everything else of
    state_tensors), every sharded leaf gathered to its full tensor (a
    collective on every rank of a sharded world)."""
    from tf_operator_tpu_torch.parallel.train_step import full_state_tensors

    tensors = full_state_tensors(state, plan)
    params = {k[len("params/"):]: v for k, v in tensors.items() if k.startswith("params/")}
    aux = {k: v for k, v in tensors.items() if not k.startswith("params/")}
    return params, aux


def _gang_shape(plan) -> dict:
    """The gang a checkpoint is saved from (or resumed into), as the
    sharding manifest records it."""
    from tf_operator_tpu_torch.parallel import mesh as mesh_lib

    return {"processCount": plan.mesh.world, "deviceCount": plan.mesh.world,
            "mesh": mesh_lib.shape_dict(plan.mesh)}


def _leaf_specs(plan, prefixes: tuple[str, ...]) -> dict:
    """keystr path -> spec of each parameter leaf under `prefixes` (""
    for the params tree, "mu/" etc. for the resume payload's)."""
    from tf_operator_tpu_torch.models import checkpoint as ckpt

    return dict(ckpt.flatten({f"{pre}{n}": spec for pre in prefixes
                              for n, spec in plan.specs.items()}))


def _snapshot_state(ckpt_dir: str, step: int, state, final: bool, keep: int,
                    pool: _PinnedPool, plan=None) -> _SaveItem:
    """Blocking snapshot leg: device->host copies of params and the resume
    payload at a step boundary (gathered to full tensors under a sharding
    plan), ordered on the stream before any later in-place update, and
    waited for before the item is returned, so the writer thread never
    touches the device."""
    from tf_operator_tpu_torch.models import checkpoint as ckpt
    from tf_operator_tpu_torch.parallel.train_step import ParallelPlan

    plan = plan or ParallelPlan()
    params, aux = _split_state(state, plan)
    buffers = pool.take()
    host_params = _host_tree(params, buffers)
    host_aux = _host_tree(aux, buffers)
    if any(t.device.type == "cuda" for t in params.values()):
        from tf_operator_tpu_torch.parallel import peer_watch

        done = torch.cuda.Event()
        done.record()
        peer_watch.synchronize(done, "the checkpoint snapshot")
    info = {**_gang_shape(plan),
            "leaves": ckpt.leaf_shardings(host_params, _leaf_specs(plan, ("",))),
            "auxLeaves": ckpt.leaf_shardings(host_aux,
                                             _leaf_specs(plan, ("mu/", "nu/", "master/")))}
    return _SaveItem(ckpt_dir=ckpt_dir, step=step, host_params=host_params,
                     host_aux=host_aux, info=info, final=final, keep=keep)


def _write_snapshot(item: _SaveItem, digest: bool, heartbeat=None, chaos=None) -> None:
    """Write leg: the trainstate first (so any visible step_<N> has its
    resume payload beside it), then the params, the sharding manifest with
    digests, FINAL, the `checkpoint` event, retention and a `torn:step=N`
    chaos directive's damage, and only then the forced heartbeat: progress
    counts from a durable save. Runs on the writer thread in async mode and
    inline in sync mode; it only writes files."""
    from tf_operator_tpu_torch.models import checkpoint as ckpt
    from tf_operator_tpu_torch.telemetry import tracer

    with tracer.span("checkpoint/ckpt_write", step=item.step, final=item.final):
        ckpt.save_named(item.ckpt_dir, f"trainstate_{item.step}", item.host_aux)
        path = ckpt.save(item.ckpt_dir, item.step, item.host_params)
        info = dict(item.info)
        if digest:
            info["digest"] = {"params": ckpt.tree_digest(item.host_params),
                              "trainstate": ckpt.tree_digest(item.host_aux)}
        ckpt.write_sharding_manifest(item.ckpt_dir, f"step_{item.step}", info)
        if item.final:
            ckpt.mark_final(item.ckpt_dir, item.step)
        _emit({"event": "checkpoint", "step": item.step, "path": path, "final": item.final})
        if item.keep:
            pruned = ckpt.prune_checkpoints(item.ckpt_dir, item.keep)
            if pruned:
                _emit({"event": "checkpoint_pruned", "steps": pruned, "keep": item.keep})
        torn = chaos.tear_for_step(item.step) if chaos is not None else None
        if torn is not None:
            from tf_operator_tpu_torch import chaos as chaos_lib

            chaos.state.mark(torn)
            damaged = chaos_lib.tear_checkpoint(item.ckpt_dir, item.step,
                                                torn.params.get("mode", "truncate"))
            _emit({"event": "chaos_torn_checkpoint", "step": item.step, "path": damaged})
    if heartbeat is not None:
        heartbeat.write(item.step, force=True)


def _ckpt_writer_main(writer: "_CkptWriter") -> None:
    """ckpt-writer thread body: drain the single-slot queue, timing each
    write leg. The first failure is latched and the thread exits; the next
    submit/drain raises it again on the step loop."""
    while True:
        with writer._cond:
            while writer._item is None and not writer._stop:
                writer._cond.wait()
            if writer._item is None:
                return  # stopped with an empty slot
            item = writer._item
        try:
            t0 = time.monotonic()
            writer.write(item)
            dt = time.monotonic() - t0
        except Exception as e:  # noqa: BLE001 — latched, raised again on the step loop
            with writer._cond:
                writer._error = e
                writer._item = None
                writer._cond.notify_all()
            return
        with writer._cond:
            writer.write_s += dt
            writer.saves += 1
            writer.last_step = item.step
            writer._item = None
            writer._cond.notify_all()


class _CkptWriter:
    """Single-slot async checkpoint write pipeline: exactly one save in
    flight; submit() of the next blocks (backpressure) until the previous
    write leg is done. `drains`/`drain_wait_s` record how often and how
    long the step loop waited: the visible share of the write time
    (hidden_fraction in the done event). `write` is the write leg,
    _write_snapshot bound to the run's settings."""

    def __init__(self, write: Callable[[_SaveItem], None]) -> None:
        self.write = write
        self._cond = threading.Condition()
        self._item: _SaveItem | None = None
        self._stop = False
        self._error: BaseException | None = None
        self.last_step: int | None = None  # newest durable step
        self.saves = 0
        self.write_s = 0.0
        self.snapshot_s = 0.0
        self.drains = 0          # submits that hit backpressure
        self.drain_wait_s = 0.0  # seconds the step loop blocked on them
        self._thread = threading.Thread(target=_ckpt_writer_main, args=(self,),
                                        name="ckpt-writer", daemon=True)
        self._thread.start()

    @property
    def error(self) -> BaseException | None:
        with self._cond:
            return self._error

    def _raise_pending(self) -> None:
        if self._error is not None:
            raise RuntimeError(
                f"async checkpoint write failed: "
                f"{type(self._error).__name__}: {self._error}") from self._error

    def submit(self, item: _SaveItem) -> None:
        """Hand a snapshot to the writer; blocks while the previous save is
        still writing (the backpressure leg of the snapshot phase)."""
        with self._cond:
            self._raise_pending()
            if self._item is not None:
                self.drains += 1
                t0 = time.monotonic()
                while self._item is not None and self._error is None:
                    self._cond.wait()
                self.drain_wait_s += time.monotonic() - t0
                self._raise_pending()
            self._item = item
            self._cond.notify_all()

    def drain(self, raise_error: bool = True) -> float:
        """Block until no write is queued or in flight; returns the seconds
        waited (not counted into drain_wait_s: the final drain stalls the
        job's end, not the step loop)."""
        t0 = time.monotonic()
        with self._cond:
            while self._item is not None and self._error is None:
                self._cond.wait()
            if raise_error:
                self._raise_pending()
        return time.monotonic() - t0

    def mean_write_s(self) -> float:
        with self._cond:
            return self.write_s / self.saves if self.saves else 0.0

    def mean_save_s(self) -> float:
        """Mean full save cost (snapshot + write) over completed saves: what
        a synchronous emergency save is expected to cost."""
        with self._cond:
            return (self.snapshot_s + self.write_s) / self.saves if self.saves else 0.0

    def note_snapshot(self, seconds: float) -> None:
        with self._cond:
            self.snapshot_s += seconds

    def stats(self) -> dict:
        with self._cond:
            hidden = (max(0.0, 1.0 - self.drain_wait_s / self.write_s)
                      if self.write_s > 0 else None)
            return {
                "mode": "async",
                "saves": self.saves,
                "snapshot_s": round(self.snapshot_s, 6),
                "write_s": round(self.write_s, 6),
                "drains": self.drains,
                "drain_wait_s": round(self.drain_wait_s, 6),
                "hidden_fraction": round(hidden, 4) if hidden is not None else None,
            }

    def close(self) -> None:
        """Wait out any in-flight write, stop the thread and swallow a
        latched error (the normal paths raised it at submit/drain)."""
        self.drain(raise_error=False)
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=60.0)


@dataclasses.dataclass
class _Checkpointing:
    """A saving run's checkpoint settings and accounting: the directory,
    retention, whether saves record digests, the async writer (None in sync
    mode), the pinned snapshot buffers and the sync saves' totals. In a
    sharded world every rank has one, for the gathers of each snapshot;
    only the writer's (`writes`) writes."""

    ckpt_dir: str
    keep: int
    digest: bool
    heartbeat: Any = None
    chaos: Any = None
    writer: _CkptWriter | None = None
    plan: Any = None
    writes: bool = True
    pool: _PinnedPool = dataclasses.field(default_factory=_PinnedPool)
    sync_stats: dict = dataclasses.field(
        default_factory=lambda: {"saves": 0, "snapshot_s": 0.0, "write_s": 0.0})

    def write(self, item: _SaveItem) -> None:
        _write_snapshot(item, self.digest, self.heartbeat, self.chaos)


def _ckpt_done_stats(ck: _Checkpointing | None) -> dict | None:
    """The done event's `checkpoint` block, whatever the mode (None when
    the run never saved)."""
    if ck is None:
        return None
    if ck.writer is not None:
        return ck.writer.stats()
    s = ck.sync_stats
    if not s["saves"]:
        return None
    return {"mode": "sync", "saves": s["saves"], "snapshot_s": round(s["snapshot_s"], 6),
            "write_s": round(s["write_s"], 6), "drains": 0, "drain_wait_s": 0.0,
            "hidden_fraction": 0.0}


def _save_checkpoint(ck: _Checkpointing, step: int, state, final: bool = False,
                     st=None, sync: bool = False) -> float:
    """step_<N> holds the params only, trainstate_<N> the resume payload.
    Async (a writer exists): only the snapshot and any backpressure wait
    block the step loop (phase `ckpt_snapshot`); a final save drains before
    returning, since job completion is durable completion. Sync (no writer,
    or sync=True for the preemption fast path): both legs inline under the
    `checkpoint` phase. Returns the estimated seconds of a synchronous save,
    the preemption guard's estimate against the grace budget."""
    if not ck.writes:
        _split_state(state, ck.plan)  # the gathers the writer's snapshot runs
        return 0.0
    writer = ck.writer
    t0 = time.monotonic()
    if writer is None or sync:
        with st.phase("checkpoint") if st is not None else contextlib.nullcontext():
            item = _snapshot_state(ck.ckpt_dir, step, state, final, ck.keep, ck.pool,
                                   ck.plan)
            snap_s = time.monotonic() - t0
            ck.write(item)
        total = time.monotonic() - t0
        ck.sync_stats["saves"] += 1
        ck.sync_stats["snapshot_s"] += snap_s
        ck.sync_stats["write_s"] += total - snap_s
        return total
    with st.phase("ckpt_snapshot") if st is not None else contextlib.nullcontext():
        # The phase covers the snapshot and any backpressure wait inside
        # submit; the done block keeps the two apart (snapshot_s, and the
        # writer's drain_wait_s).
        item = _snapshot_state(ck.ckpt_dir, step, state, final, ck.keep, ck.pool, ck.plan)
        snap_s = time.monotonic() - t0
        writer.submit(item)
    writer.note_snapshot(snap_s)
    if final:
        writer.drain()
    return snap_s + writer.mean_write_s()


def _try_resume(ckpt_dir: str | None, state, tx, allow_reshape: bool, plan):
    """Restore the newest restorable checkpoint, if any: (state, start_step).

    The walk goes newest first through list_steps. A step whose census
    fails validate_step is skipped with a `resume_fallback` event
    (`invalid_checkpoint`), and so is a step saved at another gang shape
    (`foreign_shape`: another process count or mesh) unless allow_reshape,
    which then checks the per-leaf global shapes against this model
    (`reshard_shape_mismatch`). Only the steps walked past are validated. A
    restore that raises skips to the next candidate (`restore_error`);
    nothing left is a step-0 cold start (`no_valid_checkpoint`). A step_<N>
    without a usable trainstate_<N> (torn, missing, or written under another
    optimizer layout) resumes params-only with a fresh optimizer, whose
    master copy under master weights comes from the restored params. Params
    restore at the optimizer's master precision (f32 under master weights)
    and the compute copy is re-derived. Checkpoints hold full tensors; each
    rank keeps its parts (`plan`). The `resumed` event carries crc32 digests
    of the restored host bytes beside the ones the save recorded, and a
    `reshaped` block when the gang shape changed.

    In a world of several processes every rank walks the shared directory
    itself, then they agree (collectives.agree_int, each verdict seen by
    every rank at once): on the chosen step and on the full-vs-params-only
    choice. A rank that differs from process 0 raises the JAX trainer's
    visibility error (exit 1), and the ranks that agree with process 0 raise
    PeerLostError (exit 138), since their peer leaves; a restore error
    raises instead of walking further, since the ranks agreed on that step
    only."""
    from tf_operator_tpu_torch.models import checkpoint as ckpt
    from tf_operator_tpu_torch.parallel.collectives import agree_int
    from tf_operator_tpu_torch.parallel.train_step import (
        load_state_tensors,
        local_state_tensors,
    )

    if not ckpt_dir:
        return state, 0
    multi = plan.mesh.world > 1
    all_steps = ckpt.list_steps(ckpt_dir)
    ordered = list(reversed(all_steps))  # newest first
    cur_shape = {k: _gang_shape(plan)[k] for k in ("processCount", "mesh")}
    params, aux = _split_state(state)  # this rank's tensors: dtypes only
    master_dtype = torch.float32 if tx.config.master_weights else None
    p_template = {k: master_dtype or v.dtype for k, v in params.items()}
    template_shapes = {k: v["shape"] for k, v in ckpt.leaf_shardings(
        {k: torch.empty(shape, device="meta") for k, shape in plan.full_shapes.items()}).items()}

    def candidate_gate(s: int) -> tuple[bool, dict | None, dict | None]:
        """(restorable, sharding manifest, the saved gang shape when it
        differs from this one)."""
        if not ckpt.validate_step(ckpt_dir, s):
            _emit({"event": "resume_fallback", "skipped_step": s,
                   "reason": "invalid_checkpoint"})
            return False, None, None
        sm = ckpt.read_sharding_manifest(ckpt_dir, f"step_{s}")
        if sm is None:
            if allow_reshape:
                _emit({"event": "resume_fallback", "step": s,
                       "reason": "missing_sharding_manifest: shape unverifiable, "
                                 "same-shape restore only"})
            return True, None, None
        saved = {"processCount": int(sm.get("processCount") or 0),
                 "mesh": {k: int(v) for k, v in (sm.get("mesh") or {}).items()}}
        if saved == cur_shape:
            return True, sm, None
        if not allow_reshape:
            _emit({"event": "resume_fallback", "skipped_step": s,
                   "reason": (f"foreign_shape: saved on {saved['processCount']} "
                              f"process(es), mesh {saved['mesh']} (running "
                              f"{cur_shape['processCount']}, {cur_shape['mesh']}); "
                              f"pass --allow-reshape to reshard")})
            return False, sm, None
        saved_shapes = {k: v.get("shape") for k, v in (sm.get("leaves") or {}).items()}
        if saved_shapes != template_shapes:
            _emit({"event": "resume_fallback", "skipped_step": s,
                   "reason": "reshard_shape_mismatch: per-leaf global shapes differ "
                             "from this model config"})
            return False, sm, None
        return True, sm, saved

    def next_restorable(i: int) -> tuple[int, int | None, dict | None, dict | None]:
        while i < len(ordered):
            ok, sm, reshaped = candidate_gate(ordered[i])
            if ok:
                return i, ordered[i], sm, reshaped
            i += 1
        return len(ordered), None, None, None

    def cold_start(warning: str):
        print(f"warning: {warning} — cold-starting from step 0", file=sys.stderr)
        _emit({"event": "resume_fallback", "to_step": 0, "reason": "no_valid_checkpoint",
               "steps_seen": len(all_steps)})
        return state, 0

    idx, last, sharding_m, reshaped = next_restorable(0)
    if multi:
        # Every rank runs this agreement (sentinel -1 = sees nothing) before
        # any early return, else the check itself deadlocks.
        agree_int(-1 if last is None else last, lambda mine, first: (
            f"checkpoint visibility differs across replicas (this process sees step "
            f"{mine}, process 0 sees {first}) — mount a shared --checkpoint-dir volume"),
            device=plan.device)
    if last is None:  # step_0 is a valid (externally seeded) checkpoint
        if all_steps:
            return cold_start(f"no restorable checkpoint under {ckpt_dir} (all "
                              f"{len(all_steps)} step dirs failed validation)")
        return state, 0
    raw_params = None
    while last is not None:
        try:
            raw_params = ckpt.restore(ckpt_dir, last)
            restored = ckpt.cast_to_template(raw_params, p_template)
            break
        except Exception as e:  # noqa: BLE001 — a torn tree raises anything
            if multi:
                raise  # the ranks agreed on `last` only: fail loud, retry the pod
            _emit({"event": "resume_fallback", "skipped_step": last,
                   "reason": f"restore_error: {type(e).__name__}: {e}"})
            raw_params = None
            idx, last, sharding_m, reshaped = next_restorable(idx + 1)
    if raw_params is None:
        return cold_start(f"every checkpoint under {ckpt_dir} failed to restore")
    raw_aux = None
    try:
        if not ckpt.validate_named(ckpt_dir, f"trainstate_{last}"):
            # A torn resume payload beside intact params: a params-only
            # resume beats walking further back.
            _emit({"event": "resume_fallback", "skipped_step": last,
                   "reason": "invalid_trainstate", "params_only": True})
            raise FileNotFoundError(f"trainstate_{last}")
        raw_aux = ckpt.restore_named(ckpt_dir, f"trainstate_{last}")
        full = {**{f"params/{k}": v for k, v in restored.items()},
                **ckpt.cast_to_template(raw_aux, {k: getattr(v, "dtype", v)
                                                  for k, v in aux.items()})}
        state = load_state_tensors(state, local_state_tensors(full, plan))
        partial = False
    except Exception:  # noqa: BLE001 — any unusable payload degrades, below
        # A params-only checkpoint, or a trainstate written under another
        # optimizer layout (ValueError from the leaf-list check), or torn
        # past its census: a fresh optimizer, the step from the dir name.
        raw_aux, partial = None, True
        state = _params_only_state(state, tx, restored, last, plan)
    if multi:
        # The ranks agreed on the step; they must also agree on full vs
        # params-only, or one trains on restored Adam moments and another
        # on fresh ones, and the model silently diverges.
        def kind(p: int) -> str:
            return "params-only" if p else "full"

        agree_int(int(partial), lambda mine, first: (
            f"trainstate_{last} visibility differs across replicas (this process "
            f"resumes {kind(mine)}, process 0 {kind(first)}) — shared --checkpoint-dir "
            f"volume lagging; retrying"), device=plan.device)
    event = {"event": "resumed", "from_step": state.step, "params_only": partial}
    saved_digest = (sharding_m.get("digest") or {}) if sharding_m else {}
    if saved_digest:
        # Bit-equality witness: crc32 of the restored host bytes (at their
        # saved dtypes) against what the save recorded.
        digest = {}
        if "params" in saved_digest:
            digest["params"] = ckpt.tree_digest(raw_params)
        if raw_aux is not None and "trainstate" in saved_digest:
            digest["trainstate"] = ckpt.tree_digest(raw_aux)
        if digest:
            event["digest"] = digest
            event["saved_digest"] = {k: saved_digest[k] for k in digest}
    if reshaped is not None:
        event["reshaped"] = {"from_processes": reshaped["processCount"],
                             "from_mesh": reshaped["mesh"],
                             "to_processes": cur_shape["processCount"],
                             "to_mesh": cur_shape["mesh"]}
    _emit(event)
    return state, state.step


def _params_only_state(state, tx, params: dict, step: int, plan):
    """The state with the restored params (full tensors at master
    precision; this rank's parts) loaded, a fresh optimizer built from
    them, and the step set: the resume of a step_<N> without its
    trainstate."""
    from tf_operator_tpu_torch.parallel.train_step import TrainState

    live = dict(state.model.named_parameters())
    on_device = [plan.local(i, params[n].to(p.device)) for i, (n, p) in enumerate(live.items())]
    opt_state = tx.init(on_device)
    with torch.no_grad():
        for p, new in zip(live.values(), on_device):
            p.copy_(new)
    return TrainState(step, state.model, opt_state)


def _preempt_exit(args, guard, state, done: int, ck: _Checkpointing | None,
                  last_save_s: float, last_ckpt_step: int, plan, st=None) -> int:
    """Graceful-preemption teardown at a chunk boundary: drain the in-flight
    async write first (its seconds burn the grace budget through
    guard.elapsed()), adopt the drained save as the emergency checkpoint
    when it is this boundary's step or newer, else save synchronously when
    the remaining budget still covers the estimated save. In a world of
    several processes the writer's verdict is broadcast, so every rank
    joins the gathers of a synchronous save and reports the gang's
    checkpoint. Emits `preempted` and returns 128+signum for the operator's
    ExitCode policy (143 on a rank whose peer took the signal)."""
    saved = False
    skipped = None
    drain_s = None
    adopted = False
    emergency_s = None
    sync_save = False
    if ck is not None and ck.writes:
        writer = ck.writer
        if writer is not None:
            # Drain, don't abandon: the write is mostly on disk already, and
            # a clean drain turns it into a usable emergency checkpoint.
            # Errors degrade to the fast path.
            drain_s = writer.drain(raise_error=False)
            # The estimate taken at submit time did not know the in-flight
            # write's cost; the means now include it.
            last_save_s = max(last_save_s, writer.mean_save_s())
            if (writer.error is None and writer.last_step is not None
                    and writer.last_step >= done):
                saved = adopted = True
        if not saved:
            if writer is None and done == last_ckpt_step:
                saved = True  # this boundary's periodic sync save landed
            elif guard.within_grace(last_save_s, args.preempt_grace):
                sync_save = True
            else:
                skipped = "grace_budget"
    if plan.mesh.world > 1:
        from tf_operator_tpu_torch.parallel.collectives import broadcast_int

        verdict = broadcast_int(2 if sync_save else int(saved), device=plan.device)
        sync_save, saved = verdict == 2, verdict == 1
    if sync_save:
        if ck is not None:  # a non-writer's runs the gathers only
            seconds = _save_checkpoint(ck, done, state, st=st, sync=True)
            emergency_s = seconds if ck.writes else None
        saved = True
    event = {
        "event": "preempted",
        "step": done,
        "signal": guard.signal_name,
        "exit_code": guard.exit_code,
        "emergency_checkpoint": saved,
        "grace_s": args.preempt_grace,
        "elapsed_s": round(guard.elapsed(), 3),
    }
    if drain_s is not None:
        event["drain_s"] = round(drain_s, 3)
    if adopted:
        event["adopted_async_save"] = True
    if emergency_s is not None:
        event["emergency_save_s"] = round(emergency_s, 3)
    if skipped:
        event["save_skipped"] = skipped
    _emit(event)
    return guard.exit_code


def eval_route(device_type: str) -> tuple[str, str]:
    """("graph" or "eager", why) for the Evaluator on `device_type` (one
    process whatever its env says)."""
    if device_type != "cuda":
        return "eager", "CUDA graphs exist only on a CUDA device"
    return "graph", "the Evaluator on CUDA: each batch's loss replays one captured CUDA graph"


def evaluator(model, loss_fn, make_batch, device: torch.device, n_batches: int,
              graphed: bool = False) -> Callable[[], float]:
    """run() -> the mean loss of `model` over the evaluator's fixed
    batches: batch i is make_batch of a generator seeded 10_000 + i, so
    every round sees the same batches (made one at a time, never all held).
    The loss runs as the train step runs it (model in train mode), without
    gradients. graphed (eval_route): the loss is one graphed_step.GraphedStep
    over a static batch, into which each batch is copied before its replay,
    captured at the first batch on the model's parameters, which every later
    round must hold in place (the Evaluator copies each checkpoint into
    them); the same loss bit for bit."""
    def batch(i: int) -> dict:
        return make_batch(torch.Generator(device=device).manual_seed(10_000 + i))

    held: dict = {}

    def loss(b: dict) -> float:
        if not graphed:
            with torch.no_grad():
                return float(loss_fn(model, b))
        if not held:
            from tf_operator_tpu_torch.parallel.graphed_step import GraphedStep

            static = {k: v.clone() for k, v in b.items()}

            def body() -> dict:
                with torch.no_grad():
                    return {"loss": loss_fn(model, static)}

            held.update(static=static, step=GraphedStep(body))
        else:
            for k, v in b.items():
                held["static"][k].copy_(v)
        return float(held["step"]()["loss"])

    def run() -> float:
        model.train()
        losses = [loss(batch(i)) for i in range(n_batches)]
        return sum(losses) / len(losses)

    return run


def evaluate(model, loss_fn, make_batch, device: torch.device, n_batches: int) -> float:
    """The mean loss of `model` over the evaluator's fixed batches, eagerly
    (evaluator's run)."""
    return evaluator(model, loss_fn, make_batch, device, n_batches)()


def _run_evaluator(args, model, loss_fn, make_batch, device: torch.device, guard) -> int:
    """Evaluator replica: follow the checkpoint stream until FINAL,
    evaluating each new step's parameters on fixed batches."""
    from tf_operator_tpu_torch.models import checkpoint as ckpt
    from tf_operator_tpu_torch.telemetry import tracer

    if not args.checkpoint_dir:
        print("--eval requires --checkpoint-dir", file=sys.stderr)
        return 2
    template = {name: p.dtype for name, p in model.named_parameters()}
    route, route_why = eval_route(device.type)
    _emit({"event": "eval_ready", "t": time.time(), "step_route": route,
           "step_route_why": route_why})
    run = evaluator(model, loss_fn, make_batch, device, args.steps, graphed=route == "graph")
    seen: set[int] = set()
    evaluated = 0
    while True:
        step = ckpt.wait_for_new_step(args.checkpoint_dir, seen, timeout=args.eval_timeout,
                                      should_stop=lambda: guard.triggered)
        if guard.triggered:
            _emit({"event": "preempted", "role": "evaluator",
                   "signal": guard.signal_name, "exit_code": guard.exit_code,
                   "checkpoints_evaluated": evaluated})
            return guard.exit_code
        if step is None:
            final = ckpt.final_step(args.checkpoint_dir)
            if final is not None and final in seen:
                break  # stream complete
            print(f"evaluator: no new checkpoint in {args.eval_timeout}s", file=sys.stderr)
            return 1 if evaluated == 0 else 0
        seen.add(step)
        params = ckpt.restore(args.checkpoint_dir, step, template=template)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(params[name])
        with tracer.span("eval", checkpoint_step=step, n_batches=args.steps):
            loss = run()
        evaluated += 1
        _emit({"event": "eval", "checkpoint_step": step, "eval_loss": round(loss, 6),
               "n_batches": args.steps})
    _emit({"event": "eval_done", "checkpoints_evaluated": evaluated})
    return 0


def _loss(t) -> float:
    """A step's loss on the host; in an NCCL world the wait for it is the
    watchdog's (parallel/peer_watch.py)."""
    from tf_operator_tpu_torch.parallel import peer_watch

    return peer_watch.read(t, "the step's loss")


def _device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _train_on_dataset(args, device: torch.device, state, start_step: int, loss_fn, tx,
                      t_start: float, maybe_checkpoint, check_boundary, finish,
                      plan, graphed: bool) -> int:
    """The --data-dir loop: host batches from the sharded dataset (this
    pod's shards and its --batch / pods rows of each global step, of which
    a pod's local rank i of N takes the i-th N-th,
    from start_step on, so a resumed run continues the uninterrupted
    sequence), fed through the prefetch thread or the staging ring, one
    step at a time. The uint8 wire is normalised here, on the step's
    thread, before the loss. The done event gets the ingest's `prefetch`
    or `staging` block. With `graphed` (graphed_step.step_route) each step
    is a replay of one captured CUDA graph, the counterpart of the JAX
    loop's jitted step: the batch is copied into the graph's static input
    on the step's stream first."""
    import itertools

    from tf_operator_tpu_torch.data import dataset as dataset_lib
    from tf_operator_tpu_torch.data import prefetch as prefetch_lib
    from tf_operator_tpu_torch.data import staging as staging_lib
    from tf_operator_tpu_torch.parallel import graphed_step
    from tf_operator_tpu_torch.parallel.train_step import remat_loss, train_step
    from tf_operator_tpu_torch.telemetry.phases import make_step_accounting

    reader, readers = dataset_lib.shard_from_env()
    ds = dataset_lib.ShardedDataset(args.data_dir, reader, readers)
    host_it = dataset_lib.local_part(
        ds.batches(args.batch // readers, seed=0, start_batch=start_step),
        *dataset_lib.local_part_from_env())
    prefetch_stats: dict = {}
    staging_stats: dict = {}
    tune = None
    lanes, chunks = args.staging_lanes, args.staging_chunks
    if args.input_staging == "staged":
        if args.staging_tune:
            # Peek one host batch, probe the ring's geometries with copies of
            # it, chain it back in front: the trajectory is an untuned run's.
            first = next(host_it)
            tune = staging_lib.autotune_staging(first, device=device,
                                                wire_dtype=args.wire_dtype,
                                                codec=args.wire_codec,
                                                depth=args.staging_depth)
            lanes, chunks = tune["lanes"], tune["chunks"]
            host_it = itertools.chain([first], host_it)
            _emit({"event": "staging_tuned", "lanes": lanes, "chunks": chunks,
                   "mb_per_s": tune["mb_per_s"], "probe_s": tune["probe_s"]})
        it = staging_lib.stage_to_device(host_it, depth=args.staging_depth, device=device,
                                         chunks=chunks, wire_dtype=args.wire_dtype,
                                         stats=staging_stats, lanes=lanes,
                                         codec=args.wire_codec)
    else:
        it = prefetch_lib.prefetch_to_device(
            (staging_lib.to_wire(b, args.wire_dtype) for b in host_it), depth=2,
            device=device, stats=prefetch_stats)
    preprocess = staging_lib.make_preprocess_fn()
    loss = remat_loss(loss_fn) if args.remat else loss_fn
    if graphed:
        step = graphed_step.graphed_batches(loss, tx, preprocess, plan)
    else:
        def step(state, batch):
            return train_step(state, preprocess(batch), loss, tx, plan)

    try:
        state, metrics = step(state, next(it))
        first_loss = _loss(metrics["loss"])
        t_first = time.time()
        done = start_step + 1
        _emit({
            "event": "first_step", "t": t_first, "startup_s": round(t_first - t_start, 3),
            "steps_in_first_call": 1, "loss": first_loss, **_mesh_fields(plan),
            "backend": device.type, "device_kind": _device_kind(device),
            "data_dir": args.data_dir, "local_samples": ds.num_samples,
        })
        maybe_checkpoint(done, state)
        rc = check_boundary(done, state)
        if rc is not None:
            return rc
        prof = _Profile(args.profile_dir, device) if args.profile_dir and done < args.steps \
            else None
        # Step i's loss is fetched after step i+1 is enqueued; every steady
        # step's wall clock splits into data_wait / dispatch /
        # device_blocked / checkpoint phases.
        t0 = time.time()
        pending = None
        acct = make_step_accounting()
        while done < args.steps:
            _trace_window_check(args, done - start_step - 1)
            with acct.step(done + 1) as st:
                with st.phase("data_wait"):
                    batch = next(it)
                with st.phase("dispatch"):
                    state, metrics = step(state, batch)
                done += 1
                if pending is not None:
                    pstep, pmetrics = pending
                    if pstep % args.log_every == 0:
                        with st.phase("device_blocked"):
                            ploss = _loss(pmetrics["loss"])
                        _emit({"event": "progress", "step": pstep, "loss": ploss})
                pending = (done, metrics)
                maybe_checkpoint(done, state, st)
                rc = check_boundary(done, state, st)
                if rc is not None:
                    return rc
        if pending is not None:
            pstep, pmetrics = pending
            closing_loss = _loss(pmetrics["loss"])
        dt = time.time() - t0
        if pending is not None:
            _emit({"event": "progress", "step": pstep, "loss": closing_loss})
        if prof is not None:
            prof.stop()
            _emit({"event": "profile_done", "dir": args.profile_dir,
                   "steps_traced": args.steps - start_step - 1, "in_timed_window": True})
    finally:
        it.close()
    return finish(state, metrics, args.steps - start_step - 1, dt, acct,
                  _ingest_block(args, prefetch_stats, staging_stats, lanes, chunks, tune))


def _host_grads(flat: torch.Tensor, shapes) -> tuple[list, Any]:
    """Enqueue the copy of one microbatch's flat f32 loss and gradients
    (make_multislice_step_fns' backward) to a host buffer of its own
    (pinned, on CUDA) and return (numpy views of it, one for each of
    `shapes`: the loss's (1,), then each gradient's; the event the copy
    records, None on the CPU). The views own their buffer: the exchange's
    engine may write them after the next microbatch's copy has begun, and a
    graphed backward's next replay rewrites `flat`."""
    if flat.device.type == "cuda":
        host = torch.empty(flat.shape, dtype=torch.float32, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    else:
        host, done = flat.clone(), None
    views, off = [], 0
    for shape in shapes:
        n = math.prod(shape)
        views.append(host[off:off + n].view(shape).numpy())
        off += n
    return views, done


def _train_multislice(args, device, state, start_step: int, loss_fn, tx, make_batch, plan,
                      world, heartbeat, guard, t_start: float, maybe_checkpoint,
                      check_boundary, finish, rewind, graphed: bool) -> int:
    """The multi-slice step loop (TPUJOB_NUM_SLICES > 1), the JAX trainer's
    _train_multislice: this world spans one slice, and the slices meet in
    the DCN exchange (parallel/multislice.py).

    A global step makes its whole batch once; each of the M microbatches
    runs its backward on this slice's rows block (make_multislice_step_fns),
    its loss and gradients are copied to the host and submitted, so that
    the engine streams microbatch m while m+1 computes (on the card, m is
    submitted once m+1's backward is queued behind its copy); the loop then waits
    for the exchange's tail (the `dcn_sync` phase) and applies the mean.
    The mean over every slice x microbatch block of the same global batch
    is the full batch's mean, so the trajectory follows one process's.

    When a peer slice is rolled, collect() holds at the barrier (the tick
    keeps the heartbeat fresh) until the restarted peer announces its
    resume from the shared checkpoint; SliceRewind then re-restores that
    checkpoint in process (`rewind`) and the loop replays forward. A peer
    that never returns exits retryable (138); a latched preemption signal
    leaves the hold through the graceful path.

    With `graphed` (graphed_step.step_route) the batch, each microbatch's
    backward and the apply each replay a captured CUDA graph, the
    counterpart of the JAX trainer's three jitted functions; a rewind
    restores the state in place, so the graphs replay from it."""
    from tf_operator_tpu_torch.parallel import multislice, peer_watch
    from tf_operator_tpu_torch.parallel.train_step import make_multislice_step_fns
    from tf_operator_tpu_torch.telemetry.phases import make_step_accounting
    from tf_operator_tpu_torch.utils.exit_codes import EXIT_USER_RETRYABLE

    S, M = world.num_slices, args.dcn_microbatches
    rows = args.batch // (S * M)
    if plan.mesh.world > 1:
        # One exchange per rank of the slice, each with its counterpart in
        # the other slices: the ranks of a sharded slice hold different parts.
        # The rank is the slice-local global one (a pod's local ranks count
        # p * N + i within their slice's world), never the pod's.
        world = dataclasses.replace(
            world, dcn_dir=os.path.join(world.dcn_dir, f"rank{plan.mesh.rank}"))
    # The slice's ranks share each bucket's transfer after the in-slice
    # reduction: the bandwidth dial charges the 1/ici_degree fraction only.
    world.ici_degree = plan.mesh.world
    gen_batch, backward, apply = make_multislice_step_fns(
        loss_fn, tx, make_batch, device, rows, seed=0, remat=args.remat, plan=plan,
        graphed=graphed, flat=True)
    shapes = [(1,)] + [tuple(p.shape) for p in state.params]
    ex = multislice.DcnExchange(world, resume_step=start_step, microbatches=M,
                                buckets=args.dcn_buckets,
                                peer_timeout_s=args.dcn_peer_timeout)
    sid = world.slice_id
    done = start_step
    t0, steady_start, gloss = None, start_step, None
    acct = make_step_accounting()

    def tick():
        # Holding at the barrier is live: the heartbeat's t moves, its step not.
        heartbeat.write(done)

    try:
        while done < args.steps:
            try:
                with acct.step(done + 1) as st:
                    step = done + 1
                    ex.begin_step(step)
                    pending = []

                    def submit():
                        # The copy of a microbatch whose backward was queued
                        # on the card lands while the next one's runs.
                        m, views, event = pending.pop()
                        if event is not None:
                            with st.phase("device_blocked"):
                                peer_watch.synchronize(event, "a microbatch's gradients")
                        ex.submit(step, m, views)

                    with st.phase("dispatch"):
                        batch = gen_batch(done)
                    for m in range(M):
                        with st.phase("dispatch"):
                            flat = backward(state, batch, (sid * M + m) * rows)
                            views, event = _host_grads(flat, shapes)
                            del flat
                        if pending:
                            submit()
                        pending.append((m, views, event))
                        if event is None:
                            submit()  # computed already (the CPU): stream it now
                    if pending:
                        submit()
                    del batch
                    with st.phase("dcn_sync"):
                        reduced = ex.collect(step, tick=tick,
                                             should_stop=lambda: guard.triggered)
                    gloss = float(reduced[0][0])
                    with st.phase("dispatch"):
                        state, _ = apply(state, reduced[1:])
                    done = step
                    ex.step_done(done)
                    if t0 is None:
                        t_first = time.time()
                        _emit({"event": "first_step", "t": t_first,
                               "startup_s": round(t_first - t_start, 3),
                               "steps_in_first_call": 1, "loss": gloss, **_mesh_fields(plan),
                               "backend": device.type, "device_kind": _device_kind(device),
                               "slices": S, "slice_id": sid})
                        heartbeat.write(done, force=True)
                        t0, steady_start = time.time(), done
                    elif done % args.log_every == 0 or done == args.steps:
                        # The exchange's loss is already on the host.
                        _emit({"event": "progress", "step": done, "loss": gloss})
                    maybe_checkpoint(done, state, st)
                    rc = check_boundary(done, state, st)
                    if rc is not None:
                        return rc
            except multislice.DcnInterrupted:
                # A preemption latched while holding at the barrier (a whole-job
                # eviction signals every slice): the graceful path at the last
                # completed step; the resumed job replays the abandoned one.
                return check_boundary(done, state)
            except multislice.SliceRewind as rw:
                # A peer's gang was rolled and resumed behind us: meet it at
                # the shared checkpoint without restarting this pod.
                _emit({"event": "dcn_rewind", "from_step": done, "peer_slice": rw.peer,
                       "peer_resume": rw.to_step})
                state, done = rewind(state)
                ex.rewind_to(done)
                heartbeat.write(done, force=True)
    except multislice.DcnPeerTimeout as e:
        # A peer never came back: exit retryable, so this slice's gang rolls
        # too and the job recovers whole from the shared checkpoint.
        print(f"dcn exchange: {e}; exiting retryable", file=sys.stderr)
        _emit({"event": "dcn_peer_timeout", "step": done, "detail": str(e)})
        return EXIT_USER_RETRYABLE
    finally:
        dcn_stats = ex.stats()
        ex.close()
    dt = time.time() - t0 if t0 is not None else 0.0
    return finish(state, {"loss": gloss}, args.steps - steady_start, dt, acct,
                  {"dcn": dcn_stats})


def _mesh_fields(plan) -> dict:
    """The first_step event's mesh and device count."""
    shape = _gang_shape(plan)
    return {"mesh": shape["mesh"], "n_devices": shape["deviceCount"]}


def _ingest_block(args, prefetch_stats: dict, staging_stats: dict, lanes: int, chunks: int,
                  tune: dict | None) -> dict:
    """The done event's `staging` block (the ring's transfer and overlap
    accounting, the codec's ledger, the tuner's table) or `prefetch` block,
    with the JAX trainer's keys."""
    from tf_operator_tpu_torch.data import prefetch as prefetch_lib
    from tf_operator_tpu_torch.data import staging as staging_lib

    if args.input_staging != "staged":
        overlap = prefetch_lib.overlap_efficiency(prefetch_stats)
        return {"prefetch": {
            "batches": prefetch_stats.get("batches_consumed"),
            "input_s": round(prefetch_stats.get("input_s", 0.0), 3),
            "consumer_wait_s": round(prefetch_stats.get("consumer_wait_s", 0.0), 3),
            "overlap_efficiency": round(overlap, 4) if overlap is not None else None,
        }}
    s = staging_stats
    rate = staging_lib.transfer_mb_per_s(s)
    overlap = staging_lib.input_overlap_fraction(s)
    block = {
        "depth": args.staging_depth,
        "chunks": chunks,
        "chunks_effective": s.get("chunks_effective"),
        "lanes": lanes,
        "lanes_effective": s.get("lanes_effective"),
        "wire_dtype": args.wire_dtype,
        "codec": args.wire_codec,
        "batches": s.get("batches_consumed"),
        # staged >= consumed: the ring reads ahead up to `depth` batches.
        "batches_staged": s.get("batches_staged"),
        "bytes_staged_mb": round(s.get("bytes_staged", 0) / 1e6, 3),
        "transfer_s": round(s.get("transfer_s", 0.0), 3),
        "transfer_busy_s": round(s.get("transfer_busy_s", 0.0), 3),
        "transfer_mb_per_s": round(rate, 2) if rate is not None else None,
        "input_overlap_fraction": round(overlap, 4) if overlap is not None else None,
        "wall_s": round(s.get("wall_s", 0.0), 3),
        "consumer_wait_s": round(s.get("consumer_wait_s", 0.0), 3),
        "consumer_busy_s": round(s.get("consumer_busy_s", 0.0), 3),
    }
    if args.wire_codec != "none":
        enc, raw = s.get("bytes_encoded", 0), s.get("bytes_staged", 0)
        block.update({
            "bytes_encoded_mb": round(enc / 1e6, 3),
            "codec_ratio": round(raw / enc, 3) if enc else None,
            "encode_s": round(s.get("encode_s", 0.0), 3),
            "decode_s": round(s.get("decode_s", 0.0), 3),
        })
    if tune is not None:
        block["tune"] = tune
    return {"staging": block}


def _run_trainer(args, device: torch.device, heartbeat, guard, chaos=None,
                 state_out=None) -> int:
    from tf_operator_tpu_torch import optim as optim_lib
    from tf_operator_tpu_torch.models import checkpoint as ckpt_lib
    from tf_operator_tpu_torch.parallel import distributed
    from tf_operator_tpu_torch.parallel import mesh as mesh_lib
    from tf_operator_tpu_torch.parallel import multislice
    from tf_operator_tpu_torch.parallel.graphed_step import step_route
    from tf_operator_tpu_torch.parallel.train_step import (
        create_train_state,
        make_chunked_train_step,
        parallelize,
    )
    from tf_operator_tpu_torch.telemetry.phases import make_step_accounting

    t_start = time.time()
    _emit({"event": "start", "t": t_start, "model": args.model})
    if device.type == "cuda":
        torch.cuda.init()
        device = torch.device("cuda", 0)  # the pod's first visible GPU
    # The Evaluator is one process whatever its env says.
    dist_backend = None if args.eval else distributed.initialize_from_env(device=device)
    # A library that installs its own handlers at init would displace the
    # guard's; take the signals back.
    guard.reassert()
    _emit({"event": "jax_ready", "t": time.time(), "backend": device.type,
           "dist_backend": dist_backend})
    heartbeat.write(0, force=True)

    if args.eval:
        model, loss_fn, make_batch = _build_model(args, device)
        return _run_evaluator(args, model, loss_fn, make_batch, device, guard)

    mesh = mesh_lib.mesh_from_env()
    multi = mesh.world > 1
    # A multi-slice job: this world spans one slice; the slices meet in the
    # DCN exchange (parallel/multislice.py).
    ms_world = multislice.SliceWorld.from_env()
    # One writer: rank 0 of a world of several processes (the JAX trainer's
    # rule), else the chief (or worker 0). Across slices, every slice's world
    # has its own rank 0: the global worker 0 (slice 0's rank 0) alone writes.
    if ms_world is not None:
        saver = bool(args.checkpoint_dir) and _is_checkpoint_writer() and mesh.rank == 0
    else:
        saver = bool(args.checkpoint_dir) and (mesh.rank == 0 if multi
                                               else _is_checkpoint_writer())
    allow_reshape = args.allow_reshape or os.environ.get("TPUJOB_ALLOW_RESHAPE") == "1"
    if saver:
        # A preempt/retry loop strands tmp dirs (a save killed before its
        # rename); sweep them before the resume.
        swept = ckpt_lib.sweep_tmp_dirs(args.checkpoint_dir)
        if swept:
            _emit({"event": "checkpoint_tmp_swept", "entries": swept})

    model, loss_fn, make_batch = _build_model(args, device, mesh)
    plan = parallelize(model, mesh, _sharding_rules(args), device)
    tx = optim_lib.make_optimizer(optim_lib.OptimizerConfig(
        name=args.optimizer, learning_rate=args.lr,
        moment_dtype=args.moment_dtype, master_weights=args.master_weights,
    ))
    state = create_train_state(model, tx, plan)
    state, start_step = _try_resume(args.checkpoint_dir, state, tx, allow_reshape, plan)
    # One process on CUDA and every rank of an NCCL world replay a CUDA graph
    # of each step (in a multi-slice job, of each half of it: the exchange
    # runs on the host between them); the CPU and a gloo world (its
    # collectives run on the host) step eagerly. No fallback: a failed
    # capture raises.
    route, route_why = step_route(device.type, mesh.world, dist_backend, ms_world is not None)

    _emit({"event": "model_ready", "t": time.time(), "step_route": route,
           "step_route_why": route_why})
    heartbeat.write(start_step, force=True)
    if start_step >= args.steps:
        # Already trained to (or past) the target: a restart is idempotent.
        if saver and start_step > 0 and ckpt_lib.final_step(args.checkpoint_dir) is None:
            ckpt_lib.mark_final(args.checkpoint_dir, start_step)
        _emit({"event": "done", "t": time.time(), "steps": start_step,
               "steady_steps_per_sec": None, "examples_per_sec": None,
               "final_loss": None, "total_s": round(time.time() - t_start, 3),
               "resumed_complete": True})
        if state_out is not None:
            state_out["state"] = state
        return 0

    ck = None
    joins_saves = ms_world is None or ms_world.slice_id == 0
    if saver or (args.checkpoint_dir and multi and plan.sharded and joins_saves):
        # Digests (the resumed event's bit-equality witness) ride the writer
        # thread in async mode, and are kept in sync mode for jobs that may
        # reshape. The other ranks of a sharded world join each snapshot's
        # gathers.
        ck = _Checkpointing(args.checkpoint_dir, args.keep_checkpoints,
                            digest=allow_reshape or args.checkpoint_mode == "async",
                            heartbeat=heartbeat, chaos=chaos, plan=plan, writes=saver)
        if saver and args.checkpoint_mode == "async":
            ck.writer = _CkptWriter(ck.write)
    try:
        step_chunk = make_chunked_train_step(loss_fn, tx, make_batch, device, seed=0,
                                             remat=args.remat, plan=plan,
                                             graphed=route == "graph")
        chunk = max(1, min(args.log_every, args.steps - start_step))
        if args.checkpoint_dir and args.checkpoint_every:
            # Chunk boundaries land on every multiple of --checkpoint-every.
            chunk = max(1, math.gcd(chunk, args.checkpoint_every))
        ckpt_marks = start_step // args.checkpoint_every if args.checkpoint_every else 0
        last_save_s, last_ckpt_step = 0.0, -1

        def maybe_checkpoint(done: int, state, st=None) -> None:
            nonlocal ckpt_marks, last_save_s, last_ckpt_step
            if ck is None or not args.checkpoint_every or done >= args.steps:
                return  # the final save (marked FINAL) comes after the loop
            marks = done // args.checkpoint_every
            if marks > ckpt_marks:
                ckpt_marks = marks
                last_save_s = _save_checkpoint(ck, done, state, st=st)
                last_ckpt_step = done

        def check_boundary(done: int, state, st=None) -> int | None:
            """Heartbeat, chaos hang-then-kill, and preemption after a chunk:
            the exit code to leave with, or None to go on training."""
            heartbeat.write(done)
            if chaos is not None:
                d = chaos.hang_at(done, start_step)
                if d is not None:
                    from tf_operator_tpu_torch import chaos as chaos_lib

                    duration = d.params.get("duration")
                    _emit({"event": "chaos_hang", "step": done, "duration": duration})
                    chaos_lib.hang(duration)
                chaos.maybe_kill(done, start_step)
            triggered = guard.triggered
            if multi:
                # The ranks leave at one boundary, or a signalled rank's
                # exit strands its peers in the next step's collectives.
                from tf_operator_tpu_torch.parallel import collectives

                flag = torch.tensor(float(triggered), device=device)
                triggered = bool(collectives.all_reduce(flag, dist.group.WORLD,
                                                        dist.ReduceOp.MAX))
            if triggered:
                return _preempt_exit(args, guard, state, done, ck, last_save_s,
                                     last_ckpt_step, plan, st)
            return None

        def finish(state, metrics, steady: int, dt: float, acct, extra: dict) -> int:
            """The final save, the last heartbeat and the done event (with
            `extra`'s blocks) after the last step."""
            if ck is not None:
                _save_checkpoint(ck, args.steps, state, final=True)
            heartbeat.write(args.steps, force=True)
            telem = acct.summary()
            done_event = {
                "event": "done",
                "t": time.time(),
                "steps": args.steps,
                "steady_steps_per_sec": round(steady / dt, 4) if steady > 0 else None,
                "examples_per_sec": round(steady * args.batch / dt, 4) if steady > 0 else None,
                "final_loss": _loss(metrics["loss"]),
                "total_s": round(time.time() - t_start, 3),
                "step_time_s": telem["step_time_s"] if telem else None,
                "phase_breakdown": telem["phase_breakdown"] if telem else None,
            }
            if args.trace:
                # The graph route's device phases over the steady steps
                # (telemetry/phases.py's stamps); nothing where none ran.
                from tf_operator_tpu_torch.telemetry import phases

                done_event.update(phases.device_summary(steady) or {})
            ckpt_block = _ckpt_done_stats(ck)
            if ckpt_block:
                # The step loop paid snapshot_s (+ drain_wait_s of
                # backpressure); write_s rode the writer thread,
                # hidden_fraction says how much of it training covered.
                done_event["checkpoint"] = ckpt_block
            done_event.update(extra)
            _emit(done_event)
            if state_out is not None:
                state_out["state"] = state
            return 0

        if args.data_dir:
            return _train_on_dataset(args, device, state, start_step, loss_fn, tx, t_start,
                                     maybe_checkpoint, check_boundary, finish, plan,
                                     graphed=route == "graph")
        if ms_world is not None:
            from tf_operator_tpu_torch.parallel.train_step import (
                load_state_tensors,
                state_tensors,
            )

            # A peer that finds no checkpoint resumes at step 0: a rewind
            # there restores this rank's initial state, kept on the host.
            init = None if start_step else {
                k: v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor) else v
                for k, v in state_tensors(state).items()}

            def rewind(state):
                # The writer's in-flight save may be the one the peer resumed
                # from: drain it before the walk, which overwrites the state
                # in place when it finds a checkpoint.
                if ck is not None and ck.writer is not None:
                    ck.writer.drain()
                if init is not None:
                    state = load_state_tensors(state, init)
                return _try_resume(args.checkpoint_dir, state, tx, allow_reshape, plan)

            return _train_multislice(args, device, state, start_step, loss_fn, tx,
                                     make_batch, plan, ms_world, heartbeat, guard, t_start,
                                     maybe_checkpoint, check_boundary, finish, rewind,
                                     graphed=route == "graph")

        state, metrics = step_chunk(state, chunk)
        # The loss fetch waits for the first chunk's device work: startup_s
        # includes it.
        first_loss = _loss(metrics["loss"])
        t_first = time.time()
        done = start_step + chunk
        _emit({
            "event": "first_step",
            "t": t_first,
            "startup_s": round(t_first - t_start, 3),
            "steps_in_first_call": chunk,
            "loss": first_loss,
            **_mesh_fields(plan),
            "backend": device.type,
            "device_kind": _device_kind(device),
        })
        maybe_checkpoint(done, state)
        rc = check_boundary(done, state)
        if rc is not None:
            return rc

        # Steady window: full chunks only. Chunk i+1 is enqueued before chunk
        # i's loss is fetched, so the fetch waits under the next chunk's work;
        # progress events lag one chunk and carry their own step. A profiled
        # chunk sits outside the window when there are two or more.
        full_chunks = (args.steps - done) // chunk
        tail = (args.steps - done) % chunk
        profiling = bool(args.profile_dir) and full_chunks > 0
        profile_last_chunk = profiling and full_chunks >= 2
        timed_chunks = full_chunks - 1 if profile_last_chunk else full_chunks
        prof = _Profile(args.profile_dir, device) if profiling and not profile_last_chunk \
            else None
        t0 = time.time()
        pending = None
        acct = make_step_accounting()
        for _ in range(timed_chunks):
            _trace_window_check(args, done - start_step - chunk)
            with acct.step(done + chunk, n_steps=chunk) as st:
                with st.phase("dispatch"):
                    state, metrics = step_chunk(state, chunk)
                done += chunk
                if pending is not None:
                    pstep, pmetrics = pending
                    if pstep % args.log_every == 0:
                        with st.phase("device_blocked"):
                            ploss = _loss(pmetrics["loss"])
                        _emit({"event": "progress", "step": pstep, "loss": ploss})
                pending = (done, metrics)
                maybe_checkpoint(done, state, st)
                rc = check_boundary(done, state, st)
                if rc is not None:
                    return rc
        if pending is not None:
            pstep, pmetrics = pending
            closing_loss = _loss(pmetrics["loss"])  # the window's closing sync
        dt = time.time() - t0
        if pending is not None and (pstep % args.log_every == 0 or pstep == args.steps):
            _emit({"event": "progress", "step": pstep, "loss": closing_loss})
        steady = timed_chunks * chunk
        if prof is not None:
            prof.stop()
            _emit({"event": "profile_done", "dir": args.profile_dir,
                   "steps_traced": steady, "in_timed_window": True})
        if profile_last_chunk:
            prof = _Profile(args.profile_dir, device)
            state, metrics = step_chunk(state, chunk)
            done += chunk
            # The loss fetch waits for the chunk's device work before the
            # trace stops.
            chunk_loss = _loss(metrics["loss"])
            if done % args.log_every == 0 or done == args.steps:
                _emit({"event": "progress", "step": done, "loss": chunk_loss})
            prof.stop()
            _emit({"event": "profile_done", "dir": args.profile_dir,
                   "steps_traced": chunk, "in_timed_window": False})
            maybe_checkpoint(done, state)
            rc = check_boundary(done, state)
            if rc is not None:
                return rc

        if tail:
            state, metrics = step_chunk(state, tail)
            done += tail
            _emit({"event": "progress", "step": done, "loss": _loss(metrics["loss"])})
        return finish(state, metrics, steady, dt, acct, {})
    finally:
        if ck is not None and ck.writer is not None:
            ck.writer.close()


if __name__ == "__main__":
    sys.exit(main())
