"""Trainer of the PyTorch port — the workload binary a TrainJob pod runs.

    python -m tf_operator_tpu_torch.models.train --model transformer-lm \\
        --steps 6 --batch 4 --seq 8192 --layers 12 --hidden 768 --heads 6 \\
        --moment-dtype bf16 --master-weights --log-every 2
    python -m tf_operator_tpu_torch.models.train --model resnet50 \\
        --batch 256 --image-size 224 --steps 6 --log-every 2

Counterpart of tf_operator_tpu/models/train.py for the models ported so
far: `mnist-mlp` (the default, as there), `mnist-conv`, `resnet18`,
`resnet50` and `transformer-lm`. Synthetic batches are made on the device
(x ~ N(0, 1) images of [B, 28, 28] or [B, S, S, 3] with uniform labels;
uniform tokens for the LM), the LM runs through the flash kernels, the
optimizer is mixed-precision Adam/AdamW, and the JSON events are the JAX
trainer's (`start`, `jax_ready` — kept by name for the bench's segment
reader, `model_ready`, `first_step`, `progress`, `done`) on stdout and
appended to `TPUJOB_METRICS_FILE`, plus the `TPUJOB_HEARTBEAT_FILE`
heartbeat. ResNet's batch-norm running statistics are updated once per
step and stay f32 under `--master-weights`.

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

MODELS = ("mnist-mlp", "mnist-conv", "resnet18", "resnet50", "transformer-lm",
          "bert-base", "bert-tiny", "moe-lm")
PORTED_MODELS = ("mnist-mlp", "mnist-conv", "resnet18", "resnet50", "transformer-lm")
# Flags of the JAX trainer this trainer refuses until their feature is ported.
UNPORTED_FLAGS = ("remat", "data_dir", "chaos", "trace", "eval")
# Per-device f32 logits bytes at which the loss switches to the chunked head
# (the JAX trainer's cutover).
CHUNKED_LOSS_BYTES = 6e9
VOCAB = 32000

_emit_lock = threading.Lock()


def _emit(event: dict) -> None:
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
    # Refused until ported (see UNPORTED_FLAGS).
    ap.add_argument("--remat", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--data-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--chaos", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--trace", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--eval", action="store_true", help=argparse.SUPPRESS)
    return ap


def main(argv: list[str] | None = None, state_out: dict | None = None) -> int:
    """Parse, check and train. When `state_out` is a dict, the final
    TrainState is left in it under "state" for an in-process caller."""
    ap = build_parser()
    args = ap.parse_args(argv)
    for name in UNPORTED_FLAGS:
        if getattr(args, name):
            ap.error(f"--{name.replace('_', '-')} is not ported to the PyTorch "
                     f"trainer yet")
    if args.model not in PORTED_MODELS:
        ap.error(f"--model {args.model} is not ported to the PyTorch trainer "
                 f"yet ({', '.join(PORTED_MODELS)} are)")
    for name in ("steps", "batch", "seq", "layers", "hidden", "heads", "log_every",
                 "image_size"):
        if getattr(args, name) < 1:
            ap.error(f"--{name.replace('_', '-')} must be >= 1")
    if args.checkpoint_every < 0:
        ap.error("--checkpoint-every must be >= 0")
    if args.hidden % args.heads:
        ap.error("--hidden must be a multiple of --heads")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda was asked for but no CUDA device is "
              "available; pass --device cpu to run on the CPU", file=sys.stderr)
        return 1

    from tf_operator_tpu_torch.utils.preemption import HeartbeatWriter

    heartbeat = HeartbeatWriter.from_env()
    heartbeat.write(0, force=True)
    return _run_trainer(args, torch.device(args.device), heartbeat, state_out)


def _build_model(args, device: torch.device):
    """(model, loss_fn(model, batch), make_batch(generator)) of --model,
    with weights from a seeded flax-like init."""
    gen = torch.Generator(device=device).manual_seed(0)
    if args.model == "transformer-lm":
        from tf_operator_tpu_torch.models import transformer as tfm
        from tf_operator_tpu_torch.parallel.ring_attention import make_attention_fn

        cfg = tfm.TransformerConfig(
            vocab_size=VOCAB, num_layers=args.layers, hidden=args.hidden,
            num_heads=args.heads, max_len=args.seq, causal=True,
        )
        model = tfm.TransformerLM(cfg, attn_fn=make_attention_fn(causal=True),
                                  device=device, generator=gen)
        # Past ~6 GB of f32 logits the head and softmax run per sequence chunk.
        chunked_loss = 4.0 * args.batch * args.seq * cfg.vocab_size >= CHUNKED_LOSS_BYTES

        def loss_fn(model, batch):
            tokens = batch["tokens"]
            if chunked_loss:
                return tfm.lm_loss_chunked(model.hidden(tokens), model.lm_head.weight,
                                           tokens)
            return tfm.lm_loss(model(tokens), tokens)

        def make_batch(g):
            return {"tokens": torch.randint(0, cfg.vocab_size, (args.batch, args.seq),
                                            generator=g, device=device)}

        return model, loss_fn, make_batch

    from tf_operator_tpu_torch.models import mnist

    if args.model in ("mnist-mlp", "mnist-conv"):
        classes, shape = 10, (args.batch, 28, 28)
        cls = mnist.MLP if args.model == "mnist-mlp" else mnist.ConvNet
        model = cls(device=device, generator=gen)
    else:
        from tf_operator_tpu_torch.models import resnet

        classes = 1000
        shape = (args.batch, args.image_size, args.image_size, 3)
        cls = resnet.ResNet50 if args.model == "resnet50" else resnet.ResNet18
        model = cls(num_classes=classes, device=device, generator=gen)

    def loss_fn(model, batch):
        return mnist.cross_entropy_loss(model(batch["x"]), batch["y"])

    def make_batch(g):
        return {"x": torch.randn(shape, generator=g, device=device),
                "y": torch.randint(0, classes, (args.batch,), generator=g, device=device)}

    return model, loss_fn, make_batch


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


def _split_state(state) -> tuple[dict, dict]:
    """(params {name: tensor}, the resume payload: everything else of
    state_tensors)."""
    from tf_operator_tpu_torch.parallel.train_step import state_tensors

    tensors = state_tensors(state)
    params = {k[len("params/"):]: v for k, v in tensors.items() if k.startswith("params/")}
    aux = {k: v for k, v in tensors.items() if not k.startswith("params/")}
    return params, aux


def _snapshot_state(ckpt_dir: str, step: int, state, final: bool, keep: int,
                    pool: _PinnedPool) -> _SaveItem:
    """Blocking snapshot leg: device->host copies of params and the resume
    payload at a step boundary, ordered on the stream before any later
    in-place update, and waited for before the item is returned, so the
    writer thread never touches the device."""
    from tf_operator_tpu_torch.models import checkpoint as ckpt

    params, aux = _split_state(state)
    buffers = pool.take()
    host_params = _host_tree(params, buffers)
    host_aux = _host_tree(aux, buffers)
    if any(t.device.type == "cuda" for t in params.values()):
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
    info = {**ckpt.SINGLE_PROCESS, "leaves": ckpt.leaf_shardings(host_params),
            "auxLeaves": ckpt.leaf_shardings(host_aux)}
    return _SaveItem(ckpt_dir=ckpt_dir, step=step, host_params=host_params,
                     host_aux=host_aux, info=info, final=final, keep=keep)


def _write_snapshot(item: _SaveItem, digest: bool, heartbeat=None) -> None:
    """Write leg: the trainstate first (so any visible step_<N> has its
    resume payload beside it), then the params, the sharding manifest with
    digests, FINAL, the `checkpoint` event and retention, and only then the
    forced heartbeat: progress counts from a durable save. Runs on the
    writer thread in async mode and inline in sync mode; it only writes
    files."""
    from tf_operator_tpu_torch.models import checkpoint as ckpt

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
        self.saves = 0
        self.write_s = 0.0
        self.snapshot_s = 0.0
        self.drains = 0          # submits that hit backpressure
        self.drain_wait_s = 0.0  # seconds the step loop blocked on them
        self._thread = threading.Thread(target=_ckpt_writer_main, args=(self,),
                                        name="ckpt-writer", daemon=True)
        self._thread.start()

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
    mode), the pinned snapshot buffers and the sync saves' totals."""

    ckpt_dir: str
    keep: int
    digest: bool
    heartbeat: Any = None
    writer: _CkptWriter | None = None
    pool: _PinnedPool = dataclasses.field(default_factory=_PinnedPool)
    sync_stats: dict = dataclasses.field(
        default_factory=lambda: {"saves": 0, "snapshot_s": 0.0, "write_s": 0.0})

    def write(self, item: _SaveItem) -> None:
        _write_snapshot(item, self.digest, self.heartbeat)


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
                     st=None) -> None:
    """step_<N> holds the params only, trainstate_<N> the resume payload.
    Async (a writer exists): only the snapshot and any backpressure wait
    block the step loop (phase `ckpt_snapshot`); a final save drains before
    returning, since job completion is durable completion. Sync: both legs
    inline under the `checkpoint` phase."""
    writer = ck.writer
    t0 = time.monotonic()
    if writer is None:
        with st.phase("checkpoint") if st is not None else contextlib.nullcontext():
            item = _snapshot_state(ck.ckpt_dir, step, state, final, ck.keep, ck.pool)
            snap_s = time.monotonic() - t0
            ck.write(item)
        ck.sync_stats["saves"] += 1
        ck.sync_stats["snapshot_s"] += snap_s
        ck.sync_stats["write_s"] += time.monotonic() - t0 - snap_s
        return None
    with st.phase("ckpt_snapshot") if st is not None else contextlib.nullcontext():
        # The phase covers the snapshot and any backpressure wait inside
        # submit; the done block keeps the two apart (snapshot_s, and the
        # writer's drain_wait_s).
        item = _snapshot_state(ck.ckpt_dir, step, state, final, ck.keep, ck.pool)
        snap_s = time.monotonic() - t0
        writer.submit(item)
    writer.note_snapshot(snap_s)
    if final:
        writer.drain()


def _try_resume(ckpt_dir: str | None, state, tx, allow_reshape: bool = False):
    """Restore the newest restorable checkpoint, if any: (state, start_step).

    The walk goes newest first through list_steps. A step whose census
    fails validate_step is skipped with a `resume_fallback` event
    (`invalid_checkpoint`), and so is a step saved at another gang shape
    (`foreign_shape`) unless allow_reshape, which then checks the per-leaf
    shapes against this model (`reshard_shape_mismatch`). Only the steps
    walked past are validated. A restore that raises skips to the next
    candidate (`restore_error`); nothing left is a step-0 cold start
    (`no_valid_checkpoint`). A step_<N> without a usable trainstate_<N>
    (torn, missing, or written under another optimizer layout) resumes
    params-only with a fresh optimizer, whose master copy under master
    weights comes from the restored params. Params restore at the
    optimizer's master precision (f32 under master weights) and the
    compute copy is re-derived. The `resumed` event carries crc32 digests
    of the restored host bytes beside the ones the save recorded."""
    from tf_operator_tpu_torch.models import checkpoint as ckpt
    from tf_operator_tpu_torch.parallel.train_step import load_state_tensors

    if not ckpt_dir:
        return state, 0
    all_steps = ckpt.list_steps(ckpt_dir)
    ordered = list(reversed(all_steps))  # newest first
    cur_shape = {k: ckpt.SINGLE_PROCESS[k] for k in ("processCount", "mesh")}
    params, aux = _split_state(state)
    master_dtype = torch.float32 if tx.config.master_weights else None
    p_template = {k: master_dtype or v.dtype for k, v in params.items()}

    def candidate_gate(s: int) -> tuple[bool, dict | None]:
        if not ckpt.validate_step(ckpt_dir, s):
            _emit({"event": "resume_fallback", "skipped_step": s,
                   "reason": "invalid_checkpoint"})
            return False, None
        sm = ckpt.read_sharding_manifest(ckpt_dir, f"step_{s}")
        if sm is None:
            if allow_reshape:
                _emit({"event": "resume_fallback", "step": s,
                       "reason": "missing_sharding_manifest: shape unverifiable, "
                                 "same-shape restore only"})
            return True, None
        saved = {"processCount": int(sm.get("processCount") or 0),
                 "mesh": {k: int(v) for k, v in (sm.get("mesh") or {}).items()}}
        if saved == cur_shape:
            return True, sm
        if not allow_reshape:
            _emit({"event": "resume_fallback", "skipped_step": s,
                   "reason": (f"foreign_shape: saved on {saved['processCount']} "
                              f"process(es), mesh {saved['mesh']} (running "
                              f"{cur_shape['processCount']}, {cur_shape['mesh']}); "
                              f"pass --allow-reshape to reshard")})
            return False, sm
        saved_shapes = {k: v.get("shape") for k, v in (sm.get("leaves") or {}).items()}
        if saved_shapes != {k: v["shape"] for k, v in ckpt.leaf_shardings(params).items()}:
            _emit({"event": "resume_fallback", "skipped_step": s,
                   "reason": "reshard_shape_mismatch: per-leaf global shapes differ "
                             "from this model config"})
            return False, sm
        return True, sm

    def next_restorable(i: int) -> tuple[int, int | None, dict | None]:
        while i < len(ordered):
            ok, sm = candidate_gate(ordered[i])
            if ok:
                return i, ordered[i], sm
            i += 1
        return len(ordered), None, None

    def cold_start(warning: str):
        print(f"warning: {warning} — cold-starting from step 0", file=sys.stderr)
        _emit({"event": "resume_fallback", "to_step": 0, "reason": "no_valid_checkpoint",
               "steps_seen": len(all_steps)})
        return state, 0

    idx, last, sharding_m = next_restorable(0)
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
            _emit({"event": "resume_fallback", "skipped_step": last,
                   "reason": f"restore_error: {type(e).__name__}: {e}"})
            raw_params = None
            idx, last, sharding_m = next_restorable(idx + 1)
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
        state = load_state_tensors(state, full)
        partial = False
    except Exception:  # noqa: BLE001 — any unusable payload degrades, below
        # A params-only checkpoint, or a trainstate written under another
        # optimizer layout (ValueError from the leaf-list check), or torn
        # past its census: a fresh optimizer, the step from the dir name.
        raw_aux, partial = None, True
        state = _params_only_state(state, tx, restored, last)
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
    _emit(event)
    return state, state.step


def _params_only_state(state, tx, params: dict, step: int):
    """The state with the restored params (at master precision) loaded, a
    fresh optimizer built from them, and the step set: the resume of a
    step_<N> without its trainstate."""
    from tf_operator_tpu_torch.parallel.train_step import TrainState

    live = dict(state.model.named_parameters())
    on_device = [params[n].to(live[n].device) for n in live]
    opt_state = tx.init(on_device)
    with torch.no_grad():
        for p, new in zip(live.values(), on_device):
            p.copy_(new)
    return TrainState(step, state.model, opt_state)


def _run_trainer(args, device: torch.device, heartbeat, state_out=None) -> int:
    from tf_operator_tpu_torch import optim as optim_lib
    from tf_operator_tpu_torch.models import checkpoint as ckpt_lib
    from tf_operator_tpu_torch.parallel.train_step import (
        create_train_state,
        make_chunked_train_step,
    )
    from tf_operator_tpu_torch.telemetry.phases import make_step_accounting

    t_start = time.time()
    _emit({"event": "start", "t": t_start, "model": args.model})
    if device.type == "cuda":
        torch.cuda.init()
    _emit({"event": "jax_ready", "t": time.time(), "backend": device.type})
    heartbeat.write(0, force=True)

    saver = bool(args.checkpoint_dir) and _is_checkpoint_writer()
    allow_reshape = args.allow_reshape or os.environ.get("TPUJOB_ALLOW_RESHAPE") == "1"
    if saver:
        # A preempt/retry loop strands tmp dirs (a save killed before its
        # rename); sweep them before the resume.
        swept = ckpt_lib.sweep_tmp_dirs(args.checkpoint_dir)
        if swept:
            _emit({"event": "checkpoint_tmp_swept", "entries": swept})

    model, loss_fn, make_batch = _build_model(args, device)
    tx = optim_lib.make_optimizer(optim_lib.OptimizerConfig(
        name=args.optimizer, learning_rate=args.lr,
        moment_dtype=args.moment_dtype, master_weights=args.master_weights,
    ))
    state = create_train_state(model, tx)
    state, start_step = _try_resume(args.checkpoint_dir, state, tx, allow_reshape)

    _emit({"event": "model_ready", "t": time.time()})
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
    if saver:
        # Digests (the resumed event's bit-equality witness) ride the writer
        # thread in async mode, and are kept in sync mode for jobs that may
        # reshape.
        ck = _Checkpointing(args.checkpoint_dir, args.keep_checkpoints,
                            digest=allow_reshape or args.checkpoint_mode == "async",
                            heartbeat=heartbeat)
        if args.checkpoint_mode == "async":
            ck.writer = _CkptWriter(ck.write)
    try:
        step_chunk = make_chunked_train_step(loss_fn, tx, make_batch, device, seed=0)
        chunk = max(1, min(args.log_every, args.steps - start_step))
        if args.checkpoint_dir and args.checkpoint_every:
            # Chunk boundaries land on every multiple of --checkpoint-every.
            chunk = max(1, math.gcd(chunk, args.checkpoint_every))
        ckpt_marks = start_step // args.checkpoint_every if args.checkpoint_every else 0

        def maybe_checkpoint(done: int, st=None) -> None:
            nonlocal ckpt_marks
            if ck is None or not args.checkpoint_every or done >= args.steps:
                return  # the final save (marked FINAL) comes after the loop
            marks = done // args.checkpoint_every
            if marks > ckpt_marks:
                ckpt_marks = marks
                _save_checkpoint(ck, done, state, st=st)

        state, metrics = step_chunk(state, chunk)
        # The loss fetch waits for the first chunk's device work: startup_s
        # includes it.
        first_loss = float(metrics["loss"])
        t_first = time.time()
        done = start_step + chunk
        _emit({
            "event": "first_step",
            "t": t_first,
            "startup_s": round(t_first - t_start, 3),
            "steps_in_first_call": chunk,
            "loss": first_loss,
            "mesh": {"dp": 1},
            "backend": device.type,
            "device_kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
            "n_devices": 1,
        })
        heartbeat.write(done)
        maybe_checkpoint(done)

        # Steady window: full chunks only. Chunk i+1 is enqueued before chunk
        # i's loss is fetched, so the fetch waits under the next chunk's work;
        # progress events lag one chunk and carry their own step.
        full_chunks = (args.steps - done) // chunk
        tail = (args.steps - done) % chunk
        t0 = time.time()
        pending = None
        acct = make_step_accounting()
        for _ in range(full_chunks):
            with acct.step(done + chunk, n_steps=chunk) as st:
                with st.phase("dispatch"):
                    state, metrics = step_chunk(state, chunk)
                done += chunk
                if pending is not None:
                    pstep, pmetrics = pending
                    if pstep % args.log_every == 0:
                        with st.phase("device_blocked"):
                            ploss = float(pmetrics["loss"])
                        _emit({"event": "progress", "step": pstep, "loss": ploss})
                pending = (done, metrics)
                maybe_checkpoint(done, st)
                heartbeat.write(done)
        if pending is not None:
            pstep, pmetrics = pending
            closing_loss = float(pmetrics["loss"])  # the window's closing sync
        dt = time.time() - t0
        if pending is not None and (pstep % args.log_every == 0 or pstep == args.steps):
            _emit({"event": "progress", "step": pstep, "loss": closing_loss})
        steady = full_chunks * chunk

        if tail:
            state, metrics = step_chunk(state, tail)
            done += tail
            _emit({"event": "progress", "step": done, "loss": float(metrics["loss"])})
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
            "final_loss": float(metrics["loss"]),
            "total_s": round(time.time() - t_start, 3),
            "step_time_s": telem["step_time_s"] if telem else None,
            "phase_breakdown": telem["phase_breakdown"] if telem else None,
        }
        ckpt_block = _ckpt_done_stats(ck)
        if ckpt_block:
            # The step loop paid snapshot_s (+ drain_wait_s of backpressure);
            # write_s rode the writer thread, hidden_fraction says how much of
            # it training covered.
            done_event["checkpoint"] = ckpt_block
        _emit(done_event)
        if state_out is not None:
            state_out["state"] = state
        return 0
    finally:
        if ck is not None and ck.writer is not None:
            ck.writer.close()


if __name__ == "__main__":
    sys.exit(main())
