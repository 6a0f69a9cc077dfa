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

It runs on CUDA unless `--device cpu` asks for the CPU, and exits nonzero
when CUDA is asked for and absent. Flags and models of the JAX trainer
that this one does not handle yet are refused, never ignored.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import torch

MODELS = ("mnist-mlp", "mnist-conv", "resnet18", "resnet50", "transformer-lm",
          "bert-base", "bert-tiny", "moe-lm")
PORTED_MODELS = ("mnist-mlp", "mnist-conv", "resnet18", "resnet50", "transformer-lm")
# Flags of the JAX trainer this trainer refuses until their feature is ported.
UNPORTED_FLAGS = ("checkpoint_dir", "remat", "data_dir", "chaos", "trace", "eval")
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
    # Refused until ported (see UNPORTED_FLAGS).
    ap.add_argument("--checkpoint-dir", default=None, help=argparse.SUPPRESS)
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


def _run_trainer(args, device: torch.device, heartbeat, state_out=None) -> int:
    from tf_operator_tpu_torch import optim as optim_lib
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

    model, loss_fn, make_batch = _build_model(args, device)
    tx = optim_lib.make_optimizer(optim_lib.OptimizerConfig(
        name=args.optimizer, learning_rate=args.lr,
        moment_dtype=args.moment_dtype, master_weights=args.master_weights,
    ))
    state = create_train_state(model, tx)

    _emit({"event": "model_ready", "t": time.time()})
    heartbeat.write(0, force=True)

    step_chunk = make_chunked_train_step(loss_fn, tx, make_batch, device, seed=0)
    chunk = max(1, min(args.log_every, args.steps))
    state, metrics = step_chunk(state, chunk)
    # The loss fetch waits for the first chunk's device work: startup_s
    # includes it.
    first_loss = float(metrics["loss"])
    t_first = time.time()
    done = chunk
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
    heartbeat.write(args.steps, force=True)
    telem = acct.summary()
    _emit({
        "event": "done",
        "t": time.time(),
        "steps": args.steps,
        "steady_steps_per_sec": round(steady / dt, 4) if steady > 0 else None,
        "examples_per_sec": round(steady * args.batch / dt, 4) if steady > 0 else None,
        "final_loss": float(metrics["loss"]),
        "total_s": round(time.time() - t_start, 3),
        "step_time_s": telem["step_time_s"] if telem else None,
        "phase_breakdown": telem["phase_breakdown"] if telem else None,
    })
    if state_out is not None:
        state_out["state"] = state
    return 0


if __name__ == "__main__":
    sys.exit(main())
