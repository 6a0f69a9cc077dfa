#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one CUDA card, end to end.

    python3 chip_smoke.py                 # every phase, as a check of the port
    python3 chip_smoke.py --phases build,check   # kernels only

Phases, in order:
  1. identify the card (nvidia-smi name and power limit);
  2. build the CUDA kernels from tf_operator_tpu_torch/csrc with nvcc;
  3. hold each kernel against its plain PyTorch version on the card, at the
     trainer's attention shape and three small ones (f32 with a ragged tail,
     f32 causal, bf16 at head_dim 64 with a ragged causal tail), and time
     the kernels at the trainer's shape beside their bound, their plain
     version and PyTorch's scaled_dot_product_attention;
  4. train the full-width causal LM (12L x 768h, 6 heads x 128, vocab 32000,
     seq 8192) through tf_operator_tpu_torch.models.train for a few steps,
     and check that every kernel ran on that path;
  5. (only with --phases ...,profile) the same trainer run under
     torch.profiler: device time by kernel group over its steady steps.
The last lines are the kernels' JSON record, the card, and
{"ok": true, "device": {...}}. Any failed phase exits nonzero with no
result line. Needs a CUDA device: it never runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "artifacts" / "chip_smoke"  # git-ignored

# Dense peaks of one H100 SXM (NVIDIA data sheet) for the bound.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

# The trainer's full-width configuration (bench.py's long-context LM).
BATCH = 4
SEQ = 8192
LAYERS = 12
LOG_EVERY = 2

# (shape [B, H, T, D], dtype, causal); the first is the trainer's at batch 1.
CHECK_CASES = (
    ((1, 6, SEQ, 128), "bfloat16", True),
    ((1, 2, 1000, 64), "float32", False),
    ((2, 2, 192, 128), "float32", True),
    ((1, 3, 1000, 64), "bfloat16", True),  # bf16 at D=64 with a ragged causal tail
)
# Every element must satisfy |got - ref| <= rtol * |ref| + atol * s.
# f32 as tests/test_ops.py: absolute (s = 1). bf16 o and grads: s is the rms
# of ref's own row, since a causal row i averages i values and its scale
# falls as 1/sqrt(i): one scale for the whole tensor, set by the first rows,
# would let the late rows be anything. s is floored at ROW_FLOOR x the whole
# tensor's rms for rows whose exact value cancels to zero (causal dq's row
# 0: one visible key, so P = 1 and dP = delta). The bf16 o limit covers P
# rounded against the running max (the kernel, as the Pallas one) rather
# than the row's final max (the plain version). lse is f32 on both paths
# and is held absolutely at either dtype.
TOL = {  # kind -> (rtol, atol, atol scaled by the row's rms)
    "float32": {"o": (0.0, 2e-5, False), "lse": (0.0, 2e-5, False),
                "grad": (0.0, 1e-4, False)},
    "bfloat16": {"o": (2e-2, 2e-2, True), "lse": (0.0, 1e-3, False),
                 "grad": (5e-2, 2e-2, True)},
}
ROW_FLOOR = 1e-2
# Broken kernel outputs that the check must reject at the trainer's shape:
# (output, what is broken, how).
MUTATIONS = (
    ("o", "last half of rows zero", lambda x: _tail_rows(x, 0.0)),
    ("o", "last half of rows x1.05", lambda x: _tail_rows(x, 1.05)),
    ("lse", "+0.05", lambda x: x + 0.05),
    ("dq", "last half of rows zero", lambda x: _tail_rows(x, 0.0)),
    ("dk", "last half of rows zero", lambda x: _tail_rows(x, 0.0)),
    ("dv", "last half of rows zero", lambda x: _tail_rows(x, 0.0)),
)

KERNELS = (
    ("flash_fwd", "fwd", "tf_operator_tpu/ops/flash_attention.py:51"),
    ("flash_bwd_dq", "bwd_dq", "tf_operator_tpu/ops/flash_attention.py:222"),
    ("flash_bwd_dkv", "bwd_dkv", "tf_operator_tpu/ops/flash_attention.py:295"),
)
SOURCE = "tf_operator_tpu_torch/csrc/flash_attention.cu"


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean device time of fn() over `reps` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(shape, dtype: str, causal: bool, n_matmuls: int,
          n_in: int, n_out: int, lse_arrays: int):
    """(bound_ms, bound_by): the larger of the FLOP time of the kernel's
    n_matmuls products over the visible (q, k) pairs at the dtype's dense
    peak, and the time to read n_in and write n_out [BH, T, D] arrays plus
    lse_arrays [BH, T] f32 arrays at the HBM rate."""
    b, h, t, d = shape
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    flops = n_matmuls * 2.0 * pairs * d
    item = 2 if dtype == "bfloat16" else 4
    nbytes = (n_in + n_out) * b * h * t * d * item + lse_arrays * b * h * t * 4
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def lm_flops_per_step(batch: int, seq: int, layers: int, hidden: int,
                      vocab: int, mlp_ratio: int = 4) -> float:
    """Model FLOPs of one training step of the causal LM, recomputation not
    counted: 6 x (dense weights) per token, plus causal attention's QK^T and
    PV (4 x B x T(T+1)/2 x hidden per layer forward) times 3 for forward and
    backward."""
    dense = layers * (4 * hidden * hidden + 2 * mlp_ratio * hidden * hidden) \
        + hidden * vocab
    attn = layers * 3 * 4.0 * batch * (seq * (seq + 1) / 2) * hidden
    return 6.0 * dense * batch * seq + attn


def build_phase() -> float:
    from tf_operator_tpu_torch.ops import _build, flash_attention as fa

    t0 = time.time()
    _build.build("flash_attention")
    fa._lib()
    secs = time.time() - t0
    log(f"build: flash_attention.cu in {secs:.1f} s")
    for line in _build.build_logs.get("flash_attention", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    return secs


def _tail_rows(x, factor: float):
    """x with its last half of rows (dim 1, the sequence) scaled by factor."""
    x = x.clone()
    x[:, x.shape[1] // 2:] *= factor
    return x


def excess(got, ref, dtype_name: str, kind: str) -> float:
    """The largest |got - ref| / (rtol * |ref| + atol * s) over the elements,
    with TOL[dtype_name][kind]; the check passes at <= 1."""
    import torch

    rtol, atol, row_scaled = TOL[dtype_name][kind]
    g, r = got.float(), ref.float()
    scale = 1.0
    if row_scaled:
        floor = ROW_FLOOR * r.square().mean().sqrt().clamp_min(1e-30)
        scale = torch.maximum(r.square().mean(dim=-1, keepdim=True).sqrt(), floor)
    return ((g - r).abs() / (rtol * r.abs() + atol * scale)).max().item()


def _kind(name: str) -> str:
    """The TOL kind of a checked output: "o", "lse", or "grad" for the rest."""
    return name if name in ("o", "lse") else "grad"


def checker_self_test(outs: dict, refs: dict, dtype_name: str) -> dict:
    """The check's verdict on each of MUTATIONS applied to the kernels'
    outputs `outs` against `refs`: {label: excess}. Raises if the check
    would accept one of them."""
    verdicts = {}
    for name, what, mutate in MUTATIONS:
        label = f"{name} {what}"
        verdicts[label] = excess(mutate(outs[name]), refs[name], dtype_name, _kind(name))
    accepted = [label for label, e in verdicts.items() if not e > 1.0]
    if accepted:
        raise SmokeFailure(f"the {dtype_name} check accepts broken outputs: {accepted}")
    return verdicts


def check_phase(records: dict) -> None:
    """Each kernel against its plain version, on the same inputs, for every
    case; the autograd bindings against the plain backward; at the trainer's
    shape, the check's rejection of broken outputs and the timings. Fills
    `records[name]` with max_abs_err and the times."""
    import torch

    from tf_operator_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    failures = []

    for shape, dtype_name, causal in CHECK_CASES:
        dtype = getattr(torch, dtype_name)
        b, h, t, d = shape
        main = shape == CHECK_CASES[0][0]

        def rnd(*s, dt=dtype):
            return torch.randn(*s, generator=gen, device=dev, dtype=torch.float32).to(dt)

        q, k, v, do = (rnd(b * h, t, d) for _ in range(4))
        g_lse = rnd(b * h, t, dt=torch.float32)
        # name -> (max |got - ref| / max |ref|, excess); the first is the
        # number reported, the second decides.
        errs = {}

        def hold(name, got, ref):
            got = got.reshape(ref.shape)
            diff = (got.float() - ref.float()).abs().max().item()
            errs[name] = (diff / max(ref.float().abs().max().item(), 1e-30),
                          excess(got, ref, dtype_name, _kind(name)))
            return diff

        o, lse = fa.flash_fwd(q, k, v, causal)
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal)
        abs_errs = {"fwd": hold("o", o, o_p)}
        hold("lse", lse, lse_p)
        for tag, gl in (("", None), ("+g_lse", g_lse)):
            dq = fa.flash_bwd_dq(q, k, v, o, lse, do, causal, gl)
            dq_p = fa._bwd_dq_plain(q, k, v, o, lse, do, causal, gl)
            dk, dv = fa.flash_bwd_dkv(q, k, v, o, lse, do, causal, gl)
            dk_p, dv_p = fa._bwd_dkv_plain(q, k, v, o, lse, do, causal, gl)
            diffs = [hold(name + tag, got, ref)
                     for name, got, ref in (("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p))]
            if not tag:
                abs_errs["bwd_dq"], abs_errs["bwd_dkv"] = diffs[0], max(diffs[1:])
                if main:
                    verdicts = checker_self_test(
                        {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv},
                        {"o": o_p, "lse": lse_p, "dq": dq_p, "dk": dk_p, "dv": dv_p},
                        dtype_name)
                    log(f"check {list(shape)} {dtype_name}: the check rejects broken "
                        "outputs, excess " + ", ".join(f"{n}={e:.3g}" for n, e in verdicts.items()))
            del dq, dq_p, dk, dv, dk_p, dv_p

        # The autograd bindings over [B, H, T, D], against the plain
        # forward and backward.
        q4, k4, v4 = (x.view(b, h, t, d).clone().requires_grad_() for x in (q, k, v))
        do4 = do.view(b, h, t, d)
        grads = torch.autograd.grad(fa.FlashAttention.apply(q4, k4, v4, causal),
                                    (q4, k4, v4), do4)
        ref = fa.flash_bwd_plain(q, k, v, o_p, lse_p, do, causal)
        for name, got, r in zip(("dq", "dk", "dv"), grads, ref):
            hold("FlashAttention." + name, got, r)
        o4, lse4 = fa.FlashAttentionWithLse.apply(q4, k4, v4, causal)
        grads = torch.autograd.grad((o4, lse4), (q4, k4, v4),
                                    (do4, g_lse.view(b, h, t)))
        ref = fa.flash_bwd_plain(q, k, v, o_p, lse_p, do, causal, g_lse)
        for name, got, r in zip(("dq", "dk", "dv"), grads, ref):
            hold("FlashAttentionWithLse." + name, got, r)
        torch.cuda.synchronize()
        del grads, ref, o4, lse4

        log(f"check {list(shape)} {dtype_name} causal={causal}: max err / max|ref| "
            + ", ".join(f"{n}={e[0]:.3g}" for n, e in errs.items()))
        log(f"check {list(shape)} {dtype_name} causal={causal}: excess (<= 1 passes) "
            + ", ".join(f"{n}={e[1]:.3g}" for n, e in errs.items()))
        failures += [f"{list(shape)} {dtype_name} {n}: excess {e[1]:.3g}"
                     for n, e in errs.items() if not e[1] <= 1.0]

        if main:
            for name, key, _ in KERNELS:
                records[name] = {"max_abs_err": abs_errs[key]}
            _time_main_shape(records, q, k, v, o, lse, do, causal, shape, dtype_name)
        del q, k, v, do, o, lse, o_p, lse_p, g_lse
        torch.cuda.empty_cache()

    if failures:
        raise SmokeFailure("kernel disagrees with its plain version: " + "; ".join(failures))


def _time_main_shape(records, q, k, v, o, lse, do, causal, shape, dtype_name):
    import torch
    import torch.nn.functional as F

    from tf_operator_tpu_torch.ops import flash_attention as fa

    b, h, t, d = shape
    q4, k4, v4 = (x.view(b, h, t, d).detach().clone().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
    do4 = do.view(b, h, t, d)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)

    def sdpa_bwd():
        torch.autograd.grad(out, (q4, k4, v4), do4, retain_graph=True)

    def sdpa_fwd_bwd():
        o_ = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
        torch.autograd.grad(o_, (q4, k4, v4), do4)

    times = {
        "flash_fwd": (
            time_ms(lambda: fa.flash_fwd(q, k, v, causal)),
            time_ms(lambda: fa.flash_fwd_plain(q, k, v, causal), reps=3),
            time_ms(sdpa_fwd, reps=10),
            bound(shape, dtype_name, causal, 2, 3, 1, 1)),
        "flash_bwd_dq": (
            time_ms(lambda: fa.flash_bwd_dq(q, k, v, o, lse, do, causal)),
            time_ms(lambda: fa._bwd_dq_plain(q, k, v, o, lse, do, causal), reps=3),
            time_ms(sdpa_bwd, reps=10),
            bound(shape, dtype_name, causal, 3, 5, 1, 1)),
        "flash_bwd_dkv": (
            time_ms(lambda: fa.flash_bwd_dkv(q, k, v, o, lse, do, causal)),
            time_ms(lambda: fa._bwd_dkv_plain(q, k, v, o, lse, do, causal), reps=3),
            None,
            bound(shape, dtype_name, causal, 4, 5, 2, 1)),
    }
    sdpa_fb = time_ms(sdpa_fwd_bwd, reps=10)
    # One library call computes the backward's dq, dk and dv together: it is
    # the yardstick of both backward kernels.
    times["flash_bwd_dkv"] = times["flash_bwd_dkv"][:2] + (times["flash_bwd_dq"][2],) \
        + times["flash_bwd_dkv"][3:]
    for name, (ms, plain_ms, lib_ms, (bound_ms, bound_by)) in times.items():
        records[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=lib_ms)
        log(f"time {name} {list(shape)} {dtype_name}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"scaled_dot_product_attention {lib_ms:.3f} ms")
    log(f"time scaled_dot_product_attention fwd+bwd: {sdpa_fb:.3f} ms")
    del out, q4, k4, v4


def run_trainer(steps: int) -> dict:
    """python -m tf_operator_tpu_torch.models.train at the full-width
    configuration for `steps` steps, in this process; returns its events by
    name. Fails unless it exits 0 with a finite final loss."""
    from tf_operator_tpu_torch.models import train

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    events_path = OUT_DIR / "chip_smoke_events.jsonl"
    events_path.unlink(missing_ok=True)
    argv = ["--model", "transformer-lm", "--steps", str(steps),
            "--batch", str(BATCH), "--seq", str(SEQ), "--layers", str(LAYERS),
            "--hidden", "768", "--heads", "6", "--moment-dtype", "bf16",
            "--master-weights", "--log-every", str(LOG_EVERY), "--device", "cuda"]
    log("train: python -m tf_operator_tpu_torch.models.train " + " ".join(argv))
    os.environ["TPUJOB_METRICS_FILE"] = str(events_path)
    try:
        rc = train.main(argv)
    finally:
        os.environ.pop("TPUJOB_METRICS_FILE", None)
    if rc != 0:
        raise SmokeFailure(f"trainer exited {rc}")
    by = {e["event"]: e for e in map(json.loads, events_path.read_text().splitlines())}
    done = by.get("done")
    if done is None or not isinstance(done.get("final_loss"), float) \
            or not done["final_loss"] == done["final_loss"] \
            or abs(done["final_loss"]) == float("inf"):
        raise SmokeFailure(f"no done event with a finite final_loss: {done}")
    if not isinstance(by.get("first_step", {}).get("startup_s"), float):
        raise SmokeFailure("first_step event lacks a float startup_s")
    return by


def train_phase(args, card: str) -> dict:
    """The port's trainer at full width through its entry point; every
    kernel must have launched at least layers x steps times in that run."""
    import torch

    from tf_operator_tpu_torch.ops import flash_attention as fa

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    by = run_trainer(args.steps)
    launches = dict(fa.LAUNCHES)
    need = LAYERS * args.steps
    short = {k: n for k, n in launches.items() if n < need}
    if short:
        raise SmokeFailure(f"kernels launched fewer than layers x steps = {need} "
                           f"times on the main path: {short}")
    done = by["done"]
    eps = done.get("examples_per_sec")
    tps = eps * SEQ if eps else None
    step_s = (done.get("step_time_s") or {}).get("mean")
    mfu = (lm_flops_per_step(BATCH, SEQ, LAYERS, 768, 32000) * eps / BATCH
           / PEAK_FLOPS["bfloat16"]) if eps else None
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"train: final_loss={done['final_loss']:.4f} tokens/s={tps} mfu={mfu} "
        f"step_time_mean_s={step_s} startup_s={by['first_step']['startup_s']} "
        f"max_memory_allocated={peak_gb:.2f} GB launches={launches} "
        f"batch={BATCH} [{card}]")
    return launches


def profile_phase(args, card: str) -> None:
    """The trainer's run, as the train phase drives it, under torch.profiler:
    device time by kernel group over its steady steps, the steps after its
    first chunk. Each step is cut at its first attention forward (the
    kernel stream's (LAYERS * i)-th fwd_kernel), so the window holds whole
    steps LOG_EVERY + 1 .. steps - 1 of device work and the gaps between
    them. The Chrome trace goes to OUT_DIR."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    if args.steps < LOG_EVERY + 2:
        raise SmokeFailure(f"the profile needs --steps >= {LOG_EVERY + 2}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_trainer(args.steps)
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    fwd_starts = [e.time_range.start for e in kernels if "fwd_kernel" in e.name]
    if len(fwd_starts) != LAYERS * args.steps:
        raise SmokeFailure(f"the profiler saw {len(fwd_starts)} fwd_kernel launches, "
                           f"not layers x steps = {LAYERS * args.steps}")
    t0, t1 = fwd_starts[LAYERS * LOG_EVERY], fwd_starts[LAYERS * (args.steps - 1)]
    groups = {"flash_fwd": "fwd_kernel", "flash_bwd_dq": "bwd_dq_kernel",
              "flash_bwd_dkv": "bwd_dkv_kernel"}
    by_group: dict[str, float] = {}
    n_kernels = 0
    for e in kernels:
        if not t0 <= e.time_range.start < t1:
            continue
        group = next((g for g, key in groups.items() if key in e.name), None)
        if group is None:
            low = e.name.lower()
            # cuBLAS names its Hopper GEMMs nvjet_*, older ones *gemm*/*xmma*.
            is_mm = any(key in low for key in ("nvjet", "gemm", "xmma", "cutlass"))
            group = "matmul" if is_mm else "other"
        us = min(e.time_range.end, t1) - e.time_range.start
        by_group[group] = by_group.get(group, 0.0) + us / 1e3
        n_kernels += 1
    window_ms = (t1 - t0) / 1e3
    busy = sum(by_group.values())
    summary = {"profile": {
        "steps": args.steps - 1 - LOG_EVERY, "batch": BATCH, "window_ms": window_ms,
        "device_busy_ms": busy, "idle_share": 1.0 - busy / window_ms,
        "kernels": n_kernels,
        "device_ms_by_group": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
        "card": card}}
    prof.export_chrome_trace(str(OUT_DIR / "train_profile.trace.json"))
    log("profile: " + json.dumps(summary))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,check,train",
                    help="comma-separated subset of build,check,train,profile")
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the "
              "card", file=sys.stderr)
        return 1
    try:
        import tf_operator_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is not importable here: {e}",
              file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    card = card_line()
    log(f"card: {card} | torch.cuda.get_device_name: {torch.cuda.get_device_name(0)}"
        f" | torch {torch.__version__} cuda {torch.version.cuda}")
    records: dict = {}
    launches: dict | None = None  # filled only by the train phase
    try:
        build_phase()
        if "check" in phases:
            check_phase(records)
        if "train" in phases:
            launches = train_phase(args, card)
        if "profile" in phases:
            profile_phase(args, card)
    except Exception as e:  # every phase failure ends the run without a result
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1

    kernels = []
    for name, key, replaces in KERNELS:
        rec = records.get(name, {})
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces,
            "launches": launches[key] if launches is not None else None,
            "max_abs_err": rec.get("max_abs_err"), "ms": rec.get("ms"),
            "plain_ms": rec.get("plain_ms"), "bound_ms": rec.get("bound_ms"),
            "bound_by": rec.get("bound_by"), "library_ms": rec.get("library_ms"),
        })
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
