#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one CUDA card, end to end.

    python3 chip_smoke.py                 # every phase, as a check of the port
    python3 chip_smoke.py --phases build,check   # kernels only
    python3 chip_smoke.py --phases build,k4      # the fused bottleneck only
    python3 chip_smoke.py --phases build,train,ckpt  # the trainers and checkpoints

Phases, in order:
  1. identify the card (nvidia-smi name and power limit);
  2. build the CUDA kernels from tf_operator_tpu_torch/csrc with nvcc, one
     nvcc per source, all started together, and log each kernel's registers
     and spills (ptxas) and its count of wgmma (HGMMA) instructions in the
     built library's SASS;
  3. hold each kernel against its plain PyTorch version on the card: the
     flash kernels (the forward with and without its lse) and the
     backward's delta pass at the LM trainer's attention shape and four
     small ones (f32 with a ragged tail, f32 causal, bf16 at head_dim 64
     with a ragged causal tail, bf16 full attention at head_dim 128 with a
     ragged tail) and at the head widths the kernels reach zero-padded (32,
     96, 192 and 256, f32 and bf16, causal and full, T = 1000; each of
     MUTATIONS must be rejected there too, and each width is timed at
     [1, 768 / D, 8192, D] bf16 causal beside SDPA), timed at the
     trainer's shape at batch 1 beside their
     bound, their plain version and PyTorch's scaled_dot_product_attention,
     and at the trainer's batch 4 beside their bound and that call (the
     plain versions' f32 scores would not fit); the fused
     bottleneck at ResNet-50's four stages' first identity blocks (the
     weights and input activations of the port's ResNet-50 at batch 256,
     224x224), a small bf16 case with ragged multi-tile rows, a bf16 case
     whose Cn 40 and Cw 96 run zero-padded to 64 and 128, and a small
     f32 case, timed at the four ResNet-50 shapes beside its bound, its
     plain version, the port's unfused BottleneckBlock and the three
     products alone through cuBLAS/cuDNN, with each launch's device time
     at stages 1 and 4 (torch.profiler);
  4. train the full-width causal LM (12L x 768h, 6 heads x 128, vocab 32000,
     seq 8192) through tf_operator_tpu_torch.models.train for a few steps,
     and check that every flash kernel ran on that path; then ResNet-50 at
     batch 256, 224x224, and check its loss and batch-norm running
     statistics (no hand-written kernel is on that path: the fused
     bottleneck, as in the JAX package, is on no trainer path); then the
     LM at head width 32 (--hidden 128 --heads 4, seq 8192), which must
     end finite and launch every flash kernel;
  5. checkpoints (ckpt): the full-width LM saves every 2 steps to step 4
     (async), a second run resumes it to step 6, and its step-6 loss must
     equal the train phase's uninterrupted one (or, if not bit for bit,
     stay within the spread of two uninterrupted runs); the checkpoint's
     bytes, the snapshot and write seconds per save, hidden_fraction and
     tokens/s beside the train phase's are logged;
  6. (only with --phases ...,profile) both trainers' runs under
     torch.profiler: device time by kernel group over their steady steps.
The last lines are the kernels' JSON record, the card, and
{"ok": true, "device": {...}}. Any failed phase exits nonzero with no
result line. Needs a CUDA device: it never runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
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
    ((2, 2, 1000, 128), "bfloat16", False),  # bf16 full attention, ragged tail
)
# Head widths that run zero-padded (to 64, 128, 256, 256): each checked in
# f32 and bf16, causal and full, at a T that is no multiple of any tile,
# every MUTATIONS entry rejected; each timed once in bf16 causal at
# [1, HEAD_WIDTH_HIDDEN / D, SEQ, D] beside SDPA.
HEAD_WIDTHS = (32, 96, 192, 256)
HEAD_WIDTH_HIDDEN = 768
WIDTH_CASES = tuple(((1, 2, 1000, d), dt, causal) for d in HEAD_WIDTHS
                    for dt in ("float32", "bfloat16") for causal in (True, False))
# Every element must satisfy |got - ref| <= rtol * |ref| + atol * s.
# f32 as tests/test_ops.py: absolute (s = 1). bf16 o and grads: s is the rms
# of ref's own row, since a causal row i averages i values and its scale
# falls as 1/sqrt(i): one scale for the whole tensor, set by the first rows,
# would let the late rows be anything. s is floored at ROW_FLOOR x the whole
# tensor's rms for rows whose exact value cancels to zero (causal dq's row
# 0: one visible key, so P = 1 and dP = delta). The bf16 o limit covers P
# rounded against the running max (the kernel, as the Pallas one) rather
# than the row's final max (the plain version). lse is f32 on both paths
# and is held absolutely at either dtype. delta (the backward's
# rowsum(dO o O) - g_lse) is f32 on both paths from the same inputs, each
# product exact in f32: only the order of D sums differs.
TOL = {  # kind -> (rtol, atol, atol scaled by the row's rms)
    "float32": {"o": (0.0, 2e-5, False), "lse": (0.0, 2e-5, False),
                "delta": (1e-4, 1e-4, False), "grad": (0.0, 1e-4, False)},
    "bfloat16": {"o": (2e-2, 2e-2, True), "lse": (0.0, 1e-3, False),
                 "delta": (1e-4, 1e-4, False), "grad": (5e-2, 2e-2, True)},
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
    # A helper of K2/K3: the delta that both Pallas kernels compute in-block.
    ("flash_bwd_delta", "bwd_delta", "tf_operator_tpu/ops/flash_attention.py:252"),
)
KERNEL_NOTES = {"flash_bwd_delta": "helper of flash_bwd_dq and flash_bwd_dkv, not the "
                                   "port of a TPU kernel: the Pallas kernels compute "
                                   "delta in-block (also :324); launched once a backward"}
# The flash kernels are also timed at the trainer's batch (kernel, bound and
# the library call only).
TIME_BATCHES = (1, BATCH)
SOURCE = "tf_operator_tpu_torch/csrc/flash_attention.cu"
K4 = ("fused_bottleneck_fwd", "tf_operator_tpu_torch/csrc/fused_bottleneck.cu",
      "tf_operator_tpu/ops/fused_bottleneck.py:100")
SOURCES = ("flash_attention", "fused_bottleneck")

# The fused bottleneck's cases: (label, ResNet-50 block index or None for
# random inputs, dtype). Blocks 1, 4, 8 and 14 are the first identity
# blocks of stages 1-4 (56x56 Cw 256 Cn 64 tile 1, 28x28 Cw 512 Cn 128 tile
# 4, 14x14 Cw 1024 Cn 256 tile 16, 7x7 Cw 2048 Cn 512 tile 64; tiles from
# default_tile(h, w, 256)), so every output-tile width of the bf16 kernels
# runs. The random cases (K4_RANDOM: B, H, W, Cw, Cn, tile_b): "ragged" is
# bf16 at 7x7 with tile 2, 98 rows a tile, which straddle every 64- and
# 128-row block, and each tile's x moved to x (1 + i) + i, so rows leaking
# across a tile boundary move st and y visibly; "small" is f32 (the FMA
# route) with ragged channel blocks (24 and 96 are not multiples of 64).
RN_BATCH, RN_SIZE = 256, 224
K4_CASES = (("stage1", 1, "bfloat16"), ("stage2", 4, "bfloat16"),
            ("stage3", 8, "bfloat16"), ("stage4", 14, "bfloat16"),
            ("ragged", None, "bfloat16"), ("padded", None, "bfloat16"),
            ("small", None, "float32"))
# "padded": bf16 with Cn 40 and Cw 96, which the wrapper pads to 64 and 128.
K4_RANDOM = {"ragged": (6, 7, 7, 256, 64, 2), "padded": (4, 7, 7, 96, 40, 2),
             "small": (4, 7, 7, 96, 24, 2)}
# Cases whose launches are split by kernel under torch.profiler.
K4_SPLIT_CASES = ("stage1", "stage4")
# Per-element limits of the fused bottleneck against its plain version.
# y: |got - ref| <= rtol |ref| + atol s, s the rms of ref. In bf16 the two
# round y (and n1, n2 on the way) at the same points from f32 values that
# differ by summation order, so an element may land one bf16 step away: up
# to 2^-7 of |ref| (rtol 1e-2). And an n2 element rounded one step the other
# way moves t3 by w3 x that step, which BN3 multiplies by its a3 (up to ~4
# at these inputs): small elements of y then differ by up to ~2e-2 absolute,
# as much as the f32 plain version differs from a float64 evaluation of the
# same function (the check phase logs both distances), so atol is 4e-2 s.
# In f32 the limit is absolute, as tests/test_ops.py (1e-4).
# st (raw moments [tiles, 2, C]): the mean row within tol x the channel's
# rms sqrt(E[t^2]), the mean-of-squares row within 2 tol x E[t^2], each
# scale floored at ROW_FLOOR x its average over the tensor. They average
# thousands of rows, so one-step rounding flips upstream barely move them:
# 1e-3 in bf16, 1e-5 in f32.
K4_TOL = {"bfloat16": {"y": (1e-2, 4e-2), "st": 1e-3},
          "float32": {"y": (0.0, 1e-4), "st": 1e-5}}
# Broken outputs the check must reject: (output, what is broken, how, given
# (outputs, the call's arguments, tile_b), the case it is applied to).
K4_MUTATIONS = (
    ("y", "last tile zero", lambda o, a, tb: _tail(o["y"], tb, 0.0), "stage1"),
    ("y", "last half x1.02", lambda o, a, tb: _tail(o["y"], o["y"].shape[0] // 2, 1.02),
     "stage1"),
    ("y", "relu(x): the block's path dropped", lambda o, a, tb: a[0].clamp_min(0), "stage1"),
    ("st2", "mean + 1e-2 x its rms", lambda o, a, tb: _shift_mean(o["st2"], 1e-2), "stage1"),
    ("st1", "each tile's moments taken over its rows plus the next tile's first 64",
     lambda o, a, tb: _leak_next_tile(o["st1"], a, 64), "ragged"),
)


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
    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops import fused_bottleneck as fb

    t0 = time.time()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(_build.build, SOURCES))
    fa._lib()
    fb._lib()
    secs = time.time() - t0
    log(f"build: {', '.join(n + '.cu' for n in SOURCES)} in parallel in {secs:.1f} s")
    for name in SOURCES:
        build_log = _build.build_logs.get(name, "")
        for kernel, info in parse_ptxas(build_log).items():
            log(f"  ptxas {name}: {kernel}: {info}")
        for line in build_log.splitlines():
            # ptxas reports wgmma serialisation as "Potential Performance Loss".
            if "warning" in line.lower() or "performance loss" in line.lower():
                log(f"  nvcc {name}: {line.strip()}")
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    for name in SOURCES:
        sass = subprocess.run([str(cuobjdump), "--dump-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        counts = sass_counts(sass, "HGMMA")
        log(f"  sass {name}: HGMMA instructions per kernel: "
            + ", ".join(f"{k} {n}" for k, n in sorted(counts.items())))
        missing = [k for k, n in counts.items() if "wgmma" in k and n == 0]
        if missing:
            raise SmokeFailure(f"wgmma kernels without HGMMA instructions: {missing}")
    return secs


def kernel_label(mangled: str) -> str:
    """A readable label for a mangled kernel name of this repo's sources,
    e.g. bwd_dq_wgmma_kernel<128> or fwd_kernel<float, 64>: the
    length-prefixed identifier that ends in "_kernel", and the dtype and
    integers of its template arguments."""
    i = 3 if mangled.startswith("_ZN") else 2
    while (m := re.match(r"\d+", mangled[i:])) is not None:
        start = i + len(m.group())
        name = mangled[start:start + int(m.group())]
        i = start + len(name)
        if not name.endswith("_kernel"):
            continue
        rest = mangled[i:]
        if not rest.startswith("I"):
            return name
        targs = rest[1:rest.find("EE")] if "EE" in rest else rest[1:]
        dtype = "float" if targs.startswith("f") else ("bf16" if "bfloat16" in targs else "")
        dims = re.findall(r"Li(\d+)", targs)
        return f"{name}<{', '.join([dtype] * bool(dtype) + dims)}>"
    return mangled


def parse_ptxas(log_text: str) -> dict:
    """{kernel label: "N registers, S bytes spill stores, L bytes spill
    loads"} from nvcc's -Xptxas -v report."""
    out, kernel, spills = {}, None, ""
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel, spills = kernel_label(m.group(1)), ""
        elif kernel and "spill" in line:
            spills = ", ".join(p.strip() for p in line.split(",")[1:])
        elif kernel and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out[kernel] = f"{regs} registers, {spills}"
    return out


def sass_counts(sass: str, opcode: str) -> dict:
    """{kernel label: number of instructions with that opcode} from the
    text of cuobjdump --dump-sass."""
    counts: dict = {}
    kernel = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = kernel_label(m.group(1))
            counts.setdefault(kernel, 0)
        elif kernel and re.search(rf"\b{opcode}\b", line):
            counts[kernel] += 1
    return counts


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
    """The TOL kind of a checked output, read from its name's first word
    ("o(no lse)" is an "o", "delta+g_lse" a "delta"): "o", "lse", "delta",
    or "grad" for the rest."""
    base = re.match(r"\w*", name).group()
    return base if base in ("o", "lse", "delta") else "grad"


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

    for shape, dtype_name, causal in CHECK_CASES + WIDTH_CASES:
        dtype = getattr(torch, dtype_name)
        b, h, t, d = shape
        main = shape == CHECK_CASES[0][0]
        padded = d in HEAD_WIDTHS

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
        # The forward without lse (the kernel gets NULL), as FlashAttention
        # runs it when no input needs a gradient: the same o, bit for bit.
        o_nl, lse_nl = fa.flash_fwd(q, k, v, causal, save_lse=False)
        hold("o(no lse)", o_nl, o_p)
        if lse_nl is not None or not torch.equal(o_nl, o):
            failures.append(f"{list(shape)} {dtype_name}: flash_fwd(save_lse=False) gave "
                            "an lse or another o than flash_fwd")
        del o_nl
        for tag, gl in (("", None), ("+g_lse", g_lse)):
            delta = fa.bwd_delta(o, do, gl)
            diff = hold("delta" + tag, delta, fa._bwd_delta_plain(o, do, gl))
            if not tag:
                abs_errs["bwd_delta"] = diff
            dq = fa.flash_bwd_dq(q, k, v, o, lse, do, causal, gl)
            dq_p = fa._bwd_dq_plain(q, k, v, o, lse, do, causal, gl)
            dk, dv = fa.flash_bwd_dkv(q, k, v, o, lse, do, causal, gl)
            dk_p, dv_p = fa._bwd_dkv_plain(q, k, v, o, lse, do, causal, gl)
            diffs = [hold(name + tag, got, ref)
                     for name, got, ref in (("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p))]
            if not tag:
                abs_errs["bwd_dq"], abs_errs["bwd_dkv"] = diffs[0], max(diffs[1:])
                if main or padded:
                    verdicts = checker_self_test(
                        {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv},
                        {"o": o_p, "lse": lse_p, "dq": dq_p, "dk": dk_p, "dv": dv_p},
                        dtype_name)
                    log(f"check {list(shape)} {dtype_name} causal={causal}: the check "
                        "rejects broken "
                        "outputs, excess " + ", ".join(f"{n}={e:.3g}" for n, e in verdicts.items()))
            del dq, dq_p, dk, dv, dk_p, dv_p, delta

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
    _time_head_widths(records)
    k4_check_phase(records)


def _time_head_widths(records: dict) -> None:
    """Each of HEAD_WIDTHS once at [1, HEAD_WIDTH_HIDDEN / D, SEQ, D] bf16
    causal: K1-K3 and the delta pass beside their bound (of the unpadded
    width's work) and SDPA's forward and backward. Fills
    records[kernel]["head_widths"][D]."""
    import torch

    from tf_operator_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    for d in HEAD_WIDTHS:
        h = HEAD_WIDTH_HIDDEN // d
        shape = (1, h, SEQ, d)
        gen = torch.Generator(device=dev).manual_seed(d)
        q, k, v, do = (torch.randn((h, SEQ, d), generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(4))
        o, lse = fa.flash_fwd(q, k, v, True)
        recs = _time_kernels(q, k, v, o, lse, do, True, shape, "bfloat16", with_plain=False)
        for name, rec in recs.items():
            records.setdefault(name, {}).setdefault("head_widths", {})[str(d)] = {
                "shape": list(shape), "padded_to": fa.kernel_head_dim(d),
                **{key: rec[key] for key in ("ms", "bound_ms", "bound_by", "library_ms")}}
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()


def _time_main_shape(records, q, k, v, o, lse, do, causal, shape, dtype_name):
    """Times at the trainer's attention shape: at batch 1 (these inputs) each
    kernel beside its bound, its plain version and the library call, and at
    the trainer's batch each kernel beside its bound and the library call.
    K2 and K3 are timed on a delta computed beforehand; the delta pass on
    its own."""
    import torch

    from tf_operator_tpu_torch.ops import flash_attention as fa

    for batch in TIME_BATCHES:
        shp = (batch, *shape[1:])
        if batch != shape[0]:
            gen = torch.Generator(device=q.device).manual_seed(batch)
            q, k, v, do = (torch.randn((batch * shape[1], *shape[2:]), generator=gen,
                                       device=q.device).to(q.dtype) for _ in range(4))
            o, lse = fa.flash_fwd(q, k, v, causal)
        t = _time_kernels(q, k, v, o, lse, do, causal, shp, dtype_name,
                          with_plain=batch == shape[0])
        for name, rec in t.items():
            if batch == shape[0]:
                records[name].update(rec)
            else:
                records[name]["at_batch_%d" % batch] = {
                    key: rec[key] for key in ("ms", "bound_ms", "bound_by", "library_ms")}
    del q, k, v, o, lse, do


def _time_kernels(q, k, v, o, lse, do, causal, shape, dtype_name, with_plain: bool) -> dict:
    import torch
    import torch.nn.functional as F

    from tf_operator_tpu_torch.ops import flash_attention as fa

    b, h, t, d = shape
    q4, k4, v4 = (x.view(b, h, t, d).detach().clone().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
    do4 = do.view(b, h, t, d)
    delta = fa.bwd_delta(o, do)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)

    def sdpa_bwd():
        torch.autograd.grad(out, (q4, k4, v4), do4, retain_graph=True)

    def plain(fn):
        return time_ms(fn, reps=3) if with_plain else None

    sdpa_bwd_ms = time_ms(sdpa_bwd, reps=10)
    # One library call computes the backward's dq, dk and dv together: it is
    # the yardstick of both backward kernels. No single call computes delta.
    times = {
        "flash_fwd": (
            time_ms(lambda: fa.flash_fwd(q, k, v, causal)),
            plain(lambda: fa.flash_fwd_plain(q, k, v, causal)),
            time_ms(sdpa_fwd, reps=10),
            bound(shape, dtype_name, causal, 2, 3, 1, 1)),
        "flash_bwd_dq": (
            time_ms(lambda: fa.flash_bwd_dq(q, k, v, o, lse, do, causal, delta=delta)),
            plain(lambda: fa._bwd_dq_plain(q, k, v, o, lse, do, causal, delta=delta)),
            sdpa_bwd_ms,
            bound(shape, dtype_name, causal, 3, 4, 1, 2)),
        "flash_bwd_dkv": (
            time_ms(lambda: fa.flash_bwd_dkv(q, k, v, o, lse, do, causal, delta=delta)),
            plain(lambda: fa._bwd_dkv_plain(q, k, v, o, lse, do, causal, delta=delta)),
            sdpa_bwd_ms,
            bound(shape, dtype_name, causal, 4, 4, 2, 2)),
        "flash_bwd_delta": (
            time_ms(lambda: fa.bwd_delta(o, do), reps=20),
            plain(lambda: fa._bwd_delta_plain(o, do)),
            None,
            bound(shape, dtype_name, causal, 0, 2, 0, 1)),
    }
    recs = {}
    for name, (ms, plain_ms, lib_ms, (bound_ms, bound_by)) in times.items():
        recs[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=lib_ms)
        log(f"time {name} {list(shape)} {dtype_name}: kernel {ms:.4f} ms, plain "
            + (f"{plain_ms:.3f} ms" if plain_ms is not None else "not timed")
            + f", bound {bound_ms:.4f} ms ({bound_by}), scaled_dot_product_attention "
            + (f"{lib_ms:.4f} ms" if lib_ms is not None else "none"))
    log(f"time {list(shape)} {dtype_name}: K1 {times['flash_fwd'][0]:.4f} ms = "
        f"{times['flash_fwd'][0] / times['flash_fwd'][2]:.2f} x "
        f"scaled_dot_product_attention's forward {times['flash_fwd'][2]:.4f} ms")
    pair = times["flash_bwd_dq"][0] + times["flash_bwd_dkv"][0]
    log(f"time {list(shape)} {dtype_name}: K2 + K3 {pair:.4f} ms = "
        f"{pair / sdpa_bwd_ms:.2f} x scaled_dot_product_attention's backward "
        f"{sdpa_bwd_ms:.4f} ms")
    del out, q4, k4, v4, delta
    return recs


def _tail(x, n: int, factor: float):
    """x with its last n entries along dim 0 scaled by factor."""
    x = x.clone()
    x[x.shape[0] - n:] *= factor
    return x


def _shift_mean(st, frac: float):
    """Raw moments [tiles, 2, C] with every mean moved by frac x the
    channel's rms."""
    st = st.clone()
    st[:, 0] += frac * st[:, 1].clamp_min(0).sqrt()
    return st


def _leak_next_tile(st1, args, n: int):
    """st1 with each tile's moments taken over its own rows plus the next
    tile's first n rows of t1 = x . w1 (the last tile's as they are): what
    a product block that straddles a tile boundary would give."""
    import torch

    x, w1 = args[0], args[1]
    t1 = x.reshape(-1, x.shape[-1]).float() @ w1.float()
    t = t1.view(st1.shape[0], -1, t1.shape[-1])
    rows = torch.cat((t[:-1], t[1:, :n]), 1)
    st = st1.clone()
    st[:-1, 0] = rows.mean(1)
    st[:-1, 1] = rows.square().mean(1)
    return st


def k4_tile_offset(x, tile_b: int):
    """x [B, ...] with tile i's images (tile_b a tile) moved to x (1 + i) + i."""
    tiles = x.shape[0] // tile_b
    i = (x.new_tensor(range(tiles), dtype=x.dtype)
         .repeat_interleave(tile_b).view(-1, *([1] * (x.dim() - 1))))
    return x * (1 + i) + i


def k4_excess(got, ref, dtype_name: str, name: str) -> float:
    """The largest error of the fused bottleneck's output `name` ("y" or a
    moment "st1".."st3") over its K4_TOL limit; the check passes at <= 1."""
    import torch

    g, r = got.float(), ref.float()
    tol = K4_TOL[dtype_name]
    if name == "y":
        rtol, atol = tol["y"]
        s = r.square().mean().sqrt().clamp_min(1e-30)
        return ((g - r).abs() / (rtol * r.abs() + atol * s)).max().item()
    q = r[:, 1].clamp_min(0)
    q_scale = torch.maximum(q, ROW_FLOOR * q.mean()).clamp_min(1e-30)
    rms = q.sqrt()
    m_scale = torch.maximum(rms, ROW_FLOOR * rms.mean()).clamp_min(1e-30)
    e_m = ((g[:, 0] - r[:, 0]).abs() / (tol["st"] * m_scale)).max().item()
    e_q = ((g[:, 1] - r[:, 1]).abs() / (2 * tol["st"] * q_scale)).max().item()
    return max(e_m, e_q)


def k4_checker_self_test(outs: dict, refs: dict, args, tile_b: int, dtype_name: str,
                         case: str) -> dict:
    """The check's verdict on each of K4_MUTATIONS of this case applied to
    the kernel's outputs: {label: excess}. Raises if the check would accept
    one."""
    verdicts = {f"{name} {what}": k4_excess(mutate(outs, args, tile_b), refs[name],
                                            dtype_name, name)
                for name, what, mutate, where in K4_MUTATIONS if where == case}
    accepted = [label for label, e in verdicts.items() if not e > 1.0]
    if accepted:
        raise SmokeFailure(f"the {dtype_name} fused-bottleneck check accepts "
                           f"broken outputs: {accepted}")
    return verdicts


def k4_bound(b: int, h: int, w: int, cw: int, cn: int, tile_b: int, dtype: str):
    """(bound_ms, bound_by) of one fused-bottleneck call: the larger of its
    FLOPs (2 x rows x (Cw Cn + 9 Cn^2 + Cn Cw), every 3x3 tap counted) at
    the dtype's dense peak, and reading x and the weights and writing y in
    the dtype, plus the f32 BN vectors and moments, at the HBM rate."""
    rows = b * h * w
    flops = 2.0 * rows * (cw * cn + 9 * cn * cn + cn * cw)
    item = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * rows * cw + 2 * cw * cn + 9 * cn * cn) * item \
        + 4 * (4 * cn + 2 * cw) + 4 * 2 * (b // tile_b) * (2 * cn + cw)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _resnet50_block_inputs(blocks):
    """The port's ResNet-50 (seeded init, on the card) and the NHWC inputs
    that its blocks `blocks` receive in a train-mode forward of a synthetic
    batch of RN_BATCH RN_SIZE^2 images."""
    import torch

    from tf_operator_tpu_torch.models import resnet

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    model = resnet.ResNet50(device=dev, generator=gen)
    seen = {}

    def grab(i):
        def hook(_mod, inputs):
            seen[i] = inputs[0].permute(0, 2, 3, 1).contiguous()
        return hook

    hooks = [model.blocks[i].register_forward_pre_hook(grab(i)) for i in blocks]
    x = torch.randn((RN_BATCH, RN_SIZE, RN_SIZE, 3), generator=gen, device=dev)
    with torch.no_grad():
        model.train()(x)
    for hk in hooks:
        hk.remove()
    return model, seen


def k4_launch_split(args, tile_b: int) -> list:
    """[kernel, device ms] of each kernel one fused-bottleneck call runs,
    in launch order, from torch.profiler over that one call (after a
    warm-up call); the weight transposes of the bf16 route included."""
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    from tf_operator_tpu_torch.ops import fused_bottleneck as fb

    fb.fused_bottleneck(*args, tile_b=tile_b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fb.fused_bottleneck(*args, tile_b=tile_b)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    return [[re.sub(r"^void |\(anonymous namespace\)::", "", e.name).split("(")[0][:90],
             (e.time_range.end - e.time_range.start) / 1e3] for e in kernels]


def k4_products_ms(x, w1, w2, w3) -> float:
    """A yardstick the port never calls: the block's three products alone
    through cuBLAS and cuDNN on the same operands (channels-last conv2d for
    the 3x3, matmul for the 1x1s), n1 and n2 made beforehand from x's own
    reduce product (relu'd); CUDA-event time of the three together."""
    import torch
    import torch.nn.functional as F

    b, h, w, cw = x.shape
    cn = w1.shape[1]
    flat = x.reshape(-1, cw)
    n1 = (flat @ w1).relu().view(b, h, w, cn).permute(0, 3, 1, 2)  # channels-last
    w2c = w2.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    n2 = F.conv2d(n1, w2c, padding=1).relu().permute(0, 2, 3, 1).reshape(-1, cn).contiguous()

    def products():
        flat @ w1
        F.conv2d(n1, w2c, padding=1)
        n2 @ w3

    return time_ms(products)


def k4_check_phase(records: dict) -> None:
    """The fused bottleneck against its plain version on every K4_CASES
    case; on the stage-1 and ragged cases the check's rejection of broken
    outputs; at the ResNet-50 shapes the timings (kernel, plain, unfused
    block, products alone) and, at K4_SPLIT_CASES, each launch's device
    time. Fills records[K4[0]]."""
    import torch

    from tf_operator_tpu_torch.ops import fused_bottleneck as fb

    dev = torch.device("cuda")
    model, inputs = _resnet50_block_inputs([c[1] for c in K4_CASES if c[1] is not None])
    gen = torch.Generator(device=dev).manual_seed(1)
    rec = records.setdefault(K4[0], {})
    failures = []
    fb.reset_launches()
    for label, block_idx, dtype_name in K4_CASES:
        dtype = getattr(torch, dtype_name)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        if block_idx is None:
            b, h, w, cw, cn, tb = K4_RANDOM[label]
            x = rnd(b, h, w, cw)
            if label == "ragged":
                x = k4_tile_offset(x, tb)
            x = x.to(dtype)
            w1, w2, w3 = rnd(cw, cn) * 0.1, rnd(3, 3, cn, cn) * 0.1, rnd(cn, cw) * 0.1
        else:
            blk = model.blocks[block_idx]
            x = inputs.pop(block_idx)
            b, h, w, cw = x.shape
            # The block's OIHW weights in the JAX layout.
            w1 = blk.conv_0.weight[:, :, 0, 0].t()
            w2 = blk.conv_1.weight.permute(2, 3, 1, 0)
            w3 = blk.conv_2.weight[:, :, 0, 0].t()
            cn = w1.shape[1]
            tb = fb.default_tile(h, w, b)
        w1, w2, w3 = (t.detach().to(dtype).contiguous() for t in (w1, w2, w3))
        # BN scale and bias from the generator, never the model's init (its
        # last BN has scale 0, so y = relu(x) whatever the block computes).
        bn = (rnd(cn).abs() + 0.5, 0.1 * rnd(cn), rnd(cn).abs() + 0.5, 0.1 * rnd(cn),
              rnd(cw).abs() + 0.5, 0.1 * rnd(cw))
        args = (x, w1, w2, w3, *bn)
        y, st = fb.fused_bottleneck(*args, tile_b=tb)
        y_p, st_p = fb.fused_bottleneck_reference(*args, tile_b=tb)
        torch.cuda.synchronize()
        outs = {"y": y, "st1": st[0], "st2": st[1], "st3": st[2]}
        refs = {"y": y_p, "st1": st_p[0], "st2": st_p[1], "st3": st_p[2]}
        errs = {n: k4_excess(outs[n], refs[n], dtype_name, n) for n in outs}
        rel = {n: (outs[n].float() - refs[n].float()).abs().max().item()
               / max(refs[n].float().abs().max().item(), 1e-30) for n in outs}
        tag = f"check fused_bottleneck {label} {[b, h, w, cw]} Cn {cn} tile {tb} {dtype_name}"
        log(f"{tag}: max err / max|ref| " + ", ".join(f"{n}={e:.3g}" for n, e in rel.items()))
        log(f"{tag}: excess (<= 1 passes) " + ", ".join(f"{n}={e:.3g}" for n, e in errs.items()))
        failures += [f"{label} {n}: excess {e:.3g}" for n, e in errs.items() if not e <= 1.0]
        if dtype_name == "bfloat16":
            # How far f32 sums alone move y: kernel and plain version, each
            # against the function evaluated with float64 sums.
            y64 = fb.fused_bottleneck_reference(*args, tile_b=tb, acc_dtype=torch.float64)[0]
            log(f"{tag}: y against float64 sums, excess at the same limit: kernel "
                f"{k4_excess(y, y64, dtype_name, 'y'):.3g}, plain "
                f"{k4_excess(y_p, y64, dtype_name, 'y'):.3g}")
            del y64
        if label == "stage1":
            rec["max_abs_err"] = (y.float() - y_p.float()).abs().max().item()
        if any(m[3] == label for m in K4_MUTATIONS):
            verdicts = k4_checker_self_test(outs, refs, args, tb, dtype_name, label)
            log(f"{tag}: the check rejects broken outputs, excess "
                + ", ".join(f"{n}={e:.3g}" for n, e in verdicts.items()))
        if block_idx is not None:
            x_nchw = x.permute(0, 3, 1, 2)  # the block's own channels-last input

            def unfused():
                with torch.no_grad():
                    blk(x_nchw)

            ms = time_ms(lambda: fb.fused_bottleneck(*args, tile_b=tb))
            plain_ms = time_ms(lambda: fb.fused_bottleneck_reference(*args, tile_b=tb), reps=3)
            block_ms = time_ms(unfused)
            products_ms = k4_products_ms(x, w1, w2, w3)
            bound_ms, bound_by = k4_bound(b, h, w, cw, cn, tb, dtype_name)
            times = {"shape": [b, h, w, cw, cn], "tile_b": tb, "ms": ms, "plain_ms": plain_ms,
                     "unfused_block_ms": block_ms, "products_ms": products_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by}
            rec.setdefault("times", {})[label] = times
            if label == "stage1":
                rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=None)
            log(f"time fused_bottleneck {label} {[b, h, w, cw]} Cn {cn} tile {tb} "
                f"{dtype_name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}), the port's unfused BottleneckBlock "
                f"forward (train mode) {block_ms:.4f} ms, the three products alone "
                f"(cuBLAS/cuDNN) {products_ms:.4f} ms")
            if label in K4_SPLIT_CASES:
                split = k4_launch_split(args, tb)
                times["launch_split_ms"] = split
                log(f"time fused_bottleneck {label}: device ms by launch ("
                    f"{sum(t for _, t in split):.4f} in all) "
                    + "; ".join(f"{n} {t:.4f}" for n, t in split))
        del x, y, y_p, st, st_p, outs, refs, args
        torch.cuda.empty_cache()
    rec["launches"] = fb.LAUNCHES["fwd"]
    del model
    torch.cuda.empty_cache()
    if failures:
        raise SmokeFailure("fused bottleneck disagrees with its plain version: "
                           + "; ".join(failures))


def lm_argv(steps: int, layers: int = LAYERS, hidden: int = 768, heads: int = 6) -> list[str]:
    """The LM trainer's full-width configuration (or another width)."""
    return ["--model", "transformer-lm", "--steps", str(steps),
            "--batch", str(BATCH), "--seq", str(SEQ), "--layers", str(layers),
            "--hidden", str(hidden), "--heads", str(heads), "--moment-dtype", "bf16",
            "--master-weights", "--log-every", str(LOG_EVERY), "--device", "cuda"]


# The LM at head width 32 (bench.py's CPU LM widths at the trainer's seq):
# (layers, hidden, heads, steps).
NARROW_LM = (2, 128, 4, 2)
# The checkpoint phase's runs: A saves every CKPT_EVERY steps to CKPT_STEPS
# (async); B resumes it to the train phase's step count.
CKPT_STEPS, CKPT_EVERY = 4, 2
CKPT_DIR = OUT_DIR / "ckpt"


def resnet_argv(steps: int) -> list[str]:
    """The JAX bench's ResNet-50 configuration (bench.py's workload 2), with
    the trainer's default AdamW."""
    return ["--model", "resnet50", "--batch", str(RN_BATCH), "--image-size",
            str(RN_SIZE), "--steps", str(steps), "--log-every", str(LOG_EVERY),
            "--device", "cuda"]


def run_trainer(argv: list[str], state_out: dict | None = None, tag: str = "") -> dict:
    """python -m tf_operator_tpu_torch.models.train with `argv`, in this
    process; returns its events by name (the final TrainState goes to
    state_out["state"] when given). Fails unless it exits 0 with a finite
    final loss."""
    from tf_operator_tpu_torch.models import train

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    events_path = OUT_DIR / f"chip_smoke_events_{argv[1]}{tag}.jsonl"
    events_path.unlink(missing_ok=True)
    log("train: python -m tf_operator_tpu_torch.models.train " + " ".join(argv))
    os.environ["TPUJOB_METRICS_FILE"] = str(events_path)
    try:
        rc = train.main(argv, state_out)
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
    from tf_operator_tpu_torch.ops import fused_bottleneck as fb

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    fb.reset_launches()
    by = run_trainer(lm_argv(args.steps))
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
    return launches, done


def narrow_lm_phase(card: str) -> None:
    """The LM at head width 32 through the trainer (the kernels run it
    zero-padded to 64): a finite loss, and every flash kernel launched."""
    from tf_operator_tpu_torch.ops import flash_attention as fa

    layers, hidden, heads, steps = NARROW_LM
    fa.reset_launches()
    by = run_trainer(lm_argv(steps, layers, hidden, heads), tag="_narrow")
    launches = dict(fa.LAUNCHES)
    if not all(n > 0 for n in launches.values()):
        raise SmokeFailure(f"the head-width-{hidden // heads} LM left a flash kernel "
                           f"unlaunched: {launches}")
    done = by["done"]
    eps = done.get("examples_per_sec")
    log(f"train narrow LM (--layers {layers} --hidden {hidden} --heads {heads}, head "
        f"width {hidden // heads}, padded to {fa.kernel_head_dim(hidden // heads)}): "
        f"final_loss={done['final_loss']:.4f} tokens/s={eps * SEQ if eps else None} "
        f"launches={launches} [{card}]")


def snapshot_split(state) -> list[float]:
    """Seconds of three snapshot legs of `state` (the trainer's
    _snapshot_state on one pinned pool, as its saves take them): the
    first two fill a buffer set each for the first time (allocation and
    copy), the third reuses the first set (copy only)."""
    from tf_operator_tpu_torch.models import train

    pool, times = train._PinnedPool(), []
    for _ in range(3):
        t0 = time.monotonic()
        train._snapshot_state(str(CKPT_DIR), 0, state, False, 0, pool)
        times.append(time.monotonic() - t0)
    return times


def ckpt_phase(args, card: str, uninterrupted: dict | None) -> dict:
    """Run A saves the full-width LM every CKPT_EVERY steps to CKPT_STEPS
    (async); run B resumes it to args.steps. B must emit `resumed` from
    CKPT_STEPS with digests equal to the saved ones, and its final loss
    must equal the uninterrupted run's (the train phase's done event, else
    one run here) bit for bit, or else stay within the spread of two
    uninterrupted runs. Logs the checkpoint's bytes, the snapshot and write
    seconds per save, hidden_fraction, and tokens/s beside the
    uninterrupted run's, and the snapshot leg's split (snapshot_split)."""
    import shutil

    import torch

    from tf_operator_tpu_torch.models import checkpoint as ckpt
    from tf_operator_tpu_torch.parallel.train_step import state_tensors

    if args.steps <= CKPT_STEPS:
        raise SmokeFailure(f"the ckpt phase needs --steps > {CKPT_STEPS}")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    flags = ["--checkpoint-dir", str(CKPT_DIR), "--checkpoint-every", str(CKPT_EVERY),
             "--checkpoint-mode", "async"]
    torch.cuda.empty_cache()
    out: dict = {}
    run_a = run_trainer(lm_argv(CKPT_STEPS) + flags, out, tag="_ckpt_a")
    state = out.pop("state")
    nbytes = sum(t.numel() * t.element_size() for t in state_tensors(state).values()
                 if isinstance(t, torch.Tensor))
    split = snapshot_split(state)
    del state
    disk = sum(json.loads(Path(f"{CKPT_DIR}/{name}_{CKPT_STEPS}{ckpt.MANIFEST_SUFFIX}")
                          .read_text())["total_bytes"] for name in ("step", "trainstate"))
    torch.cuda.empty_cache()
    run_b = run_trainer(lm_argv(args.steps) + flags, tag="_ckpt_b")
    resumed = run_b.get("resumed")
    if (resumed is None or resumed["from_step"] != CKPT_STEPS or resumed["params_only"]
            or not resumed.get("digest") or resumed["digest"] != resumed.get("saved_digest")):
        raise SmokeFailure(f"run B did not resume from step {CKPT_STEPS} with matching "
                           f"digests: {resumed}")
    if uninterrupted is None:
        torch.cuda.empty_cache()
        uninterrupted = run_trainer(lm_argv(args.steps), tag="_ckpt_u")["done"]
    loss_b, loss_u = run_b["done"]["final_loss"], uninterrupted["final_loss"]
    log(f"ckpt: step-{args.steps} loss resumed {loss_b!r}, uninterrupted {loss_u!r}, "
        f"bit for bit: {loss_b == loss_u}")
    if loss_b != loss_u:
        torch.cuda.empty_cache()
        loss_u2 = run_trainer(lm_argv(args.steps), tag="_ckpt_u2")["done"]["final_loss"]
        spread = abs(loss_u2 - loss_u)
        log(f"ckpt: two uninterrupted runs give {loss_u!r} and {loss_u2!r} (spread "
            f"{spread!r}); resumed - uninterrupted = {loss_b - loss_u!r}")
        if not abs(loss_b - loss_u) <= spread:
            raise SmokeFailure(f"the resumed loss {loss_b!r} is off the uninterrupted "
                               f"{loss_u!r} by more than the runs' spread {spread!r}")
    block = run_a["done"]["checkpoint"]
    saves = block["saves"]
    eps_a, eps_u = run_a["done"].get("examples_per_sec"), uninterrupted.get("examples_per_sec")
    result = {
        "bytes": nbytes, "bytes_on_disk": disk, "saves": saves,
        "snapshot_s_per_save": block["snapshot_s"] / saves,
        "write_s_per_save": block["write_s"] / saves,
        "snapshot_s_first_use_of_buffers": split[:2], "snapshot_s_reused_buffers": split[2],
        "drains": block["drains"], "drain_wait_s": block["drain_wait_s"],
        "hidden_fraction": block["hidden_fraction"],
        "tokens_per_s_with_saves": eps_a * SEQ if eps_a else None,
        "tokens_per_s_without": eps_u * SEQ if eps_u else None,
        "resumed_loss": loss_b, "uninterrupted_loss": loss_u,
        "digest": resumed["digest"], "card": card}
    log("ckpt: " + json.dumps(result))
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return result


def model_flops_per_example(model_fn, example_shape) -> float:
    """Forward FLOPs of one example: 2 x the multiply-adds of every Conv and
    Dense module of model_fn(device="meta"), from the shapes that a forward
    of one example on the meta device gives them."""
    import math

    import torch

    from tf_operator_tpu_torch.models.mnist import Conv
    from tf_operator_tpu_torch.models.transformer import Dense

    model = model_fn(device="meta")
    total = 0

    def count(mod, _inputs, out):
        nonlocal total
        total += 2 * out.numel() * math.prod(mod.weight.shape[1:])

    for mod in model.modules():
        if isinstance(mod, (Conv, Dense)):
            mod.register_forward_hook(count)
    with torch.no_grad():
        model(torch.empty((1, *example_shape), device="meta"))
    return float(total)


def resnet_train_phase(args, card: str) -> dict:
    """ResNet-50 through the trainer's entry point at the JAX bench's
    configuration. Fails unless the loss is finite and every batch-norm
    running statistic is finite, f32, and moved from its init. No
    hand-written kernel is on this path: the launch counts, zeroed before
    and read after, are logged."""
    import torch

    from tf_operator_tpu_torch.models import resnet
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops import fused_bottleneck as fb

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    fb.reset_launches()
    out: dict = {}
    by = run_trainer(resnet_argv(args.steps), out)
    launches = {**fa.LAUNCHES, **{"fused_bottleneck_" + k: n for k, n in fb.LAUNCHES.items()}}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    bad, n_stats = [], 0
    for name, buf in out["state"].model.named_buffers():
        n_stats += 1
        init = 0.0 if name.endswith("mean") else 1.0
        if buf.dtype != torch.float32 or not bool(torch.isfinite(buf).all()) \
                or bool((buf == init).all()):
            bad.append(f"{name} {buf.dtype}")
    if bad or n_stats != 2 * 53:
        raise SmokeFailure(f"of {n_stats} batch-norm running statistics (106 expected), "
                           f"these are not finite f32 moved from init: {bad}")
    del out
    done = by["done"]
    ips = done.get("examples_per_sec")
    step_s = (done.get("step_time_s") or {}).get("mean")
    flops = 3 * model_flops_per_example(resnet.ResNet50, (RN_SIZE, RN_SIZE, 3))
    mfu = flops * ips / PEAK_FLOPS["bfloat16"] if ips else None
    log(f"train resnet50: final_loss={done['final_loss']:.4f} images/s={ips} "
        f"mfu={mfu} (training FLOPs/image {flops:.4e}) step_time_mean_s={step_s} "
        f"startup_s={by['first_step']['startup_s']} max_memory_allocated={peak_gb:.2f} GB "
        f"running statistics: {n_stats} finite f32, all moved from init; "
        f"launches={launches} batch={RN_BATCH} [{card}]")
    return launches


# Kernel groups of each profiled trainer: (group, substrings of the kernel's
# lower-cased name), first match wins; the rest is "other". cuBLAS names
# its Hopper GEMMs nvjet_*, older ones *gemm*/*xmma*; cuDNN's convolutions
# carry fprop/dgrad/wgrad or implicit-GEMM names.
LM_GROUPS = (("flash_fwd", ("fwd_kernel", "fwd_wgmma_kernel")),
             ("flash_bwd_dq", ("bwd_dq_kernel", "bwd_dq_wgmma_kernel")),
             ("flash_bwd_dkv", ("bwd_dkv_kernel", "bwd_dkv_wgmma_kernel")),
             ("flash_bwd_delta", ("bwd_delta_kernel",)),
             ("matmul", ("nvjet", "gemm", "xmma", "cutlass")))
RESNET_GROUPS = (("conv", ("fprop", "dgrad", "wgrad", "conv", "implicit", "winograd",
                           "xmma")),
                 ("matmul", ("nvjet", "gemm", "cutlass")),
                 ("reduce", ("reduce",)), ("elementwise", ("elementwise",)))
# The LM profile cuts its steps at the attention forward: a kernel whose
# lower-cased name holds both substrings (fwd_kernel in f32,
# fwd_wgmma_kernel in bf16; no other kernel of csrc/).
LM_STEP_MARKER = ("fwd_", "_kernel")


def kernel_group(name: str, groups) -> str:
    """The group of a profiled kernel's name: the first of `groups` with a
    substring in the lower-cased name, else "other"."""
    low = name.lower()
    return next((g for g, keys in groups if any(k in low for k in keys)), "other")


def _profile_trainer(argv, steps: int, marker: tuple, per_step: int, groups,
                     batch: int, card: str, trace: str) -> None:
    """One trainer run under torch.profiler: device time by kernel group
    over its steady steps, the steps after its first chunk. Each step is
    cut at its first kernel whose lower-cased name holds every substring of
    `marker` (the kernel stream's (per_step * i)-th such kernel), so the
    window holds whole steps of device work and the gaps between them."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_trainer(argv)
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in kernels
              if all(k in e.name.lower() for k in marker)]
    if len(starts) != per_step * steps:
        raise SmokeFailure(f"the profiler saw {len(starts)} '{marker}' kernels, "
                           f"not {per_step} x {steps} steps")
    t0, t1 = starts[per_step * LOG_EVERY], starts[per_step * (steps - 1)]
    by_group: dict[str, float] = {}
    by_name: dict[str, float] = {}
    n_kernels = 0
    for e in kernels:
        if not t0 <= e.time_range.start < t1:
            continue
        group = kernel_group(e.name, groups)
        ms = (min(e.time_range.end, t1) - e.time_range.start) / 1e3
        by_group[group] = by_group.get(group, 0.0) + ms
        by_name[e.name[:100]] = by_name.get(e.name[:100], 0.0) + ms
        n_kernels += 1
    window_ms = (t1 - t0) / 1e3
    busy = sum(by_group.values())
    summary = {"profile": {
        "model": argv[1], "steps": steps - 1 - LOG_EVERY, "batch": batch,
        "window_ms": window_ms, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / window_ms, "kernels": n_kernels,
        "device_ms_by_group": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8]),
        "card": card}}
    prof.export_chrome_trace(str(OUT_DIR / trace))
    log("profile: " + json.dumps(summary))


def profile_phase(args, card: str) -> None:
    """Both trainers' runs, as the train phase drives them, under
    torch.profiler. The LM's steps are cut at their first attention forward,
    ResNet-50's at their loss's log-softmax forward. The Chrome traces go to
    OUT_DIR."""
    if args.steps < LOG_EVERY + 2:
        raise SmokeFailure(f"the profile needs --steps >= {LOG_EVERY + 2}")
    _profile_trainer(lm_argv(args.steps), args.steps, LM_STEP_MARKER, LAYERS, LM_GROUPS,
                     BATCH, card, "train_profile.trace.json")
    _profile_trainer(resnet_argv(args.steps), args.steps, ("softmax", "forward"), 1,
                     RESNET_GROUPS, RN_BATCH, card, "resnet50_profile.trace.json")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,check,train,ckpt",
                    help="comma-separated subset of build,check,train,ckpt,profile; k4 "
                         "for the fused bottleneck's checks alone")
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
        elif "k4" in phases:
            k4_check_phase(records)
        uninterrupted = None
        if "train" in phases:
            launches, uninterrupted = train_phase(args, card)
            resnet_train_phase(args, card)
            narrow_lm_phase(card)
        if "ckpt" in phases:
            ckpt_phase(args, card, uninterrupted)
        if "profile" in phases:
            profile_phase(args, card)
    except Exception as e:  # every phase failure ends the run without a result
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1

    kernels = []
    for name, key, replaces in KERNELS:
        rec = records.get(name, {})
        entry = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces,
            "launches": launches[key] if launches is not None else None,
            "max_abs_err": rec.get("max_abs_err"), "ms": rec.get("ms"),
            "plain_ms": rec.get("plain_ms"), "bound_ms": rec.get("bound_ms"),
            "bound_by": rec.get("bound_by"), "library_ms": rec.get("library_ms"),
        }
        for extra in (f"at_batch_{BATCH}", "head_widths"):
            if extra in rec:
                entry[extra] = rec[extra]
        if name in KERNEL_NOTES:
            entry["note"] = KERNEL_NOTES[name]
        kernels.append(entry)
    rec = records.get(K4[0], {})
    kernels.append({
        "name": K4[0], "route": "cuda", "source": K4[1], "replaces": K4[2],
        "launches": rec.get("launches"), "max_abs_err": rec.get("max_abs_err"),
        "ms": rec.get("ms"), "plain_ms": rec.get("plain_ms"),
        "bound_ms": rec.get("bound_ms"), "bound_by": rec.get("bound_by"),
        "library_ms": None,
        "note": ("on no trainer path (as in the JAX package); launches counted in "
                 "the check phase; times at ResNet-50 stage 1, batch 256; every "
                 "stage under times"),
        "times": rec.get("times"),
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
