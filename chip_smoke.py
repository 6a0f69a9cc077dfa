#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one CUDA card, end to end.

    python3 chip_smoke.py                 # every phase, as a check of the port
    python3 chip_smoke.py --phases build,check   # kernels only
    python3 chip_smoke.py --phases build,k4      # the fused bottleneck only
    python3 chip_smoke.py --phases build,train,ckpt  # the trainers and checkpoints
    python3 chip_smoke.py --phases build,longctx      # the 64k and 128k LM alone
    python3 chip_smoke.py --phases build,bert,data    # BERT and the --data-dir path
    python3 chip_smoke.py --phases build,dist         # torch.distributed: NCCL, dp/tp/fsdp
    python3 chip_smoke.py --phases build,sp           # sequence parallelism: ring, Ulysses
    python3 chip_smoke.py --phases build,moe          # the MoE LM and K5, ep = 2
    python3 chip_smoke.py --phases build,k5           # K5's checks and times alone
    python3 chip_smoke.py --phases build,serve        # the inference server (A13)
    python3 chip_smoke.py --phases build,multislice,pipeline  # A12: slices, the GPipe schedule
    python3 chip_smoke.py --phases build,pod          # pods of several local ranks (A14)
    python3 chip_smoke.py --phases build,dist4        # four GPUs over NCCL (not default)
    python3 chip_smoke.py --phases build,moe4         # dist4's MoE runs alone (four GPUs)
    python3 chip_smoke.py --phases build,pod4         # pods over four GPUs (not default)

Phases, in order:
  1. identify the card (nvidia-smi name and power limit);
  2. build the CUDA kernels from tf_operator_tpu_torch/csrc with nvcc, one
     nvcc per source, all started together, and log each kernel's registers
     and spills (ptxas) and its count of wgmma (HGMMA) instructions in the
     built library's SASS: every *wgmma_kernel must have HGMMA ones, every
     other *mma_kernel (K5's mma.sync route) HMMA ones (sass_failures);
  3. hold each kernel against its plain PyTorch version on the card: the
     flash kernels (the forward with and without its lse) and the
     backward's delta pass at the LM trainer's attention shape and four
     small ones (f32 with a ragged tail, f32 causal, bf16 at head_dim 64
     with a ragged causal tail, bf16 full attention at head_dim 128 with a
     ragged tail, bf16 [2, 3, 2048, 256] causal and full: the wide K1-K3
     with several heads and whole tiles, every MUTATIONS entry rejected;
     K1 at D 256 and 192 at the wide forward's tile edges and tq != tk)
     and at the head widths the kernels reach zero-padded (32,
     96, 192, 256, 320 and 512, f32 and bf16, causal and full, T = 1000; each of
     MUTATIONS must be rejected there too, and each width is timed at
     [1, 768 // D, 8192, D] bf16 causal beside SDPA, with the kernel each
     pass ran there: bf16 K1-K3 at 192 and 256 on the wide route),
     timed at the
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
     end finite and launch every flash kernel; then the LM at head width
     256 (--hidden 768 --heads 3, batch 4, 4 steps) under torch.profiler
     (device activity only): its loss finite and falling, by the
     profiler's kernel names 12 launches a step of the wide K2 and K3, at
     least 12 of the wide K1, and none of the FMA K1-K3, tokens/s and the
     step beside the head-width-128 LM's; then the graph check
     (graph_check): the full-width LM's chunks replayed as CUDA graphs
     against the eager train_step loop on the same seed, in process, 6
     steps: every step's loss and gradient norm and the final parameters,
     mu, nu and master bit-equal, K1-K3 and the delta pass 12 launches a
     step in both, and two planted faults (GRAPH_FAULTS: a replay without
     the generator re-seed, bias corrections frozen at the capture) each
     rejected by name; and the card's f32 pow against the CPU's over the
     first 200000 Adam counts (the bias corrections' only op that may
     round differently);
  5. checkpoints (ckpt): the full-width LM saves every 2 steps to step 4
     (async), a second run resumes it to step 6, and its step-6 loss must
     equal the train phase's uninterrupted one (or, if not bit for bit,
     stay within the spread of two uninterrupted runs); the checkpoint's
     bytes, the snapshot and write seconds per save, hidden_fraction and
     tokens/s beside the train phase's are logged;
  6. the evaluator (eval): a subprocess `--eval` follows the ckpt phase's
     directory to FINAL on the graph route (one captured graph of the
     loss, eval_ready); its last eval_loss must equal the final
     parameters' loss on the same batches, computed here eagerly, and
     here the graphed round must equal the eager one bit for bit (seconds
     a checkpoint on both routes);
  7. the long-context LM (longctx): K1, the delta pass, K2 and K3 at
     [1, 6, 65536, 128] bf16 causal held on three 128-row tiles against
     their plain versions and timed; then bench.py's 64k point (12L x 768h,
     batch 1) with --remat --remat-save-flash, with --remat alone and
     without remat, and its 128k point with --remat
     --remat-save-flash-layers 9: tokens/s, MFU, peak memory and launches
     per step, which must be what each save policy gives; only the run
     without remat may run out of memory (recorded with fits: false);
  8. preemption (preempt): the full-width LM in a subprocess, async saves
     every 2 steps, SIGTERMed at step 4 by --chaos, must exit 143 with one
     `preempted` event and an emergency checkpoint; its restart must
     resume from step 4 and end on the train phase's step-6 loss; their
     --trace files must hold the checkpoint and step spans, the restart's
     --profile-dir a trace; a run without periodic saves times the
     synchronous emergency save;
  9. BERT (bert): K1 (with and without lse), the delta pass, K2 and K3 in
     bf16, full attention, at BERT-base's pretraining shapes [32, 12, 512,
     64] and [128, 12, 128, 64], held on the whole tensors against their
     plain versions (every MUTATIONS entry rejected at each) and timed
     beside their bound, plain version and SDPA; then BERT-base (12L x
     768h, 12 heads x 64, vocab 30522) through the trainer at seq 512 /
     batch 32 and seq 128 / batch 128, and bert-tiny at seq 512, each
     finite with every flash kernel launched once a layer a step and the
     MLM loss kernel (ops/mlm_xent.py; mlm_xent_check: against its plain
     version at XENT_SHAPES and timed beside its bound first) once a step:
     tokens/s, MFU (bert_flops_per_step), peak memory; then a BERT-base chief saving
     every 2 steps with an Evaluator subprocess following it, whose last
     eval_loss must equal the final parameters' loss computed here;
 10. the on-disk input path (data): a uint8 ImageNet-shaped shard set
     (2560 x 224 x 224 x 3, from the seed) and ResNet-50 at batch 256 for 8
     steps from it through the prefetch thread and the staging ring (uint8
     and f32 wires, zlib with --staging-tune, 1, 2 and 4 lanes), cuDNN held
     deterministic: the staged uint8 runs must give the prefetch run's
     losses bit for bit, the f32 wire within rtol 1e-3; images/s, transfer
     MB/s, overlap and consumer wait beside the synthetic-batch images/s;
 11. torch.distributed (dist): a one-rank NCCL world in a child process
     (initialize_from_env(force=True), an all_reduce and a broadcast of
     CUDA tensors, the backend reported), and in it the capture probe
     (nccl_graph_probe: the port's all_reduce, all_gather, reduce_scatter,
     all_to_all and rotate in one CUDA graph, 3 replays on fresh inputs
     each bit-equal to the eager calls; the world watch's empty all-reduce
     ordered after the stream's work with no device event of its own:
     NCCL_GRAPH_PROBE); then BERT-base at seq 512, global
     batch 32, 6 steps, cut to FAULT_LAYERS (4) blocks (12 until the
     default run passed its 950 s rule), as one process and at dp = 2,
     tp = 2 and fsdp = 2
     as two co-located trainer processes started through the operator's
     env (JAX_COORDINATOR_ADDRESS, JAX_PROCESS_ID, JAX_NUM_PROCESSES,
     TPUJOB_MESH). Two ranks on one GPU take gloo on CUDA tensors (NCCL
     refuses them) by the backend rule; the flash kernels are first held
     against their plain versions (and timed) at the runs' local shapes;
     every rank must launch K1, K2, K3 and the delta pass once a layer a
     step, and match the one-process run on every step's loss and global
     gradient norm and on its final parameters (DIST_RTOL,
     DIST_NORM_RTOL, DIST_PARAM_GAP), fsdp's ranks must hold half of each
     fsdp-sharded parameter's bytes between steps (zero-3), every rank
     must step eagerly (gloo: world_route), and a planted fault (dp = 2
     without the gradient reduction) must fail that comparison: global
     tokens/s, step time and each rank's peak memory beside the gaps;
 12. sequence parallelism (sp): K1 (with lse), the delta pass with a
     nonzero lse cotangent, K2 and K3 held against their plain versions
     (every MUTATIONS entry rejected) and timed at the ring's local blocks
     [1, 6, 8192, 128] bf16, causal and full, and at Ulysses' [1, 3,
     16384, 128] causal; then the LM at its full width and CUT_LAYERS (2)
     layers deep at seq 16384, batch 1, --remat --remat-save-flash, 6
     steps, as one process and at sp = 2 as two co-located trainer
     processes (gloo) through ring attention and through Ulysses
     (TPUJOB_SP_MODE), each held against one process as the dist runs
     are, with the flash kernels launched sp times a layer a forward pass
     for the ring and once for Ulysses; two planted faults (sp = 2 without
     the gradient sum over sp, a ring without the visibility mask), run at
     once (fault_controls; no fault run is timed), must each fail that
     comparison;
 13. the MoE LM (moe): K5, the grouped matmul of the dropless dispatch
     (gmm NN and NT, tgmm with an f32 and a bf16 output), held against its
     plain version at bench.py's MoE cell (12 x 768, 8 experts top-2, seq
     2048, batch 8: 32768 routed rows from a top-2 routing of random
     tokens, K x N = 768 x 3072, the wgmma route; every K5_MUTATIONS entry
     rejected) and at K5_SMALL's ragged cases in bf16 (both bf16 routes)
     and f32, each output handed to the kernel NaN-filled (an empty group,
     a one-row group, sizes off the tile, groups of 1-63 rows, all rows in
     one expert, two of four groups on each bf16 route, K and N off 8),
     timed at the cell beside its bound, its plain version and
     torch._grouped_mm (the k5 phase alone does this much); K1-K3 and
     delta at the cell's [8, 6, 2048, 128] bf16 causal; then the cell
     through the trainer with --moe-dispatch sparse (K1-K3 and delta 12 a
     step, each K5 kernel 12, all on the wgmma route: tokens/s, MFU by
     moe_flops_per_step, peak memory) and dense (no K5 launch); then ep = 2
     at 4 layers, both dispatches, as two co-located gloo ranks held
     against one process, and ep = 2 without the sum over ep rejected;
 14. serving (serve): the port trainer writes 2 steps of the full-width LM
     at seq 2048 (f32 parameters); `python -m
     tf_operator_tpu_torch.serve.server` runs on the card as a subprocess
     with the controller's env (window 2048, 8 KV slots, 128 new tokens at
     most, batch 8, TPUJOB_SERVE_NUM_HEADS=6) and must answer, all with
     200 and every token asked for, (a) one request of 8 rows of 17-1984
     prompt tokens, 64 new each, and (b) 24 concurrent single rows with
     8-128 new tokens, then drain to exit 0 on SIGTERM; in this process the
     same request a through the server's own code must give the server's
     tokens up to each row's first top-2 margin under SERVE_MARGIN, prefill's
     last logits must match the port's TransformerLM forward (K1) and each
     decode tick's logits a prefill of the same context (bf16, within
     SERVE_LIMITS, each of SERVE_FAULTS rejected), and f32 greedy chains
     must equal a naive f32 re-forward; on the card the server takes the
     graph route (serve/decode_graphs.py: its tick and every prefill grid
     point replay CUDA graphs captured at load), its tick under
     torch.profiler (beside the eager decode_step's) must show one
     cudaGraphLaunch a tick and no kernel launched outside the graph
     (tick_census), and the serve graph check holds the graphed tick
     (SERVE_GRAPH_TICKS at every slot, then 4 with one slot parked at 0)
     and the graphed prefill at SERVE_GRAPH_POINTS bit-equal to the eager
     functions from the same cache state, before and after a swap to
     perturbed weights, with each of SERVE_GRAPH_FAULTS failing by its
     name; time to ready, prefill and decode tokens/s, tick ms against its
     bound (graphed and eager), request latencies, the cache's bytes, the
     peak memory and a swap's copy time are logged; then the classifier
     check (classifier_check): mnist-conv trained 2 steps by the port
     trainer, served on the graph route (a graph a row bucket, 1-64), its
     predictions and logits at every bucket bit-equal to the eager forward
     before and after a swap (a swap not copied into the captured
     parameters rejected), one cudaGraphLaunch a request batch
     (tick_census), and each bucket's request batch timed on both routes;
 15. multi-slice (multislice): the LM (train phase's argv at
     MS_REWIND_LAYERS = 4 layers, every step logged) as 2 slices, one
     process a slice on the card, each a one-rank world with
     TPUJOB_NUM_SLICES=2, its TPUJOB_SLICE_ID and one TPUJOB_DCN_DIR (on
     /dev/shm when it has MS_SHM_BYTES free), 2 microbatches a step, held
     against one process at the same argv on dist_gaps' limits with K1-K3
     and delta launched once a layer a microbatch a step in each slice;
     against the same one-process run each slice applying its own mean
     (no-dcn-sum; its slices run while the rewind does) must fail those
     limits, and slice 1 killed
     (SIGKILL, --chaos) at step 5, two after worker 0's step-3 save, then
     relaunched, must resume from step 3 while slice 0, never restarted,
     emits dcn_rewind and ends on the uninterrupted run's losses: global
     tokens/s, step time, the dcn block and each slice's peak. Each slice
     replays graphs of the step's halves; in this process the halves
     graphed against eager (ms_graph_check: both slices' blocks a step, a
     rewind, bit-equal; one cudaGraphLaunch for the batch, one a block's
     backward, one for the apply a step, K1-K3 under them, no other kernel
     but the batch graph's generator fills); with multislice_eager in
     --phases, the sound run again with every slice eager (tokens/s beside
     the graphed run's, both held against one process);
 16. the pipeline (pipeline): make_pipelined_lm at the LM's widths (12
     layers, 6 a stage at pp = 2, batch 4 in 4 microbatches) as two gloo
     ranks on the card, the logits (rel_err) and one step's gradients
     (norm_err) within PP_LIMIT of the unpipelined LM with the same
     weights, a zero hop over it, each flash kernel launched 24 times a
     rank a step; the step (and its backward / reduction split) beside one
     process's, the bubble;
 17. pods of several GPUs (pod): the LM at full width and CUT_LAYERS (2)
     layers deep (train phase's argv, every step logged) as 2 pods x 2
     local ranks at {"dp": 2, "tp": 2},
     each pod started as the operator starts one (JAX_COORDINATOR_ADDRESS,
     JAX_PROCESS_ID, JAX_NUM_PROCESSES=2, TPUJOB_MESH, its own metrics and
     heartbeat files) and its supervisor given 2 ranks through the explicit
     count (the card is one: the four ranks share it over gloo); K1-K3 and
     delta first held against their plain versions at the ranks' [2, 3,
     8192, 128] causal; every pod must exit 0 with one jax_ready,
     first_step (n_devices 4) and done in its metrics file, every rank
     launch K1-K3 and delta once a layer a step at 3 local heads, and the
     run hold against one process at the same argv on dist_gaps' limits,
     while dp without the gradient reduction across the pods must fail
     them against the same process: global tokens/s, step time, each
     rank's peak;
 18. (only with --phases ...,graph4, on four GPUs) the world graph check:
     the LM cell at dp x tp = 2 x 2 and BERT-base at fsdp = 4, four ranks
     with a GPU each over NCCL, each rank running GRAPH_STEPS steps eagerly
     and graphed from the same initial state on the same communicators,
     every step's loss and gradient norm and every rank's final params,
     mu, nu and master bit-equal, K1-K3 and delta 12 a step on both routes,
     WORLD_GRAPH_FAULTS each rejected by name, and a profiled graphed run
     whose census shows one cudaGraphLaunch a step a rank with every NCCL
     kernel under it; then the kill check (BERT at dp = 4, the last rank
     SIGKILLed inside a step, a 60 s collective timeout) on the graph route
     and on the eager one: every survivor must exit 138 with a peer_lost
     event within KILL_LIMIT_S (90 s) of the kill; --parent's eager world
     runs beside them, recorded (a survivor still running at the limit has
     its Python stacks dumped), not held;
 19. (only with --phases ...,dist4, on four GPUs) the dist runs and dp = 4,
     dp x tp = 2 x 2 and fsdp = 4 (saving every 2 steps) with one GPU a rank
     (CUDA_VISIBLE_DEVICES), where the backend rule picks NCCL and every
     rank replays a CUDA graph of its step, and the dist fault at dp = 2;
     then the 64k LM at sp = 4 (ring) and sp x tp = 2 x 2 (ring, 3 local
     heads) at batch 1 and dp x sp = 2 x 2 (Ulysses) at batch 2, each held
     against one process at its global batch, with sp = 4 without the
     gradient sum over sp rejected; the kernels at those runs' local shapes
     first (on three tiles where the whole tensors are too large);
 20. (only with --phases ...,pod4, on four GPUs) one pod seeing GPUs 0-3,
     its local rank count taken from them, at dp = 4 and dp x tp = 2 x 2,
     then 2 pods seeing 0,1 and 2,3 at dp x tp = 2 x 2, one GPU a rank
     (NCCL, graphed), each held against one process at its global batch;
     (with ...,moe4) the MoE cell (sparse) at ep = 4 and dp x ep = 2 x 2,
     each held against one process;
 21. (only with --phases ...,profile) both trainers' runs, the 64k LM,
     BERT-base at seq 512 and the MoE cell (sparse) under torch.profiler:
     device time by kernel group over their steady steps, and the host API
     that launched each kernel there (launch_census): on the graphed step
     one cudaGraphLaunch a step and no K1-K3 or NCCL kernel launched one by
     one.
Every trainer subprocess that is not given GPUs of its own sees this
process's first GPU alone (CUDA_VISIBLE_DEVICES), a pod given one card.
The last lines are the wide_lm, graph, eval, longctx, preempt, bert, data,
dist, sp, moe, serve, multislice, pipeline and pod phases' records as one
JSON object ({"phases": ...}), the kernels' JSON record, the card, and
{"ok": true, "device": {...}}. Any failed phase exits nonzero with no
result line. Needs a CUDA device: it never runs on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import signal
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
    # bf16 at D = 256 (the wide K2/K3) with several heads and whole tiles
    ((2, 3, 2048, 256), "bfloat16", True),
    ((2, 3, 2048, 256), "bfloat16", False),
)
# Head widths that run zero-padded (to 64, 128, 256, 256, 384, 512): each
# checked in f32 and bf16, causal and full, at a T that is no multiple of
# any tile, every MUTATIONS entry rejected; each timed once in bf16 causal
# at [1, HEAD_WIDTH_HIDDEN // D, SEQ, D] beside SDPA.
HEAD_WIDTHS = (32, 96, 192, 256, 320, 512)
HEAD_WIDTH_HIDDEN = 768
WIDTH_CASES = tuple(((1, 2, 1000, d), dt, causal) for d in HEAD_WIDTHS
                    for dt in ("float32", "bfloat16") for causal in (True, False))
# K1 in bf16 at the widths of its wide route (256, and 192 padded to it),
# at (tq, tk) on either side of the wide forward's 128-row q blocks and
# 64-row k tiles, and with tq != tk (causal keys aligned to the start): o
# and lse against the plain version, each rerun bit for bit. Too short for
# MUTATIONS (a causal row with one visible key has dq = 0).
K1_EDGE_WIDTHS = (256, 192)
K1_EDGE_LENGTHS = ((1, 1), (63, 63), (64, 64), (65, 65), (127, 127), (128, 128),
                   (129, 129), (200, 200), (1000, 700), (700, 1000), (64, 300), (300, 64))
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
SOURCES = ("flash_attention", "fused_bottleneck", "grouped_matmul", "mlm_xent")

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


_T0 = time.monotonic()


def log(msg: str) -> None:
    """A progress line with the seconds since the script started."""
    print(f"[chip_smoke {time.monotonic() - _T0:.1f}s] {msg}", flush=True)


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
    from tf_operator_tpu_torch.ops import grouped_matmul as gm
    from tf_operator_tpu_torch.ops import mlm_xent as mx

    t0 = time.time()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(_build.build, SOURCES))
    fa._lib()
    fb._lib()
    gm._lib()
    mx._lib()
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
        for opcode in ("HGMMA", "HMMA"):
            counts = sass_counts(sass, opcode)
            if opcode == "HGMMA" or name == "grouped_matmul":
                log(f"  sass {name}: {opcode} instructions per kernel: "
                    + ", ".join(f"{k} {n}" for k, n in sorted(counts.items())))
        failures = sass_failures(sass)
        if failures:
            raise SmokeFailure(f"{name}: " + "; ".join(failures))
    return secs


def sass_failures(sass: str) -> list[str]:
    """The kernels of a cuobjdump --dump-sass listing that miss their
    tensor-core instructions: a *wgmma_kernel without HGMMA (wgmma), and
    any other *mma_kernel (K5's mma.sync route) without HMMA (mma.sync;
    "HGMMA" does not hold "HMMA" as a word)."""
    hgmma, hmma = sass_counts(sass, "HGMMA"), sass_counts(sass, "HMMA")
    out = [f"{k} without HGMMA instructions" for k, n in hgmma.items()
           if "wgmma_kernel" in k and n == 0]
    out += [f"{k} without HMMA instructions" for k, n in hmma.items()
            if "mma_kernel" in k and "wgmma" not in k and n == 0]
    return out


def kernel_label(mangled: str) -> str:
    """A readable label for a mangled kernel name of this repo's sources,
    e.g. bwd_dq_wgmma_kernel<128> or fwd_kernel<float, 64>: the
    length-prefixed identifier that ends in "_kernel", and the dtype and
    integers (and bools) of its template arguments."""
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
        dims = [("true" if v == "1" else "false") if kind == "b" else v
                for kind, v in re.findall(r"L([ib])(\d+)", targs)]
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


def check_case(shape, dtype_name: str, causal: bool, gen, self_test: bool):
    """Each flash kernel against its plain version on one case: K1 with and
    without lse, the delta pass and K2/K3 (with and without an lse
    cotangent), and the autograd bindings; with self_test, the check's
    rejection of every MUTATIONS entry there. Returns ({output: (max err /
    max |ref|, excess)}, {kernel key: max abs err}, (q, k, v, o, lse, do))."""
    import torch

    from tf_operator_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    dtype = getattr(torch, dtype_name)
    b, h, t, d = shape

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
        errs["o(no lse) equals o"] = (float("inf"), float("inf"))
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
            if self_test:
                verdicts = checker_self_test(
                    {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv},
                    {"o": o_p, "lse": lse_p, "dq": dq_p, "dk": dk_p, "dv": dv_p},
                    dtype_name)
                log(f"check {list(shape)} {dtype_name} causal={causal}: the check "
                    "rejects broken "
                    "outputs, excess " + ", ".join(f"{n}={e:.3g}" for n, e in verdicts.items()))
        del dq, dq_p, dk, dv, dk_p, dv_p, delta

    # The autograd bindings over [B, H, T, D], against the plain forward
    # and backward.
    q4, k4, v4 = (x.view(b, h, t, d).clone().requires_grad_() for x in (q, k, v))
    do4 = do.view(b, h, t, d)
    grads = torch.autograd.grad(fa.FlashAttention.apply(q4, k4, v4, causal),
                                (q4, k4, v4), do4)
    ref = fa.flash_bwd_plain(q, k, v, o_p, lse_p, do, causal)
    for name, got, r in zip(("dq", "dk", "dv"), grads, ref):
        hold("FlashAttention." + name, got, r)
    o4, lse4 = fa.FlashAttentionWithLse.apply(q4, k4, v4, causal)
    grads = torch.autograd.grad((o4, lse4), (q4, k4, v4), (do4, g_lse.view(b, h, t)))
    ref = fa.flash_bwd_plain(q, k, v, o_p, lse_p, do, causal, g_lse)
    for name, got, r in zip(("dq", "dk", "dv"), grads, ref):
        hold("FlashAttentionWithLse." + name, got, r)
    torch.cuda.synchronize()
    del grads, ref, o4, lse4, o_p, lse_p, g_lse

    log(f"check {list(shape)} {dtype_name} causal={causal}: max err / max|ref| "
        + ", ".join(f"{n}={e[0]:.3g}" for n, e in errs.items()))
    log(f"check {list(shape)} {dtype_name} causal={causal}: excess (<= 1 passes) "
        + ", ".join(f"{n}={e[1]:.3g}" for n, e in errs.items()))
    return errs, abs_errs, (q, k, v, o, lse, do)


def check_phase(records: dict) -> None:
    """Each kernel against its plain version, on the same inputs, for every
    case; the autograd bindings against the plain backward; at the trainer's
    shape, the check's rejection of broken outputs and the timings. Fills
    `records[name]` with max_abs_err and the times."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    failures = []

    for shape, dtype_name, causal in CHECK_CASES + WIDTH_CASES:
        main = shape == CHECK_CASES[0][0]
        errs, abs_errs, tensors = check_case(shape, dtype_name, causal, gen,
                                             self_test=main or shape[-1] in HEAD_WIDTHS)
        failures += [f"{list(shape)} {dtype_name} {n}: excess {e[1]:.3g}"
                     for n, e in errs.items() if not e[1] <= 1.0]
        if main:
            for name, key, _ in KERNELS:
                records[name] = {"max_abs_err": abs_errs[key]}
            _time_main_shape(records, *tensors, causal, shape, dtype_name)
        del tensors
        torch.cuda.empty_cache()

    failures += k1_edge_failures(gen)
    if failures:
        raise SmokeFailure("kernel disagrees with its plain version: " + "; ".join(failures))
    _time_head_widths(records)
    k4_check_phase(records)


def k1_edge_failures(gen) -> list[str]:
    """K1 at K1_EDGE_WIDTHS x K1_EDGE_LENGTHS, causal and full, 6 heads of
    bf16: the cases whose o or lse is off the plain version, or whose rerun
    differs."""
    import torch

    from tf_operator_tpu_torch.ops import flash_attention as fa

    failures, worst = [], 0.0
    for d in K1_EDGE_WIDTHS:
        for tq, tk in K1_EDGE_LENGTHS:
            for causal in (True, False):
                q, k, v = (torch.randn(6, t, d, generator=gen, device="cuda").to(torch.bfloat16)
                           for t in (tq, tk, tk))
                o, lse = fa.flash_fwd(q, k, v, causal)
                o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal)
                e = max(excess(o, o_p, "bfloat16", "o"), excess(lse, lse_p, "bfloat16", "lse"))
                worst = max(worst, e)
                if not e <= 1.0 or not torch.equal(fa.flash_fwd(q, k, v, causal)[0], o):
                    failures.append(f"K1 D {d} tq {tq} tk {tk} causal={causal}: excess {e:.3g}")
    log(f"check K1 at its tile edges (D {K1_EDGE_WIDTHS}, (tq, tk) {K1_EDGE_LENGTHS}, bf16, "
        f"causal and full): worst excess {worst:.3g}, reruns bit for bit")
    return failures


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
        width = fa.kernel_head_dim(d)
        for name, key, _ in KERNELS:
            records.setdefault(name, {}).setdefault("head_widths", {})[str(d)] = {
                "shape": list(shape), "padded_to": width,
                "kernel": kernel_function(key, torch.bfloat16, width),
                **{field: recs[name][field]
                   for field in ("ms", "bound_ms", "bound_by", "library_ms")}}
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()


def kernel_function(key: str, dtype, d: int) -> str:
    """The __global__ kernel that a CUDA call of KERNELS' `key` runs at
    the built width d: the wrapper's route (ops/flash_attention.py::route);
    the delta pass has one kernel."""
    from tf_operator_tpu_torch.ops import flash_attention as fa

    return "bwd_delta_kernel" if key == "bwd_delta" else fa.kernel_name(key, dtype, d)


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
# The LM at head width 256 (Gemma-2B's, at the LM's hidden width), where K2
# and K3 take the wide route: (layers, hidden, heads, steps).
WIDE_LM = (LAYERS, 768, 3, 4)
# Its attention shapes [B, H, T, D]: the head widths' timed one and the
# trained one.
WIDE_LM_SHAPES = [(1, 3, SEQ, 256), (BATCH, 3, SEQ, 256)]
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


def run_trainer(argv: list[str], state_out: dict | None = None, tag: str = "",
                all_events: bool = False):
    """python -m tf_operator_tpu_torch.models.train with `argv`, in this
    process; returns its events by name, or all of them in order with
    all_events (the final TrainState goes to state_out["state"] when
    given). Fails unless it exits 0 with a finite final loss."""
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
    events = [json.loads(x) for x in events_path.read_text().splitlines()]
    by = {e["event"]: e for e in events}
    done = by.get("done")
    if done is None or not isinstance(done.get("final_loss"), float) \
            or not done["final_loss"] == done["final_loss"] \
            or abs(done["final_loss"]) == float("inf"):
        raise SmokeFailure(f"no done event with a finite final_loss: {done}")
    if not isinstance(by.get("first_step", {}).get("startup_s"), float):
        raise SmokeFailure("first_step event lacks a float startup_s")
    return events if all_events else by


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


def profiled_kernel_count(names, kernel: str) -> int:
    """How many of the profiled kernel names (`names`, as the profiler
    demangles them) are launches of the __global__ kernel `kernel`."""
    return sum(bool(re.search(rf"\b{kernel}\b", n)) for n in names)


def wide_lm_phase(records: dict, card: str, base: dict | None, steps: int) -> dict:
    """The LM at head width 256 (WIDE_LM) through the trainer. First K1-K3
    and the delta pass at WIDE_LM_SHAPES (the timed and the trained
    attention shape), held against their plain versions (shape_kernel_check,
    records[kernel]["wide_lm"]). Then `steps` steps as the D 128 LM ran
    (`base`, the train phase's done event), unprofiled: tokens/s and the
    step beside the D 128 LM's, K2 and K3 counted once a layer a step. Then
    WIDE_LM's steps under torch.profiler, device activity only, held by
    wide_lm_verdict."""
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    from tf_operator_tpu_torch.ops import flash_attention as fa

    shape_kernel_check(records, WIDE_LM_SHAPES, "wide_lm", 256, causal=True)
    layers, hidden, heads, prof_steps = WIDE_LM
    width = fa.kernel_head_dim(hidden // heads)
    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    timed = run_trainer(lm_argv(steps, layers, hidden, heads), tag="_wide_timed")
    counted = dict(fa.LAUNCHES)
    argv = lm_argv(prof_steps, layers, hidden, heads)
    argv[argv.index("--log-every") + 1] = "1"
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        events = run_trainer(argv, tag="_wide", all_events=True)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    losses = _step_losses(events)
    verdict = wide_lm_verdict(names, counted, losses, layers, prof_steps, steps, width)
    if verdict["failures"]:
        raise SmokeFailure(f"the head-width-{hidden // heads} LM: "
                           + "; ".join(verdict["failures"]))
    seen, fma = verdict["kernel_launches"], verdict["fma_launches"]
    done = timed["done"]
    tps = done["examples_per_sec"] * SEQ
    base_eps = (base or {}).get("examples_per_sec")
    base_step = ((base or {}).get("step_time_s") or {}).get("mean")
    k1 = kernel_function("fwd", torch.bfloat16, width)
    rec = {"argv": argv, "timed_steps": steps, "head_width": hidden // heads,
           "kernel_launches": seen, "fma_launches": fma,
           "k1_kernel": k1, "k1_launches": seen[k1],
           "launches_per_step": {k: n // prof_steps for k, n in seen.items()},
           "counted_launches": counted, "losses": losses, "tokens_per_s": tps,
           "d128_tokens_per_s": base_eps * SEQ if base_eps else None,
           "step_time_mean_s": (done.get("step_time_s") or {}).get("mean"),
           "d128_step_time_mean_s": base_step,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card}
    log(f"train wide LM (--layers {layers} --hidden {hidden} --heads {heads}, head width "
        f"{hidden // heads}): tokens/s={tps}, step {rec['step_time_mean_s']} s over {steps} "
        f"steps unprofiled, beside the D 128 LM's {rec['d128_tokens_per_s']}, "
        f"{base_step} s; under the profiler losses={losses}, launches {seen}, FMA {fma} "
        f"[{card}]")
    return rec


def wide_lm_verdict(names, counted: dict, losses: dict, layers: int, prof_steps: int,
                    steps: int, width: int = 256) -> dict:
    """The wide LM phase's rule on one run: `names`, the profiled kernel
    names of prof_steps steps; `counted`, the wrappers' counts (LAUNCHES)
    over `steps` unprofiled steps; `losses`, the profiled run's by step.
    K2 and K3 on their bf16 route at `width` exactly once a layer a step,
    K1 and the delta pass at least that (in both runs); no launch of an
    FMA K1-K3 kernel; the loss falling. Returns {"kernel_launches": {route
    kernel: profiled count}, "fma_launches": {FMA kernel: count},
    "failures": [...]}."""
    import torch

    from tf_operator_tpu_torch.ops import flash_attention as fa

    need = layers * prof_steps
    kernels = {key: kernel_function(key, torch.bfloat16, width) for key in FLASH_LAUNCH_KEYS}
    seen = {kernels[key]: profiled_kernel_count(names, kernels[key]) for key in kernels}
    fma = {n: profiled_kernel_count(names, n)
           for n in (fa.ROUTE_KERNELS["fma"][key] for key in ("fwd", "bwd_dq", "bwd_dkv"))}
    # K2 and K3 once a layer a step, exactly; K1 and delta at least that.
    exact = (kernels["bwd_dq"], kernels["bwd_dkv"])
    failures = [f"{k}: {n} launches, not {need}" for k, n in seen.items()
                if n != need and (k in exact or n < need)]
    failures += [f"{k} launched {n} times" for k, n in fma.items() if n]
    failures += [f"{k} counted {n} in {steps} steps, not {layers * steps}"
                 for k, n in counted.items()
                 if n != layers * steps and (k in ("bwd_dq", "bwd_dkv") or n < layers * steps)]
    if sorted(losses) != list(range(1, prof_steps + 1)) \
            or not losses[prof_steps] < losses[1]:
        failures.append(f"the loss does not fall: {losses}")
    return {"kernel_launches": seen, "fma_launches": fma, "failures": failures}


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


def ckpt_phase(args, card: str, uninterrupted: dict | None) -> tuple:
    """Run A saves the full-width LM every CKPT_EVERY steps to CKPT_STEPS
    (async); run B resumes it to args.steps. B must emit `resumed` from
    CKPT_STEPS with digests equal to the saved ones, and its final loss
    must equal the uninterrupted run's (the train phase's done event, else
    one run here) bit for bit, or else stay within the spread of two
    uninterrupted runs. Logs the checkpoint's bytes, the snapshot and write
    seconds per save, hidden_fraction, and tokens/s beside the
    uninterrupted run's, and the snapshot leg's split (snapshot_split).
    Returns (the logged record, run B's final TrainState)."""
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
    out_b: dict = {}
    run_b = run_trainer(lm_argv(args.steps) + flags, out_b, tag="_ckpt_b")
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
    # The directory stays for the eval phase, which follows it; main
    # removes it.
    return result, out_b["state"]


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


def resnet_train_phase(args, card: str) -> float | None:
    """ResNet-50 through the trainer's entry point at the JAX bench's
    configuration. Fails unless the loss is finite and every batch-norm
    running statistic is finite, f32, and moved from its init. No
    hand-written kernel is on this path: the launch counts, zeroed before
    and read after, are logged. Returns images/s."""
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
    return ips


# Kernel groups of each profiled trainer: (group, substrings of the kernel's
# lower-cased name), first match wins; the rest is "other". cuBLAS names
# its Hopper GEMMs nvjet_*, older ones *gemm*/*xmma*; cuDNN's convolutions
# carry fprop/dgrad/wgrad or implicit-GEMM names.
LM_GROUPS = (("flash_fwd", ("fwd_kernel", "fwd_wgmma_kernel", "fwd_wide_wgmma_kernel")),
             ("flash_bwd_dq", ("bwd_dq_kernel", "bwd_dq_wgmma_kernel",
                               "bwd_dq_wide_wgmma_kernel")),
             ("flash_bwd_dkv", ("bwd_dkv_kernel", "bwd_dkv_wgmma_kernel",
                                "bwd_dkv_wide_wgmma_kernel")),
             ("flash_bwd_delta", ("bwd_delta_kernel",)),
             ("matmul", ("nvjet", "gemm", "xmma", "cutlass")))
# The MoE LM's: K5's kernels on each route (tgmm first: "gmm_wgmma",
# "gmm_mma" and "gmm_fma" are in its names) and
# the LM's groups.
MOE_GROUPS = (("grouped_matmul_tgmm", ("tgmm_wgmma_kernel", "tgmm_mma_kernel",
                                        "tgmm_fma_kernel")),
              ("grouped_matmul_gmm", ("gmm_wgmma_kernel", "gmm_mma_kernel", "gmm_fma_kernel")),
              *LM_GROUPS)
RESNET_GROUPS = (("conv", ("fprop", "dgrad", "wgrad", "conv", "implicit", "winograd",
                           "xmma")),
                 ("matmul", ("nvjet", "gemm", "cutlass")),
                 ("reduce", ("reduce",)), ("elementwise", ("elementwise",)))
# The long-context LM (bench.py's 64k and 128k points): full width, batch 1.
# Each run: (label, seq, steps, extra flags, K1 launches per step with 12
# layers, whether it may not fit in memory). --remat also rematerialises
# the loss, whose replay runs every block's forward (and K1) once more in
# the backward; a block without the save policy then replays K1 once more
# for its own backward. So K1 runs 12 (forward) + 12 (the loss replay) +
# the blocks without save-flash. Only the run without remat is a question
# of fit; the bench's two points and remat alone must fit.
LONG_SEQ, LONGER_SEQ = 65536, 131072
LONGCTX_RUNS = (
    ("64k remat save-flash", LONG_SEQ, 4, ["--remat", "--remat-save-flash"], 24, False),
    ("64k remat", LONG_SEQ, 4, ["--remat"], 36, False),
    ("64k no remat", LONG_SEQ, 4, [], 12, True),
    ("128k remat save-flash-layers 9", LONGER_SEQ, 3,
     ["--remat", "--remat-save-flash-layers", "9"], 27, False),
)
# Rows (and key columns) of one head held against the plain versions at
# T = LONG_SEQ: the first, a middle and the last 128-row tile.
LONG_TILE = 128
LONG_HEADS = 6


def longctx_argv(seq: int, steps: int, extra: list[str]) -> list[str]:
    return ["--model", "transformer-lm", "--steps", str(steps), "--batch", "1",
            "--seq", str(seq), "--layers", str(LAYERS), "--hidden", "768", "--heads",
            str(LONG_HEADS), "--moment-dtype", "bf16", "--master-weights",
            "--log-every", "1", "--device", "cuda", *extra]


def tile_kernel_check(records: dict, shape, causal: bool, group: str, seed: int,
                      with_g_lse: bool = False) -> None:
    """K1 (o, lse), the delta pass, K2 and K3 at `shape` [1, H, T, D] bf16,
    each held on LONG_TILE-row tiles (first, middle, last) of head 0
    against its plain version computed for just those rows (K1, K2: the
    rows against every key they see) or key columns (K3: the keys against
    every row that sees them), for tensors too large to hold whole, every
    MUTATIONS entry rejected on the last tile; with with_g_lse, delta (and
    so K2 and K3) takes a nonzero lse cotangent.
    Then timed beside their bound and SDPA. Fills records[name][group]
    (a dict of the shape's record, or, for group "at_T_65536", the record
    itself)."""
    import torch

    from tf_operator_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    _, h, t, d = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn((h, t, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    g_lse = torch.randn((h, t), generator=gen, device=dev) if with_g_lse else None
    o, lse = fa.flash_fwd(q, k, v, causal)
    delta = fa.bwd_delta(o, do, g_lse)
    dq = fa.flash_bwd_dq(q, k, v, o, lse, do, causal, delta=delta)
    dk, dv = fa.flash_bwd_dkv(q, k, v, o, lse, do, causal, delta=delta)
    torch.cuda.synchronize()
    failures, rec = [], {"shape": list(shape), "causal": causal, "g_lse": with_g_lse}
    recs = {name: dict(rec, max_abs_err=0.0) for name in _LONG_KERNEL.values()}
    for r0 in (0, t // 2, t - LONG_TILE):
        rows = slice(r0, r0 + LONG_TILE)
        keys = slice(0, r0 + LONG_TILE if causal else t)
        o_p, lse_p = fa.flash_fwd_plain(q[:1, rows], k[:1, keys], v[:1, keys], causal,
                                        q_offset=r0)
        dq_p = fa._bwd_dq_plain(q[:1, rows], k[:1, keys], v[:1, keys], o[:1, rows],
                                lse[:1, rows], do[:1, rows], causal, delta=delta[:1, rows],
                                q_offset=r0)
        delta_p = fa._bwd_delta_plain(o[:1, rows], do[:1, rows],
                                      None if g_lse is None else g_lse[:1, rows])
        # Key columns [r0, r0 + tile) against the rows that see them (from
        # r0 on under the causal rule: both start at r0, so it needs no
        # offset).
        after = slice(r0 if causal else 0, t)
        dk_p, dv_p = fa._bwd_dkv_plain(q[:1, after], k[:1, rows], v[:1, rows], o[:1, after],
                                       lse[:1, after], do[:1, after], causal,
                                       delta=delta[:1, after])
        pairs = (("o", o[:1, rows], o_p), ("lse", lse[:1, rows], lse_p),
                 ("delta", delta[:1, rows], delta_p),
                 ("dq", dq[:1, rows], dq_p), ("dk", dk[:1, rows], dk_p),
                 ("dv", dv[:1, rows], dv_p))
        if r0 == t - LONG_TILE:
            verdicts = checker_self_test({n: g for n, g, _ in pairs},
                                         {n: r for n, _, r in pairs}, "bfloat16")
            log(f"{group} check {list(shape)} causal={causal}: the check rejects broken "
                "outputs, excess " + ", ".join(f"{n}={e:.3g}" for n, e in verdicts.items()))
        for name, got, ref in pairs:
            e = excess(got, ref, "bfloat16", _kind(name))
            diff = (got.float() - ref.float()).abs().max().item()
            log(f"{group} check {list(shape)} causal={causal} {name} rows {r0}.."
                f"{r0 + LONG_TILE - 1}: max abs err {diff:.4g}, excess {e:.3g}")
            if not e <= 1.0:
                failures.append(f"{name}@{r0}: excess {e:.3g}")
            r = recs[_LONG_KERNEL[name]]
            r["max_abs_err"] = max(r["max_abs_err"], diff)
    if failures:
        raise SmokeFailure(f"a kernel at {list(shape)} causal={causal} disagrees with its "
                           "plain version: " + "; ".join(failures))
    del dq, dk, dv
    times = _time_kernels(q, k, v, o, lse, do, causal, shape, "bfloat16", with_plain=False)
    for name, r in recs.items():
        r.update({key: times[name][key] for key in ("ms", "bound_ms", "bound_by",
                                                   "library_ms")})
        if group == "at_T_65536":
            records.setdefault(name, {})[group] = r
        else:
            records.setdefault(name, {}).setdefault(group, {})[_shape_key(shape, causal)] = r
    del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()


def longctx_kernel_check(records: dict) -> None:
    """tile_kernel_check at [1, 6, 65536, 128] bf16 causal: fills
    records[name]["at_T_65536"]."""
    tile_kernel_check(records, (1, LONG_HEADS, LONG_SEQ, 128), True, "at_T_65536", 65536)


# Which kernel each checked output of longctx_kernel_check belongs to.
_LONG_KERNEL = {"o": "flash_fwd", "lse": "flash_fwd", "delta": "flash_bwd_delta",
                "dq": "flash_bwd_dq", "dk": "flash_bwd_dkv", "dv": "flash_bwd_dkv"}


def longctx_phase(records: dict, card: str) -> list[dict]:
    """The bench's long-context points through the trainer (LONGCTX_RUNS):
    tokens/s, MFU, peak memory and launches per step of each run. Every run
    must launch K2, K3 and the delta pass once per block a step and K1 as
    its save policy says. A run marked as one that may not fit is recorded
    as such when it runs out of memory; any other run that does fails."""
    import gc

    import torch

    from tf_operator_tpu_torch.ops import flash_attention as fa

    longctx_kernel_check(records)
    results = []
    for label, seq, steps, extra, k1_per_step, may_not_fit in LONGCTX_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        tag = "_long_" + re.sub(r"\W+", "_", label)
        try:
            by = run_trainer(longctx_argv(seq, steps, extra), tag=tag)
        except torch.cuda.OutOfMemoryError as e:
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            msg = (f"longctx {label}: does not fit: {str(e).splitlines()[0]} (peak "
                   f"{peak_gb:.2f} GB before the failure) [{card}]")
            if not may_not_fit:
                raise SmokeFailure(msg) from e
            log(msg)
            results.append({"run": label, "fits": False, "peak_gb": peak_gb, "card": card})
            continue
        per_step = {key: n / steps for key, n in fa.LAUNCHES.items()}
        want = {"fwd": k1_per_step, "bwd_dq": LAYERS, "bwd_dkv": LAYERS,
                "bwd_delta": LAYERS}
        if per_step != want:
            raise SmokeFailure(f"longctx {label}: launches per step {per_step}, the "
                               f"save policy gives {want}")
        done = by["done"]
        eps = done.get("examples_per_sec")
        res = {
            "run": label, "fits": True, "seq": seq, "steps": steps,
            "tokens_per_s": eps * seq if eps else None,
            "mfu": (lm_flops_per_step(1, seq, LAYERS, 768, 32000) * eps
                    / PEAK_FLOPS["bfloat16"]) if eps else None,
            "step_time_s": (done.get("step_time_s") or {}).get("mean"),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches_per_step": per_step, "final_loss": done["final_loss"], "card": card}
        log("longctx: " + json.dumps(res))
        results.append(res)
    return results


# The preemption phase: the full-width LM as a pod runs it, in a
# subprocess, SIGTERMed by its own chaos directive at PREEMPT_STEP.
PREEMPT_STEP = 4
PREEMPT_DIR = OUT_DIR / "preempt"
# A child that runs the trainer's entry point and, at exit, writes its
# kernels' launch counts to the file named by its first argument.
_CHILD = (
    "import atexit, json, runpy, sys\n"
    "path = sys.argv.pop(1)\n"
    "from tf_operator_tpu_torch.ops import flash_attention as fa\n"
    "atexit.register(lambda: open(path, 'w').write(json.dumps(fa.LAUNCHES)))\n"
    "runpy.run_module('tf_operator_tpu_torch.models.train', run_name='__main__', "
    "alter_sys=True)\n"
)


def first_card() -> str:
    """This process's first visible GPU, as CUDA_VISIBLE_DEVICES names it."""
    return (os.environ.get("CUDA_VISIBLE_DEVICES") or "0").split(",")[0].strip()


def start_child(argv: list[str], tag: str, env: dict | None = None, child: str = _CHILD):
    """python -m tf_operator_tpu_torch.models.train `argv` started in a
    subprocess (through `child`, with `env` added to this process's), with
    its events in a metrics file; pass the result to finish_child. The
    child sees this process's first GPU alone unless `env` sets
    CUDA_VISIBLE_DEVICES: a pod given one card, so co-located ranks stay
    one process each on a machine of several GPUs (the trainer runs a local
    rank for every GPU its pod sees)."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    events_path = OUT_DIR / f"chip_smoke_events{tag}.jsonl"
    counts_path = OUT_DIR / f"chip_smoke_launches{tag}.json"
    for path in (events_path, counts_path):
        path.unlink(missing_ok=True)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": first_card(), **(env or {}),
           "TPUJOB_METRICS_FILE": str(events_path),
           "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    log("child: python -m tf_operator_tpu_torch.models.train " + " ".join(argv))
    proc = subprocess.Popen([sys.executable, "-c", child, str(counts_path), *argv],
                            cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    return proc, events_path, counts_path


def finish_child(child, timeout: float = 600) -> tuple[int, list, dict]:
    """Wait for a start_child process (killed past `timeout`): (exit code,
    events, the child's kernel launch counts)."""
    proc, events_path, counts_path = child
    try:
        _, stderr = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    for line in stderr.strip().splitlines()[-5:]:
        log(f"  child stderr: {line}")
    events = ([json.loads(x) for x in events_path.read_text().splitlines()]
              if events_path.exists() else [])
    counts = json.loads(counts_path.read_text()) if counts_path.exists() else {}
    return proc.returncode, events, counts


def run_child(argv: list[str], tag: str, timeout: float = 600) -> tuple[int, list, dict]:
    """start_child then finish_child."""
    return finish_child(start_child(argv, tag), timeout)


# The flash kernels' launch counters (ops.flash_attention.LAUNCHES).
FLASH_LAUNCH_KEYS = ("fwd", "bwd_dq", "bwd_dkv", "bwd_delta")
# Span names a preempted run and its restart must have recorded together.
PREEMPT_SPANS = ("step", "phase/dispatch", "phase/device_blocked", "phase/ckpt_snapshot",
                 "checkpoint/ckpt_write", "checkpoint/save", "checkpoint/restore")


def _spans(path: Path) -> set:
    trace = json.loads(path.read_text())
    return {e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"}


def preempt_phase(args, card: str, uninterrupted: dict | None) -> dict:
    """The full-width LM in a subprocess, saving every 2 steps (async),
    SIGTERMed at PREEMPT_STEP by --chaos: it must exit 143 with one
    `preempted` event that says the emergency checkpoint is there. Its
    restart must resume from that step and end on the uninterrupted run's
    step-6 loss (bit for bit, else within two uninterrupted runs' spread).
    The runs' traces must parse and hold PREEMPT_SPANS, and the restart's
    profile_done must name a non-empty directory. A second preempted run
    without periodic saves times the synchronous emergency save."""
    shutil.rmtree(PREEMPT_DIR, ignore_errors=True)
    ckpt_dir, trace_dir, prof_dir = (PREEMPT_DIR / n for n in ("ckpt", "traces", "profile"))
    argv = lm_argv(args.steps)
    argv[argv.index("--log-every") + 1] = "1"  # the restart's last step is profiled
    flags = ["--checkpoint-dir", str(ckpt_dir), "--checkpoint-every", "2",
             "--checkpoint-mode", "async", "--preempt-grace", "60",
             "--chaos", f"kill:step={PREEMPT_STEP},signal=TERM", "--trace",
             "--trace-dir", str(trace_dir), "--profile-dir", str(prof_dir)]
    rc, events, counts_a = run_child(argv + flags, "_preempt_a")
    pre = [e for e in events if e["event"] == "preempted"]
    if rc != 143 or len(pre) != 1 or pre[0]["step"] != PREEMPT_STEP \
            or not pre[0]["emergency_checkpoint"]:
        raise SmokeFailure(f"the preempted run exited {rc} with preempted events {pre}")
    spans = _spans(trace_dir / "local-0.trace.json")
    rc, events_b, counts_b = run_child(argv + flags, "_preempt_b")
    by = {e["event"]: e for e in events_b}
    if rc != 0 or by.get("resumed", {}).get("from_step") != PREEMPT_STEP:
        raise SmokeFailure(f"the restart exited {rc}, resumed {by.get('resumed')}")
    spans |= _spans(trace_dir / "local-0.trace.json")
    missing = [n for n in PREEMPT_SPANS if n not in spans]
    if missing:
        raise SmokeFailure(f"the preempted run and its restart traced no {missing}")
    prof = by.get("profile_done")
    if prof is None or not any(Path(prof["dir"]).rglob("*.json")):
        raise SmokeFailure(f"no profile in the restart's profile_done {prof}")
    if not all(counts.get(key, 0) > 0 for counts in (counts_a, counts_b)
               for key in FLASH_LAUNCH_KEYS):
        raise SmokeFailure(f"a flash kernel was not launched (or a child wrote no "
                           f"counts): {counts_a}, {counts_b}")
    loss_b = by["done"]["final_loss"]
    if uninterrupted is None:
        uninterrupted = run_trainer(lm_argv(args.steps), tag="_preempt_u")["done"]
    loss_u = uninterrupted["final_loss"]
    log(f"preempt: step-{args.steps} loss after the restart {loss_b!r}, uninterrupted "
        f"{loss_u!r}, bit for bit: {loss_b == loss_u}")
    if loss_b != loss_u:
        loss_u2 = run_trainer(lm_argv(args.steps), tag="_preempt_u2")["done"]["final_loss"]
        spread = abs(loss_u2 - loss_u)
        if not abs(loss_b - loss_u) <= spread:
            raise SmokeFailure(f"the restarted loss {loss_b!r} is off the uninterrupted "
                               f"{loss_u!r} by more than the runs' spread {spread!r}")
    # The synchronous emergency save: no periodic save to adopt.
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    sync_flags = ["--checkpoint-dir", str(ckpt_dir), "--preempt-grace", "60",
                  "--chaos", f"kill:step={PREEMPT_STEP},signal=TERM"]
    rc, events_s, _ = run_child(argv + sync_flags, "_preempt_sync")
    pre_s = [e for e in events_s if e["event"] == "preempted"]
    if rc != 143 or len(pre_s) != 1 or not pre_s[0]["emergency_checkpoint"] \
            or pre_s[0].get("adopted_async_save"):
        raise SmokeFailure(f"the sync-save preempted run exited {rc}: {pre_s}")
    result = {"preempted": pre[0], "adopted_async_save": bool(pre[0].get("adopted_async_save")),
              "drain_s": pre[0].get("drain_s"), "elapsed_s": pre[0]["elapsed_s"],
              "emergency_sync_save_elapsed_s": pre_s[0]["elapsed_s"],
              "restart_resumed": by["resumed"], "restart_loss": loss_b,
              "uninterrupted_loss": loss_u, "spans": sorted(spans),
              "profile_dir": prof["dir"], "launches_preempted_run": counts_a,
              "launches_restart": counts_b, "card": card}
    log("preempt: " + json.dumps(result))
    shutil.rmtree(PREEMPT_DIR, ignore_errors=True)
    return result


EVAL_BATCHES = 2
EVAL_ROUNDS = 3


def eval_phase(args, card: str, final_state) -> dict:
    """An evaluator subprocess on the card follows the ckpt phase's
    directory to FINAL on the graph route (its eval_ready): one `eval` per
    checkpoint and `eval_done`; its last eval_loss must equal the loss of
    the ckpt phase's final parameters on the same batches, computed here
    eagerly (train.evaluate) with the same kernels on the same card, after
    the event's own rounding to 6 decimals: the two sides run the same code
    on the same bits, so only that rounding may part them. Here too the
    graphed round (train.evaluator) against the eager one on the final
    parameters, bit for bit, and each one's seconds a round (a checkpoint's
    evaluation), the mean of EVAL_ROUNDS after the graph's capture."""
    import torch

    from tf_operator_tpu_torch.models import checkpoint as ckpt
    from tf_operator_tpu_torch.models import train

    argv = lm_argv(EVAL_BATCHES)
    rc, events, counts = run_child(argv + ["--eval", "--checkpoint-dir", str(CKPT_DIR),
                                           "--eval-timeout", "60"], "_eval")
    evals = [e for e in events if e["event"] == "eval"]
    steps = ckpt.list_steps(str(CKPT_DIR))
    if rc != 0 or [e["checkpoint_step"] for e in evals] != steps \
            or not any(e["event"] == "eval_done" for e in events):
        raise SmokeFailure(f"the evaluator exited {rc} with eval events {evals} over the "
                           f"steps {steps}")
    if counts.get("fwd", 0) != LAYERS * EVAL_BATCHES * len(steps):
        raise SmokeFailure(f"the evaluator launched {counts}, not K1 once a block a batch")
    ready = [e for e in events if e["event"] == "eval_ready"]
    if [e["step_route"] for e in ready] != ["graph"]:
        raise SmokeFailure(f"the evaluator's route: {ready}, not one graph")
    t_args = train.build_parser().parse_args(argv)
    device = torch.device("cuda")
    _, loss_fn, make_batch = train._build_model(t_args, device)
    model = final_state.model
    here = train.evaluate(model, loss_fn, make_batch, device, EVAL_BATCHES)
    rounds = {}
    for route in ("eager", "graph"):
        run = train.evaluator(model, loss_fn, make_batch, device, EVAL_BATCHES,
                              graphed=route == "graph")
        losses = [run()]  # a graph's capture, an eager run's warm caches
        t0 = time.time()
        losses += [run() for _ in range(EVAL_ROUNDS)]
        rounds[route] = {"s_per_checkpoint": (time.time() - t0) / EVAL_ROUNDS,
                         "losses": losses}
    got = evals[-1]["eval_loss"]
    log(f"eval: last eval_loss {got!r} (step {evals[-1]['checkpoint_step']}, graphed), "
        f"in-process eager {here!r}; evaluator launches {counts}; in-process rounds "
        f"{json.dumps(rounds)} [{card}]")
    if got != round(here, 6):
        raise SmokeFailure(f"the evaluator's loss {got!r} is off the final parameters' "
                           f"{here!r}")
    if set(rounds["graph"]["losses"]) != {here} or set(rounds["eager"]["losses"]) != {here}:
        raise SmokeFailure(f"the graphed evaluator's rounds {rounds['graph']['losses']} are "
                           f"not the eager loss {here!r}")
    return {"evals": evals, "in_process_loss": here, "launches": counts,
            "route": ready[0]["step_route"], "rounds": rounds, "card": card}


# BERT (BASELINE.md workload 4, BERT-base at full width): the kernels at its
# two pretraining shapes, full attention, then the trainer.
BERT_SHAPES = ((32, 12, 512, 64), (128, 12, 128, 64))
# (model, seq, batch, layers): seq 512 is BERT pretraining's last 10% of
# steps, seq 128 its first phase (Devlin et al. 2018, appendix A.2);
# bert-tiny's heads of 32 run zero-padded to 64.
BERT_RUNS = (("bert-base", 512, 32, 12), ("bert-base", 128, 128, 12),
             ("bert-tiny", 512, 32, 2))
BERT_STEPS = 6
# The chief with checkpoints and its Evaluator (the JAX example's shape).
BERT_CKPT = ("bert-base", 128, 8)
BERT_CKPT_DIR = OUT_DIR / "bert_ckpt"


# The MLM head's loss kernel (ops/mlm_xent.py): (rows, vocab) at BERT's 65536
# tokens a step (the cells' 128 x 512 and 512 x 128) and vocabulary, then
# rows held in registers at a small vocabulary, and GPT-2's 50257 columns,
# past the 32768 a block holds (read twice with a gradient).
XENT_SHAPES = ((65536, 30522), (4096, 1021), (4096, 50257))
XENT_MASK_RATE = 0.15
XENT_REPS = 10


def xent_bound_ms(n: int, vocab: int) -> float:
    """The kernel's bound: the bf16 logits [n, Vp] read once and their
    gradient written once at the HBM rate (its exp are not the limit)."""
    from tf_operator_tpu_torch.ops import mlm_xent as mx

    return 2 * n * mx.padded_vocab(vocab) * 2 / PEAK_BYTES_PER_S * 1e3


def xent_gaps(n: int, vocab: int, seed: int) -> dict:
    """The kernel against its plain version on the same bf16 logits
    [n, Vp] (normal, std 2, the pad 0), targets and a 15% mask: the loss's
    relative gap, the gradient's largest gap in units of the plain
    gradient's bf16 rounding step (0.5 = both rounded the same f32 value;
    1 = one step apart), the loss-only call's gap and whether it left the
    logits as they were, and a planted fault (the target's -1 left out of
    the gradient) that the same measure must reject."""
    import torch

    from tf_operator_tpu_torch.ops import mlm_xent as mx

    gen = torch.Generator(device="cuda").manual_seed(seed)
    vp = mx.padded_vocab(vocab)
    z = torch.zeros((n, vp), dtype=torch.bfloat16, device="cuda")
    z[:, :vocab] = (2.0 * torch.randn((n, vocab), generator=gen, device="cuda")).bfloat16()
    targets = torch.randint(0, vocab, (n,), generator=gen, device="cuda")
    mask = (torch.rand((n,), generator=gen, device="cuda") < XENT_MASK_RATE).float()
    got = z.clone()
    loss = mx.masked_xent_(got, vocab, targets, mask, True)
    ref = z.clone()
    want = mx.masked_xent_reference_(ref, vocab, targets, mask, True)
    kept = z.clone()
    loss_only = mx.masked_xent_(kept, vocab, targets, mask, False)

    def steps(a, b) -> float:
        # |a - b| over the bf16 rounding step at b (8 bits of mantissa).
        b32 = b.float()
        ulp = torch.ldexp(torch.ones_like(b32), torch.frexp(b32)[1] - 8).clamp_min(2.0 ** -133)
        ulp = torch.where(b32 == 0, 2.0 ** -133, ulp)
        return float(((a.float() - b32).abs() / ulp).max())

    planted = ref.clone()
    rows = torch.arange(n, device="cuda")
    planted[rows, targets] = (ref[rows, targets].float()
                              + mask / mask.sum().clamp_min(1.0)).bfloat16()
    out = {"shape": [n, vocab], "pitch": vp,
           "loss_rel_gap": abs(float(loss) - float(want)) / abs(float(want)),
           "grad_steps": steps(got, ref), "pad_zero": bool((got[:, vocab:] == 0).all()),
           "loss_only_rel_gap": abs(float(loss_only) - float(want)) / abs(float(want)),
           "loss_only_kept_logits": bool(torch.equal(kept, z)),
           "planted_grad_steps": steps(planted, ref)}
    del z, got, ref, kept, planted
    torch.cuda.empty_cache()
    return out


def mlm_xent_check(records: dict) -> dict:
    """ops/mlm_xent.py's kernel at XENT_SHAPES against its plain version
    (xent_gaps): the loss within 1e-5 relative, the gradient within one
    bf16 rounding step, the pad 0, the loss-only call the same loss with
    the logits left alone, the planted fault rejected; bit-equal loss and
    gradient over two launches; then timed (mean of XENT_REPS, CUDA events,
    with and without the gradient) beside its bound and the plain version.
    Fills records["mlm_xent"] with the first shape's numbers."""
    import torch

    from tf_operator_tpu_torch.ops import mlm_xent as mx

    if "mlm_xent" in records:
        return records["mlm_xent"]
    failures, rows = [], []
    for i, (n, vocab) in enumerate(XENT_SHAPES):
        gaps = xent_gaps(n, vocab, 25 + i)
        bad = [k for k, ok in (("loss_rel_gap", gaps["loss_rel_gap"] <= 1e-5),
                               ("grad_steps", gaps["grad_steps"] <= 1.0),
                               ("pad_zero", gaps["pad_zero"]),
                               ("loss_only_rel_gap", gaps["loss_only_rel_gap"] <= 1e-5),
                               ("loss_only_kept_logits", gaps["loss_only_kept_logits"]),
                               ("planted_grad_steps", gaps["planted_grad_steps"] > 1.0))
               if not ok]
        failures += [f"{[n, vocab]} {k}" for k in bad]
        gen = torch.Generator(device="cuda").manual_seed(50 + i)
        vp = mx.padded_vocab(vocab)
        z = torch.randn((n, vp), generator=gen, device="cuda").bfloat16()
        targets = torch.randint(0, vocab, (n,), generator=gen, device="cuda")
        mask = (torch.rand((n,), generator=gen, device="cuda") < XENT_MASK_RATE).float()
        runs = [z.clone() for _ in range(2)]
        losses = [mx.masked_xent_(r, vocab, targets, mask, True) for r in runs]
        gaps["bit_equal_repeat"] = bool(torch.equal(runs[0], runs[1])
                                        and torch.equal(losses[0], losses[1]))
        if not gaps["bit_equal_repeat"]:
            failures.append(f"{[n, vocab]} two launches differ")
        del runs
        # Each timed launch overwrites z with a gradient, which is finite
        # logits for the next: the same bytes and exp either way.
        gaps["ms"] = time_ms(lambda: mx.masked_xent_(z, vocab, targets, mask, True),
                             reps=XENT_REPS)
        gaps["loss_only_ms"] = time_ms(lambda: mx.masked_xent_(z, vocab, targets, mask, False),
                                       reps=XENT_REPS)
        gaps["bound_ms"], gaps["bound_by"] = xent_bound_ms(n, vocab), "bytes"
        gaps["plain_ms"] = time_ms(
            lambda: mx.masked_xent_reference_(z, vocab, targets, mask, True), reps=2)
        gaps["roofline"] = gaps["bound_ms"] / gaps["ms"]
        del z
        torch.cuda.empty_cache()
        log("mlm_xent: " + json.dumps(gaps))
        rows.append(gaps)
    if failures:
        raise SmokeFailure("the MLM cross-entropy kernel disagrees with its plain version: "
                           + "; ".join(failures))
    records["mlm_xent"] = {**rows[0], "shapes": rows[1:]}
    return records["mlm_xent"]


def bert_flops_per_step(batch: int, seq: int, layers: int = 12, hidden: int = 768,
                        vocab: int = 30522, mlp_ratio: int = 4) -> float:
    """Model FLOPs of one BERT MLM training step: 6 x the dense weights per
    token (each layer's 4 h^2 + 2 mlp h^2, the MLM transform's h^2 and the
    h x vocab decoder over every position, as BertMLM computes it) plus
    full attention's QK^T and PV, 12 x layers x T x h per token for forward
    and backward."""
    dense = layers * (4 + 2 * mlp_ratio) * hidden * hidden + hidden * hidden + hidden * vocab
    return batch * seq * (6.0 * dense + 12.0 * layers * seq * hidden)


def bert_argv(model: str, seq: int, batch: int, steps: int) -> list[str]:
    """The trainer's BERT configuration: f32 moments, no master weights, as
    examples/bert-gang.yaml."""
    return ["--model", model, "--seq", str(seq), "--batch", str(batch), "--steps",
            str(steps), "--log-every", str(LOG_EVERY), "--device", "cuda"]


def _shape_key(shape, causal: bool) -> str:
    return "x".join(map(str, shape)) + ("-causal" if causal else "")


def shape_kernel_check(records: dict, shapes, group: str, seed: int,
                       causal: bool = False) -> None:
    """K1 (with and without lse), the delta pass (with and without an lse
    cotangent), K2 and K3 in bf16, causal or full attention, at each of
    `shapes`, held on the whole tensors against their plain versions with
    the check phase's tolerances, every MUTATIONS entry rejected at each;
    then timed beside their bound, their plain version and SDPA's forward
    and backward. Fills records[kernel][group][shape key]."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    failures = []
    for shape in shapes:
        errs, abs_errs, tensors = check_case(shape, "bfloat16", causal, gen, self_test=True)
        failures += [f"{list(shape)} {n}: excess {e[1]:.3g}" for n, e in errs.items()
                     if not e[1] <= 1.0]
        recs = _time_kernels(*tensors, causal, shape, "bfloat16", with_plain=True)
        for name, key_l, _ in KERNELS:
            records.setdefault(name, {}).setdefault(group, {})[_shape_key(shape, causal)] = {
                "shape": list(shape), "causal": causal, "max_abs_err": abs_errs[key_l],
                **recs[name]}
        del tensors
        torch.cuda.empty_cache()
    if failures:
        raise SmokeFailure(f"a kernel at a {group} shape disagrees with its plain version: "
                           + "; ".join(failures))


def bert_kernel_check(records: dict) -> None:
    """shape_kernel_check at BERT_SHAPES."""
    shape_kernel_check(records, BERT_SHAPES, "bert", 512)


def bert_train_run(model: str, seq: int, batch: int, layers: int, card: str) -> dict:
    """One BERT run through the trainer: a finite loss, K1, K2, K3 and the
    delta pass launched once a layer a step, the MLM loss kernel once a
    step."""
    import torch

    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops import mlm_xent as mx

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    mx.reset_launches()
    by = run_trainer(bert_argv(model, seq, batch, BERT_STEPS), tag=f"_{seq}_{batch}")
    launches = dict(fa.LAUNCHES)
    want = {key: layers * BERT_STEPS for key in FLASH_LAUNCH_KEYS}
    if launches != want or mx.LAUNCHES["mlm_xent"] != BERT_STEPS:
        raise SmokeFailure(f"{model} seq {seq}: launches {launches}, MLM loss "
                           f"{mx.LAUNCHES['mlm_xent']}, not one a layer a step {want} and "
                           f"one a step")
    done = by["done"]
    eps = done.get("examples_per_sec")
    hidden, heads = (768, 12) if model == "bert-base" else (128, 4)
    vocab = 30522 if model == "bert-base" else 1024
    res = {"model": model, "seq": seq, "batch": batch, "steps": BERT_STEPS,
           "tokens_per_s": eps * seq if eps else None,
           "mfu": (bert_flops_per_step(batch, seq, layers, hidden, vocab) * eps / batch
                   / PEAK_FLOPS["bfloat16"]) if eps else None,
           "step_time_s": (done.get("step_time_s") or {}).get("mean"),
           "startup_s": by["first_step"]["startup_s"],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_per_step": {k: n / BERT_STEPS for k, n in launches.items()},
           "mlm_xent_launches_per_step": mx.LAUNCHES["mlm_xent"] / BERT_STEPS,
           "step_route": by["model_ready"].get("step_route"),
           "first_loss": by["first_step"]["loss"], "final_loss": done["final_loss"],
           "head_width": hidden // heads, "card": card}
    log("bert: " + json.dumps(res))
    return res


def bert_eval_run(card: str) -> dict:
    """A BERT-base chief saving every 2 steps (BERT_CKPT's shape) with an
    Evaluator subprocess following its directory from the start: the
    evaluator must reach FINAL, and its last eval_loss must equal the final
    parameters' MLM loss on the same batches computed here, after the
    event's rounding to 6 decimals."""
    import torch

    from tf_operator_tpu_torch.models import train

    model, seq, batch = BERT_CKPT
    shutil.rmtree(BERT_CKPT_DIR, ignore_errors=True)
    argv = bert_argv(model, seq, batch, BERT_STEPS)
    eval_argv = bert_argv(model, seq, batch, EVAL_BATCHES)
    child = start_child(eval_argv + ["--eval", "--checkpoint-dir", str(BERT_CKPT_DIR),
                                     "--eval-timeout", "300"], "_bert_eval")
    try:
        out: dict = {}
        run_trainer(argv + ["--checkpoint-dir", str(BERT_CKPT_DIR), "--checkpoint-every",
                            "2"], out, tag="_bert_chief")
    finally:
        rc, events, counts = finish_child(child, timeout=600)
    evals = [e for e in events if e["event"] == "eval"]
    if rc != 0 or not evals or evals[-1]["checkpoint_step"] != BERT_STEPS \
            or not any(e["event"] == "eval_done" for e in events):
        raise SmokeFailure(f"the BERT evaluator exited {rc} with eval events {evals}")
    t_args = train.build_parser().parse_args(eval_argv)
    dev = torch.device(t_args.device)
    _, loss_fn, make_batch = train._build_model(t_args, dev)
    here = train.evaluate(out["state"].model, loss_fn, make_batch, dev, EVAL_BATCHES)
    got = evals[-1]["eval_loss"]
    log(f"bert eval: last eval_loss {got!r} (step {evals[-1]['checkpoint_step']}), "
        f"in-process {here!r}; evaluated steps {[e['checkpoint_step'] for e in evals]}; "
        f"evaluator launches {counts} [{card}]")
    if got != round(here, 6):
        raise SmokeFailure(f"the BERT evaluator's loss {got!r} is off the final "
                           f"parameters' {here!r}")
    shutil.rmtree(BERT_CKPT_DIR, ignore_errors=True)
    return {"evals": evals, "in_process_loss": here, "launches": counts, "card": card}


def bert_phase(records: dict, card: str) -> dict:
    bert_kernel_check(records)
    xent = mlm_xent_check(records)
    runs = [bert_train_run(*run, card) for run in BERT_RUNS]
    return {"mlm_xent": xent, "runs": runs, "eval": bert_eval_run(card)}


# The --data-dir path: a uint8 ImageNet-shaped shard set (x [N, 224, 224, 3]
# uint8, y int32) and ResNet-50 at batch 256 trained from it.
DATA_SAMPLES, DATA_SHARDS, DATA_STEPS = 2560, 10, 8
DATA_IMAGE, DATA_CLASSES = (RN_SIZE, RN_SIZE, 3), 1000
DATA_DIR = OUT_DIR / "imagenet_u8"
# (label, ingest flags); (b) and (d) must equal (a) bit for bit, (c) stay
# within rtol 1e-3 of it; the lane runs are (b) at 1 and 4 lanes.
STAGED = ["--input-staging", "staged", "--staging-depth", "2", "--staging-lanes", "2",
          "--staging-chunks", "2"]
DATA_RUNS = (
    ("a prefetch uint8", ["--input-staging", "prefetch", "--wire-dtype", "uint8"]),
    ("b staged uint8", STAGED + ["--wire-dtype", "uint8"]),
    ("c staged f32", STAGED + ["--wire-dtype", "f32"]),
    ("d staged uint8 zlib tuned", STAGED + ["--wire-dtype", "uint8", "--wire-codec", "zlib",
                                            "--staging-tune"]),
    ("b at 1 lane", ["--input-staging", "staged", "--staging-depth", "2", "--staging-lanes",
                     "1", "--staging-chunks", "2", "--wire-dtype", "uint8"]),
    ("b at 4 lanes", ["--input-staging", "staged", "--staging-depth", "4", "--staging-lanes",
                      "4", "--staging-chunks", "2", "--wire-dtype", "uint8"]),
)


def write_image_shards(seed: int = 0) -> float:
    """DATA_DIR's shard set from `seed` (the port's write_array_shards);
    returns its bytes."""
    import numpy as np

    from tf_operator_tpu_torch.data.dataset import write_array_shards

    shutil.rmtree(DATA_DIR, ignore_errors=True)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=(DATA_SAMPLES, *DATA_IMAGE), dtype=np.uint8)
    y = rng.integers(0, DATA_CLASSES, size=(DATA_SAMPLES,)).astype(np.int32)
    write_array_shards(str(DATA_DIR), {"x": x, "y": y}, DATA_SHARDS)
    return float(x.nbytes + y.nbytes)


def data_phase(card: str, synthetic_ips: float | None) -> dict:
    """ResNet-50 at batch 256 from DATA_DIR for DATA_STEPS steps, each of
    DATA_RUNS, with cuDNN held to deterministic algorithms so that runs fed
    the same bytes run the same device ops: (b) and (d) must give (a)'s
    losses bit for bit and (c) stay within rtol 1e-3 of them. Logs images/s
    beside the synthetic-batch ResNet-50's (the train phase's, and one run
    here under the same cuDNN setting), and each run's ingest block."""
    import torch

    t0 = time.time()
    nbytes = write_image_shards()
    log(f"data: wrote {nbytes / 1e6:.1f} MB of uint8 shards in {time.time() - t0:.1f} s")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        torch.cuda.empty_cache()
        synth = run_trainer(resnet_argv(DATA_STEPS), tag="_det")["done"]["examples_per_sec"]
        results, losses = [], {}
        for label, flags in DATA_RUNS:
            torch.cuda.empty_cache()
            argv = resnet_argv(DATA_STEPS) + ["--data-dir", str(DATA_DIR), *flags]
            argv[argv.index("--log-every") + 1] = "1"
            tag = "_data_" + re.sub(r"\W+", "_", label)
            by_list = run_trainer(argv, tag=tag, all_events=True)
            losses[label] = [e["loss"] for e in by_list if e["event"] in ("first_step",
                                                                           "progress")]
            done = [e for e in by_list if e["event"] == "done"][-1]
            block = done.get("staging") or done.get("prefetch")
            res = {"run": label, "images_per_s": done["examples_per_sec"],
                   "step_time_s": (done.get("step_time_s") or {}).get("mean"),
                   "data_wait_s": (done.get("phase_breakdown") or {}).get("data_wait"),
                   "losses": losses[label], "ingest": block, "card": card}
            log("data: " + json.dumps(res))
            results.append(res)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    a, b, c, d = (losses[label] for label, _ in DATA_RUNS[:4])
    if not (len(a) == DATA_STEPS and b == a and d == a):
        raise SmokeFailure(f"staged ingest changed the losses: (a) {a}, (b) {b}, (d) {d}")
    if not all(abs(x - y) <= 1e-3 * abs(y) for x, y in zip(c, a)) or len(c) != len(a):
        raise SmokeFailure(f"the f32 wire's losses {c} are off the uint8 wire's {a}")
    log(f"data: images/s synthetic {synthetic_ips} (train phase), {synth} (deterministic "
        f"cuDNN, here); from disk " + ", ".join(f"{r['run']} {r['images_per_s']}"
                                                for r in results) + f" [{card}]")
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    return {"synthetic_images_per_s": synthetic_ips, "synthetic_deterministic_images_per_s":
            synth, "runs": results, "dataset_bytes": nbytes, "card": card}


# The dist phase: torch.distributed through the operator's env. The card is
# one GPU, so a two-rank world runs co-located, and the backend rule picks
# gloo (on CUDA tensors); NCCL runs at world size 1.
DIST_RUNS = (("dp", {"dp": 2}), ("tp", {"tp": 2}), ("fsdp", {"fsdp": 2}))
DIST_SEQ, DIST_BATCH, DIST_STEPS, DIST_LAYERS = 512, 32, 6, 12
# Each run is held against the one-process run at the same global batch and
# seed on what a wrong update moves, not only on the loss (six steps of
# batch noise spread the reference's own losses by 3.2e-3):
#   - every step's loss within DIST_RTOL;
#   - every step's global gradient norm within DIST_NORM_RTOL: a rank that
#     steps on its own rows' gradient reports the norm of half a batch's
#     gradient, weighted by 1/2;
#   - each rank's final parameters: |final - ref final| / |ref final - init|
#     over its local parameters within DIST_PARAM_GAP (a rank that never
#     updated reads 1; an update from other gradients flips Adam's first
#     steps on many elements), with the init equal bit for bit.
# The limits sit between the sound runs' readings on one H100 (gloo, two
# ranks: loss 2.6e-4, norm 3.6e-3, param gap 0.146 at most, tp) and the
# planted fault's (DIST_FAULT: dp = 2 without the gradient reduction; loss
# 2.9e-3, norm 0.38, param gap 1.0), which held_against's own comparison
# must reject; PERF.md records both readings. The sp runs are held to the
# same limits (PERF.md records their readings and their faults').
DIST_RTOL = 1e-3
DIST_NORM_RTOL = 2e-2
DIST_PARAM_GAP = 0.4
DIST_FAULT = ("dp without the gradient reduction", {"dp": 2}, "no-grad-reduce", None)
DIST_REF = OUT_DIR / "dist_reference.pt"
# A dist rank (or the one-process reference): dist_child.
_DIST_CHILD = "import sys, chip_smoke\nsys.exit(chip_smoke.dist_child(sys.argv[1:]))\n"
# A world of one through initialize_from_env(force=True): the backend, an
# all_reduce and a broadcast of CUDA tensors (the first line it prints),
# then the capture probe (nccl_graph_probe; the second line).
_NCCL_CHILD = (
    "import json, torch, torch.distributed as dist, chip_smoke\n"
    "from tf_operator_tpu_torch.parallel import distributed\n"
    "dev = torch.device('cuda', 0)\n"
    "backend = distributed.initialize_from_env(force=True, device=dev)\n"
    "x = torch.arange(1, 5, dtype=torch.float32, device=dev)\n"
    "dist.all_reduce(x)\n"
    "y = torch.full((3,), 7.0, device=dev)\n"
    "dist.broadcast(y, src=0)\n"
    "torch.cuda.synchronize()\n"
    "print(json.dumps({'backend': backend, 'world': dist.get_world_size(),\n"
    "                  'all_reduce': x.tolist(), 'broadcast': y.tolist()}))\n"
    "print(json.dumps(chip_smoke.nccl_graph_probe(dev)))\n"
    "distributed.distributed_goodbye()\n"
)
# The capture probe: the port's collectives over the world of one in one
# CUDA graph, each replay on fresh inputs held against the eager calls.
NCCL_GRAPH_COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
                          "rotate")
NCCL_GRAPH_REPLAYS = 3
# What the probe must read: every replay bit-equal; the world watch's empty
# all-reduce (graphed_step.world_watch) ordered after the stream's earlier
# work and launching nothing on the card.
NCCL_GRAPH_PROBE = {"collectives": list(NCCL_GRAPH_COLLECTIVES),
                    "replays": NCCL_GRAPH_REPLAYS,
                    "bit_equal": [True] * NCCL_GRAPH_REPLAYS,
                    "watch_waits_for_the_stream": True, "watch_device_events": 0}


def nccl_graph_probe(dev) -> dict:
    """In a process that joined a world of one over NCCL: the port's
    all_reduce, all_gather, reduce_scatter_flat, all_to_all and rotate (a
    point-to-point pair to itself) of one static input captured in one
    GraphedStep after its eager warm-up, then NCCL_GRAPH_REPLAYS replays,
    each on fresh inputs copied into the static input and held bit for bit
    against the same calls made eagerly. Then the world watch's empty
    all-reduce: enqueued behind half a second of spinning on the stream,
    whether its work is still pending (ProcessGroupNCCL's watchdog then
    waits on it as on the stream's collectives) and done after a
    synchronise, and the device events ten of them make under
    torch.profiler."""
    import torch
    import torch.distributed as dist
    from torch.profiler import DeviceType, ProfilerActivity, profile

    from tf_operator_tpu_torch.parallel import collectives, graphed_step

    world = dist.group.WORLD
    static = torch.empty((8, 64), device=dev)

    def body():
        return {"all_reduce": collectives.all_reduce(static, world),
                "all_gather": collectives.all_gather(static, 0, world),
                "reduce_scatter": collectives.reduce_scatter_flat([static], [0], world)[0],
                "all_to_all": collectives.all_to_all(static, 0, 1, world),
                "rotate": torch.cat(collectives.rotate(static[:4], static[4:], world))}

    gen = torch.Generator(device=dev).manual_seed(0)
    static.normal_(generator=gen)
    step = graphed_step.GraphedStep(body)
    step()  # the eager warm-up, then the capture
    bit_equal = []
    for _ in range(NCCL_GRAPH_REPLAYS):
        static.copy_(torch.randn(static.shape, generator=gen, device=dev))
        got = {k: v.clone() for k, v in step().items()}
        want = body()
        bit_equal.append(sorted(got) == sorted(want) and
                         all(torch.equal(got[k], want[k]) for k in want))
    empty = torch.empty(0, device=dev)
    torch.cuda.synchronize()
    torch.cuda._sleep(2 ** 30)
    work = dist.all_reduce(empty, async_op=True)
    pending = not work.is_completed()
    work.wait()
    torch.cuda.synchronize()
    waits = pending and work.is_completed()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            dist.all_reduce(empty)
        torch.cuda.synchronize()
    events = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {"collectives": sorted(want, key=NCCL_GRAPH_COLLECTIVES.index),
            "replays": len(bit_equal), "bit_equal": bit_equal,
            "watch_waits_for_the_stream": waits, "watch_device_events": len(events),
            "watch_device_event_names": sorted(set(events))[:4]}


def nccl_graph_failures(rec: dict) -> list[str]:
    """What of the probe's record (nccl_graph_probe) is off NCCL_GRAPH_PROBE."""
    return [f"{k} {rec.get(k)!r}, not {want!r}" for k, want in NCCL_GRAPH_PROBE.items()
            if rec.get(k) != want]


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _plant_fault(fault: str) -> None:
    """Break this process's port as CHIP_SMOKE_DIST_FAULT says:
    no-grad-reduce (each rank steps on its own gradients), no-dcn-sum (each
    slice of a multi-slice job applies its own microbatches' mean: the
    exchange counts its peers' contributions but does not add them), no-sp-grad-sum
    (the gradients are summed over the data axes but not over sp),
    no-ring-mask (a ring block of a later rank is visible: no causal mask
    across blocks) or no-ep-sum (an MoE layer's output and input gradient
    are not summed over ep: each rank keeps its own experts' part)."""
    from tf_operator_tpu_torch.parallel import ring_attention
    from tf_operator_tpu_torch.parallel import train_step as ts

    if fault == "no-grad-reduce":
        ts.ParallelPlan.reduce_grads = lambda self, grads: grads
    elif fault == "no-sp-grad-sum":
        real = ts.ParallelPlan.reduce_grads

        def reduce_grads(self, grads):
            seq, self.seq = self.seq, False
            try:
                return real(self, grads)
            finally:
                self.seq = seq

        ts.ParallelPlan.reduce_grads = reduce_grads
    elif fault == "no-dcn-sum":
        from tf_operator_tpu_torch.parallel import multislice

        real_acc, real_collect = (multislice.DcnExchange._accumulate,
                                  multislice.DcnExchange.collect)

        def accumulate(self, p, sid, m, bucket_ids, host_by_bucket):
            if sid != self.world.slice_id:
                p.got.update((sid, m, b) for b in bucket_ids)
                return
            real_acc(self, p, sid, m, bucket_ids, host_by_bucket)

        def collect(self, *args, **kwargs):
            return [a * self.world.num_slices for a in real_collect(self, *args, **kwargs)]

        multislice.DcnExchange._accumulate = accumulate
        multislice.DcnExchange.collect = collect
    elif fault == "no-ring-mask":
        ring_attention.block_visible = lambda src, my: True
    elif fault == "no-ep-sum":
        real_place = ts._place_experts

        def place(mod, plan, name):
            real_place(mod, plan, name)
            mod.group = None

        ts._place_experts = place
    elif fault:
        raise ValueError(f"unknown fault {fault!r}")


def dist_child(argv: list[str]) -> int:
    """The trainer's entry point on argv[1:] as a dist rank: records every
    step's global gradient norm, the parameters before the first step, the
    route step_route gave it and the [B * H, T, D] shapes K1 ran at; at the
    end writes its launches, peak memory (allocated and reserved), norms,
    route, those shapes and each
    parameter's bytes (its shard's, under fsdp) to argv[0], and, with
    CHIP_SMOKE_DIST_ROLE=reference, its initial and final parameters to
    CHIP_SMOKE_DIST_REF (DIST_REF by default), with =measure nothing, or
    else the gap of its local parameters to that file's (dist_compare).
    CHIP_SMOKE_DIST_FAULT plants
    a fault (_plant_fault); CHIP_SMOKE_DIST_TIMEOUT_S sets the world's
    collective timeout (distributed.TIMEOUT) for the kill check, where a
    SIGUSR2 dumps every thread's Python stack to stderr (faulthandler).
    CHIP_SMOKE_STEP_ROUTE=eager sends the trainer eager whatever
    step_route says (the eager side of a graph-against-eager comparison);
    CHIP_SMOKE_BERT_LAYERS cuts bert-base's depth (its trainer takes no
    --layers); CHIP_SMOKE_MEMORY_SNAPSHOT=1 adds memory_pools of the
    allocator after the last chunk to the record. The record also holds param_digest, a
    hash of the final parameters' bytes (in every role)."""
    import datetime
    import faulthandler
    import hashlib

    import torch

    from tf_operator_tpu_torch.models import train
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops import grouped_matmul as gm
    from tf_operator_tpu_torch.ops import mlm_xent as mx
    from tf_operator_tpu_torch.parallel import distributed, graphed_step
    from tf_operator_tpu_torch.parallel import train_step as ts

    path, argv = argv[0], argv[1:]
    ref_path = Path(os.environ.get("CHIP_SMOKE_DIST_REF") or DIST_REF)
    snapshot, pools = os.environ.get("CHIP_SMOKE_MEMORY_SNAPSHOT") == "1", []
    try:
        from tf_operator_tpu_torch.parallel import peer_watch

        def host_read(t) -> float:
            # Each step's norm is read here, before the trainer's own reads:
            # in an NCCL world through the trainer's watchdog as they are.
            return peer_watch.read(t, "a step's gradient norm (dist_child)")
    except ImportError:  # a tree from before the watchdog
        host_read = float
    norms, init, plans, shapes = [], [], [], set()
    real_chunks, real_parallelize, real_fwd = (ts.make_chunked_train_step, ts.parallelize,
                                               fa._fwd_at)

    def fwd_at(q, *args, **kwargs):
        shapes.add(tuple(q.shape))
        return real_fwd(q, *args, **kwargs)

    def parallelize(*args, **kwargs):
        plans.append(real_parallelize(*args, **kwargs))
        return plans[-1]

    def make_chunked_train_step(*args, **kwargs):
        # Every step's metrics, on the eager and the graphed route alike.
        run = real_chunks(*args, **kwargs)

        def recorded(state, n, every=None):
            if not init:
                init.extend(p.detach().clone() for p in state.params)
            steps: list = []
            state, metrics = run(state, n, steps)
            norms.extend(host_read(m["grad_norm"]) for m in steps)
            if snapshot:
                # While the step's graph (and its pool) is alive.
                pools[:] = [memory_pools(torch.cuda.memory_snapshot())]
            if every is not None:
                every.extend(steps)
            return state, metrics

        return recorded

    real_ms = ts.make_multislice_step_fns

    def make_multislice_step_fns(*args, **kwargs):
        gen_batch, backward, apply = real_ms(*args, **kwargs)

        def recorded(state, grads):
            if not init:
                init.extend(p.detach().clone() for p in state.params)
            state, norm = apply(state, grads)
            norms.append(host_read(norm))
            return state, norm

        return gen_batch, backward, recorded

    routes: list = []
    real_route = graphed_step.step_route
    forced = os.environ.get("CHIP_SMOKE_STEP_ROUTE")

    def step_route(*args, **kwargs):
        routes.append((forced, "chip_smoke: CHIP_SMOKE_STEP_ROUTE") if forced
                      else real_route(*args, **kwargs))
        return routes[-1]

    if os.environ.get("CHIP_SMOKE_BERT_LAYERS"):
        from tf_operator_tpu_torch.models import transformer as tfm

        tfm.BERT_BASE = dataclasses.replace(
            tfm.BERT_BASE, num_layers=int(os.environ["CHIP_SMOKE_BERT_LAYERS"]))

    ts.parallelize, ts.make_chunked_train_step, fa._fwd_at = (
        parallelize, make_chunked_train_step, fwd_at)
    ts.make_multislice_step_fns = make_multislice_step_fns
    graphed_step.step_route = step_route
    if os.environ.get("CHIP_SMOKE_DIST_TIMEOUT_S"):
        distributed.TIMEOUT = datetime.timedelta(
            seconds=float(os.environ["CHIP_SMOKE_DIST_TIMEOUT_S"]))
        faulthandler.register(signal.SIGUSR2, all_threads=True)
    _plant_fault(os.environ.get("CHIP_SMOKE_DIST_FAULT", ""))
    out: dict = {}
    rc = train.main(argv, out)
    rec = {"launches": dict(fa.LAUNCHES), "k5_launches": dict(gm.LAUNCHES),
           "xent_launches": mx.LAUNCHES["mlm_xent"], "grad_norms": norms,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
           "step_route": routes[0][0] if routes else None,
           "flash_fwd_shapes": sorted(map(list, shapes))}
    if pools:
        rec["memory_pools"] = pools[0]
    if rc == 0:
        model = out["state"].model
        names = [n for n, _ in model.named_parameters()]
        final = [p.detach() for p in model.parameters()]
        digest = hashlib.sha256()
        for t in final:
            digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        rec["param_digest"] = digest.hexdigest()
        rec["param_bytes"] = {n: p.numel() * p.element_size() for n, p in zip(names, final)}
        rec["fsdp_sharded"] = [n for n, d in zip(names, plans[0].fsdp_dims) if d is not None]
        role = os.environ.get("CHIP_SMOKE_DIST_ROLE")
        if role == "reference":
            torch.save({"init": {n: t.cpu() for n, t in zip(names, init)},
                        "final": {n: t.cpu() for n, t in zip(names, final)}}, ref_path)
        elif role != "measure":
            rec.update(dist_compare(torch.load(ref_path), plans[0], names, init, final))
    Path(path).write_text(json.dumps(rec))
    return rc


def memory_pools(snapshot: list) -> dict:
    """torch.cuda.memory_snapshot()'s segments summed by memory pool (the
    caching allocator's own, "(0, 0)", or a CUDA graph's private one): the
    bytes reserved, and the blocks by state and size, the largest sizes
    first, with their counts: what a pool keeps."""
    pools: dict = {}
    for seg in snapshot:
        pool = pools.setdefault(str(tuple(seg.get("segment_pool_id", (0, 0)))),
                                {"reserved_bytes": 0, "segments": 0, "blocks": {}})
        pool["reserved_bytes"] += seg["total_size"]
        pool["segments"] += 1
        for block in seg.get("blocks", []):
            key = f"{block['state']} {block['size']}"
            pool["blocks"][key] = pool["blocks"].get(key, 0) + 1
    for pool in pools.values():
        top = sorted(pool["blocks"].items(),
                     key=lambda kv: -int(kv[0].rsplit(" ", 1)[1]) * kv[1])[:12]
        pool["blocks"] = dict(top)
    return pools


def dist_compare(ref: dict, plan, names, init, final) -> dict:
    """This rank's local parameters against the reference's full ones
    (plan.local's part of each): param_gap = |final - ref final| / |ref
    final - ref init| over them, and init_gap = |init - ref init| (0 when
    both start from the same seeded init)."""
    import torch

    sums = torch.zeros(3, dtype=torch.float64, device=final[0].device)
    for i, name in enumerate(names):
        r_init, r_final = (plan.local(i, ref[k][name].to(final[i].device)).double()
                           for k in ("init", "final"))
        sums += torch.stack([(final[i].double() - r_final).square().sum(),
                             (r_final - r_init).square().sum(),
                             (init[i].double() - r_init).square().sum()])
    gap, step, init_gap = sums.sqrt().tolist()
    return {"param_gap": gap / step, "init_gap": init_gap}


def nccl_world_of_one(card: str) -> dict:
    """A world of one over NCCL (_NCCL_CHILD): its backend, an all_reduce
    and a broadcast, and the capture probe (nccl_graph_probe), which must
    read NCCL_GRAPH_PROBE."""
    env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{free_port()}",
               JAX_PROCESS_ID="0", JAX_NUM_PROCESSES="1",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", _NCCL_CHILD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise SmokeFailure(f"the one-rank NCCL world exited {proc.returncode}: "
                           f"{proc.stderr[-2000:]}")
    first, probe = (json.loads(x) for x in proc.stdout.strip().splitlines()[-2:])
    if first != {"backend": "nccl", "world": 1, "all_reduce": [1.0, 2.0, 3.0, 4.0],
                 "broadcast": [7.0, 7.0, 7.0]}:
        raise SmokeFailure(f"the one-rank world is not NCCL's: {first}")
    res = {**first, "graph_probe": probe, "seconds": time.time() - t0, "card": card}
    log("dist: " + json.dumps(res))
    failed = nccl_graph_failures(probe)
    if failed:
        raise SmokeFailure("the one-rank NCCL capture probe: " + "; ".join(failed))
    return res


def dist_argv() -> list[str]:
    return ["--model", "bert-base", "--seq", str(DIST_SEQ), "--batch", str(DIST_BATCH),
            "--steps", str(DIST_STEPS), "--log-every", "1", "--device", "cuda"]


def _step_losses(events: list) -> dict:
    """Every step's loss: the first_step event's (one step a chunk) and the
    progress events'."""
    out = {e["step"]: e["loss"] for e in events if e["event"] == "progress"}
    first = [e for e in events if e["event"] == "first_step"]
    if first:
        out[1] = first[0]["loss"]
    return out


@dataclasses.dataclass(frozen=True)
class DistJob:
    """A model the dist phases hold across processes: the trainer's argv
    at global batch `batch`, its tokens an example, steps, layers, how many
    forward passes a step launch K1 (2 under --remat --remat-save-flash:
    the forward and the loss's replay), the file of its one-process
    reference, its width, each K5 kernel's launches a step (the MoE LM's
    sparse dispatch) and the env its processes add (dist_child's)."""

    label: str
    argv: tuple
    seq: int
    batch: int
    steps: int
    layers: int
    heads: int
    fwd_passes: int
    ref: Path
    hidden: int = 768
    k5_per_step: int = 0
    env: tuple = ()

    def sp_blocks(self, mesh: dict | None, mode: str | None) -> int:
        """Flash launches a layer a pass: sp ring blocks, else one."""
        sp = (mesh or {}).get("sp", 1)
        return sp if sp > 1 and mode == "ring" else 1

    def launches(self, mesh: dict | None, mode: str | None) -> dict:
        """Each rank's K1, K2, K3 and delta launches over the run."""
        n = self.layers * self.steps * self.sp_blocks(mesh, mode)
        return {key: n * (self.fwd_passes if key == "fwd" else 1)
                for key in FLASH_LAUNCH_KEYS}

    def xent_launches(self, mesh: dict | None) -> int:
        """Each rank's launches of the MLM loss kernel over the run: BERT's
        loss takes it once a step (twice under --remat: the loss's replay)
        where the decoder is whole on the rank, so not under tp or fsdp;
        the other models never."""
        mesh = mesh or {}
        model = self.argv[self.argv.index("--model") + 1]
        if not model.startswith("bert") or mesh.get("tp", 1) > 1 or mesh.get("fsdp", 1) > 1:
            return 0
        return self.steps * (2 if "--remat" in self.argv else 1)

    def local_shape(self, mesh: dict | None, mode: str | None) -> tuple:
        """The [B, H, T, D] of each flash launch on a rank: its rows, its tp
        heads, and under sp its T/sp block (ring) or its H/sp heads over the
        whole sequence (Ulysses)."""
        mesh = mesh or {}
        rows = self.batch // (mesh.get("dp", 1) * mesh.get("fsdp", 1))
        heads, t, sp = self.heads // mesh.get("tp", 1), self.seq, mesh.get("sp", 1)
        if sp > 1:
            if mode == "ring":
                t //= sp
            else:
                heads //= sp
        return (rows, heads, t, self.hidden // self.heads)


BERT_DIST = DistJob("bert-base", tuple(dist_argv()), DIST_SEQ, DIST_BATCH, DIST_STEPS,
                    DIST_LAYERS, 12, 1, DIST_REF)


def bert_dist_job(layers: int) -> DistJob:
    """BERT_DIST cut to `layers` blocks (dist_child's CHIP_SMOKE_BERT_LAYERS)."""
    return dataclasses.replace(BERT_DIST, label=f"bert-base, {layers} layers", layers=layers,
                               env=(("CHIP_SMOKE_BERT_LAYERS", str(layers)),))


def sp_lm_job(seq: int, batch: int, ref: str, layers: int = LAYERS) -> DistJob:
    """The full-width LM (12L x 768h, 6 heads x 128; or `layers` deep) at
    `seq`, global `batch`, 6 steps, --remat --remat-save-flash, as the
    long-context bench runs it."""
    argv = longctx_argv(seq, SP_STEPS, ["--remat", "--remat-save-flash"])
    argv[argv.index("--batch") + 1] = str(batch)
    argv[argv.index("--layers") + 1] = str(layers)
    label = f"lm {seq} batch {batch}" + ("" if layers == LAYERS else f", {layers} layers")
    return DistJob(label, tuple(argv), seq, batch, SP_STEPS, layers, LONG_HEADS, 2,
                   OUT_DIR / ref)


def dist_world(name: str, mesh: dict | None, own_gpus: bool = False,
               role: str = "run", fault: str = "", job: DistJob = BERT_DIST,
               mode: str | None = None) -> dict:
    """`job` through the trainer in as many processes as `mesh` needs (one
    without a mesh), each started as the operator starts a pod
    (JAX_COORDINATOR_ADDRESS, JAX_PROCESS_ID, JAX_NUM_PROCESSES,
    TPUJOB_MESH; TPUJOB_SP_MODE = `mode`) through dist_child, co-located on
    GPU 0 or, with own_gpus, each seeing GPU `rank` alone: every rank must
    exit 0 with K1, K2, K3 and the delta pass launched as job.launches
    says, and a finite loss and gradient norm at every step."""
    return finish_dist_world(name, start_dist_world(name, mesh, own_gpus, role, fault, job,
                                                    mode), mesh, job, mode)


def start_dist_world(name: str, mesh: dict | None, own_gpus: bool = False,
                     role: str = "run", fault: str = "", job: DistJob = BERT_DIST,
                     mode: str | None = None) -> list:
    """dist_world's processes, started (pass them to finish_dist_world)."""
    n = 1 if mesh is None else int(math.prod(mesh.values()))
    port = free_port()
    children = []
    for rank in range(n):
        env = {"CHIP_SMOKE_DIST_ROLE": role, "CHIP_SMOKE_DIST_FAULT": fault,
               "CHIP_SMOKE_DIST_REF": str(job.ref)}
        if mesh is not None:
            env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_PROCESS_ID=str(rank),
                       JAX_NUM_PROCESSES=str(n), TPUJOB_MESH=json.dumps(mesh))
        if mode is not None:
            env["TPUJOB_SP_MODE"] = mode
        env.update(job.env)
        if own_gpus:
            env["CUDA_VISIBLE_DEVICES"] = str(rank)
        children.append(start_child(list(job.argv), f"_dist_{name}_{rank}", env,
                                    _DIST_CHILD))
    return children


def finish_dist_world(name: str, children: list, mesh: dict | None,
                      job: DistJob = BERT_DIST, mode: str | None = None) -> dict:
    """dist_world's checks on its started processes, once they end."""
    ranks = [finish_child(c, timeout=900) for c in children]
    want = job.launches(mesh, mode)
    out = []
    for rank, (rc, events, rec) in enumerate(ranks):
        if rc != 0:
            raise SmokeFailure(f"dist {name}: rank {rank} exited {rc}")
        want_k5 = {key: job.k5_per_step * job.steps for _, key in K5}
        want_xent = job.xent_launches(mesh)
        if rec.get("launches") != want or rec.get("k5_launches") != want_k5 \
                or rec.get("xent_launches") != want_xent:
            raise SmokeFailure(f"dist {name}: rank {rank} launches {rec.get('launches')}, "
                               f"K5 {rec.get('k5_launches')}, MLM loss "
                               f"{rec.get('xent_launches')}, not {want}, {want_k5}, "
                               f"{want_xent}")
        losses, norms = _step_losses(events), rec["grad_norms"]
        if sorted(losses) != list(range(1, job.steps + 1)) or len(norms) != job.steps or \
                not all(math.isfinite(x) for x in list(losses.values()) + norms):
            raise SmokeFailure(f"dist {name}: rank {rank} losses {losses}, norms {norms}")
        by = {e["event"]: e for e in events}
        out.append({**rec, "losses": losses, "done": by["done"],
                    "dist_backend": by["jax_ready"].get("dist_backend"),
                    "mesh": by["first_step"]["mesh"],
                    "model_ready_route": by["model_ready"].get("step_route")})
    return {"ranks": out}


def world_route(backend: str) -> str:
    """The step route every rank of a world over `backend` must take on
    CUDA (graphed_step.step_route): NCCL's ranks replay graphs, gloo's step
    eagerly."""
    return "graph" if backend == "nccl" else "eager"


def dist_gaps(ref: dict, world: dict) -> dict:
    """The largest gaps of a world's ranks to the reference run: relative
    loss and gradient norm over the steps, param_gap and init_gap."""
    def rel(a, b):
        return abs(a - b) / abs(b)

    ranks = world["ranks"]
    return {
        "loss": max(rel(r["losses"][s], ref["losses"][s]) for r in ranks for s in r["losses"]),
        "grad_norm": max(rel(x, y) for r in ranks for x, y in zip(r["grad_norms"],
                                                                  ref["grad_norms"])),
        "param_gap": max(r["param_gap"] for r in ranks),
        "init_gap": max(r["init_gap"] for r in ranks)}


def dist_verdict(gaps: dict) -> list[str]:
    """What of dist_gaps exceeds its limit (empty when the run holds)."""
    limits = {"loss": DIST_RTOL, "grad_norm": DIST_NORM_RTOL, "param_gap": DIST_PARAM_GAP,
              "init_gap": 0.0}
    return [f"{k} {gaps[k]:.4g} > {limit}" for k, limit in limits.items()
            if not gaps[k] <= limit]


def fsdp_bytes_check(name: str, world: dict, ref: dict) -> dict:
    """Each rank of an fsdp run holds its shards between steps: every
    fsdp-sharded parameter at 1/fsdp of one process's bytes, the rest whole.
    Returns the bytes each rank holds beside one process's."""
    n = world["mesh"].get("fsdp", 1)
    held = []
    for rank, r in enumerate(world["ranks"]):
        sharded = set(r["fsdp_sharded"])
        if not sharded:
            raise SmokeFailure(f"dist {name}: rank {rank} holds no fsdp shard")
        for leaf, nbytes in r["param_bytes"].items():
            whole = ref["param_bytes"][leaf] // (n if leaf in sharded else 1)
            if nbytes != whole:
                raise SmokeFailure(f"dist {name}: rank {rank} holds {nbytes} bytes of "
                                   f"{leaf}, not {whole}")
        held.append(sum(r["param_bytes"].values()))
    return {"param_bytes": held, "one_process_param_bytes": sum(ref["param_bytes"].values())}


def held_against(ref: dict, runs, backend: str, own_gpus: bool, card: str,
                 job: DistJob = BERT_DIST) -> list:
    """Each (name, mesh[, sp mode]) of `runs` through dist_world, held
    against the one-process run `ref`: the backend the rule must pick, the
    mesh in the events, dist_verdict's limits and, under fsdp, the shards'
    bytes; global tokens/s, step time, each rank's peak memory and the
    gaps."""
    out = []
    for name, mesh, *rest in runs:
        mode = rest[0] if rest else None
        world = dist_world(name, mesh, own_gpus, job=job, mode=mode)
        world["mesh"] = mesh
        for r in world["ranks"]:
            if r["dist_backend"] != backend or r["mesh"] != mesh:
                raise SmokeFailure(f"dist {name}: backend {r['dist_backend']}, mesh "
                                   f"{r['mesh']} (the rule picks {backend} here)")
            if r["step_route"] != world_route(backend) or \
                    r["model_ready_route"] != r["step_route"]:
                raise SmokeFailure(f"dist {name}: a rank steps on the {r['step_route']} "
                                   f"route (model_ready: {r['model_ready_route']}), not "
                                   f"{world_route(backend)}")
        gaps = dist_gaps(ref, world)
        done = world["ranks"][0]["done"]
        eps = done.get("examples_per_sec")
        res = {"run": name, "model": job.label, "mesh": mesh, "sp_mode": mode,
               "backend": backend, "step_route": world_route(backend),
               "tokens_per_s": eps * job.seq if eps else None,
               "step_time_s": (done.get("step_time_s") or {}).get("mean"),
               "peak_gb": [r["peak_gb"] for r in world["ranks"]],
               "peak_reserved_gb": [r["peak_reserved_gb"] for r in world["ranks"]],
               "gaps": gaps,
               "kernel_shape": list(job.local_shape(mesh, mode)),
               "launches_per_step_per_rank": {k: n / job.steps for k, n in
                                              job.launches(mesh, mode).items()},
               "mlm_xent_launches_per_step_per_rank": [r["xent_launches"] / job.steps
                                                       for r in world["ranks"]],
               "losses": world["ranks"][0]["losses"],
               "grad_norms": world["ranks"][0]["grad_norms"], "card": card}
        if mesh.get("fsdp", 1) > 1:
            res["fsdp_bytes"] = fsdp_bytes_check(name, world, ref)
        log("dist: " + json.dumps(res))
        failed = dist_verdict(gaps)
        if failed:
            raise SmokeFailure(f"dist {name} is off one process's run: {failed}")
        out.append(res)
    return out


def fault_control(ref: dict, fault=DIST_FAULT, job: DistJob = BERT_DIST,
                  own_gpus: bool = False) -> dict:
    """A planted fault (label, mesh, CHIP_SMOKE_DIST_FAULT, sp mode) through
    dist_world, which dist_verdict must reject on what a wrong update moves
    (the gradient norm or the parameters), the loss aside."""
    return fault_controls(ref, [fault], job, own_gpus)[0]


def fault_controls(ref: dict, faults, job: DistJob = BERT_DIST,
                   own_gpus: bool = False) -> list[dict]:
    """fault_control of each of `faults`, their worlds run at once (no
    fault run is timed)."""
    started = [start_dist_world(f"fault{i}", mesh, own_gpus, fault=kind, job=job, mode=mode)
               for i, (_, mesh, kind, mode) in enumerate(faults)]
    out = []
    for i, ((label, mesh, _, mode), children) in enumerate(zip(faults, started)):
        gaps = dist_gaps(ref, finish_dist_world(f"fault{i}", children, mesh, job, mode))
        failed = [f for f in dist_verdict(gaps) if not f.startswith("loss")]
        res = {"run": label, "model": job.label, "mesh": mesh, "gaps": gaps,
               "rejected_on": failed}
        log("dist: planted fault " + json.dumps(res))
        if not failed:
            raise SmokeFailure(f"the dist check accepts a run with {label}: {gaps}")
        out.append(res)
    return out


def one_process(card: str, job: DistJob = BERT_DIST) -> tuple[dict, dict]:
    """The one-process reference run (its initial and final parameters in
    job.ref) and its record."""
    ref = dist_world("one", None, role="reference", job=job)["ranks"][0]
    eps = ref["done"].get("examples_per_sec")
    rec = {"run": "one process", "model": job.label,
           "tokens_per_s": eps * job.seq if eps else None,
           "step_time_s": (ref["done"].get("step_time_s") or {}).get("mean"),
           "peak_gb": [ref["peak_gb"]], "param_bytes": sum(ref["param_bytes"].values()),
           "losses": ref["losses"], "grad_norms": ref["grad_norms"], "card": card}
    log("dist: " + json.dumps(rec))
    return ref, rec


def dist_kernel_check(records: dict, runs) -> None:
    """shape_kernel_check at every local shape of `runs` not yet checked."""
    done = set(records.get(KERNELS[0][0], {}).get("dist", {}))
    shapes = [sh for sh in dict.fromkeys(BERT_DIST.local_shape(m, None) for _, m in runs)
              if _shape_key(sh, False) not in done]
    shape_kernel_check(records, shapes, "dist", 513)


def dist_phase(records: dict, card: str) -> dict:
    """(a) NCCL at world size 1; the flash kernels at the dist runs' local
    shapes; (b, c) BERT-base at seq 512, global batch 32, 6 steps, cut to
    FAULT_LAYERS blocks, at dp = 2, tp = 2 and fsdp = 2 as two co-located
    trainer processes, held against one process at the same depth, global
    batch and seed (held_against; fsdp's ranks hold half of each sharded
    parameter's bytes), and the planted fault rejected: two ranks on one
    GPU take gloo. (12 blocks until the default run outgrew its rule of
    950 s; dist4 keeps them.)"""
    import torch

    torch.cuda.empty_cache()
    nccl = nccl_world_of_one(card)
    dist_kernel_check(records, DIST_RUNS)
    job = bert_dist_job(FAULT_LAYERS)
    ref, reference = one_process(card, job)
    try:
        return {"nccl_world_of_one": nccl, "reference": reference,
                "runs": held_against(ref, DIST_RUNS, "gloo", False, card, job),
                "fault_control": fault_control(ref, job=job)}
    finally:
        job.ref.unlink(missing_ok=True)


# The sp phase: sequence parallelism on the full-width LM at SP_SEQ, two
# co-located ranks on the one card (gloo, by the backend rule).
SP_SEQ, SP_STEPS = 16384, 6
# The depth of the sp and pod phases' planted faults, each held against a
# one-process run of its own at that depth (a missing sum shows at any
# depth; cut from 12 layers for the default run's time, as the moe and
# multislice phases' faults are), of the sp phase's sound runs, which
# share the faults' one-process run (cut from 12 layers when a default run
# took 1040.4 s of its 1200 s limit), and of the dist phase's BERT runs and
# their one-process reference (cut from 12 when a default run took 984.1 s).
FAULT_LAYERS = 4
# The depth of the sp and pod phases' runs, sound and faulty, and of their
# one-process references: cut from FAULT_LAYERS when the graph checks of
# the multi-slice halves, the classifier and the Evaluator would have taken
# a default run to ~1030 s of its 1200 s limit.
CUT_LAYERS = 2
# The kernels at the local shapes of SP_RUNS: the ring's [1, 6, T/2, 128]
# blocks (the diagonal causal, the others full) and Ulysses' [1, 3, T, 128]
# causal, bf16.
SP_SHAPES = (((1, LONG_HEADS, SP_SEQ // 2, 128), True),
             ((1, LONG_HEADS, SP_SEQ // 2, 128), False),
             ((1, LONG_HEADS // 2, SP_SEQ, 128), True))
SP_RUNS = (("sp-ring", {"sp": 2}, "ring"), ("sp-ulysses", {"sp": 2}, "ulysses"))
SP_FAULTS = (("sp = 2 without the gradient sum over sp", {"sp": 2}, "no-sp-grad-sum", "ring"),
             ("a ring without the visibility mask", {"sp": 2}, "no-ring-mask", "ring"))


# The largest B x H x T^2 held on whole tensors (its plain backward keeps
# four f32 [BH, T, T] arrays: 13 GB here); larger shapes are held on tiles.
SP_WHOLE_MAX = 3 * 16384 ** 2


def sp_kernel_check(records: dict, shapes, seed: int) -> None:
    """K1 (with lse), the delta pass with a nonzero g_lse, K2 and K3 at
    each (shape, causal) of `shapes`, skipping those already checked: on
    whole tensors (shape_kernel_check: every MUTATIONS entry rejected,
    timed beside bound, plain and SDPA) up to SP_WHOLE_MAX, on three tiles
    (tile_kernel_check) beyond."""
    done = set(records.get(KERNELS[0][0], {}).get("sp", {}))
    for shape, causal in dict.fromkeys(shapes):
        if _shape_key(shape, causal) in done:
            continue
        if shape[0] * shape[1] * shape[2] ** 2 <= SP_WHOLE_MAX:
            shape_kernel_check(records, [shape], "sp", seed, causal=causal)
        else:
            tile_kernel_check(records, shape, causal, "sp", seed, with_g_lse=True)


def sp_phase(records: dict, card: str) -> dict:
    """The flash kernels at SP_SHAPES; the LM at its full width and
    CUT_LAYERS deep at SP_SEQ, batch 1, --remat --remat-save-flash, as
    one process and at sp = 2 through the ring and through Ulysses (two
    co-located ranks, gloo), each held against one process (held_against:
    launches sp times a layer a pass for the ring, once for Ulysses); and
    the planted faults of SP_FAULTS, run at once, rejected against the
    same process."""
    import torch

    torch.cuda.empty_cache()
    sp_kernel_check(records, SP_SHAPES, 16384)
    job = sp_lm_job(SP_SEQ, 1, "sp_reference.pt", CUT_LAYERS)
    ref, reference = one_process(card, job)
    try:
        runs = held_against(ref, SP_RUNS, "gloo", False, card, job)
        for name, key, _ in KERNELS:
            records.setdefault(name, {})["sp_launches_per_step_per_rank"] = {
                r["run"]: r["launches_per_step_per_rank"][key] for r in runs}
        return {"reference": reference, "runs": runs,
                "fault_control": fault_controls(ref, SP_FAULTS, job)}
    finally:
        job.ref.unlink(missing_ok=True)


# The moe phase: the MoE LM at bench.py's cell (bench.py:1122-1140: 12 x
# 768, 6 heads x 128, 8 experts top-2 every 2nd block, seq 2048, batch 8),
# and K5, the grouped matmul of its dropless dispatch
# (ops/grouped_matmul.py), at that cell's expert products.
MOE_SEQ, MOE_BATCH, MOE_LAYERS, MOE_HEADS, MOE_STEPS = 2048, 8, 12, 6, 6
MOE_EXPERTS, MOE_TOP_K, MOE_HIDDEN = 8, 2, 768
MOE_FFN = 4 * MOE_HIDDEN
MOE_SHAPE = (MOE_BATCH, MOE_HEADS, MOE_SEQ, MOE_HIDDEN // MOE_HEADS)
# K5's three kernels: (record name, LAUNCHES key, the product timed at the
# cell: (rows' operand, K, N) of x . w, x . w^T or x^T . dy).
K5 = (("grouped_matmul_nn", "gmm_nn"), ("grouped_matmul_nt", "gmm_nt"),
      ("grouped_matmul_tgmm", "tgmm"))
K5_SOURCE = "tf_operator_tpu_torch/csrc/grouped_matmul.cu"
# The kernel functions behind each record, one a route: wgmma (bf16 that
# TMA can describe: the cell), mma.sync (other bf16), FMA (f32).
K5_FUNCTIONS = {
    "grouped_matmul_nn": ["gmm_wgmma_kernel<false>", "gmm_mma_kernel<false>",
                          "gmm_fma_kernel<false>"],
    "grouped_matmul_nt": ["gmm_wgmma_kernel<true>", "gmm_mma_kernel<true>",
                          "gmm_fma_kernel<true>"],
    "grouped_matmul_tgmm": ["tgmm_wgmma_kernel", "tgmm_mma_kernel", "tgmm_fma_kernel"],
}
K5_REPLACES = "tf_operator_tpu/models/moe.py:193"
# Per-element limits of K5 against its plain version, |got - ref| <= rtol
# |ref| + atol s, s the rms of ref: gmm's bf16 output is one rounding of an
# f32 sum on both sides, so a value near a rounding boundary may land one
# bf16 step (2^-7 relative at most) away: rtol 1e-2, atol 1e-2 s. tgmm's
# f32 output: in f32 the inputs' products are exact on both sides, only the
# order of the sums differs (1e-4). tgmm's bf16 output (the trainer's dW,
# written in w's dtype) is one rounding of those f32 sums on both sides,
# which may land one bf16 step apart as gmm's do: gmm's (1e-2, 1e-2). f32
# inputs run the FMA kernels against an f32 plain version: 1e-5.
K5_TOL = {("bfloat16", "gmm"): (1e-2, 1e-2), ("bfloat16", "tgmm"): (1e-4, 1e-4),
          ("bfloat16", "tgmm_bf16"): (1e-2, 1e-2),
          ("float32", "gmm"): (1e-5, 1e-5), ("float32", "tgmm"): (1e-5, 1e-5),
          ("float32", "tgmm_bf16"): (1e-2, 1e-2)}
# The small cases: (label, M, K, N, group sizes, first group, groups held).
# In bf16 a case whose K and N are multiples of 8 takes the wgmma route (K
# and N off 64 here, so TMA's zero fill and the tiles' tails are reached),
# the others the mma.sync route (grouped_matmul.route); the tgmm edge
# masks' groups of 1-63 rows start and end inside 64-row k-steps.
K5_SMALL = (
    ("empty, one-row and off-tile groups", 300, 72, 136, (0, 1, 130, 169), 0, 4),
    ("tgmm edge masks: groups of 1-63 rows", 300, 72, 136, (5, 1, 63, 17, 40, 62, 112), 0, 7),
    ("all rows in one expert", 300, 72, 136, (300, 0, 0, 0), 0, 4),
    ("two of four groups (ep), wgmma", 517, 40, 104, (100, 200, 117, 100), 1, 2),
    ("two of four groups (ep)", 517, 40, 100, (100, 200, 117, 100), 1, 2),
    ("K, N off 8 (element loads)", 257, 30, 50, (128, 129), 0, 2),
)
# Broken outputs the K5 check must reject, each the plain version's on
# altered inputs (sizes, w, the row operand): groups 0 and 1 exchange their
# weights (tgmm: their outputs); one row moved across the first group
# boundary; each group's last row dropped.
K5_MUTATIONS = (
    ("a swapped group", lambda s, w, a: (s, w[[1, 0, *range(2, w.shape[0])]], a)),
    ("an off-by-one offset", lambda s, w, a: (_shift_first_group(s), w, a)),
    ("a dropped tail row", lambda s, w, a: (s, w, _drop_tail_rows(s, a))),
)
# The ep runs: the MoE LM at 4 of its 12 layers (two MoE layers) as two
# co-located gloo ranks, held against one process at the dist limits; and
# the planted fault, ep = 2 without the sum over ep.
MOE_EP_LAYERS = 4
MOE_EP_RUNS = (("ep", {"ep": 2}),)
MOE_EP_FAULT = ("ep = 2 without the sum over ep", {"ep": 2}, "no-ep-sum", None)


def _shift_first_group(sizes):
    """Group sizes with one row moved from the second group into the first."""
    sizes = sizes.clone()
    sizes[0] += 1
    sizes[1] -= 1
    return sizes


def _drop_tail_rows(sizes, a):
    """The row operand with each non-empty group's last row zeroed."""
    ends = sizes.cumsum(0)
    a = a.clone()
    a[ends[sizes > 0] - 1] = 0
    return a


def moe_flops_per_step(batch: int, seq: int, layers: int = MOE_LAYERS,
                       hidden: int = MOE_HIDDEN, vocab: int = 32000, experts: int = MOE_EXPERTS,
                       top_k: int = MOE_TOP_K, moe_every: int = 2) -> float:
    """Model FLOPs of one training step of the MoE LM over its active
    parameters, recomputation not counted: 6 x (the attention projections
    and dense MLPs of every block, top_k experts' FFNs and the router in
    each MoE block, the head) per token, plus causal attention's QK^T and
    PV (4 x B x T(T+1)/2 x hidden a layer forward) times 3."""
    ffn = 4 * hidden
    n_moe = sum(1 for i in range(layers) if i % moe_every == moe_every - 1)
    active = layers * 4 * hidden * hidden + (layers - n_moe) * 2 * hidden * ffn \
        + n_moe * (top_k * 2 * hidden * ffn + hidden * experts) + hidden * vocab
    attn = layers * 3 * 4.0 * batch * (seq * (seq + 1) / 2) * hidden
    return 6.0 * active * batch * seq + attn


def moe_argv(dispatch: str, layers: int = MOE_LAYERS, steps: int = MOE_STEPS) -> list[str]:
    """bench.py's MoE cell through the trainer, with its optimizer flags."""
    return ["--model", "moe-lm", "--moe-dispatch", dispatch, "--seq", str(MOE_SEQ),
            "--batch", str(MOE_BATCH), "--layers", str(layers), "--hidden", str(MOE_HIDDEN),
            "--heads", str(MOE_HEADS), "--steps", str(steps), "--log-every", "1",
            "--moment-dtype", "bf16", "--master-weights", "--device", "cuda"]


def moe_routed_inputs(gen):
    """The cell's expert-product operands from a real top-2 routing: B x T
    tokens through a lecun-initialised router, their copies sorted by
    expert (x_sorted [B T K, h] bf16) and the group sizes (int64, on the
    card); expert weights w_in [E, h, ffn] and w_out [E, ffn, h] bf16."""
    import torch

    dev = torch.device("cuda")
    n = MOE_BATCH * MOE_SEQ
    x = torch.randn(n, MOE_HIDDEN, generator=gen, device=dev)
    router = torch.randn(MOE_HIDDEN, MOE_EXPERTS, generator=gen, device=dev) \
        * MOE_HIDDEN ** -0.5
    topi = torch.topk(torch.softmax(x @ router, -1), MOE_TOP_K, -1).indices.reshape(-1)
    order = torch.argsort(topi, stable=True)
    sizes = torch.bincount(topi, minlength=MOE_EXPERTS)
    x_sorted = x.to(torch.bfloat16)[order // MOE_TOP_K].contiguous()
    w_in = (torch.randn(MOE_EXPERTS, MOE_HIDDEN, MOE_FFN, generator=gen, device=dev)
            * MOE_HIDDEN ** -0.5).to(torch.bfloat16)
    w_out = (torch.randn(MOE_EXPERTS, MOE_FFN, MOE_HIDDEN, generator=gen, device=dev)
             * MOE_FFN ** -0.5).to(torch.bfloat16)
    return x_sorted, sizes, w_in, w_out


def k5_excess(got, ref, dtype_name: str, kind: str) -> float:
    """The largest |got - ref| / (rtol |ref| + atol s) of K5_TOL[dtype,
    kind], s the rms of ref; the check passes at <= 1. A non-finite got
    fails."""
    rtol, atol = K5_TOL[(dtype_name, kind)]
    g, r = got.float(), ref.float()
    s = r.square().mean().sqrt().clamp_min(1e-30)
    e = ((g - r).abs() / (rtol * r.abs() + atol * s)).max().item()
    return e if math.isfinite(e) and bool(g.isfinite().all()) else float("inf")


def _k5_products(x, w_in, w_out, dy, dh, sizes, first: int = 0) -> dict:
    """K5's three kernels on one set of operands: {name: (kernel call,
    plain call of (sizes, w, row operand), kind)}: NN is x . w_in, NT is
    dy . w_out^T (dgrad's orientation, w_out [G, N, K] as it lies), tgmm is
    x^T . dh over the groups, with an f32 output and (tgmm_bf16, as the
    trainer's backward asks for it) a bf16 one."""
    import torch

    from tf_operator_tpu_torch.ops import grouped_matmul as gm

    local = w_in.shape[0]
    bf16 = torch.bfloat16
    return {
        "grouped_matmul_nn": (lambda: gm.gmm(x, w_in, sizes, first),
                              lambda s=sizes, w=w_in, a=x: gm.gmm_reference(a, w, s, first),
                              "gmm"),
        "grouped_matmul_nt": (lambda: gm.gmm(dy, w_out, sizes, first, trans_w=True),
                              lambda s=sizes, w=w_out, a=dy: gm.gmm_reference(a, w, s, first,
                                                                              True), "gmm"),
        "grouped_matmul_tgmm": (lambda: gm.tgmm(x, dh, sizes, first, local),
                                lambda s=sizes, w=None, a=x: gm.tgmm_reference(a, dh, s, first,
                                                                               local), "tgmm"),
        "grouped_matmul_tgmm_bf16": (
            lambda: gm.tgmm(x, dh, sizes, first, local, bf16),
            lambda s=sizes, w=None, a=x: gm.tgmm_reference(a, dh, s, first, local, bf16),
            "tgmm_bf16"),
    }


@contextlib.contextmanager
def stale_outputs():
    """Inside, every floating tensor torch.empty makes is filled with NaN:
    the memory a kernel's output lands on then holds no zeros by chance,
    and a row the kernel misses fails the check. (Filling a freed block
    and counting on the caching allocator to hand it back is not certain:
    a freed block coalesces with free neighbours.)"""
    import torch

    empty = torch.empty

    def nan_empty(*args, **kwargs):
        t = empty(*args, **kwargs)
        if t.is_floating_point():
            t.fill_(float("nan"))
        return t

    torch.empty = nan_empty
    try:
        yield
    finally:
        torch.empty = empty


def k5_check_case(label: str, x, w_in, w_out, dy, sizes, first: int, mutate: bool) -> dict:
    """Each K5 kernel against its plain version on one case (tgmm's dY the
    plain NT product), its output handed to it NaN-filled (stale_outputs):
    {name: (max |got - ref|, excess)}; with `mutate`, every K5_MUTATIONS
    entry's output must be rejected (raises otherwise) on each kernel's
    output at its own limits. (Not on tgmm's bf16 output: it is the f32
    output's sums rounded once, and a dropped row of a 4000-row sum moves
    an element less than the bf16 limit.)"""
    import torch

    from tf_operator_tpu_torch.ops import grouped_matmul as gm

    dtype_name = str(x.dtype).split(".")[1]
    dh = gm.gmm_reference(dy, w_out, sizes, first, trans_w=True)
    out, rejected = {}, {}
    for name, (kernel, plain, kind) in _k5_products(x, w_in, w_out, dy, dh, sizes,
                                                    first).items():
        with stale_outputs():
            got = kernel()
        if got.is_cuda:
            torch.cuda.synchronize()
        ref = plain()
        out[name] = ((got.float() - ref.float()).abs().max().item(),
                     k5_excess(got, ref, dtype_name, kind))
        if mutate and kind != "tgmm_bf16":
            w = w_in if name.endswith("nn") else w_out
            a = dy if name.endswith("nt") else x
            for what, alter in K5_MUTATIONS:
                if what == "a swapped group" and kind == "tgmm":
                    bad = ref[[1, 0, *range(2, ref.shape[0])]]
                else:
                    bad = plain(*alter(sizes, w, a))
                rejected[f"{name} {what}"] = k5_excess(bad, ref, dtype_name, kind)
        del got, ref
    accepted = [k for k, e in rejected.items() if not e > 1.0]
    if accepted:
        raise SmokeFailure(f"the K5 check accepts broken outputs: {accepted}")
    path = gm.route(x.dtype, x.shape[0], x.shape[1], w_in.shape[2], w_in.shape[0],
                    x.data_ptr(), w_in.data_ptr())
    log(f"moe: K5 {label} {dtype_name} ({path} route): (max abs err, excess) "
        + ", ".join(f"{n}=({e[0]:.3g}, {e[1]:.3g})" for n, e in out.items())
        + ("; mutations rejected, excess " + ", ".join(f"{k}={e:.3g}" for k, e in
                                                     rejected.items()) if mutate else ""))
    failed = [f"{label} {n}: excess {e[1]:.3g}" for n, e in out.items() if not e[1] <= 1.0]
    if failed:
        raise SmokeFailure("K5 disagrees with its plain version: " + "; ".join(failed))
    return out


def k5_bound(m_rows: int, k: int, n: int, groups: int) -> tuple[float, str]:
    """(bound_ms, bound_by) of one K5 launch at the cell: 2 m k n operations
    at the bf16 peak against its bytes, all bf16 (gmm: x [m, k], w [G, k, n]
    and out [m, n]; tgmm: x [m, k], dy [m, n] and dw [G, k, n], written in
    the weights' dtype as the trainer asks and as its ms is timed)."""
    t_ops = 2.0 * m_rows * k * n / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = 2.0 * (m_rows * k + groups * k * n + m_rows * n) / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _grouped_mm_ms(fn) -> float | str:
    """The library call's time, or its error where it refuses."""
    try:
        return time_ms(fn)
    except Exception as e:  # noqa: BLE001 — recorded: the card's torch may refuse it
        return f"{type(e).__name__}: {str(e)[:200]}"


def k5_check_phase(records: dict) -> None:
    """K5 against its plain version at the cell's products on routed
    operands (every K5_MUTATIONS entry rejected), at their other
    orientation (K 3072, N 768) and at K5_SMALL in bf16 and f32; then each
    kernel timed at the cell beside its bound, its plain
    version and torch._grouped_mm (the library yardstick, never called by
    the port), and at the cell's other orientation (K 3072, N 768). tgmm's
    ms is its bf16 output's, as the trainer's backward and
    torch._grouped_mm write it (ms_f32_out beside it); each record names
    the route its launches took and the SM count of the persistent grid."""
    import torch

    from tf_operator_tpu_torch.ops import grouped_matmul as gm

    gen = torch.Generator(device="cuda").manual_seed(2048)
    x, sizes, w_in, w_out = moe_routed_inputs(gen)
    m = x.shape[0]
    dy = torch.randn(m, MOE_HIDDEN, generator=gen, device="cuda").to(torch.bfloat16)
    log(f"moe: K5 at the cell, {m} routed rows, group sizes {sizes.tolist()}")
    cell = k5_check_case("cell", x, w_in, w_out, dy, sizes, 0, mutate=True)
    for dtype in (torch.bfloat16, torch.float32):
        for label, rows, k, n, gs, first, held in K5_SMALL:
            g = torch.Generator(device="cuda").manual_seed(rows)
            xs = torch.randn(rows, k, generator=g, device="cuda").to(dtype)
            wi = (torch.randn(held, k, n, generator=g, device="cuda") * k ** -0.5).to(dtype)
            wo = (torch.randn(held, n, k, generator=g, device="cuda") * k ** -0.5).to(dtype)
            dys = torch.randn(rows, k, generator=g, device="cuda").to(dtype)
            k5_check_case(label, xs, wi, wo, dys, torch.tensor(gs, device="cuda"), first,
                          mutate=False)
    dh = torch.randn(m, MOE_FFN, generator=gen, device="cuda").to(torch.bfloat16)
    # The trainer's other orientation, the experts' second product.
    k5_check_case("cell, K 3072, N 768", dh, w_out, w_in, dh, sizes, 0, mutate=False)
    products = _k5_products(x, w_in, w_out, dy, dh, sizes)
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    library = {"grouped_matmul_nn": lambda: torch._grouped_mm(x, w_in, offs=offs),
               "grouped_matmul_nt": lambda: torch._grouped_mm(dy, w_out.transpose(-2, -1),
                                                              offs=offs),
               "grouped_matmul_tgmm": lambda: torch._grouped_mm(x.t(), dh, offs=offs)}
    others = {"grouped_matmul_nn": lambda: gm.gmm(dh, w_out, sizes),
              "grouped_matmul_nt": lambda: gm.gmm(dh, w_in, sizes, trans_w=True),
              "grouped_matmul_tgmm": lambda: gm.tgmm(dh, dy, sizes, 0, MOE_EXPERTS),
              "grouped_matmul_tgmm_bf16": lambda: gm.tgmm(dh, dy, sizes, 0, MOE_EXPERTS,
                                                          torch.bfloat16)}
    b_ms, b_by = k5_bound(m, MOE_HIDDEN, MOE_FFN, MOE_EXPERTS)
    for name, _ in K5:
        timed = name + "_bf16" if name.endswith("tgmm") else name
        kernel, plain, _ = products[timed]
        gm.reset_launches()
        rec = {"ms": time_ms(kernel), "plain_ms": time_ms(plain, reps=2),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": _grouped_mm_ms(library[name]),
               "ms_k3072_n768": time_ms(others[timed]),
               "max_abs_err": cell[timed][0], "excess": cell[timed][1],
               "route": [r for r, c in gm.ROUTE_LAUNCHES.items() if c],
               # the persistent grid of the wgmma route: one block an SM
               "sm_count": torch.cuda.get_device_properties(0).multi_processor_count,
               "shape": {"rows": m, "k": MOE_HIDDEN, "n": MOE_FFN, "groups": MOE_EXPERTS},
               "group_sizes": sizes.tolist()}
        if timed != name:
            rec["ms_f32_out"] = time_ms(products[name][0])
            rec["f32_out_max_abs_err"], rec["f32_out_excess"] = cell[name]
        records.setdefault(name, {}).update(rec)
        log(f"moe: {name} at the cell: " + json.dumps(rec))


def moe_train_run(dispatch: str, card: str) -> dict:
    """bench.py's MoE cell through the trainer: a finite loss, K1, K2, K3
    and the delta pass once a layer a step and, under the sparse dispatch,
    each K5 kernel twice a MoE layer a step (the dense dispatch launches
    none); tokens/s, step time, peak memory and MFU (moe_flops_per_step).
    The launch counts are zeroed just before the run and read just after."""
    import torch

    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops import grouped_matmul as gm

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    gm.reset_launches()
    by = run_trainer(moe_argv(dispatch), tag=f"_{dispatch}")
    launches, k5, routes = dict(fa.LAUNCHES), dict(gm.LAUNCHES), dict(gm.ROUTE_LAUNCHES)
    n_moe = MOE_LAYERS // 2
    want = {key: MOE_LAYERS * MOE_STEPS for key in FLASH_LAUNCH_KEYS}
    want_k5 = {key: (2 * n_moe * MOE_STEPS if dispatch == "sparse" else 0) for _, key in K5}
    # The cell's products (K, N 768 and 3072) all take the wgmma route.
    want_routes = {"wgmma": sum(want_k5.values()), "mma": 0, "fma": 0}
    if launches != want or k5 != want_k5 or routes != want_routes:
        raise SmokeFailure(f"moe-lm {dispatch}: launches {launches}, K5 {k5} by route "
                           f"{routes}; want {want}, {want_k5}, {want_routes}")
    done = by["done"]
    eps = done.get("examples_per_sec")
    res = {"dispatch": dispatch, "seq": MOE_SEQ, "batch": MOE_BATCH, "layers": MOE_LAYERS,
           "steps": MOE_STEPS, "tokens_per_s": eps * MOE_SEQ if eps else None,
           "mfu": (moe_flops_per_step(MOE_BATCH, MOE_SEQ) * eps / MOE_BATCH
                   / PEAK_FLOPS["bfloat16"]) if eps else None,
           "step_time_s": (done.get("step_time_s") or {}).get("mean"),
           "startup_s": by["first_step"]["startup_s"],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_per_step": {k: n / MOE_STEPS for k, n in {**launches, **k5}.items()},
           "k5_launches_by_route": routes,
           "first_loss": by["first_step"]["loss"], "final_loss": done["final_loss"],
           "card": card}
    log("moe: " + json.dumps(res))
    return res


def moe_ep_job(dispatch: str, layers: int = MOE_EP_LAYERS) -> DistJob:
    """The MoE cell at `layers` layers (6 steps) as a DistJob: each K5
    kernel launches twice a MoE layer (every 2nd) a step under sparse."""
    return DistJob(f"moe-lm {dispatch} {layers} layers", tuple(moe_argv(dispatch, layers)),
                   MOE_SEQ, MOE_BATCH, MOE_STEPS, layers, MOE_HEADS, 1,
                   OUT_DIR / f"moe_reference_{dispatch}.pt", MOE_HIDDEN,
                   k5_per_step=(layers if dispatch == "sparse" else 0))


def moe_phase(records: dict, card: str) -> dict:
    """K5 (k5_check_phase); K1-K3 and delta at the cell's attention
    [8, 6, 2048, 128] bf16 causal (every MUTATIONS entry rejected, timed
    beside bound and SDPA); the cell through the trainer with both
    dispatches; and ep = 2 (both dispatches, two co-located gloo ranks at
    MOE_EP_LAYERS layers) held against one process, with the planted fault
    rejected."""
    import torch

    torch.cuda.empty_cache()
    k5_check_phase(records)
    shape_kernel_check(records, [MOE_SHAPE], "moe", 2048, causal=True)
    out = {"runs": [moe_train_run(d, card) for d in ("sparse", "dense")]}
    for name, key in K5:
        records[name]["launches"] = int(out["runs"][0]["launches_per_step"][key] * MOE_STEPS)
    for dispatch in ("sparse", "dense"):
        job = moe_ep_job(dispatch)
        ref, reference = one_process(card, job)
        try:
            out[f"ep_{dispatch}"] = {
                "reference": reference, "runs": held_against(ref, MOE_EP_RUNS, "gloo", False,
                                                             card, job),
                "fault_control": (fault_control(ref, MOE_EP_FAULT, job)
                                  if dispatch == "sparse" else None)}
        finally:
            job.ref.unlink(missing_ok=True)
    return out


# The serve phase (A13): the port's inference server on the card with the
# full-width LM the trainer trains (bench.py:1006-1019's LM, 12 x 768, 6
# heads x 128, vocab 32000), at a 2048-token window: the controller's env,
# 8 KV slots, 128 new tokens at most. `a_lengths`: one request of 8 rows
# spread over the seq buckets (sorted admission); `b_*`: 24 concurrent
# single-row requests over the 8 slots (continuous admission).
# `check_lengths`: the prompts whose decode ticks are held against a
# prefill of the same context (short ones, where one position carries a
# visible share of the attention, and a long one); `chain_lengths`: the f32
# greedy chains held against a naive re-forward.
@dataclasses.dataclass(frozen=True)
class ServeCell:
    layers: int = 12
    hidden: int = 768
    heads: int = 6
    vocab: int = 32000
    seq: int = 2048
    slots: int = 8
    max_new: int = 128
    batch_max: int = 8
    a_lengths: tuple = (17, 45, 120, 300, 640, 1024, 1500, 1984)
    a_new: int = 64
    b_requests: int = 24
    b_new: tuple = (8, 128, 16, 96, 32, 64)  # cycled over the requests
    b_length_range: tuple = (5, 400)
    forward_lengths: tuple = (17, 300, 1984)
    check_lengths: tuple = (1, 3, 11, 1500)
    ticks: int = 4
    chain_lengths: tuple = (5, 20, 100)
    chain_tokens: int = 16
    train_batch: int = 4
    train_steps: int = 2
    device: str = "cuda"


SERVE = ServeCell()
SERVE_DIR = OUT_DIR / "serve"
# bf16 limits of the in-process checks, on max |got - ref| / rms(ref) over
# the checked logits (`rel_err`), placed between the sound readings and
# those of SERVE_FAULTS, which must each exceed one. On an H100: sound
# 0.031 for both; the faults 0.43 and 0.42 (tick against prefill) and 0.32
# (prefill against the forward).
SERVE_LIMITS = {"prefill_vs_forward": 0.1, "tick_vs_prefill": 0.1}
# The server's answers are held to the in-process chains up to the first
# position whose reference top-2 logit margin is below this (a bf16 near
# tie, which rounding may break either way; logit units).
SERVE_MARGIN = 0.05
# Broken decode paths the checks must reject: (what is broken, the
# models/decode.py helper replaced).
SERVE_FAULTS = (("decode visibility < in place of <=", "visible_mask"),
                ("the tick's K/V written at position + 1", "write_token_kv"),
                ("prefill's logits taken at lengths, not lengths - 1", "last_index"))


@contextlib.contextmanager
def planted(helper: str | None):
    """models/decode.py with one SERVE_FAULTS helper broken (None: as it
    is), restored on exit."""
    import torch

    from tf_operator_tpu_torch.models import decode

    orig = getattr(decode, helper) if helper else None
    broken = {
        None: None,
        "visible_mask": lambda positions, max_len: (
            torch.arange(max_len, device=positions.device)[None] < positions[:, None]),
        "write_token_kv": lambda cache, layer, positions, kv: orig(
            cache, layer, (positions + 1).clamp_max(cache.shape[3] - 1), kv),
        "last_index": lambda lengths: lengths,
    }[helper]
    if helper:
        setattr(decode, helper, broken)
    try:
        yield
    finally:
        if helper:
            setattr(decode, helper, orig)


def rel_err(got, ref) -> float:
    """max |got - ref| / rms(ref), in f32."""
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.square().mean().sqrt())


def top2_margin(logits):
    """The gap between each row's two largest logits."""
    top = logits.float().topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def serve_train_argv(cell: ServeCell, ckpt_dir) -> list[str]:
    """The port trainer writing the phase's checkpoint: f32 parameters and
    moments, the cell's widths, position table `seq`."""
    return ["--model", "transformer-lm", "--steps", str(cell.train_steps),
            "--batch", str(cell.train_batch), "--seq", str(cell.seq),
            "--layers", str(cell.layers), "--hidden", str(cell.hidden),
            "--heads", str(cell.heads), "--log-every", "1", "--device", cell.device,
            "--checkpoint-dir", str(ckpt_dir)]


def serve_env(cell: ServeCell, ckpt_dir, port: int, files: dict) -> dict:
    """The env the InferenceService controller gives a server pod (and the
    pod's heartbeat, stats and events files)."""
    return {"TPUJOB_SERVE_MODEL": "transformer-lm",
            "TPUJOB_SERVE_CHECKPOINT_DIR": str(ckpt_dir),
            "TPUJOB_SERVE_PORT": str(port), "TPUJOB_SERVE_LISTEN_PORT": str(port),
            "TPUJOB_SERVE_MAX_SEQ_LEN": str(cell.seq),
            "TPUJOB_SERVE_MAX_CONCURRENT_SEQS": str(cell.slots),
            "TPUJOB_SERVE_MAX_NEW_TOKENS": str(cell.max_new),
            "TPUJOB_SERVE_BATCH_MAX": str(cell.batch_max),
            "TPUJOB_SERVE_BATCH_TIMEOUT_MS": "5.0",
            "TPUJOB_SERVE_NUM_HEADS": str(cell.heads),
            "TPUJOB_SERVE_DEVICE": cell.device,
            "TPUJOB_POD_NAME": "chip-smoke-serve-0",
            "TPUJOB_SERVE_STATS_FILE": str(files["stats"]),
            "TPUJOB_HEARTBEAT_FILE": str(files["heartbeat"]),
            "TPUJOB_METRICS_FILE": str(files["events"])}


def serve_requests(cell: ServeCell, seed: int = 0):
    """(a's rows, [(row, maxNewTokens)] of b), token ids from the seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    a = [rng.integers(0, cell.vocab, n).tolist() for n in cell.a_lengths]
    lo, hi = cell.b_length_range
    b = [(rng.integers(0, cell.vocab, int(rng.integers(lo, hi))).tolist(),
          cell.b_new[i % len(cell.b_new)]) for i in range(cell.b_requests)]
    return a, b


def _padded(rows, t: int, device):
    import torch

    tok = torch.zeros((len(rows), t), dtype=torch.int64)
    for i, r in enumerate(rows):
        tok[i, :len(r)] = torch.tensor(r)
    return tok.to(device), torch.tensor([len(r) for r in rows])


def decode_readings(host: dict, cell: ServeCell, seed: int = 1) -> dict:
    """The bf16 decode path against references, in this process:
    `prefill_vs_forward`, prefill's last logits against the port's
    TransformerLM forward (the flash kernels on the card) at rows of
    `forward_lengths`; `tick_vs_prefill`, each of `ticks` decode ticks'
    logits for prompts of `check_lengths` against a prefill of the same
    context. Both as rel_err."""
    import numpy as np
    import torch

    from tf_operator_tpu_torch.models import decode
    from tf_operator_tpu_torch.models import transformer as tfm
    from tf_operator_tpu_torch.parallel.ring_attention import make_attention_fn

    dev = torch.device(cell.device)
    cfg = decode.config_from_params(host, num_heads=cell.heads)
    params = decode.prepare_params({k: v.to(dev) for k, v in host.items()}, cfg)
    rng = np.random.default_rng(seed)
    out = {}
    with torch.inference_mode():
        rows = [rng.integers(0, cfg.vocab_size, n).tolist() for n in cell.forward_lengths]
        tokens, lengths = _padded(rows, cell.seq, dev)
        if int(lengths.max()) >= cell.seq:
            raise SmokeFailure("the forward check's rows must be shorter than the window")
        model = tfm.TransformerLM(dataclasses.replace(cfg, max_len=cell.seq),
                                  attn_fn=make_attention_fn(None, causal=True), device=dev)
        model.load_state_dict(host)
        want = model(tokens)[torch.arange(len(rows)), lengths.to(dev) - 1]
        del model
        got = decode.prefill(params, tokens, lengths, cfg)[3]
        out["prefill_vs_forward"] = rel_err(got, want)

        prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in cell.check_lengths]
        n = len(prompts)
        k, v = decode.init_kv_cache(cfg, n + 1, cell.seq, dev)
        # Every prefill here pads past its longest row, so that the planted
        # last_index fault reads a pad position, not past the tensor.
        tok, lens = _padded(prompts, max(cell.check_lengths) + 1, dev)
        _, _, first, _ = decode.prefill_into_slots(params, k, v, tok, lens, list(range(n)), cfg)
        fed = [[int(x)] for x in first.cpu()]
        positions = np.array(list(cell.check_lengths) + [0], np.int64)
        errs = []
        for _ in range(cell.ticks):
            last = torch.tensor([f[-1] for f in fed] + [0])
            _, _, nxt, logits = decode.decode_step(params, k, v, last, positions, cfg)
            ctx = [p + f for p, f in zip(prompts, fed)]
            ctok, clens = _padded(ctx, max(len(c) for c in ctx) + 1, dev)
            ref = decode.prefill(params, ctok, clens, cfg)[3]
            errs.append(rel_err(logits[:n], ref))
            for f, t in zip(fed, nxt.cpu().tolist()):
                f.append(t)
            positions[:n] += 1
        out["tick_vs_prefill"] = max(errs)
    return out


def f32_chains(host: dict, cell: ServeCell, seed: int = 2) -> dict:
    """Greedy chains at cfg.dtype f32 through prefill_into_slots and
    decode_step against a naive f32 re-forward (the port's TransformerLM,
    plain attention), for prompts of `chain_lengths`, `chain_tokens` each:
    the chains, and whether they are equal token for token."""
    import numpy as np
    import torch

    from tf_operator_tpu_torch.models import decode
    from tf_operator_tpu_torch.models import transformer as tfm

    dev = torch.device(cell.device)
    cfg = dataclasses.replace(decode.config_from_params(host, num_heads=cell.heads),
                              dtype=torch.float32)
    params = {k: v.to(dev) for k, v in host.items()}
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in cell.chain_lengths]
    with torch.inference_mode():
        model = tfm.TransformerLM(dataclasses.replace(cfg, max_len=cell.seq), device=dev)
        model.load_state_dict(host)
        naive, margins = [], []
        for p in prompts:
            seq, row = list(p), []
            for _ in range(cell.chain_tokens):
                logits = model(torch.tensor([seq], device=dev))[0, -1]
                margins.append(float(top2_margin(logits)))
                row.append(int(logits.argmax()))
                seq.append(row[-1])
            naive.append(row)
        del model
        n = len(prompts)
        k, v = decode.init_kv_cache(cfg, n + 1, cell.seq, dev)
        tok, lens = _padded(prompts, max(cell.chain_lengths), dev)
        _, _, first, _ = decode.prefill_into_slots(params, k, v, tok, lens, list(range(n)), cfg)
        got = [[int(x)] for x in first.cpu()]
        positions = np.array(list(cell.chain_lengths) + [0], np.int64)
        for _ in range(cell.chain_tokens - 1):
            last = torch.tensor([g[-1] for g in got] + [0])
            _, _, nxt, _ = decode.decode_step(params, k, v, last, positions, cfg)
            for g, t in zip(got, nxt.cpu().tolist()):
                g.append(t)
            positions[:n] += 1
    return {"equal": got == naive, "chains": got, "naive": naive,
            "min_margin": min(margins)}


def reference_answers(ckpt_dir, cell: ServeCell, rows, max_new: int) -> dict:
    """One request of `rows` through an InferenceServer in this process
    (the server's own load, scheduler and decode functions at its bucket
    shapes): its answers, each row's top-2 margins along its chain, the
    prefill and tick times (each call synchronised) and the peak device
    memory of the load and the run."""
    import torch

    from tf_operator_tpu_torch.serve import server as srv_mod

    dev = torch.device(cell.device)
    os.environ["TPUJOB_SERVE_NUM_HEADS"] = str(cell.heads)
    try:
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            base_reserved = torch.cuda.memory_reserved()
        srv = srv_mod.InferenceServer(
            "transformer-lm", str(ckpt_dir), 0, batch_max=cell.batch_max,
            batch_timeout_ms=5.0, max_seq_len=cell.seq, max_new_tokens=cell.max_new,
            max_slots=cell.slots, device=cell.device)
        t0 = time.perf_counter()
        srv.load()
        load_s = time.perf_counter() - t0
    finally:
        os.environ.pop("TPUJOB_SERVE_NUM_HEADS", None)
    fns = {"prefill_fn": srv._prefill_fn, "decode_fn": srv._decode_fn}
    margins: dict = {}  # slot -> the top-2 margins of its chain so far
    times = {"prefill": [], "tick": []}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def timed(kind, fn):
        def call(params, k, v, tokens, *rest):
            sync()
            t0 = time.perf_counter()
            out = fn(params, k, v, tokens, *rest)
            sync()
            times[kind].append(time.perf_counter() - t0)
            m = top2_margin(out[3]).cpu().tolist()
            if kind == "prefill":  # rows land in slots rest[1], each a new chain
                for s, x in zip(rest[1], m):
                    margins[int(s)] = [x]
            else:
                for s in margins:
                    margins[s].append(m[s])
            return out
        return call

    srv._prefill_fn = timed("prefill", srv._prefill_fn)
    srv._decode_fn = timed("tick", srv._decode_fn)
    item = srv_mod._Pending([list(r) for r in rows], max_new=max_new)
    srv._shift_inflight(+1)
    srv.queue.submit(item)
    srv.queue.close()
    threads = srv.start_pipeline()
    if not item.event.wait(600):
        raise SmokeFailure("the in-process server never answered")
    for t in threads:
        t.join(60)
    if item.error:
        raise SmokeFailure(f"the in-process server failed: {item.error}")
    # Admission sorted the rows by length (stable) into slots 0, 1, ...
    order = sorted(range(len(rows)), key=lambda i: len(rows[i]))
    row_margins = [None] * len(rows)
    for slot, i in enumerate(order):
        row_margins[i] = margins[slot][:max_new]
    cuda = dev.type == "cuda"
    return {"answers": item.result, "margins": row_margins, "times": times, "load_s": load_s,
            "peak_bytes": torch.cuda.max_memory_allocated() - base if cuda else None,
            "peak_reserved_bytes": torch.cuda.max_memory_reserved() - base_reserved
            if cuda else None,
            "kv_bytes": sum(t.numel() * t.element_size() for t in srv._kv),
            "cfg": srv._decode_cfg, "params": srv._live[0], "kv": srv._kv,
            "route": getattr(srv, "route", "eager"), "graphs": getattr(srv, "_graphs", None),
            **fns}


def _tick_profile(fn, params, k, v, last, positions, ticks: int) -> tuple[dict, list, list]:
    """`ticks` calls of a tick function under torch.profiler, each ending in
    the host copy of its next tokens as the scheduler's does: the device's
    busy ms a tick, the idle share of the window from the first device
    event's start to the last one's end, device events a tick, the longest
    kernels; and the profiler's raw device and host runtime events."""
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    fn(params, k, v, last, positions)[2].cpu()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            fn(params, k, v, last, positions)[2].cpu()
    torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    window = (max(e.time_range.end for e in events) - events[0].time_range.start) / 1e3
    by_name: dict[str, float] = {}
    for e in events:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + ms / ticks
    busy = sum(by_name.values()) * ticks
    raw = prof.profiler.kineto_results.events()
    device = [(e.name(), e.start_ns(), e.correlation_id()) for e in raw
              if e.device_type() == DeviceType.CUDA]
    host = [(e.name(), e.correlation_id()) for e in raw
            if e.device_type() == DeviceType.CPU and e.name().startswith(("cuda", "cu"))]
    return ({"device_ms_per_tick": busy / ticks, "window_ms_per_tick": window / ticks,
             "idle_share": 1.0 - busy / window, "launches_per_tick": len(events) / ticks,
             "top_kernels_ms_per_tick": dict(sorted(by_name.items(),
                                                    key=lambda kv: -kv[1])[:6])},
            device, host)


COPY_EVENTS = ("Memcpy", "Memset")


def tick_census(device: list, host: list, ticks: int) -> dict:
    """Which host call launched the device work of `ticks` profiled ticks
    (_tick_profile's raw events: device events as (name, start, correlation
    id), host runtime calls as (name, correlation id)): each host call's
    count a tick; the cudaGraphLaunch calls (the host records, and the
    correlation ids of kernels whose host record the profile lacks); and
    the device kernels (not copies) by the host call behind them,
    "unattributed" where the profile holds none. Counted over the whole
    profile, not cut into whole ticks by a marker as launch_census cuts a
    trainer's steps: a profile may miss events (one of a default run's held
    6563 device events for 10 ticks of 661)."""
    runtime = {corr: name for name, corr in host}
    calls: dict[str, int] = {}
    for name, _ in host:
        calls[name] = calls.get(name, 0) + 1
    kernels: dict[str, int] = {}
    graphs = {corr for name, corr in host if name == GRAPH_LAUNCH}
    for name, _, corr in device:
        if name.startswith(COPY_EVENTS):
            continue
        api = runtime.get(corr, "unattributed")
        kernels[api] = kernels.get(api, 0) + 1
        if api == "unattributed":
            graphs.add(corr)
    return {"ticks": ticks, "graph_launches": len(graphs),
            "device_events_per_tick": len(device) / ticks,
            "host_calls_per_tick": {k: n / ticks for k, n in calls.items()},
            "kernels_by_launch_api": kernels}


def tick_census_failures(census: dict) -> list[str]:
    """A graphed tick: one cudaGraphLaunch a tick, and no kernel launched
    by any other host call (the static inputs' and the next tokens' copies
    aside; a kernel whose host record the profile lacks is not counted
    against it)."""
    fails = []
    if census["graph_launches"] != census["ticks"]:
        fails.append(f"{census['graph_launches']} cudaGraphLaunch calls over "
                     f"{census['ticks']} ticks")
    other = {api: n for api, n in census["kernels_by_launch_api"].items()
             if api not in (GRAPH_LAUNCH, "unattributed")}
    if other:
        fails.append(f"kernels launched outside the graph: {other}")
    return fails


def device_profile(ref: dict, cell: ServeCell, rows, ticks: int = 10) -> dict:
    """On the server's weights and cache, in this process, the server's own
    decode functions (ref's prefill_fn and decode_fn: the graphed ones on
    the graph route) beside the eager models/decode.py functions: three
    synchronised prefills of `rows` at the bucket the server gave them with
    each (their seconds, `prefill_s`), 20 synchronised ticks of each in
    turn, every slot at mid-window (`tick_ms`), then `ticks` ticks of each
    under torch.profiler (_tick_profile: `tick` the server's, `eager_tick`)
    and, on the graph route, the server's tick census (tick_census)."""
    import functools

    import numpy as np
    import torch

    from tf_operator_tpu_torch.models import decode
    from tf_operator_tpu_torch.serve.server import select_bucket, seq_bucket_sizes

    params, (k, v), cfg = ref["params"], ref["kv"], ref["cfg"]
    fns = {"server": (ref["prefill_fn"], ref["decode_fn"]),
           "eager": (functools.partial(decode.prefill_into_slots, cfg=cfg),
                     functools.partial(decode.decode_step, cfg=cfg))}
    rows = sorted(rows, key=len)
    tokens, lengths = _padded(rows, select_bucket(len(rows[-1]), seq_bucket_sizes(cell.seq)),
                              "cpu")
    ids = list(range(len(rows)))
    prefill_s = {kind: [] for kind in fns}
    tick_ms = {kind: [] for kind in fns}
    last = np.arange(cell.slots + 1) + 100
    positions = np.array([cell.seq // 2] * cell.slots + [0])
    out = {"census": None}
    with torch.inference_mode():
        for _ in range(3):
            for kind, (prefill_fn, _) in fns.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prefill_fn(params, k, v, tokens, lengths, ids)[2].cpu()
                prefill_s[kind].append(time.perf_counter() - t0)
        for _ in range(20):
            for kind, (_, tick_fn) in fns.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tick_fn(params, k, v, last, positions)[2].cpu()
                tick_ms[kind].append((time.perf_counter() - t0) * 1e3)
        for kind, (_, tick_fn) in fns.items():
            out[kind], device, host = _tick_profile(tick_fn, params, k, v, last, positions,
                                                    ticks)
            if kind == "server" and ref["route"] == "graph":
                out["census"] = tick_census(device, host, ticks)
    return {"prefill_s": prefill_s, "tick_ms": tick_ms, "tick": out["server"],
            "eager_tick": out["eager"], "tick_census": out["census"]}


# The serve graph check: the grid points held (the smallest, one between,
# the largest), the ticks at every slot before one slot is parked, and the
# planted faults, each (what it breaks, its name in
# planted_serve_graph_fault, the first word of the failures that must name
# it).
SERVE_GRAPH_POINTS = ((1, 16), (4, 256), (8, 2048))
SERVE_GRAPH_TICKS = 16
SERVE_GRAPH_FAULTS = (("a swap that does not copy into the captured parameters",
                       "no-swap-copy", "swap"),
                      ("a tick whose positions are not copied into its static input",
                       "stale-positions", "tick"))


@contextlib.contextmanager
def planted_serve_graph_fault(fault: str):
    """no-swap-copy: GraphedDecode.adopt hands back the captured dict
    without copying the new weights into it. stale-positions: the tick's
    positions are left out of its pinned staging buffer, so the static
    input keeps the previous tick's."""
    from tf_operator_tpu_torch.serve import decode_graphs

    if fault == "no-swap-copy":
        real = decode_graphs.GraphedDecode.adopt
        decode_graphs.GraphedDecode.adopt = lambda self, new: self.params
        try:
            yield
        finally:
            decode_graphs.GraphedDecode.adopt = real
    elif fault == "stale-positions":
        real = decode_graphs.stage

        def stage(static, values):
            real(static, {k: a for k, a in values.items() if k != "positions"})

        decode_graphs.stage = stage
        try:
            yield
        finally:
            decode_graphs.stage = real
    else:
        raise ValueError(f"unknown serve graph fault {fault!r}")


def serve_graph_run(graphs, points, ticks: int = SERVE_GRAPH_TICKS, seed: int = 4,
                    record: dict | None = None) -> list[str]:
    """The graphed prefill and tick of a loaded server (its GraphedDecode)
    against the eager decode.prefill_into_slots and decode_step on a copy
    of the same cache: prefills at each of `points` (rows, tokens), the
    last filling every slot but the scratch (the rest padded into it);
    `ticks` ticks over those slots with the scratch parked at position 0,
    then 4 with the first active slot retired and parked there too; then a swap to
    perturbed weights (the graph's through GraphedDecode.adopt, as the
    server's dispatch thread swaps, the eager side's the new dict), the
    last point prefilled again and 4 ticks. Returns the failures, each
    named by its step (`prefill (r, t)`, `tick i`, `swap: ...`): next
    tokens, logits or a cache not bit-equal. The captured weights are
    restored at the end. `record` gets the swap's copy ms."""
    import numpy as np
    import torch

    from tf_operator_tpu_torch.models import decode

    params, cfg, k, v = graphs.params, graphs.cfg, graphs.k, graphs.v
    slots, window = k.shape[1], k.shape[3]
    scratch = slots - 1
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=k.device).manual_seed(seed)
    ek, ev = k.clone(), v.clone()
    fails: list[str] = []

    def held(what, got, want):
        for name, a, b in (("next tokens", got[2], want[2]), ("logits", got[3], want[3])):
            if not torch.equal(a, b):
                fails.append(f"{what}: {name} differ (max |d| "
                             f"{float((a.float() - b.float()).abs().max()):.4g})")
        for name, a, b in (("K", k, ek), ("V", v, ev)):
            if not torch.equal(a, b):
                fails.append(f"{what}: the {name} cache differs")

    def prefill(eager_params, rb, tb, top, prefix):
        n = min(rb, scratch)
        lengths = np.ones(rb, np.int64)
        lengths[:n] = rng.integers(1, min(tb, top) + 1, n)
        tokens = np.zeros((rb, tb), np.int64)
        for i in range(n):
            tokens[i, :lengths[i]] = rng.integers(0, cfg.vocab_size, lengths[i])
        ids = np.full(rb, scratch, np.int64)
        ids[:n] = rng.permutation(scratch)[:n]
        got = graphs.prefill(params, k, v, tokens, lengths, ids)
        want = decode.prefill_into_slots(eager_params, ek, ev, tokens, lengths, ids, cfg)
        held(f"{prefix}prefill ({rb}, {tb})", got, want)
        last = np.zeros(slots, np.int64)
        pos = np.zeros(slots, np.int64)
        last[ids[:n]] = want[2][:n].cpu().numpy()
        pos[ids[:n]] = lengths[:n]
        return last, pos

    def tick(eager_params, last, pos, n, prefix, park=None):
        for i in range(n):
            if park is not None and i == n - 4:
                last[park] = pos[park] = 0
            got = graphs.decode(params, k, v, last, pos)
            want = decode.decode_step(eager_params, ek, ev, last, pos, cfg)
            held(f"{prefix}tick {i + 1}", got, want)
            active = pos > 0
            last = np.where(active, want[2].cpu().numpy(), 0)
            pos = np.where(active, pos + 1, 0)

    top = window - ticks - 6
    with torch.inference_mode():
        for rb, tb in points:
            last, pos = prefill(params, rb, tb, top, "")
        tick(params, last, pos, ticks + 4, "", park=int(np.flatnonzero(pos)[0]))
        kept = {name: t.clone() for name, t in params.items()}
        new = {name: (t.float() + 0.02 * t.float().std()
                      * torch.randn(t.shape, generator=gen, device=t.device)).to(t.dtype)
               for name, t in params.items()}
        if k.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if graphs.adopt(new) is not params:
            fails.append("swap: adopt did not hand back the captured dict")
        if k.is_cuda:
            torch.cuda.synchronize()
        if record is not None:
            record["swap_copy_ms"] = (time.perf_counter() - t0) * 1e3
            record["swap_bytes"] = sum(t.numel() * t.element_size() for t in params.values())
        rb, tb = points[-1]
        last, pos = prefill(new, rb, tb, top, "swap: ")
        tick(new, last, pos, 4, "swap: ")
        graphs.adopt(kept)
    return fails


def serve_graph_check(graphs, card: str) -> dict:
    """The serve graph check (module docstring, phase 14): the sound run,
    then each planted fault, which must fail by its name."""
    record: dict = {}
    fails = serve_graph_run(graphs, SERVE_GRAPH_POINTS, record=record)
    if fails:
        raise SmokeFailure("serve graph check: the graphed decode differs from the eager "
                           "functions: " + "; ".join(fails[:6]))
    faults = {}
    for label, fault, must in SERVE_GRAPH_FAULTS:
        with planted_serve_graph_fault(fault):
            got = serve_graph_run(graphs, SERVE_GRAPH_POINTS)
        if not any(f.startswith(must) for f in got):
            raise SmokeFailure(f"serve graph check: the planted fault '{label}' was not "
                               f"rejected by '{must}': {got[:4]}")
        faults[fault] = {"failures": len(got), "first": got[:2]}
    res = {"points": [list(p) for p in SERVE_GRAPH_POINTS], "ticks": SERVE_GRAPH_TICKS + 4,
           "bit_equal": True, "faults_rejected": faults, **record, "card": card}
    log("serve graph: " + json.dumps(res))
    return res


def held_answers(got, want, margins, tol: float = SERVE_MARGIN) -> dict:
    """Each row of `got` against `want` up to (not including) the first
    position whose reference margin is below tol: the positions compared
    and the first disagreement inside them (None when they all agree)."""
    compared, mismatch = 0, None
    for r, (g, w, m) in enumerate(zip(got, want, margins)):
        if len(g) != len(w):
            mismatch = mismatch or (r, "length", len(g), len(w))
            continue
        stop = next((i for i, x in enumerate(m) if x < tol), len(w))
        bad = next((i for i in range(stop) if g[i] != w[i]), None)
        if bad is not None:
            mismatch = mismatch or (r, bad, g[bad], w[bad])
        compared += stop
    return {"compared": compared, "of": sum(len(w) for w in want), "mismatch": mismatch,
            "identical": got == want}


def tick_bound_bytes(params: dict, cfg, slots: int, max_len: int) -> int:
    """Bytes one decode tick must move: every weight as the tick reads it
    (the dense weights in the compute dtype, LayerNorm parameters, the
    `slots` rows of both embedding tables), the whole KV cache (attention
    reads every position of every slot), this tick's K/V writes and the
    f32 logits."""
    item = {"float32": 4, "bfloat16": 2}[str(cfg.dtype).removeprefix("torch.")]
    total = 0
    for name, t in params.items():
        if name in ("trunk.embed.weight", "trunk.pos_embed.weight"):
            total += slots * t.shape[1] * t.element_size()
        else:
            total += t.numel() * t.element_size()
    cache = 2 * cfg.num_layers * slots * cfg.num_heads * max_len * cfg.head_dim * item
    writes = 2 * cfg.num_layers * slots * cfg.hidden * item
    return total + cache + writes + slots * cfg.vocab_size * 4


def _post(port: int, body: dict, timeout: float = 120.0) -> tuple[int, dict, float]:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), time.perf_counter() - t0


def _percentile(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))]


def run_server(cell: ServeCell, ckpt_dir, a_rows, b_reqs, tree: Path = ROOT) -> dict:
    """The server as a pod runs it (`python -m
    tf_operator_tpu_torch.serve.server` with the controller's env, from the
    checkout `tree`): time to ready; request a (the rows, a_new tokens) and
    then b (concurrent single rows); SIGTERM, which must drain to exit 0
    with a done event. Fails on any answer that is not a 200 with its full
    token count."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor as Pool

    SERVE_DIR.mkdir(parents=True, exist_ok=True)
    files = {k: SERVE_DIR / f"server.{k}" for k in ("stats", "heartbeat", "events", "log")}
    for f in files.values():
        f.unlink(missing_ok=True)
    port = free_port()
    env = dict(os.environ, **serve_env(cell, ckpt_dir, port, files),
               PYTHONPATH=str(tree) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    with open(files["log"], "w") as logf:
        proc = subprocess.Popen([sys.executable, "-m", "tf_operator_tpu_torch.serve.server"],
                                cwd=tree, env=env, stdout=logf, stderr=subprocess.STDOUT)
    try:
        ready_s = None
        while time.perf_counter() - t0 < 300 and proc.poll() is None:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2) as r:
                    if json.loads(r.read()).get("ok"):
                        ready_s = time.perf_counter() - t0
                        break
            except OSError:
                pass
            time.sleep(0.1)
        if ready_s is None:
            raise SmokeFailure(f"the server never became ready (exit {proc.poll()}): "
                               + files["log"].read_text()[-2000:])
        code, a_resp, a_s = _post(port, {"instances": a_rows, "maxNewTokens": cell.a_new})
        if code != 200 or [len(p) for p in a_resp.get("predictions", [])] != \
                [cell.a_new] * len(a_rows):
            raise SmokeFailure(f"request a answered {code}: {str(a_resp)[:300]}")
        with Pool(len(b_reqs)) as pool:
            b_out = list(pool.map(lambda rq: _post(port, {"instances": [rq[0]],
                                                          "maxNewTokens": rq[1]}), b_reqs))
        bad = [(i, c, str(r)[:200]) for i, ((_, n), (c, r, _)) in enumerate(zip(b_reqs, b_out))
               if c != 200 or [len(p) for p in r.get("predictions", [])] != [n]]
        if bad:
            raise SmokeFailure(f"requests of b not answered in full: {bad[:3]}")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
            metrics = r.read().decode()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    events = [json.loads(x) for x in files["events"].read_text().splitlines()]
    names = [e["event"] for e in events]
    stats = json.loads(files["stats"].read_text())  # the drain's final snapshot
    if rc != 0 or names[:2] != ["start", "serve_ready"] or names[-1] != "done":
        raise SmokeFailure(f"the server's SIGTERM drain exited {rc} with events {names}")
    b_lat = [s for _, _, s in b_out]
    return {"ready_s": ready_s, "a_answers": a_resp["predictions"], "a_s": a_s,
            "b_p50_s": _percentile(b_lat, 0.5), "b_p99_s": _percentile(b_lat, 0.99),
            "b_tokens": sum(n for _, n in b_reqs), "stats": stats,
            "metrics_families": sorted({ln.split()[2] for ln in metrics.splitlines()
                                        if ln.startswith("# TYPE")}),
            "done": events[-1]}


def serve_phase(card: str, cell: ServeCell = SERVE) -> dict:
    """A13 on the card: the port trainer writes the cell's checkpoint; the
    server serves requests a and b from it as a pod would; in this process
    the decode path is held against the port's forward and against itself
    (decode_readings, within SERVE_LIMITS, each of SERVE_FAULTS rejected),
    the f32 chains against a naive re-forward, and the server's answers to
    a against the same request through the server's code here
    (held_answers). Logs time to ready, prefill and decode tokens/s, tick
    ms against its bound, request latencies and memory."""
    import torch

    from tf_operator_tpu_torch.models import checkpoint as ckpt
    from tf_operator_tpu_torch.ops import flash_attention as fa

    ckpt_dir = SERVE_DIR / "ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    run_trainer(serve_train_argv(cell, ckpt_dir), tag="_serve")
    a_rows, b_reqs = serve_requests(cell)
    served = run_server(cell, ckpt_dir, a_rows, b_reqs)
    log(f"serve: ready in {served['ready_s']:.3f} s; request a (8 rows) {served['a_s']:.3f} s; "
        f"b ({len(b_reqs)} concurrent, {served['b_tokens']} tokens) latency p50 "
        f"{served['b_p50_s'] * 1e3:.3f} ms p99 {served['b_p99_s'] * 1e3:.3f} ms; server "
        f"stats p50/p99 {served['stats']['latency_p50_ms']}/{served['stats']['latency_p99_ms']}"
        f" ms, decode_steps {served['stats']['decode_steps']}, tokens "
        f"{served['stats']['tokens_total']} [{card}]")

    ref = reference_answers(ckpt_dir, cell, a_rows, cell.a_new)
    held = held_answers(served["a_answers"], ref["answers"], ref["margins"])
    if held["mismatch"] is not None:
        raise SmokeFailure(f"the server's answers to a differ from the in-process chains: {held}")
    prefill_first_s = ref["times"]["prefill"][-1]  # the server's own call
    if cell.device == "cuda" and ref["route"] != "graph":
        raise SmokeFailure(f"the server on CUDA took the {ref['route']} route")
    prof = device_profile(ref, cell, a_rows) if cell.device == "cuda" else None
    prefill_s = sum(prof["prefill_s"]["server"]) / 3 if prof else prefill_first_s
    ticks = ref["times"]["tick"]
    tick_ms = sorted(t * 1e3 for t in ticks)
    bound_bytes = tick_bound_bytes(ref["params"], ref["cfg"], cell.slots + 1, cell.seq)
    rec = {
        "ready_s": served["ready_s"],
        "prefill_tokens_per_s": sum(cell.a_lengths) / prefill_s,
        "prefill_ms": prefill_s * 1e3, "prefill_first_ms": prefill_first_s * 1e3,
        "decode_tokens_per_s": len(a_rows) / (sum(ticks) / len(ticks)),
        "tick_ms": {"mean": sum(tick_ms) / len(tick_ms), "p50": _percentile(tick_ms, 0.5),
                    "p99": _percentile(tick_ms, 0.99), "n": len(tick_ms)},
        "tick_bound_ms": bound_bytes / PEAK_BYTES_PER_S * 1e3, "tick_bound_bytes": bound_bytes,
        "b_latency_ms": {"p50": served["b_p50_s"] * 1e3, "p99": served["b_p99_s"] * 1e3},
        "server_stats": {k: served["stats"][k] for k in (
            "served_total", "decode_steps", "tokens_total", "pad_efficiency",
            "latency_p50_ms", "latency_p99_ms")},
        "kv_bytes": ref["kv_bytes"], "peak_bytes": ref["peak_bytes"],
        "peak_reserved_bytes": ref["peak_reserved_bytes"], "load_s": ref["load_s"],
        "route": ref["route"], "answers_held": held,
    }
    if prof:
        census = prof["tick_census"]
        rec.update(tick_profile=prof["tick"], eager_tick_profile=prof["eager_tick"],
                   tick_census=census, repeats={"prefill_s": prof["prefill_s"],
                                                "tick_ms": prof["tick_ms"]})
        log(f"serve: prefill repeats (server, eager) {prof['prefill_s']} s; ticks in turn "
            f"(server, eager) {prof['tick_ms']} ms; the server's tick under torch.profiler: "
            f"{json.dumps(prof['tick'])}; the eager tick: {json.dumps(prof['eager_tick'])}; "
            f"census {json.dumps(census)} [{card}]")
        fails = tick_census_failures(census)
        if fails:
            raise SmokeFailure("serve: the server's tick is not one graph: " + "; ".join(fails))
        rec["graph_check"] = serve_graph_check(ref["graphs"], card)
    del ref
    host = ckpt.restore(ckpt_dir, ckpt.latest_valid_checkpoint(ckpt_dir))
    before = fa.LAUNCHES["fwd"]
    readings = {"sound": decode_readings(host, cell)}
    if fa.LAUNCHES["fwd"] - before < cell.layers and cell.device == "cuda":
        raise SmokeFailure("the reference forward did not launch K1 once a layer")
    for what, helper in SERVE_FAULTS:
        with planted(helper):
            readings[what] = decode_readings(host, cell)
    chains = f32_chains(host, cell)
    del host
    if cell.device == "cuda":
        torch.cuda.empty_cache()
    rec.update(readings=readings, limits=SERVE_LIMITS,
               f32_chains={"equal": chains["equal"], "min_margin": chains["min_margin"]})
    log(f"serve: prefill {rec['prefill_tokens_per_s']:.1f} tokens/s ({rec['prefill_ms']:.3f} ms "
        f"for {sum(cell.a_lengths)} prompt tokens at (8, {cell.seq}); the server's own call "
        f"{rec['prefill_first_ms']:.3f} ms); decode "
        f"{rec['decode_tokens_per_s']:.1f} tokens/s at {len(a_rows)} active slots; tick ms "
        f"mean {rec['tick_ms']['mean']:.4f} p50 {rec['tick_ms']['p50']:.4f} p99 "
        f"{rec['tick_ms']['p99']:.4f} against its bound {rec['tick_bound_ms']:.4f} "
        f"({bound_bytes} bytes at 3.35 TB/s); KV cache {rec['kv_bytes']} bytes, peak "
        f"{rec['peak_bytes']} bytes; answers held on {held['compared']} of {held['of']} "
        f"tokens (identical: {held['identical']}); readings {readings} (limits "
        f"{SERVE_LIMITS}); f32 chains equal: {chains['equal']} (min margin "
        f"{chains['min_margin']:.3g}) [{card}]")
    failures = serve_verdict(readings)
    if not chains["equal"]:
        failures.append(f"f32 greedy chains differ from the naive re-forward: "
                        f"{chains['chains']} vs {chains['naive']}")
    if failures:
        raise SmokeFailure("serve: " + "; ".join(failures))
    if cell.device == "cuda":
        rec["classifier"] = classifier_check(card)
    return rec


# The classifier check (serve phase): the port trainer trains mnist-conv at
# CLASSIFIER_BATCH (saving every step); the port's server loads it on the
# graph route (a graph of the forward and its argmax a row bucket, up to
# CLASSIFIER_BATCH rows), and at every bucket its predictions and logits on
# rows from a seed must equal the eager forward's (the server's eager apply:
# functional_call, argmax) bit for bit, before and after a swap to the
# step-1 checkpoint through the dispatch thread's _swap_in; a swap that is
# not copied into the captured parameters (CLASSIFIER_FAULT) must be
# rejected. CLASSIFIER_CALLS request batches at each bucket time both routes
# (host wall of the server's apply: staging, replay, the predictions' copy
# back), and CLASSIFIER_CENSUS profiled ones at the largest bucket must each
# be one cudaGraphLaunch, no kernel launched by another call (tick_census).
CLASSIFIER_BATCH, CLASSIFIER_STEPS = 64, 2
CLASSIFIER_CALLS, CLASSIFIER_CENSUS = 20, 10
CLASSIFIER_FAULT = "a swap that does not copy into the captured parameters"


def classifier_check(card: str) -> dict:
    """The classifier check (above): its record."""
    import numpy as np
    import torch

    from tf_operator_tpu_torch.models import checkpoint as ckpt
    from tf_operator_tpu_torch.serve import decode_graphs
    from tf_operator_tpu_torch.serve import server as server_lib

    ckpt_dir = SERVE_DIR / "classifier_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    run_trainer(["--model", "mnist-conv", "--batch", str(CLASSIFIER_BATCH), "--steps",
                 str(CLASSIFIER_STEPS), "--log-every", "1", "--device", "cuda",
                 "--checkpoint-dir", str(ckpt_dir), "--checkpoint-every", "1"],
                tag="_classifier")
    srv = server_lib.InferenceServer("mnist-conv", str(ckpt_dir), 0,
                                     batch_max=CLASSIFIER_BATCH, batch_timeout_ms=5.0,
                                     replica="classifier", device="cuda")
    t0 = time.time()
    srv.load()
    load_s = time.time() - t0
    graphs = srv._graphs
    if srv.route != "graph" or not isinstance(graphs, decode_graphs.GraphedForward) or \
            sorted(graphs.buckets) != list(srv.buckets) or not graphs.sealed:
        raise SmokeFailure(f"classifier: route {srv.route}, buckets "
                           f"{sorted(getattr(graphs, 'buckets', {}))} of {srv.buckets}")
    captured = srv._live[0]
    rng = np.random.default_rng(11)
    rows = {b: rng.normal(size=(b, 28, 28)).astype(np.float32) for b in srv.buckets}

    def eager(params, x):
        logits = torch.func.functional_call(graphs.model, params,
                                            (torch.from_numpy(x).to("cuda"),))
        return logits, logits.argmax(-1)

    def held(params) -> list[str]:
        fails = []
        for b, x in rows.items():
            out = graphs.forward(captured, x)
            logits, pred = eager(params, x)
            if not torch.equal(out["logits"], logits) or not torch.equal(out["pred"], pred):
                fails.append(f"bucket {b}: max |d logits| "
                             f"{(out['logits'] - logits).abs().max().item():.3g}")
        return fails

    swapped = srv._to_device(ckpt.restore(str(ckpt_dir), 1))
    with torch.inference_mode():
        before = held(captured)
        real_adopt = graphs.adopt
        graphs.adopt = lambda new: captured  # CLASSIFIER_FAULT
        srv._live = (swapped, 1)
        srv._swap_in(swapped, 1)
        fault = held(swapped)
        graphs.adopt = real_adopt
        srv._live = (swapped, 1)
        if srv._swap_in(swapped, 1) is not captured or srv._live[0] is not captured:
            raise SmokeFailure("classifier: the swap did not hand back the captured dict")
        after = held(swapped)
        times = {}
        for b, x in rows.items():
            for route in ("graph", "eager"):
                call = (lambda: srv._apply(captured, x)) if route == "graph" else \
                    (lambda: eager(captured, x)[1].cpu().numpy())
                call()
                ms = []
                for _ in range(CLASSIFIER_CALLS):
                    t = time.perf_counter()
                    call()
                    ms.append((time.perf_counter() - t) * 1e3)
                ms.sort()
                times.setdefault(str(b), {})[route] = {
                    "p50_ms": _percentile(ms, 0.5),
                    "batches_per_s": 1e3 * len(ms) / sum(ms)}
        big = rows[srv.buckets[-1]]
        from torch.profiler import DeviceType, ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(CLASSIFIER_CENSUS):
                srv._apply(captured, big)
        raw = prof.profiler.kineto_results.events()
        census = tick_census(
            [(e.name(), e.start_ns(), e.correlation_id()) for e in raw
             if e.device_type() == DeviceType.CUDA],
            [(e.name(), e.correlation_id()) for e in raw
             if e.device_type() == DeviceType.CPU and e.name().startswith(("cuda", "cu"))],
            CLASSIFIER_CENSUS)
    res = {"model": "mnist-conv", "buckets": list(srv.buckets), "load_s": load_s,
           "bit_equal_before_swap": not before, "bit_equal_after_swap": not after,
           "fault_rejected_on": fault, "latency": times, "census": census, "card": card}
    log("serve: classifier " + json.dumps(res))
    fails = [f"before the swap, {f}" for f in before] + [f"after the swap, {f}" for f in after]
    if not fault:
        fails.append(f"the planted fault ({CLASSIFIER_FAULT}) was not rejected")
    fails += tick_census_failures(census)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    if fails:
        raise SmokeFailure("serve: the classifier's graphs: " + "; ".join(fails))
    return res


def serve_verdict(readings: dict) -> list[str]:
    """Failures of decode_readings records: the sound one over a limit, or
    a planted fault under every limit (not rejected)."""
    out = [f"sound {k} {v:.4g} over its limit {SERVE_LIMITS[k]}"
           for k, v in readings["sound"].items() if not v <= SERVE_LIMITS[k]]
    for what, _ in SERVE_FAULTS:
        r = readings.get(what)
        if r is None or all(v <= SERVE_LIMITS[k] for k, v in r.items()):
            out.append(f"planted fault not rejected: {what} ({r})")
    return out


# The multislice phase: a 2-slice job of the LM at MS_REWIND_LAYERS layers (one
# process a slice, one-rank worlds sharing the card) meeting in the DCN
# exchange (parallel/multislice.py) through a directory on /dev/shm when it
# has the room, held against one process at the same global batch and seed
# on dist_gaps' limits; against the same one-process run the planted fault
# (each slice applies its own mean) must fail them, and a kill of slice 1
# two steps after a save (checkpoint every MS_CKPT_EVERY, kill at MS_KILL),
# its relaunch and slice 0's in-process rewind must end on the
# uninterrupted run's losses. The sound run was cut from 12 layers to the
# fault's 4 when the graph check joined the default run (as the sp phase's
# was when a default run took 1040.4 s of its 1200 s limit). Each slice
# replays graphs of the step's halves (graphed_step.step_route), and
# ms_graph_check holds them bit for bit against the eager halves in this
# process, both slices' blocks reduced in one order. Across slices the
# exchange sums the blocks in the order their files arrive (the JAX
# package's engine, f32), so two runs of one job differ in the last bits
# whatever their route: with multislice_eager the sound run is run again
# with every slice eager (CHIP_SMOKE_STEP_ROUTE, for its tokens/s), and
# both, and the rewind, are held against the one-process run at the dist
# limits, their gaps to each other recorded (world_gap).
MS_SLICES, MS_MICRO, MS_STEPS = 2, 2, 6
MS_REWIND_LAYERS, MS_CKPT_EVERY, MS_KILL = 4, 3, 5
MS_FAULT = ("each slice applies its own mean", "no-dcn-sum")
MS_SHM_BYTES = 16e9  # /dev/shm room the full-width exchange may take


def ms_job(layers: int, ref: str) -> DistJob:
    """The train phase's LM argv at `layers` (every step logged), as a
    DistJob whose flash kernels launch once a layer a microbatch a step in
    each slice."""
    argv = lm_argv(MS_STEPS, layers)
    argv[argv.index("--log-every") + 1] = "1"
    return DistJob(f"lm {SEQ} {layers} layers", tuple(argv), SEQ, BATCH, MS_STEPS, layers,
                   6, 1, OUT_DIR / ref)


def dcn_dir(name: str) -> Path:
    """A fresh exchange directory: under /dev/shm when it has MS_SHM_BYTES
    free, else under OUT_DIR."""
    shm = Path("/dev/shm")
    root = shm if shm.is_dir() and shutil.disk_usage(shm).free >= MS_SHM_BYTES else OUT_DIR
    path = root / f"chip_smoke_dcn_{os.getpid()}_{name}"
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    log(f"multislice: exchange directory {path} ({shutil.disk_usage(path).free} bytes free)")
    return path


def slice_env(sid: int, dcn: Path, job: DistJob, fault: str = "", route: str = "") -> dict:
    """A slice's pod env as the operator injects it (worker `sid` of a
    job without a chief: worker 0 writes the checkpoints), with dist_child's
    (`route` forces the step route: CHIP_SMOKE_STEP_ROUTE)."""
    env = {"CHIP_SMOKE_DIST_ROLE": "run", "CHIP_SMOKE_DIST_FAULT": fault,
           "CHIP_SMOKE_DIST_REF": str(job.ref), "TPUJOB_NUM_SLICES": str(MS_SLICES),
           "TPUJOB_SLICE_ID": str(sid), "TPUJOB_DCN_DIR": str(dcn),
           "TPUJOB_REPLICA_TYPE": "worker", "TPUJOB_REPLICA_INDEX": str(sid)}
    if route:
        env["CHIP_SMOKE_STEP_ROUTE"] = route
    return env


def ms_argv(job: DistJob, extra=()) -> list[str]:
    return list(job.argv) + ["--dcn-microbatches", str(MS_MICRO), *extra]


def slice_launches(job: DistJob) -> dict:
    """A slice's flash launches over the run: one a layer a microbatch a
    step."""
    return {k: job.layers * job.steps * MS_MICRO for k in FLASH_LAUNCH_KEYS}


def slice_record(name: str, job: DistJob, sid: int, res, route: str = "graph") -> dict:
    """A slice's (exit code, events, dist_child record) checked: exit 0 on
    `route`, the flash kernels launched once a layer a microbatch a step, a
    finite loss and gradient norm at every step, a done event with its dcn
    block."""
    rc, events, rec = res
    if rc != 0:
        raise SmokeFailure(f"multislice {name}: slice {sid} exited {rc}")
    if rec.get("step_route") != route:
        raise SmokeFailure(f"multislice {name}: slice {sid} took the {rec.get('step_route')} "
                           f"route, not {route}")
    want = slice_launches(job)
    if rec.get("launches") != want:
        raise SmokeFailure(f"multislice {name}: slice {sid} launches {rec.get('launches')}, "
                           f"not {want}")
    losses, norms = _step_losses(events), rec["grad_norms"]
    if sorted(losses) != list(range(1, job.steps + 1)) or len(norms) != job.steps or \
            not all(math.isfinite(x) for x in list(losses.values()) + norms):
        raise SmokeFailure(f"multislice {name}: slice {sid} losses {losses}, norms {norms}")
    by = {e["event"]: e for e in events}
    if not by.get("done", {}).get("dcn") or by["first_step"].get("slices") != MS_SLICES:
        raise SmokeFailure(f"multislice {name}: slice {sid} events lack the dcn block")
    return {**rec, "losses": losses, "done": by["done"], "events": events}


def slice_world(name: str, job: DistJob, fault: str = "", route: str = "") -> dict:
    """`job` as MS_SLICES slice processes of one rank each (dist_child),
    every slice checked by slice_record; `route` forces the step route
    (by default the trainer's own: graph on CUDA)."""
    return finish_slice_world(name, job, *start_slice_world(name, job, fault, route), route)


def start_slice_world(name: str, job: DistJob, fault: str = "", route: str = "") -> tuple:
    """slice_world's processes, started, and their exchange directory."""
    dcn = dcn_dir(name)
    return [start_child(ms_argv(job), f"_ms_{name}_{sid}",
                        slice_env(sid, dcn, job, fault, route), _DIST_CHILD)
            for sid in range(MS_SLICES)], dcn


def finish_slice_world(name: str, job: DistJob, children: list, dcn: Path,
                       route: str = "") -> dict:
    """slice_world's checks on its started slices, once they end."""
    try:
        res = [finish_child(c, timeout=900) for c in children]
    finally:
        shutil.rmtree(dcn, ignore_errors=True)
    device = job.argv[job.argv.index("--device") + 1]
    want = route or ("graph" if device == "cuda" else "eager")
    return {"ranks": [slice_record(name, job, sid, r, want) for sid, r in enumerate(res)]}


def world_gap(a: dict, b: dict) -> dict:
    """The largest relative gaps between two runs of one job, over every
    rank and step: loss and gradient norm; and whether every rank's final
    parameters are the same bytes."""
    def rel(x, y):
        return abs(x - y) / abs(y) if y else abs(x - y)

    pairs = list(zip(a["ranks"], b["ranks"]))
    return {"loss": max(rel(x["losses"][s], y["losses"][s]) for x, y in pairs
                        for s in x["losses"]),
            "grad_norm": max(rel(u, v) for x, y in pairs
                             for u, v in zip(x["grad_norms"], y["grad_norms"])),
            "same_params": all(x.get("param_digest") == y.get("param_digest")
                               for x, y in pairs)}


def ms_summary(name: str, job: DistJob, world: dict, ref: dict, card: str) -> dict:
    """Global tokens/s, step time, the dcn block and peak of each slice,
    and dist_gaps to the one-process run."""
    done = world["ranks"][0]["done"]
    eps = done.get("examples_per_sec")
    return {"run": name, "model": job.label, "slices": MS_SLICES, "microbatches": MS_MICRO,
            "tokens_per_s": eps * job.seq if eps else None,
            "step_time_s": (done.get("step_time_s") or {}).get("mean"),
            "phase_breakdown": done.get("phase_breakdown"),
            "dcn": [r["done"]["dcn"] for r in world["ranks"]],
            "peak_gb": [r["peak_gb"] for r in world["ranks"]],
            "launches_per_slice": world["ranks"][0]["launches"],
            "gaps": dist_gaps(ref, world), "losses": world["ranks"][0]["losses"],
            "grad_norms": world["ranks"][0]["grad_norms"], "card": card}


def ms_rewind(job: DistJob, ref: dict, card: str, sound: dict) -> dict:
    """Slice 1 killed (SIGKILL, by --chaos) MS_KILL steps in, two after the
    step-MS_CKPT_EVERY save of worker 0, and relaunched: it must resume
    from that step, slice 0 must emit dcn_rewind with peer_resume at that
    step without restarting, and both must end on the one-process run's
    losses within DIST_RTOL; slice 0's gaps to the `sound` (uninterrupted)
    run's losses are recorded."""
    dcn, ckpt = dcn_dir("rewind"), OUT_DIR / "ms_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    save = ["--checkpoint-dir", str(ckpt), "--checkpoint-every", str(MS_CKPT_EVERY)]
    chaos = ["--chaos", f"kill:step={MS_KILL},slice=1,signal=KILL"]
    t0 = time.time()
    try:
        s0 = start_child(ms_argv(job, save), "_ms_rewind_0", slice_env(0, dcn, job), _DIST_CHILD)
        rc1, _, _ = finish_child(start_child(ms_argv(job, save + chaos), "_ms_rewind_1a",
                                             slice_env(1, dcn, job), _DIST_CHILD), 900)
        if rc1 != -signal.SIGKILL:
            raise SmokeFailure(f"multislice rewind: slice 1 exited {rc1}, not killed")
        relaunch = finish_child(start_child(ms_argv(job, save), "_ms_rewind_1b",
                                            slice_env(1, dcn, job), _DIST_CHILD), 900)
        r0 = finish_child(s0, 900)
    finally:
        shutil.rmtree(dcn, ignore_errors=True)
        shutil.rmtree(ckpt, ignore_errors=True)
    rc0, ev0, _ = r0
    if rc0 != 0 or relaunch[0] != 0:
        raise SmokeFailure(f"multislice rewind: slice 0 exited {rc0}, the relaunch {relaunch[0]}")
    resumed = [e for e in relaunch[1] if e["event"] == "resumed"]
    rewinds = [e for e in ev0 if e["event"] == "dcn_rewind"]
    starts = [e for e in ev0 if e["event"] == "start"]
    if not resumed or resumed[-1]["from_step"] != MS_CKPT_EVERY or len(starts) != 1 or \
            not rewinds or rewinds[-1]["peer_resume"] != MS_CKPT_EVERY:
        raise SmokeFailure(f"multislice rewind: resumed {resumed}, rewinds {rewinds}, "
                           f"slice 0 starts {len(starts)}")
    got = {e["step"]: e["loss"] for e in ev0 if e["event"] == "progress"}
    want = ref["losses"]
    gaps = {s: abs(got[s] - want[s]) / abs(want[s]) for s in want if s in got}
    done = next(e for e in ev0 if e["event"] == "done")
    sound_losses = sound["ranks"][0]["losses"]
    res = {"killed_at": MS_KILL, "resumed_from": resumed[-1]["from_step"],
           "rewind": rewinds[-1], "slice0_starts": len(starts), "loss_gaps": gaps,
           "gaps_to_the_sound_run": {s: abs(got[s] - sound_losses[s]) / abs(sound_losses[s])
                                     for s in got if s in sound_losses},
           "final_loss": done["final_loss"], "reference_final_loss": want[MS_STEPS],
           "dcn": done["dcn"], "seconds": time.time() - t0, "card": card}
    log("multislice: rewind " + json.dumps(res))
    if MS_STEPS not in gaps or not max(gaps.values()) <= DIST_RTOL:
        raise SmokeFailure(f"multislice rewind: losses off the uninterrupted run: {gaps}")
    return res


# ms_graph_check: steps 1, 2, the rewind to step 1's state, step 2 again
# (profiled).
MS_CENSUS_STEPS, MS_CENSUS_PROFILED = 3, 1


def ms_graph_check(job: DistJob, card: str, steps: int = MS_CENSUS_STEPS) -> dict:
    """The multi-slice halves in this process, on `job`'s model: both
    slices' row blocks each step (MS_SLICES x MS_MICRO backward calls, their
    f32 mean as the exchange gives it, the apply; make_multislice_step_fns
    as the trainer makes them, flat=True), `steps` steps graphed and eager
    from the same init, the state restored in place to its step-1 copy
    after step 2 (a rewind) and step 2 replayed: every step's loss and norm
    and the final parameters bit-equal, K1-K3 launched a layer a block a
    step on both routes; then the graphed run's last step under
    torch.profiler (tick_census): one cudaGraphLaunch for the batch, one a
    block's backward and one for the apply a step, no kernel launched by
    another call but the batch graph's replay prologue (two fills of its
    generator's seed and offset), the K1-K3 kernels under the graph
    launches (K1-K3's counts are the launch counters': a profile may miss
    device events)."""
    import gc

    import numpy as np
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    from tf_operator_tpu_torch import optim as optim_lib
    from tf_operator_tpu_torch.models import train
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.parallel import mesh as mesh_lib
    from tf_operator_tpu_torch.parallel import train_step as ts

    args = train.build_parser().parse_args(list(job.argv))
    device = torch.device("cuda", 0)
    blocks = MS_SLICES * MS_MICRO
    rows = args.batch // blocks

    def run(graphed: bool, profiled: int = 0) -> dict:
        gc.collect()
        torch.cuda.empty_cache()
        model, loss_fn, make_batch = train._build_model(args, device)
        plan = ts.parallelize(model, mesh_lib.Mesh({"dp": 1}), train._sharding_rules(args),
                              device)
        tx = optim_lib.make_optimizer(optim_lib.OptimizerConfig(
            name=args.optimizer, learning_rate=args.lr, moment_dtype=args.moment_dtype,
            master_weights=args.master_weights))
        state = ts.create_train_state(model, tx, plan)
        gen_batch, backward, apply = ts.make_multislice_step_fns(
            loss_fn, tx, make_batch, device, rows, seed=0, plan=plan, graphed=graphed,
            flat=True)
        fa.reset_launches()
        losses, norms, snap, prof = [], [], None, None
        step, done = 0, 0
        t0 = time.time()
        while done < steps:
            if profiled and done == steps - profiled:
                torch.cuda.synchronize()
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                prof.__enter__()
            batch = gen_batch(step + 1)
            # The blocks' mean on the host, as the exchange makes it: no
            # kernel of this harness's own on the card.
            mean = np.mean(np.stack([backward(state, batch, b * rows).cpu().numpy()
                                     for b in range(blocks)]), axis=0, dtype=np.float32)
            at, host = 1, []
            for p in state.params:
                host.append(mean[at:at + p.numel()].reshape(p.shape))
                at += p.numel()
            state, norm = apply(state, host)
            losses.append(float(mean[0]))
            norms.append(float(norm))
            step, done = step + 1, done + 1
            if step == 1:
                snap = {k: v.detach().clone() if isinstance(v, torch.Tensor) else v
                        for k, v in ts.state_tensors(state).items()}
            if step == 2 and len(losses) == 2:
                state, step = ts.load_state_tensors(state, snap), 1
        torch.cuda.synchronize()
        wall = time.time() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
        rec = {"losses": losses, "norms": norms, "wall_s": wall,
               "launches": dict(fa.LAUNCHES),
               "state": {k: v.detach().cpu() for k, v in ts.state_tensors(state).items()
                         if isinstance(v, torch.Tensor)}}
        if prof is not None:
            raw = prof.profiler.kineto_results.events()
            device_ev = [(e.name(), e.start_ns(), e.correlation_id()) for e in raw
                         if e.device_type() == DeviceType.CUDA]
            host_ev = [(e.name(), e.correlation_id()) for e in raw
                       if e.device_type() == DeviceType.CPU and e.name().startswith(("cuda", "cu"))]
            rec["census"] = tick_census(device_ev, host_ev, profiled)
            runtime = {corr: name for name, corr in host_ev}
            k123: dict = {}
            outside: dict = {}
            for name, _, corr in device_ev:
                api = runtime.get(corr, "unattributed")
                if is_k123(name):
                    k123[api] = k123.get(api, 0) + 1
                if api not in (GRAPH_LAUNCH, "unattributed") and \
                        not name.startswith(COPY_EVENTS):
                    outside[name[:90]] = outside.get(name[:90], 0) + 1
            rec["census"]["k123_by_launch_api"] = k123
            rec["census"]["kernels_outside_graphs"] = outside
        return rec

    eager, graphed = run(False), run(True, profiled=MS_CENSUS_PROFILED)
    fails = []
    for key in ("losses", "norms"):
        if eager[key] != graphed[key]:
            fails.append(f"{key}: graphed {graphed[key]}, eager {eager[key]}")
    bad = [k for k in eager["state"] if not torch.equal(eager["state"][k], graphed["state"][k])]
    if bad:
        fails.append(f"the final state differs in {len(bad)} tensors ({bad[0]} first)")
    want = job.layers * blocks * steps
    for name, rec in (("eager", eager), ("graphed", graphed)):
        off = {k: rec["launches"].get(k, 0) for k in FLASH_LAUNCH_KEYS
               if rec["launches"].get(k, 0) != want}
        if off:
            fails.append(f"{name} launches {off}, not {want}")
    census = graphed["census"]
    per_step = 2 + blocks
    n = MS_CENSUS_PROFILED
    if census["graph_launches"] != per_step * n:
        fails.append(f"{census['graph_launches']} cudaGraphLaunch calls over {n} steps, "
                     f"not {per_step} a step")
    # A replay of a graph with a registered generator first fills the
    # generator's seed and offset on the card (PyTorch's replay prologue):
    # two fills a step for the batch's graph, and no other kernel. A
    # profile may miss device events (tick_census), so the kernels are held
    # by where they were launched, not by their count.
    outside = census["kernels_outside_graphs"]
    fills = sum(n for name, n in outside.items() if "FillFunctor" in name)
    if fills > 2 * n or sum(outside.values()) != fills:
        fails.append(f"kernels launched outside the graphs: {outside} (the batch graph's "
                     f"two seed and offset fills a step aside)")
    k123 = census["k123_by_launch_api"]
    if set(k123) - {GRAPH_LAUNCH, "unattributed"} or not k123.get(GRAPH_LAUNCH):
        fails.append(f"K1-K3 by launch call {k123}, not under the graphs")
    res = {"steps": steps, "blocks_a_step": blocks, "rewound_after_step": 2,
           "bit_equal": not fails, "losses": graphed["losses"], "norms": graphed["norms"],
           "launches": graphed["launches"], "census": census,
           "graph_launches_per_step": census["graph_launches"] / n,
           "eager_wall_s": eager["wall_s"], "graphed_wall_s": graphed["wall_s"], "card": card}
    log("multislice: graph check " + json.dumps(res))
    if fails:
        raise SmokeFailure("multislice graph check: " + "; ".join(fails))
    return res


def multislice_phase(records: dict, card: str, eager_world: bool = False) -> dict:
    """At MS_REWIND_LAYERS layers, against one process: the halves graphed
    against eager in this process (ms_graph_check); the LM as 2 slices x 2
    microbatches, graphed (and with `eager_world`, the multislice_eager
    phase, again with every slice eager, for its tokens/s); the planted
    fault rejected; the kill, relaunch and rewind."""
    import torch

    torch.cuda.empty_cache()
    out = {}
    job = ms_job(MS_REWIND_LAYERS, "ms_reference.pt")
    out["graph_check"] = ms_graph_check(job, card)
    torch.cuda.empty_cache()
    ref, reference = one_process(card, job)
    try:
        sound = slice_world("full", job)
        res = ms_summary("2 slices", job, sound, ref, card)
        log("multislice: " + json.dumps({k: v for k, v in res.items()
                                         if k not in ("losses", "grad_norms")}))
        failed = dist_verdict(res["gaps"])
        if failed:
            raise SmokeFailure(f"multislice is off one process's run: {failed}")
        if eager_world:
            eager = slice_world("eager", job, route="eager")
            res["eager"] = ms_summary("2 slices, eager", job, eager, ref, card)
            res["gap_to_eager"] = world_gap(sound, eager)
            log("multislice: eager " + json.dumps({k: res["eager"][k] for k in
                                                   ("tokens_per_s", "step_time_s", "peak_gb",
                                                    "gaps")})
                + f"; graphed against eager: {json.dumps(res['gap_to_eager'])}")
            failed = dist_verdict(res["eager"]["gaps"])
            if failed:
                raise SmokeFailure(f"multislice's eager slices are off one process's run: "
                                   f"{failed}")
        for name, key, _ in KERNELS:
            records.setdefault(name, {})["multislice_launches_per_slice"] = \
                res["launches_per_slice"][key]
        out.update(reference=reference, run=res)
        label, kind = MS_FAULT
        # The fault's slices run while the rewind runs (neither is timed).
        fault_world = start_slice_world("fault", job, kind)
        try:
            out["rewind"] = ms_rewind(job, ref, card, sound)
        finally:
            fault_world = finish_slice_world("fault", job, *fault_world)
        gaps = dist_gaps(ref, fault_world)
        failed = [f for f in dist_verdict(gaps) if not f.startswith("loss")]
        out["fault_control"] = {"run": label, "layers": MS_REWIND_LAYERS, "gaps": gaps,
                                "rejected_on": failed}
        log("multislice: planted fault " + json.dumps(out["fault_control"]))
        if not failed:
            raise SmokeFailure(f"the multislice check accepts a run where {label}: {gaps}")
    finally:
        job.ref.unlink(missing_ok=True)
    return out


# The pipeline phase: make_pipelined_lm at the LM's widths (12 layers, 6 a
# stage at pp = 2, seq 8192, batch 4, 4 microbatches (PipeCell), bf16 compute on
# f32 weights) as two co-located gloo ranks, held against the unpipelined
# port LM with the same weights: rel_err = max |d| / rms(ref) of the logits,
# and norm_err = |d| / |ref| of each parameter's gradient after one step (the
# pipelined ones summed over pp by reduce_grads; the key biases' aside: zero
# in exact arithmetic), the largest of each within PP_LIMIT; a hop that sends
# zeros must exceed it. The gradients are held in norm: the 4 microbatches'
# bf16 weight gradients, each rounded, summed against one rounded batch-4
# gradient put single elements of a weight's gradient up to 0.079 of its rms
# apart (max |d| / rms, logged as grads_max_elem, an mlp_out weight on an
# H100; the norm reading 0.0024 there), while a lost microbatch moves the
# norm by ~1/4.
PP_LIMIT = 0.05
_PP_CHILD = "import sys, chip_smoke\nsys.exit(chip_smoke.pipeline_child(sys.argv[1:]))\n"


@dataclasses.dataclass(frozen=True)
class PipeCell:
    """The pipeline phase's model and schedule (the LM's widths by
    default)."""

    layers: int = LAYERS
    hidden: int = 768
    heads: int = 6
    vocab: int = 32000
    seq: int = SEQ
    batch: int = BATCH
    stages: int = 2
    micro: int = 4
    device: str = "cuda"
    dtype: str = "bfloat16"


PIPE = PipeCell()


def norm_err(got, ref) -> float:
    """|got - ref| / |ref| (Frobenius), in f32."""
    got, ref = got.float(), ref.float()
    return float((got - ref).norm() / ref.norm())


def pipeline_readings(model, loss_fn, ref, batch, map_grads) -> dict:
    """rel_err of the pipelined logits and gradients against `ref`'s (on
    the rank that holds `ref`; every rank runs the pipelined half)."""
    import torch

    with torch.no_grad():
        logits = model(batch["tokens"])
        out = {"logits": rel_err(logits, ref(batch["tokens"])) if ref is not None else None}
    del logits
    model.zero_grad(set_to_none=True)
    loss_fn(model, batch).backward()
    model.reduce_grads()
    if ref is not None:
        from tf_operator_tpu_torch.models import transformer as tfm

        ref.zero_grad(set_to_none=True)
        tfm.lm_loss(ref(batch["tokens"]), batch["tokens"]).backward()
        want = dict(ref.named_parameters())
        got = map_grads({n: p.grad for n, p in model.named_parameters()})
        # A key bias's gradient is zero in exact arithmetic (softmax is
        # invariant to it): both sides hold noise there.
        errs = {n: norm_err(got[n], want[n].grad) for n in want
                if not n.endswith("attn.key.bias")}
        worst = max(errs, key=errs.get)
        out["grads"], out["grads_worst"] = errs[worst], worst
        elem = {n: rel_err(got[n], want[n].grad) for n in errs}
        worst = max(elem, key=elem.get)
        out["grads_max_elem"], out["grads_max_elem_worst"] = elem[worst], worst
        ref.zero_grad(set_to_none=True)
    model.zero_grad(set_to_none=True)
    return out


def pipeline_child(argv: list[str]) -> int:
    """One pp rank of the pipeline phase (argv: the record file, the
    PipeCell as JSON): the sound readings, one step's flash launches, the
    step time against one process (on rank 0, rank 1 waiting) and the
    readings with a hop that sends zeros."""
    import torch
    import torch.distributed as dist

    from tf_operator_tpu_torch.models import transformer as tfm
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.parallel import distributed
    from tf_operator_tpu_torch.parallel import mesh as mesh_lib
    from tf_operator_tpu_torch.parallel import pipeline as pl

    cell = PipeCell(**json.loads(argv[1]))
    cuda = cell.device == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    backend = distributed.initialize_from_env(force=True, device=dev)
    mesh = mesh_lib.make_mesh({"pp": cell.stages})
    rank = mesh.rank
    cfg = tfm.TransformerConfig(vocab_size=cell.vocab, num_layers=cell.layers,
                                hidden=cell.hidden, num_heads=cell.heads, max_len=cell.seq,
                                causal=True, dtype=getattr(torch, cell.dtype))
    model, loss_fn = pl.make_pipelined_lm(
        cfg, mesh, cell.micro, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (cell.batch, cell.seq), generator=gen,
                                     device=dev)}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    ref = None
    if rank == 0:
        from tf_operator_tpu_torch.parallel.ring_attention import make_attention_fn

        ref = tfm.TransformerLM(cfg, attn_fn=make_attention_fn(None, causal=True), device=dev)
        ref.load_state_dict(pl.lm_state_dict(model.state_dict(), cell.layers))

    def map_grads(grads):
        return pl.lm_state_dict(grads, cell.layers)

    rec = {"backend": backend, "rank": rank, "stage": mesh.coord("pp"),
           "sound": pipeline_readings(model, loss_fn, ref, batch, map_grads)}

    def step():
        model.zero_grad(set_to_none=True)
        loss_fn(model, batch).backward()
        model.reduce_grads()

    fa.reset_launches()
    step()
    rec["launches_per_step"] = dict(fa.LAUNCHES)
    times, split = [], []
    for _ in range(3):
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        model.zero_grad(set_to_none=True)
        loss_fn(model, batch).backward()
        sync()
        t1 = time.perf_counter()
        model.reduce_grads()
        sync()
        times.append(time.perf_counter() - t0)
        split.append([t1 - t0, time.perf_counter() - t1])
    rec["step_s"], rec["forward_backward_and_reduce_s"] = times, split
    dist.barrier()
    if ref is not None:
        def ref_step():
            ref.zero_grad(set_to_none=True)
            tfm.lm_loss(ref(batch["tokens"]), batch["tokens"]).backward()

        ref_step()
        rec["one_process_step_s"] = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            ref_step()
            sync()
            rec["one_process_step_s"].append(time.perf_counter() - t0)
    dist.barrier()
    real = pl._Send.forward

    def zero_hop(ctx, x, dst, group, tag):
        return real(ctx, torch.zeros_like(x), dst, group, tag)

    pl._Send.forward = staticmethod(zero_hop)
    rec["zero_hop"] = pipeline_readings(model, loss_fn, ref, batch, map_grads)
    pl._Send.forward = staticmethod(real)
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    Path(argv[0]).write_text(json.dumps(rec))
    distributed.distributed_goodbye()
    return 0


def pipeline_launches(cell: PipeCell) -> dict:
    """Each rank's flash launches a step: one a layer of its stage a
    microbatch."""
    return {k: cell.layers // cell.stages * cell.micro for k in FLASH_LAUNCH_KEYS}


def pipeline_phase(records: dict, card: str, cell: PipeCell = PIPE) -> dict:
    """make_pipelined_lm at pp = 2 as two co-located ranks (gloo by the
    backend rule): the logits and one step's gradients within PP_LIMIT of
    the unpipelined LM's, a zero hop over it, 6 layers x 4 microbatches of
    K1-K3 a rank a step; the step time beside one process's and the
    bubble."""
    import torch

    from tf_operator_tpu_torch.parallel.pipeline import bubble_fraction

    if cell.device == "cuda":
        torch.cuda.empty_cache()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    port = free_port()
    procs = []
    for rank in range(cell.stages):
        path = OUT_DIR / f"chip_smoke_pipeline_{rank}.json"
        path.unlink(missing_ok=True)
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_PROCESS_ID=str(rank), JAX_NUM_PROCESSES=str(cell.stages),
                   CUDA_VISIBLE_DEVICES=first_card(),
                   PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append((subprocess.Popen([sys.executable, "-c", _PP_CHILD, str(path),
                                        json.dumps(dataclasses.asdict(cell))], cwd=ROOT,
                                       env=env, stdout=subprocess.DEVNULL,
                                       stderr=subprocess.PIPE, text=True), path))
    ranks = []
    for proc, path in procs:
        try:
            _, err = proc.communicate(timeout=900)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        if proc.returncode != 0 or not path.exists():
            raise SmokeFailure(f"pipeline: a rank exited {proc.returncode}: {err[-3000:]}")
        ranks.append(json.loads(path.read_text()))
    want = pipeline_launches(cell)
    r0 = ranks[0]
    res = {"stages": cell.stages, "microbatches": cell.micro, "backend": r0["backend"],
           "sound": r0["sound"], "zero_hop": r0["zero_hop"], "limit": PP_LIMIT,
           "step_s": [r["step_s"] for r in ranks],
           "forward_backward_and_reduce_s": [r["forward_backward_and_reduce_s"] for r in ranks],
           "one_process_step_s": r0["one_process_step_s"],
           "bubble": bubble_fraction(cell.stages, cell.micro),
           "launches_per_step_per_rank": [r["launches_per_step"] for r in ranks],
           "peak_gb": [r["peak_gb"] for r in ranks], "card": card}
    log("pipeline: " + json.dumps(res))
    for name, key, _ in KERNELS:
        records.setdefault(name, {})["pipeline_launches_per_step_per_rank"] = want[key]
    failures = [f"rank {r['rank']} launches {r['launches_per_step']}, not {want}"
                for r in ranks if r["launches_per_step"] != want]
    readings = ("logits", "grads")
    failures += [f"sound {k} {r0['sound'][k]:.4g} over {PP_LIMIT}" for k in readings
                 if not r0["sound"][k] <= PP_LIMIT]
    if all(r0["zero_hop"][k] <= PP_LIMIT for k in readings):
        failures.append(f"a zero hop is not rejected: {r0['zero_hop']}")
    if r0["backend"] != "gloo":
        failures.append(f"backend {r0['backend']}, not gloo (two ranks on one card)")
    if failures:
        raise SmokeFailure("pipeline: " + "; ".join(failures))
    return res


# The pod phase: the trainer's "one pod, all its GPUs" (parallel/launch.py).
# The full-width LM (the train phase's argv, every step logged) as POD_PODS
# pods of POD_LOCAL local ranks each at POD_MESH, started as the operator
# starts pods, each supervisor given its count through the explicit API
# (the card is one, so the four ranks share it over gloo), held against one
# process at the same argv on dist_gaps' limits, with dist's planted fault
# (dp without the gradient reduction, here across the pods) rejected.
POD_PODS, POD_LOCAL, POD_STEPS = 2, 2, 6
POD_MESH = {"dp": 2, "tp": 2}
POD_FAULT = ("dp without the gradient reduction, across the pods", POD_MESH,
             "no-grad-reduce", None)
# A pod: pod_child.
_POD_CHILD = "import sys, chip_smoke\nsys.exit(chip_smoke.pod_child(sys.argv[1:]))\n"
# (only with --phases ...,pod4, on four GPUs) pods that take their count from
# the GPUs they see: (name, mesh, pods, each pod's CUDA_VISIBLE_DEVICES).
POD4_RUNS = (("pod-dp4", {"dp": 4}, 1, ("0,1,2,3",)),
             ("pod-dp-tp", {"dp": 2, "tp": 2}, 1, ("0,1,2,3",)),
             ("pods-dp-tp", {"dp": 2, "tp": 2}, 2, ("0,1", "2,3")))


def pod_job(layers: int = LAYERS) -> DistJob:
    """The train phase's LM argv (or `layers` deep), every step logged, over
    POD_STEPS steps."""
    argv = lm_argv(POD_STEPS, layers)
    argv[argv.index("--log-every") + 1] = "1"
    label = f"lm {SEQ}" + ("" if layers == LAYERS else f", {layers} layers")
    return DistJob(label, tuple(argv), SEQ, BATCH, POD_STEPS, layers, 6, 1,
                   OUT_DIR / f"pod_reference_{layers}.pt")


def pod_child(argv: list[str]) -> int:
    """A pod: the trainer's main on argv[1:] with CHIP_SMOKE_POD_RANKS local
    ranks (else the count of GPUs the pod sees). Its supervisor replays this
    command line in each local rank, which runs dist_child with its record
    in argv[0].<local rank>."""
    from tf_operator_tpu_torch.models import train
    from tf_operator_tpu_torch.parallel import distributed

    local = distributed.local_rank()
    if local is None:
        count = os.environ.get("CHIP_SMOKE_POD_RANKS")
        return train.main(argv[1:], local_ranks=int(count) if count else None)
    return dist_child([f"{argv[0]}.{local}", *argv[1:]])


def pod_world(name: str, job: DistJob, mesh: dict, visible, local: int | None,
              backend: str, fault: str = "") -> dict:
    """`job` as len(visible) pods at `mesh`, pod p seeing visible[p], each
    with its own metrics and heartbeat files and the operator's env, its
    supervisor given `local` ranks (None: the count of GPUs it sees). Every
    pod must exit 0 with one jax_ready, first_step and done in its metrics
    file (n_devices the world), every rank launch K1, K2, K3 and the delta
    pass once a layer a step at its local [rows * heads, T, D], with a finite
    gradient norm at every step and `backend` picked by the rule."""
    pods = len(visible)
    world = int(math.prod(mesh.values()))
    port = free_port()
    children = []
    for p, cards in enumerate(visible):
        env = {"CHIP_SMOKE_DIST_ROLE": "run", "CHIP_SMOKE_DIST_FAULT": fault,
               "CHIP_SMOKE_DIST_REF": str(job.ref), "TPUJOB_MESH": json.dumps(mesh),
               "CUDA_VISIBLE_DEVICES": cards,
               "TPUJOB_HEARTBEAT_FILE": str(OUT_DIR / f"chip_smoke_heartbeat_{name}_{p}")}
        if pods > 1:
            env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_PROCESS_ID=str(p),
                       JAX_NUM_PROCESSES=str(pods))
        if local is not None:
            env["CHIP_SMOKE_POD_RANKS"] = str(local)
        record = OUT_DIR / f"chip_smoke_launches_pod_{name}_{p}.json"  # start_child's
        for i in range(world // pods):
            Path(f"{record}.{i}").unlink(missing_ok=True)
        children.append(start_child(list(job.argv), f"_pod_{name}_{p}", env, _POD_CHILD))
    results = [(finish_child(c, timeout=900), c[2]) for c in children]
    want = job.launches(mesh, None)
    rows, heads, t, d = job.local_shape(mesh, None)
    ranks, dones = [], []
    for p, ((rc, events, _), record) in enumerate(results):
        if rc != 0:
            raise SmokeFailure(f"pod {name}: pod {p} exited {rc}")
        names = [e["event"] for e in events]
        if any(names.count(k) != 1 for k in ("jax_ready", "first_step", "done")):
            raise SmokeFailure(f"pod {name}: pod {p}'s events are not one stream: {names}")
        by = {e["event"]: e for e in events}
        if by["first_step"]["n_devices"] != world or by["first_step"]["mesh"] != mesh or \
                by["jax_ready"].get("dist_backend") != backend:
            raise SmokeFailure(f"pod {name}: pod {p} reports {by['first_step']['n_devices']} "
                               f"devices, mesh {by['first_step']['mesh']}, backend "
                               f"{by['jax_ready'].get('dist_backend')}")
        losses = _step_losses(events)
        if sorted(losses) != list(range(1, job.steps + 1)) or \
                not all(math.isfinite(x) for x in losses.values()):
            raise SmokeFailure(f"pod {name}: pod {p} losses {losses}")
        dones.append(by["done"])
        for i in range(world // pods):
            rec = json.loads(Path(f"{record}.{i}").read_text())
            norms = rec["grad_norms"]
            if rec["launches"] != want or rec["flash_fwd_shapes"] != [[rows * heads, t, d]] \
                    or len(norms) != job.steps or not all(map(math.isfinite, norms)):
                raise SmokeFailure(f"pod {name}: pod {p} rank {i} launches {rec['launches']} "
                                   f"at {rec['flash_fwd_shapes']}, not {want} at "
                                   f"{[rows * heads, t, d]}; norms {norms}")
            if rec["step_route"] != world_route(backend):
                raise SmokeFailure(f"pod {name}: pod {p} rank {i} steps on the "
                                   f"{rec['step_route']} route, not {world_route(backend)}")
            ranks.append({**rec, "losses": losses, "pod": p, "local_rank": i})
    return {"ranks": ranks, "dones": dones}


def pod_summary(name: str, job: DistJob, mesh: dict, world: dict, ref: dict,
                card: str) -> dict:
    """Global tokens/s and step time (pod 0's done event), each rank's peak
    and the gaps to the one-process run."""
    done = world["dones"][0]
    eps = done.get("examples_per_sec")
    return {"run": name, "model": job.label, "mesh": mesh, "pods": len(world["dones"]),
            "ranks_per_pod": len(world["ranks"]) // len(world["dones"]),
            "tokens_per_s": eps * job.seq if eps else None,
            "step_time_s": (done.get("step_time_s") or {}).get("mean"),
            "phase_breakdown": done.get("phase_breakdown"),
            "step_route": sorted({r["step_route"] for r in world["ranks"]}),
            "peak_gb": [r["peak_gb"] for r in world["ranks"]],
            "peak_reserved_gb": [r["peak_reserved_gb"] for r in world["ranks"]],
            "kernel_shape": list(job.local_shape(mesh, None)),
            "launches_per_step_per_rank": {k: n / job.steps for k, n in
                                           job.launches(mesh, None).items()},
            "gaps": dist_gaps(ref, world), "losses": world["ranks"][0]["losses"],
            "grad_norms": world["ranks"][0]["grad_norms"], "card": card}


def pod_phase(records: dict, card: str) -> dict:
    """The LM at full width, CUT_LAYERS deep, as POD_PODS pods x POD_LOCAL
    local ranks on the one card against one process at that depth
    (dist_gaps' limits), the kernels held first at the ranks' shape, and
    POD_FAULT rejected against the same process (the sound run went from
    12 layers to FAULT_LAYERS, then to CUT_LAYERS, for the default run's
    time)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"pod: this process holds {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved; the card has "
        f"{free / 1e9:.3f} of {total / 1e9:.3f} GB free [{card}]")
    job = pod_job(CUT_LAYERS)
    shape_kernel_check(records, [job.local_shape(POD_MESH, None)], "pod", 8193, causal=True)
    ref, reference = one_process(card, job)
    visible = (first_card(),) * POD_PODS
    try:
        res = pod_summary("pods", job, POD_MESH,
                          pod_world("pods", job, POD_MESH, visible, POD_LOCAL, "gloo"),
                          ref, card)
        log("pod: " + json.dumps({k: v for k, v in res.items()
                                  if k not in ("losses", "grad_norms")}))
        failed = dist_verdict(res["gaps"])
        if failed:
            raise SmokeFailure(f"the pods are off one process's run: {failed}")
        label, mesh, kind, _ = POD_FAULT
        gaps = dist_gaps(ref, pod_world("fault", job, mesh, visible, POD_LOCAL, "gloo", kind))
        rejected = [f for f in dist_verdict(gaps) if not f.startswith("loss")]
        fault = {"run": label, "model": job.label, "mesh": mesh, "gaps": gaps,
                 "rejected_on": rejected}
        log("pod: planted fault " + json.dumps(fault))
        if not rejected:
            raise SmokeFailure(f"the pod check accepts a run with {label}: {gaps}")
    finally:
        job.ref.unlink(missing_ok=True)
    for name, key, _ in KERNELS:
        records.setdefault(name, {})["pod_launches_per_step_per_rank"] = \
            res["launches_per_step_per_rank"][key]
    return {"reference": reference, "run": res, "fault_control": fault}


def pod4_phase(records: dict, card: str) -> dict:
    """(only with --phases ...,pod4, on four GPUs) POD4_RUNS: pods that take
    their local rank count from the GPUs they see, one a rank (NCCL), each
    held against one process at the same global batch."""
    four_gpus("pod4")
    job = pod_job()
    ref, reference = one_process(card, job)
    out = {"reference": reference, "gpus": 4, "runs": []}
    try:
        for name, mesh, _pods, visible in POD4_RUNS:
            res = pod_summary(name, job, mesh,
                              pod_world(name, job, mesh, visible, None, "nccl"), ref, card)
            res["visible"] = list(visible)
            log("pod4: " + json.dumps({k: v for k, v in res.items()
                                       if k not in ("losses", "grad_norms")}))
            failed = dist_verdict(res["gaps"])
            if failed:
                raise SmokeFailure(f"pod4 {name} is off one process's run: {failed}")
            out["runs"].append(res)
    finally:
        job.ref.unlink(missing_ok=True)
    return out


# (only with --phases ...,dist4, on a machine of four GPUs) the dist runs
# with one GPU a rank, as pods of their own: the rule picks NCCL, and every
# rank replays a CUDA graph of its step. BERT adds dp = 4, dp x tp and fsdp =
# 4 (saving every 2 steps: a checkpoint's gathers run eagerly between the
# replays) and the dist fault at dp = 2; the 64k LM runs sp = 4 (ring), sp x
# tp (ring: 3 local heads) at batch 1 and dp x sp (Ulysses) at batch 2. The
# MoE cell's ep = 4 and dp x ep = 2 x 2 are the moe4 phase; the world graph
# check and the kill check the graph4 phase.
DIST4_RUNS = DIST_RUNS + (("dp4", {"dp": 4}), ("dp-tp", {"dp": 2, "tp": 2}))
DIST4_CKPT_RUNS = (("fsdp4", {"fsdp": 4}),)
DIST4_SP = ((1, (("sp4-ring", {"sp": 4}, "ring"), ("sp-tp-ring", {"sp": 2, "tp": 2}, "ring")),
             ("sp = 4 without the gradient sum over sp", {"sp": 4}, "no-sp-grad-sum", "ring")),
            (2, (("dp-sp-ulysses", {"dp": 2, "sp": 2}, "ulysses"),), None))
DIST4_MOE = (("ep4", {"ep": 4}), ("dp-ep", {"dp": 2, "ep": 2}))
DIST4_CKPT_DIR = OUT_DIR / "dist4_ckpt"


def four_gpus(phase: str) -> None:
    import torch

    if torch.cuda.device_count() < 4:
        raise SmokeFailure(f"the {phase} phase needs four GPUs, sees "
                           f"{torch.cuda.device_count()}")
    torch.cuda.empty_cache()


def dist4_phase(records: dict, card: str) -> dict:
    """The four-GPU NCCL runs: DIST4_RUNS, DIST4_CKPT_RUNS and DIST_FAULT
    (BERT), DIST4_SP (the 64k LM), each part run whatever the others gave;
    the phase fails after the last if any failed."""
    four_gpus("dist4")
    out: dict = {"gpus": 4}
    failed: list[str] = []

    def bert_runs():
        dist_kernel_check(records, DIST4_RUNS + DIST4_CKPT_RUNS)
        ref, reference = one_process(card)
        ckpt_job = dataclasses.replace(BERT_DIST, argv=BERT_DIST.argv + (
            "--checkpoint-dir", str(DIST4_CKPT_DIR), "--checkpoint-every", "2"))
        try:
            return {"reference": reference,
                    "runs": held_against(ref, DIST4_RUNS, "nccl", True, card)
                    + held_against(ref, DIST4_CKPT_RUNS, "nccl", True, card, ckpt_job),
                    "fault_control": fault_control(ref, own_gpus=True)}
        finally:
            DIST_REF.unlink(missing_ok=True)
            shutil.rmtree(DIST4_CKPT_DIR, ignore_errors=True)

    def lm_runs(batch, runs, fault):
        job = sp_lm_job(LONG_SEQ, batch, f"sp4_reference_{batch}.pt")
        sp_kernel_check(records, [(job.local_shape(m, mode), True) for _, m, mode in runs]
                        + [(job.local_shape(m, mode), False) for _, m, mode in runs
                           if mode == "ring"], 65536 + batch)
        ref, reference = one_process(card, job)
        try:
            return {"reference": reference,
                    "runs": held_against(ref, runs, "nccl", True, card, job),
                    "fault_control": fault and fault_control(ref, fault, job, own_gpus=True)}
        finally:
            job.ref.unlink(missing_ok=True)

    parts = [("bert", bert_runs, ())] + [(f"lm_64k_batch_{batch}", lm_runs, (batch, runs, fault))
                                         for batch, runs, fault in DIST4_SP]
    for name, fn, args in parts:
        try:
            out[name] = fn(*args)
        except SmokeFailure as e:
            log(f"dist4: {name} FAILED: {e}")
            failed.append(f"{name}: {e}")
    if failed:
        raise SmokeFailure("dist4: " + " | ".join(failed))
    return out


def graph4_phase(card: str, parent: Path | None = None) -> dict:
    """(only with --phases ...,graph4, on four GPUs) the world graph check,
    then the kill check on this tree's graph and eager routes (with
    `parent`'s eager world beside them, recorded, not held), both run
    whatever the first gave."""
    four_gpus("graph4")
    out: dict = {}
    failed: list[str] = []
    try:
        out["world_graph"] = world_graph_check(card)
    except SmokeFailure as e:
        failed.append(str(e))
    out["kill"], fails = kill4(card, parent)
    failed += fails
    if failed:
        raise SmokeFailure("graph4: " + " | ".join(failed))
    return out


def kill4(card: str, parent: Path | None = None) -> tuple[dict, list[str]]:
    """The kill check on this tree's graph and eager routes (with `parent`'s
    eager world beside them, recorded, not held): its record and
    kill_failures'."""
    worlds = {"graph": (ROOT, {}), "eager": (ROOT, KILL_EAGER)}
    if parent:
        worlds["parent eager"] = (parent, KILL_EAGER)
    res = kill_check(card, worlds)
    return res, kill_failures(res)


def kill4_phase(card: str, parent: Path | None = None) -> dict:
    """(only with --phases ...,kill4, on four GPUs) graph4's kill check
    alone."""
    four_gpus("kill4")
    res, failed = kill4(card, parent)
    if failed:
        raise SmokeFailure("kill4: " + " | ".join(failed))
    return res


def moe4_phase(card: str) -> dict:
    """(only with --phases ...,moe4, on four GPUs) the MoE cell, sparse, at
    ep = 4 and dp x ep = 2 x 2 with one GPU a rank (NCCL, graphed), each
    held against one process."""
    four_gpus("moe4")
    job = moe_ep_job("sparse", MOE_LAYERS)
    ref, reference = one_process(card, job)
    try:
        return {"reference": reference,
                "runs": held_against(ref, DIST4_MOE, "nccl", True, card, job)}
    finally:
        job.ref.unlink(missing_ok=True)


# The LM profile cuts its steps at the attention forward: a kernel whose
# lower-cased name holds both substrings (fwd_kernel in f32 and bf16 at
# 384/512, fwd_wgmma_kernel and fwd_wide_wgmma_kernel in bf16; no other
# kernel of csrc/).
# The graph check: the full-width LM (lm_argv) for GRAPH_STEPS steps in
# chunks of LOG_EVERY, graphed against eager, and the planted faults, each
# (what it breaks, its name in planted_graph_fault, the failure that must
# name it: graph_verdict's first word).
GRAPH_STEPS = 6
GRAPH_FAULTS = (("a replay without the generator re-seed", "skip-reseed", "loss"),
                ("bias corrections frozen at the capture", "frozen-bias", "params"))
GRAPH_STATE_GROUPS = ("params", "mu", "nu", "master")
POW_COUNTS = 200000


@contextlib.contextmanager
def planted_graph_fault(fault: str):
    """skip-reseed: the batch generator is seeded for the first step only,
    so the replays draw on from the warm-up's Philox offset instead of their
    own steps' seeds. frozen-bias: the bias corrections as host values (0-dim
    CPU tensors), read from the count outside the capture and baked into it
    at the capture's count (the functional update's behaviour under a
    graph). skip-grad-reduce (a world's): the gradient buckets'
    all-reduce (collectives.all_reduce_flat) runs in the eager warm-up and
    is left out of the capture, so every replay steps on this rank's own
    gradients."""
    import torch

    from tf_operator_tpu_torch import optim
    from tf_operator_tpu_torch.parallel import collectives, graphed_step

    if fault == "skip-grad-reduce":
        real_flat = collectives.all_reduce_flat

        def flat(tensors, group):
            if torch.cuda.is_current_stream_capturing():
                return list(tensors)
            return real_flat(tensors, group)

        collectives.all_reduce_flat = flat
        try:
            yield
        finally:
            collectives.all_reduce_flat = real_flat
    elif fault == "skip-reseed":
        real, seeded = graphed_step._reseed, []

        def reseed(gen, seed, step):
            if not seeded:
                seeded.append(step)
                real(gen, seed, step)

        graphed_step._reseed = reseed
        try:
            yield
        finally:
            graphed_step._reseed = real
    elif fault == "frozen-bias":
        real, seen = optim.bias_corrections, [0]

        def frozen(cfg, count):
            if torch.cuda.is_current_stream_capturing():
                n = seen[0] + 1
            else:
                n = seen[0] = int(count)
            c = torch.tensor(float(n), dtype=torch.float32)
            return tuple(1.0 - torch.tensor(b, dtype=torch.float32) ** c
                         for b in (cfg.b1, cfg.b2))

        optim.bias_corrections = frozen
        try:
            yield
        finally:
            optim.bias_corrections = real
    elif fault:
        raise ValueError(f"unknown graph fault {fault!r}")
    else:
        yield


def graph_run(graphed: bool, fault: str = "", steps: int = GRAPH_STEPS,
              argv: list[str] | None = None, world: bool = False) -> dict:
    """The trainer's cell on `argv` (the LM cell's by default) built as the
    trainer builds it (its model, loss, batches, plan and optimizer: in one
    process, or with `world` this rank's of the world it joined, over
    TPUJOB_MESH), `steps` steps through make_chunked_train_step in chunks
    of LOG_EVERY, graphed or eager: every step's loss and gradient norm,
    the final state on the host and the flash launches."""
    import torch

    from tf_operator_tpu_torch import optim as optim_lib
    from tf_operator_tpu_torch.models import train
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.parallel import mesh as mesh_lib
    from tf_operator_tpu_torch.parallel import train_step as ts

    args = train.build_parser().parse_args(argv or lm_argv(steps))
    device = torch.device("cuda", 0)
    mesh = mesh_lib.mesh_from_env() if world else mesh_lib.Mesh({"dp": 1})
    model, loss_fn, make_batch = train._build_model(args, device, mesh if world else None)
    plan = ts.parallelize(model, mesh, train._sharding_rules(args), device)
    tx = optim_lib.make_optimizer(optim_lib.OptimizerConfig(
        name=args.optimizer, learning_rate=args.lr, moment_dtype=args.moment_dtype,
        master_weights=args.master_weights))
    state = ts.create_train_state(model, tx, plan)
    run = ts.make_chunked_train_step(loss_fn, tx, make_batch, device, seed=0,
                                     remat=args.remat, plan=plan, graphed=graphed)
    fa.reset_launches()
    every: list = []
    t0 = time.time()
    with planted_graph_fault(fault):
        for _ in range(steps // LOG_EVERY):
            state, _ = run(state, LOG_EVERY, every)
    torch.cuda.synchronize()
    wall = time.time() - t0
    return {"loss": [float(m["loss"]) for m in every],
            "grad_norm": [float(m["grad_norm"]) for m in every],
            "state": {k: v.detach().cpu() for k, v in ts.state_tensors(state).items()
                      if isinstance(v, torch.Tensor)},
            "count": int(state.opt_state.count), "launches": dict(fa.LAUNCHES),
            "wall_s": wall}


def graph_verdict(eager: dict, graphed: dict, layers: int, steps: int) -> list[str]:
    """The failures of a graphed run against the eager one (graph_run's
    records), each starting with what differs: every step's loss and
    grad_norm bit-equal, the final state's params, mu, nu and master
    tensors equal, the same count, and K1-K3 and the delta pass launched
    layers x steps times in both runs."""
    import torch

    fails = []
    for key in ("loss", "grad_norm"):
        if len(eager[key]) != steps or len(graphed[key]) != steps:
            fails.append(f"{key} recorded for {len(eager[key])} (eager) and "
                         f"{len(graphed[key])} (graphed) steps, not {steps}")
        bad = [i + 1 for i, (a, b) in enumerate(zip(eager[key], graphed[key])) if not a == b]
        if bad:
            fails.append(f"{key} differs at steps {bad}")
    for group in GRAPH_STATE_GROUPS:
        keys = [k for k in eager["state"] if k.startswith(group + "/")]
        bad = [k for k in keys if k not in graphed["state"]
               or not torch.equal(eager["state"][k], graphed["state"][k])]
        if bad:
            fails.append(f"{group} differ in {len(bad)} of {len(keys)} tensors ({bad[0]} first)")
    if eager["count"] != graphed["count"]:
        fails.append(f"count {graphed['count']} after the graphed run, {eager['count']} eager")
    need = layers * steps
    for name, rec in (("eager", eager), ("graphed", graphed)):
        off = {k: rec["launches"].get(k, 0) for k in FLASH_LAUNCH_KEYS
               if rec["launches"].get(k, 0) != need}
        if off:
            fails.append(f"launches in the {name} run {off}, not {layers} x {steps} = {need}")
    return fails


def pow_mismatches(b: float, n: int = POW_COUNTS) -> dict:
    """Counts 1..n at which the card's f32 1 - b^count differs from the
    CPU's: how many, and the first."""
    import torch

    c = torch.arange(1, n + 1, dtype=torch.float32)
    host = 1.0 - torch.pow(b, c)
    card = (1.0 - torch.pow(b, c.cuda())).cpu()
    bad = (host != card).nonzero().flatten()
    return {"b": b, "counts": n, "mismatches": int(bad.numel()),
            "first": int(c[bad[0]]) if bad.numel() else None}


def graph_check(card: str) -> dict:
    """The graph check (module docstring, phase 4): eager, graphed, then
    each planted fault, one run at a time in this process."""
    import gc

    import torch

    from tf_operator_tpu_torch import optim

    def fresh(graphed, fault=""):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rec = graph_run(graphed, fault)
        rec["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rec["peak_reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
        return rec

    eager = fresh(False)
    graphed = fresh(True)
    fails = graph_verdict(eager, graphed, LAYERS, GRAPH_STEPS)
    if fails:
        raise SmokeFailure("graph check: the graphed chunk differs from the eager loop: "
                           + "; ".join(fails))
    faults = {}
    for label, fault, must in GRAPH_FAULTS:
        got = graph_verdict(eager, fresh(True, fault), LAYERS, GRAPH_STEPS)
        if not any(f.startswith(must) for f in got):
            raise SmokeFailure(f"graph check: the planted fault '{label}' was not rejected "
                               f"by '{must}': {got}")
        faults[fault] = got
    cfg = optim.OptimizerConfig()
    res = {"steps": GRAPH_STEPS, "bit_equal": True, "loss": graphed["loss"],
           "grad_norm": graphed["grad_norm"], "launches": graphed["launches"],
           "eager_wall_s": eager["wall_s"], "graphed_wall_s": graphed["wall_s"],
           "peak_gb": {k: {"eager": eager[k], "graphed": graphed[k]}
                       for k in ("peak_allocated_gb", "peak_reserved_gb")},
           "faults_rejected": faults,
           "pow_vs_cpu": [pow_mismatches(cfg.b1), pow_mismatches(cfg.b2)], "card": card}
    log("graph: " + json.dumps(res))
    return res


# The world graph check (dist4, four GPUs): graph_check in every rank of a
# world of four, one GPU a rank over NCCL. Each rank runs its cell's
# GRAPH_STEPS steps eagerly and graphed, each from a fresh model built from
# the same seed, on the same communicators; the first world adds
# WORLD_GRAPH_FAULTS, each (what it breaks, its name in
# planted_graph_fault, the failure that must name it); every world ends
# with a graphed run of CENSUS_STEPS steps under torch.profiler for the
# census a rank. (name, cell of world_graph_argv, mesh) of each world.
WORLD_GRAPH_RUNS = (("lm dp x tp", "lm", {"dp": 2, "tp": 2}),
                    ("bert fsdp", "bert", {"fsdp": 4}))
WORLD_GRAPH_FAULTS = (("a graph whose captured gradient all-reduce is left out of the replay",
                       "skip-grad-reduce", "grad_norm"),)
CENSUS_STEPS = 6
_WORLD_GRAPH_CHILD = ("import sys, chip_smoke\n"
                      "sys.exit(chip_smoke.world_graph_child(sys.argv[1:]))\n")


def world_graph_argv(cell: str, steps: int = GRAPH_STEPS) -> list[str]:
    """The trainer's argv of a world graph check's cell: the LM cell (lm)
    or BERT-base at seq 512, batch 32 (bert); both 12 layers."""
    if cell == "lm":
        return lm_argv(steps)
    model, seq, batch, _ = BERT_RUNS[0]
    return bert_argv(model, seq, batch, steps)


def world_graph_child(argv: list[str]) -> int:
    """A rank of the world graph check: argv = [record path, cell, 1 to run
    WORLD_GRAPH_FAULTS]. Joins the world from the operator's env, then
    graph_run eager and graphed (graph_verdict's failures), the faults'
    failures and the census (launch_census, census_failures for a world),
    written as JSON to the record path."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tf_operator_tpu_torch.parallel import distributed

    path, cell, with_faults = argv[0], argv[1], argv[2] == "1"
    distributed.initialize_from_env(device=torch.device("cuda", 0))

    def fresh(graphed, fault=""):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rec = graph_run(graphed, fault, argv=world_graph_argv(cell), world=True)
        rec["peak_gb"] = [torch.cuda.max_memory_allocated() / 1e9,
                          torch.cuda.max_memory_reserved() / 1e9]
        return rec

    eager, graphed = fresh(False), fresh(True)
    rec = {"fails": graph_verdict(eager, graphed, LAYERS, GRAPH_STEPS),
           "loss": graphed["loss"], "grad_norm": graphed["grad_norm"],
           "eager_loss": eager["loss"], "eager_grad_norm": eager["grad_norm"],
           "launches": {"eager": eager["launches"], "graphed": graphed["launches"]},
           "wall_s": {"eager": eager["wall_s"], "graphed": graphed["wall_s"]},
           "peak_allocated_reserved_gb": {"eager": eager["peak_gb"],
                                          "graphed": graphed["peak_gb"]}}
    del graphed
    if with_faults:
        rec["faults"] = {fault: graph_verdict(eager, fresh(True, fault), LAYERS, GRAPH_STEPS)
                         for _, fault, _ in WORLD_GRAPH_FAULTS}
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graph_run(True, steps=CENSUS_STEPS, argv=world_graph_argv(cell, CENSUS_STEPS),
                  world=True)
    rec["census"] = profiled_census(prof, LM_STEP_MARKER, LAYERS, CENSUS_STEPS)
    rec["census_fails"] = census_failures(rec["census"], world=True)
    Path(path).write_text(json.dumps(rec))
    distributed.distributed_goodbye()
    return 0


def world_graph_failures(name: str, ranks: list[dict], with_faults: bool) -> list[str]:
    """What of a world graph check's rank records (world_graph_child's) is
    wrong: a rank whose graphed run differs from its eager one, a planted
    fault no rank's check names, a census off census_failures' rule."""
    fails = []
    for r, rec in enumerate(ranks):
        fails += [f"{name} rank {r}: {f}" for f in rec["fails"] + rec["census_fails"]]
    for label, fault, must in WORLD_GRAPH_FAULTS if with_faults else ():
        if not all(any(f.startswith(must) for f in rec["faults"][fault]) for rec in ranks):
            fails.append(f"{name}: the planted fault '{label}' was not rejected by '{must}' "
                         f"in every rank: {[rec['faults'][fault] for rec in ranks]}")
    return fails


def world_graph_check(card: str) -> dict:
    """WORLD_GRAPH_RUNS, each as four ranks with a GPU each
    (world_graph_child), held by world_graph_failures."""
    out, fails = {}, []
    for i, (name, cell, mesh) in enumerate(WORLD_GRAPH_RUNS):
        port, children = free_port(), []
        for rank in range(4):
            env = {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "JAX_PROCESS_ID": str(rank),
                   "JAX_NUM_PROCESSES": "4", "TPUJOB_MESH": json.dumps(mesh),
                   "CUDA_VISIBLE_DEVICES": str(rank)}
            children.append(start_child([cell, "1" if i == 0 else "0"],
                                        f"_world_graph_{cell}_{rank}", env, _WORLD_GRAPH_CHILD))
        ranks = []
        for rank, (rc, _, rec) in enumerate(finish_child(c, timeout=900) for c in children):
            if rc != 0 or not rec:
                raise SmokeFailure(f"world graph {name}: rank {rank} exited {rc}")
            ranks.append(rec)
        fails += world_graph_failures(name, ranks, i == 0)
        res = {"world": name, "mesh": mesh, "steps": GRAPH_STEPS,
               "bit_equal": not any(r["fails"] for r in ranks),
               "loss": ranks[0]["loss"], "grad_norm": ranks[0]["grad_norm"],
               "launches": ranks[0]["launches"]["graphed"],
               "wall_s": [r["wall_s"] for r in ranks],
               "peak_allocated_reserved_gb": [r["peak_allocated_reserved_gb"] for r in ranks],
               "faults_rejected": ranks[0].get("faults"),
               "census": [{k: r["census"][k] for k in ("graph_launches_per_step",
                                                       "k123_by_launch_api",
                                                       "nccl_by_launch_api")}
                          for r in ranks],
               "fails": [f for f in fails if f.startswith(name)], "card": card}
        log("world graph: " + json.dumps(res))
        out[name] = res
    if fails:
        raise SmokeFailure("world graph check: " + "; ".join(fails))
    return out


# The kill check (graph4): BERT (dist_argv, 12 steps) at dp = 4, one GPU a
# rank over NCCL, rank 3 killed (SIGKILL, from here) once it has reported
# step KILL_STEP (its progress event comes after its next step is
# dispatched: the kill lands inside a step), with the world's collective
# timeout at KILL_TIMEOUT_S (the trainer's distributed.TIMEOUT is 300 s),
# on this tree's graph route and on its eager one (CHIP_SMOKE_STEP_ROUTE):
# every survivor must exit 138 (retryable) with a peer_lost event within
# KILL_LIMIT_S of the kill (the trainer's watchdog, parallel/peer_watch.py).
# A survivor still running then has its threads' Python stacks dumped
# (faulthandler, SIGUSR2) before it is killed; with --parent, the parent
# tree's eager world runs beside them for that record alone.
KILL_STEP = 3
KILL_TIMEOUT_S = 60
KILL_LIMIT_S = KILL_TIMEOUT_S + 30
KILL_MESH = {"dp": 4}
KILL_EAGER = {"CHIP_SMOKE_STEP_ROUTE": "eager"}
# A dist_child (or any chip_smoke function of argv) on another tree's
# package: argv = [record path, tree, function, *its argv].
_TREE_CHILD = (
    "import importlib.util, os, sys\n"
    "path, tree, fn = sys.argv[1:4]\n"
    "sys.path.insert(0, tree)\n"
    f"spec = importlib.util.spec_from_file_location('chip_smoke', {str(Path(__file__))!r})\n"
    "cs = importlib.util.module_from_spec(spec)\n"
    "sys.modules['chip_smoke'] = cs\n"
    "spec.loader.exec_module(cs)\n"
    "import tf_operator_tpu_torch\n"
    "assert os.path.realpath(tf_operator_tpu_torch.__file__).startswith(os.path.realpath(tree))\n"
    "sys.exit(getattr(cs, fn)([path, *sys.argv[4:]]))\n"
)


def link_build(tree: Path) -> None:
    """Point another tree's kernel build directory at this checkout's, so a
    tree with the same sources builds nothing (the libraries' names are
    hashes of their sources)."""
    shared = ROOT / "build" / "torch_kernels"
    shared.mkdir(parents=True, exist_ok=True)
    link = tree / "build" / "torch_kernels"
    if tree.resolve() != ROOT.resolve() and not link.exists():
        link.parent.mkdir(parents=True, exist_ok=True)
        link.symlink_to(shared)


def start_tree_world(tree: Path, tag: str, argv: list[str], mesh: dict, env: dict,
                     fn: str = "dist_child") -> list:
    """`fn` of chip_smoke on `tree`'s package as the ranks of a world at
    `mesh`, one GPU a rank (start_child's children)."""
    n = int(math.prod(mesh.values()))
    port = free_port()
    link_build(tree)
    return [start_child([str(tree), fn, *argv], f"_{tag}_{rank}",
                        {**env, "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                         "JAX_PROCESS_ID": str(rank), "JAX_NUM_PROCESSES": str(n),
                         "TPUJOB_MESH": json.dumps(mesh), "TPUJOB_REPLICA_INDEX": str(rank),
                         "CUDA_VISIBLE_DEVICES": str(rank)}, _TREE_CHILD)
            for rank in range(n)]


def kill_check(card: str, worlds: dict, argv: list[str] | None = None,
               mesh: dict = KILL_MESH) -> dict:
    """The kill check on each of `worlds` (label -> (tree, env added to the
    ranks')), all at once, on `argv` (the BERT run's by default) at `mesh`,
    its last rank killed: how every survivor ends (exit code, whether it
    emitted peer_lost, its last event, seconds from the kill), or, still
    running KILL_LIMIT_S after the kill, its threads' Python stacks and
    kernel wait channels (then killed here)."""
    if argv is None:
        argv = dist_argv()
        argv[argv.index("--steps") + 1] = "12"
    env = {"CHIP_SMOKE_DIST_ROLE": "measure", "CHIP_SMOKE_DIST_TIMEOUT_S": str(KILL_TIMEOUT_S)}
    started = {label: start_tree_world(tree, f"kill_{label.replace(' ', '_')}", argv, mesh,
                                       {**env, **extra})
               for label, (tree, extra) in worlds.items()}
    killed: dict = {}
    deadline = time.time() + 600
    while len(killed) < len(started) and time.time() < deadline:
        for label, children in started.items():
            proc, events_path, _ = children[-1]
            if label not in killed and max(_progress_steps(events_path), default=0) >= KILL_STEP:
                proc.send_signal(signal.SIGKILL)
                killed[label] = time.time()
        time.sleep(0.05)

    def end(label, rank, child):
        proc, events_path, _ = child
        t_kill = killed.get(label, time.time())
        stacks, waits = None, None
        try:
            _, stderr = proc.communicate(timeout=max(1.0, t_kill + KILL_LIMIT_S - time.time()))
            rc, seconds = proc.returncode, time.time() - t_kill
        except subprocess.TimeoutExpired:
            waits = thread_waits(proc.pid)
            proc.send_signal(signal.SIGUSR2)
            time.sleep(3)
            proc.kill()
            _, stderr = proc.communicate()
            rc, seconds = None, None
            lines = stderr.splitlines()
            at = next((i for i, x in enumerate(lines) if x.startswith(("Thread 0x",
                                                                      "Current thread"))),
                      len(lines))
            stacks = lines[at:at + 120]
        events = _events(events_path)
        return {"rank": rank, "exit_code": rc, "seconds_after_kill": seconds,
                "peer_lost": any(e["event"] == "peer_lost" for e in events),
                "peer_lost_error": next((e["error"] for e in events
                                         if e["event"] == "peer_lost"), None),
                "last_event": events[-1]["event"] if events else None,
                "stderr_tail": stderr.strip().splitlines()[-3:] if stacks is None else None,
                "stacks": stacks, "thread_waits": waits}

    with ThreadPoolExecutor(max_workers=sum(len(c) for c in started.values())) as pool:
        ends = {label: [pool.submit(end, label, r, c) for r, c in enumerate(children[:-1])]
                for label, children in started.items()}
        out = {"mesh": mesh, "kill_after_step": KILL_STEP, "timeout_s": KILL_TIMEOUT_S,
               "limit_s": KILL_LIMIT_S, "card": card}
        for label, futures in ends.items():
            out[label] = {"tree": str(worlds[label][0]), "env": worlds[label][1],
                          "killed": label in killed,
                          "survivors": [f.result() for f in futures]}
    for children in started.values():
        finish_child(children[-1], timeout=30)
    log("kill: " + json.dumps(out))
    return out


def thread_waits(pid: int) -> dict:
    """Each thread of a process by name: how many wait in each kernel wait
    channel (/proc/<pid>/task/*/wchan), and in which state."""
    waits: dict = {}
    for task in Path(f"/proc/{pid}/task").glob("*"):
        try:
            name = (task / "comm").read_text().strip()
            state = (task / "stat").read_text().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        try:
            wchan = (task / "wchan").read_text().strip() or "-"
        except OSError:
            wchan = "?"
        key = f"{name} {state} {wchan}"
        waits[key] = waits.get(key, 0) + 1
    return waits


def _events(path: Path) -> list[dict]:
    """The events of a metrics file a process may still be writing (a
    partial last line is left out)."""
    if not path.exists():
        return []
    out = []
    for line in path.read_text().splitlines():
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            pass
    return out


def _progress_steps(path: Path) -> list[int]:
    return [e["step"] for e in _events(path) if e["event"] == "progress"]


def kill_failures(res: dict, demanded=("graph", "eager")) -> list[str]:
    """Every survivor of each `demanded` world of kill_check's record must
    exit 138 with a peer_lost event within KILL_LIMIT_S of the kill."""
    fails = []
    for label in demanded:
        world = res.get(label)
        if world is None or not world["killed"]:
            fails.append(f"{label}: its last rank was never seen at step {KILL_STEP}")
            continue
        for s in world["survivors"]:
            t = s["seconds_after_kill"]
            if s["exit_code"] != 138 or not s["peer_lost"] or t is None or t > KILL_LIMIT_S:
                fails.append(f"{label}: rank {s['rank']} ended with {s['exit_code']} "
                             f"(peer_lost {s['peer_lost']}) "
                             f"{'never' if t is None else f'{t:.1f} s'} after the kill, not "
                             f"138 with peer_lost within {KILL_LIMIT_S} s")
    return fails


LM_STEP_MARKER = ("fwd_", "_kernel")


def kernel_group(name: str, groups) -> str:
    """The group of a profiled kernel's name: the first of `groups` with a
    substring in the lower-cased name, else "other"."""
    low = name.lower()
    return next((g for g, keys in groups if any(k in low for k in keys)), "other")


# The flash kernels whose launches the census follows (K1-K3).
K123_KEYS = ("fwd_kernel", "fwd_wgmma_kernel", "fwd_wide_wgmma_kernel", "bwd_dq_kernel",
             "bwd_dq_wgmma_kernel", "bwd_dq_wide_wgmma_kernel", "bwd_dkv_kernel",
             "bwd_dkv_wgmma_kernel", "bwd_dkv_wide_wgmma_kernel")
GRAPH_LAUNCH = "cudaGraphLaunch"


def is_k123(name: str) -> bool:
    low = name.lower()
    return any(k in low for k in K123_KEYS) and "delta" not in low


def is_nccl(name: str) -> bool:
    """An NCCL kernel (ncclKernel_*, ncclDevKernel_*)."""
    return name.lower().startswith("nccl")


def launch_census(kernels, runtime: dict, marker: tuple, per_step: int, steps: int) -> dict:
    """Which host API launched each kernel of a profiled run's steady
    window. `kernels`: the device kernels as (name, start, correlation id);
    `runtime`: correlation id -> the host runtime call's name (cudaLaunchKernel,
    cudaGraphLaunch, ...). The window is _profile_trainer's (from the first
    marker kernel of step LOG_EVERY + 1 to that of the last step); the
    graph launches counted are the distinct cudaGraphLaunch calls of the
    window's marker kernels, one a step when every step is one graph."""
    kernels = sorted(kernels, key=lambda k: k[1])
    marks = [k for k in kernels if all(m in k[0].lower() for m in marker)]
    if len(marks) != per_step * steps:
        raise SmokeFailure(f"the census saw {len(marks)} '{marker}' kernels, not "
                           f"{per_step} x {steps} steps")
    t0, t1 = marks[per_step * LOG_EVERY][1], marks[per_step * (steps - 1)][1]
    window = [k for k in kernels if t0 <= k[1] < t1]
    by_api: dict[str, int] = {}
    k123_by_api: dict[str, int] = {}
    nccl_by_api: dict[str, int] = {}
    for name, _, corr in window:
        api = runtime.get(corr, "unattributed")
        by_api[api] = by_api.get(api, 0) + 1
        for kind, counts in ((is_k123(name), k123_by_api), (is_nccl(name), nccl_by_api)):
            if kind:
                counts[api] = counts.get(api, 0) + 1
    graphs = {runtime.get(corr) == GRAPH_LAUNCH and corr for name, _, corr in window
              if all(m in name.lower() for m in marker)} - {False}
    n = steps - 1 - LOG_EVERY
    return {"steps": n, "graph_launches": len(graphs),
            "graph_launches_per_step": len(graphs) / n,
            "kernels_by_launch_api": by_api, "k123_by_launch_api": k123_by_api,
            "nccl_by_launch_api": nccl_by_api}


def census_failures(census: dict, world: bool = False) -> list[str]:
    """A graphed trainer's window must hold one cudaGraphLaunch a step and
    no K1-K3 or NCCL kernel launched by another call; a rank of a `world`
    must launch its step's NCCL kernels under the graph."""
    fails = []
    if census["graph_launches"] != census["steps"]:
        fails.append(f"{census['graph_launches']} cudaGraphLaunch calls over "
                     f"{census['steps']} steps")
    for what in ("k123", "nccl"):
        other = {api: n for api, n in census[f"{what}_by_launch_api"].items()
                 if api != GRAPH_LAUNCH}
        if other:
            fails.append(f"{'K1-K3' if what == 'k123' else 'NCCL'} kernels launched outside "
                         f"a graph: {other}")
    if world and not census["nccl_by_launch_api"].get(GRAPH_LAUNCH):
        fails.append("no NCCL kernel under the graph launches")
    return fails


def profiled_census(prof, marker: tuple, per_step: int, steps: int) -> dict:
    """launch_census over a finished torch.profiler run's device kernels and
    host runtime calls."""
    from torch.profiler import DeviceType

    raw = prof.profiler.kineto_results.events()
    return launch_census(
        [(e.name(), e.start_ns(), e.correlation_id()) for e in raw
         if e.device_type() == DeviceType.CUDA],
        {e.correlation_id(): e.name() for e in raw
         if e.device_type() == DeviceType.CPU and e.name().startswith(("cuda", "cu"))},
        marker, per_step, steps)


def _profile_trainer(argv, steps: int, marker: tuple, per_step: int, groups,
                     batch: int, card: str, trace: str, graphed: bool = True) -> dict:
    """One trainer run under torch.profiler: device time by kernel group
    over its steady steps, the steps after its first chunk. Each step is
    cut at its first kernel whose lower-cased name holds every substring of
    `marker` (the kernel stream's (per_step * i)-th such kernel), so the
    window holds whole steps of device work and the gaps between them.
    Also the launch census (launch_census); a `graphed` run must pass
    census_failures. Returns the summary."""
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
        "model": argv[1], "seq": int(argv[argv.index("--seq") + 1]) if "--seq" in argv
        else None, "steps": steps - 1 - LOG_EVERY, "batch": batch,
        "window_ms": window_ms, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / window_ms, "kernels": n_kernels,
        "device_ms_by_group": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8]),
        "card": card}}
    summary["profile"]["launches"] = census = profiled_census(prof, marker, per_step, steps)
    prof.export_chrome_trace(str(OUT_DIR / trace))
    log("profile: " + json.dumps(summary))
    fails = census_failures(census) if graphed else []
    if fails:
        raise SmokeFailure(f"profile {argv[1]}: " + "; ".join(fails))
    return summary["profile"]


def profile_phase(args, card: str) -> None:
    """Both trainers' runs, as the train phase drives them, the 64k LM
    with --remat --remat-save-flash (LONGCTX_RUNS' first, 5 steps),
    BERT-base at seq 512 (BERT_RUNS' first) and the MoE cell (sparse),
    under torch.profiler. The LM's steps are cut at their first attention
    forward (24 a step at 64k: the forward's and the loss replay's),
    ResNet-50's at their loss's log-softmax forward. The Chrome traces go
    to OUT_DIR."""
    if args.steps < LOG_EVERY + 2:
        raise SmokeFailure(f"the profile needs --steps >= {LOG_EVERY + 2}")
    _profile_trainer(lm_argv(args.steps), args.steps, LM_STEP_MARKER, LAYERS, LM_GROUPS,
                     BATCH, card, "train_profile.trace.json")
    _profile_trainer(resnet_argv(args.steps), args.steps, ("softmax", "forward"), 1,
                     RESNET_GROUPS, RN_BATCH, card, "resnet50_profile.trace.json")
    _, seq, _, extra, k1_per_step, _ = LONGCTX_RUNS[0]
    _profile_trainer(longctx_argv(seq, 5, extra), 5, LM_STEP_MARKER, k1_per_step,
                     LM_GROUPS, 1, card, "longctx_profile.trace.json")
    model, seq, batch, layers = BERT_RUNS[0]
    _profile_trainer(bert_argv(model, seq, batch, args.steps), args.steps, LM_STEP_MARKER,
                     layers, LM_GROUPS, batch, card, "bert_profile.trace.json")
    _profile_trainer(moe_argv("sparse", steps=args.steps), args.steps, LM_STEP_MARKER,
                     MOE_LAYERS, MOE_GROUPS, MOE_BATCH, card, "moe_profile.trace.json")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="build,check,train,ckpt,eval,longctx,preempt,bert,data,dist,sp,moe,"
                            "serve,multislice,pipeline,pod",
                    help="comma-separated subset of build,check,train,ckpt,eval,longctx,"
                         "preempt,bert,data,dist,sp,moe,serve,multislice,pipeline,pod,profile; "
                         "multislice_eager (with multislice) adds its eager slices; "
                         "k4 for the fused bottleneck's "
                         "checks alone, k5 for the grouped matmul's (moe runs them too; "
                         "xent for the MLM loss kernel's (bert runs them too); "
                         "eval follows the ckpt phase's directory); graph4 (the world "
                         "graph and kill checks; kill4 the kill check alone), dist4, pod4 and "
                         "moe4 (the MoE's) on a "
                         "machine of four GPUs, in that order")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--parent", type=Path, default=None,
                    help="a tree of the repo (e.g. a git archive of the parent commit) "
                         "whose eager NCCL world graph4's kill check runs beside this "
                         "tree's, recorded (its survivors' stacks), not held")
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
    results: dict = {}  # the eval, longctx and preempt phases' records
    try:
        build_phase()
        if "check" in phases:
            check_phase(records)
        elif "k4" in phases:
            k4_check_phase(records)
        if "k5" in phases and "moe" not in phases:
            k5_check_phase(records)
        if "xent" in phases:
            results["mlm_xent"] = mlm_xent_check(records)
        uninterrupted = synthetic_ips = None
        if "train" in phases:
            launches, uninterrupted = train_phase(args, card)
            synthetic_ips = resnet_train_phase(args, card)
            narrow_lm_phase(card)
            results["wide_lm"] = wide_lm_phase(records, card, uninterrupted, args.steps)
            results["graph"] = graph_check(card)
        if "ckpt" in phases:
            _, final_state = ckpt_phase(args, card, uninterrupted)
            if "eval" in phases:
                results["eval"] = eval_phase(args, card, final_state)
            del final_state
            shutil.rmtree(CKPT_DIR, ignore_errors=True)
        if "longctx" in phases:
            results["longctx"] = longctx_phase(records, card)
        if "preempt" in phases:
            results["preempt"] = preempt_phase(args, card, uninterrupted)
        if "bert" in phases:
            results["bert"] = bert_phase(records, card)
        if "data" in phases:
            results["data"] = data_phase(card, synthetic_ips)
        if "dist" in phases:
            results["dist"] = dist_phase(records, card)
        if "sp" in phases:
            results["sp"] = sp_phase(records, card)
        if "moe" in phases:
            results["moe"] = moe_phase(records, card)
        if "serve" in phases:
            results["serve"] = serve_phase(card)
        if "multislice" in phases:
            results["multislice"] = multislice_phase(records, card,
                                                     "multislice_eager" in phases)
        if "pipeline" in phases:
            results["pipeline"] = pipeline_phase(records, card)
        if "pod" in phases:
            results["pod"] = pod_phase(records, card)
        if "graph4" in phases:
            results["graph4"] = graph4_phase(card, args.parent)
        elif "kill4" in phases:
            results["kill4"] = kill4_phase(card, args.parent)
        if "dist4" in phases:
            results["dist4"] = dist4_phase(records, card)
        if "pod4" in phases:
            results["pod4"] = pod4_phase(records, card)
        if "moe4" in phases:
            results["moe4"] = moe4_phase(card)
        if "profile" in phases:
            profile_phase(args, card)
    except Exception as e:  # every phase failure ends the run without a result
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1

    from tf_operator_tpu_torch.ops import flash_attention as fa

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
        for extra in (f"at_batch_{BATCH}", "head_widths", "at_T_65536", "bert", "dist",
                      "sp", "sp_launches_per_step_per_rank", "moe",
                      "multislice_launches_per_slice", "pipeline_launches_per_step_per_rank",
                      "pod", "pod_launches_per_step_per_rank", "wide_lm"):
            if extra in rec:
                entry[extra] = rec[extra]
        entry["kernel_functions"] = (
            {"every route": "bwd_delta_kernel"} if key == "bwd_delta" else
            {route: names[key] for route, names in fa.ROUTE_KERNELS.items() if key in names})
        if "wide_lm" in results:
            wide = kernel_function(key, torch.bfloat16, 256)
            entry["wide_lm_kernel"] = wide
            entry["wide_lm_launches"] = results["wide_lm"]["kernel_launches"][wide]
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
    for name, _ in K5:
        rec = records.get(name, {})
        kernels.append({
            "name": name, "route": "cuda", "source": K5_SOURCE, "replaces": K5_REPLACES,
            **{k: rec.get(k) for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms")},
            "kernel_functions": K5_FUNCTIONS[name],
            "kernel_route": rec.get("route"), "sm_count": rec.get("sm_count"),
            "note": ("launches: the sparse moe-lm cell's run (12 a step); times at the "
                     "cell's routed rows, K 768, N 3072, on kernel_route (the first of "
                     "kernel_functions; the others are the mma.sync and FMA routes); "
                     "tgmm's ms with a bf16 output, as the trainer asks, ms_f32_out "
                     "with f32; ms_k3072_n768 the other orientation; library_ms "
                     "torch._grouped_mm, or its error"),
            **{k: rec.get(k) for k in ("ms_f32_out", "ms_k3072_n768", "group_sizes")},
        })
    rec = records.get("mlm_xent", {})
    kernels.append({
        "name": "mlm_xent", "route": "cuda", "source": "tf_operator_tpu_torch/csrc/mlm_xent.cu",
        "replaces": None,
        **{k: rec.get(k) for k in ("ms", "plain_ms", "bound_ms", "bound_by", "loss_only_ms",
                                   "grad_steps", "loss_rel_gap", "shapes")},
        "note": ("replaces no Pallas kernel (the JAX loss is XLA's); BERT's masked cross "
                 "entropy and its gradient in place over the bf16 logits; times at "
                 "[65536, 30522] (pitch 30528); launches in the bert phase's runs "
                 "(mlm_xent_launches_per_step) and the dist worlds'")})
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"phases": results}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
