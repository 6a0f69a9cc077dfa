#!/usr/bin/env python3
"""The port's trainer cells on one CUDA card, from two trees of the repo,
in alternating runs: the graphed step against a tree that steps eagerly.

    python3 tools/graph_cells.py --trees .,artifacts/parent
    python3 tools/graph_cells.py --trees .,artifacts/parent --cells lm,bert --no-profile

A tree is a checkout (e.g. a `git archive` of a parent commit unpacked
under a git-ignored directory). Each run is a fresh process that imports
the tree's `tf_operator_tpu_torch` and this checkout's chip_smoke.py, and
drives the tree's trainer (`models.train.main`) at the cell's arguments,
chip_smoke's own argv functions:

  lm          the full-width LM, seq 8192, batch 4, 6 steps (lm_argv)
  bert        BERT-base at seq 512, batch 32 (BERT_RUNS' first)
  moe-sparse  the MoE cell, sparse dispatch (moe_argv)
  moe-dense   the MoE cell, dense dispatch
  resnet50    ResNet-50 at batch 256, 224x224 (resnet_argv)
  lm64k       the 64k LM with --remat --remat-save-flash, 5 steps
  lm128k      the 128k LM with --remat --remat-save-flash-layers 9, 3
              steps (timed only)

A timed run reports tokens/s (examples/s x seq; images/s for ResNet-50)
and the mean step time from the trainer's done event, and the peak
allocated and reserved memory (torch.cuda.max_memory_*). The timed runs go
A, B, B, A per cell, each tree's kernels built once beforehand into this
checkout's build directory (the library names are hashes of the sources).
A profiled run (chip_smoke._profile_trainer) adds the device's idle share
over the steady window, its step time and the launch census (which host
call launched each kernel). Each run's record is a JSON line in --out, the
card's name and power limit in each.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELLS = ("lm", "bert", "moe-sparse", "moe-dense", "resnet50", "lm64k", "lm128k")

_CHILD = r'''
import importlib.util, json, os, sys
tree, root, cell, mode, out = sys.argv[1:6]
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
sys.modules["chip_smoke"] = cs
spec.loader.exec_module(cs)
import torch
import tf_operator_tpu_torch
assert os.path.realpath(tf_operator_tpu_torch.__file__).startswith(os.path.realpath(tree))
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
sys.path.insert(1, os.path.join(root, "tools"))
from graph_cells import cell_spec
argv, tokens, prof = cell_spec(cs, cell)
card = cs.card_line()
rec = {"cell": cell, "mode": mode, "tree": tree, "card": card}
if mode == "timed":
    by = cs.run_trainer(argv, tag="_cells")
    done = by["done"]
    eps = done.get("examples_per_sec")
    rec.update(tokens_per_s=eps * tokens if eps else None,
               step_time_s=(done.get("step_time_s") or {}).get("mean"),
               final_loss=done["final_loss"],
               route=by.get("model_ready", {}).get("step_route", "eager"),
               peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
               peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9)
else:
    marker, per_step, groups, batch, steps = prof
    summary = cs._profile_trainer(argv, steps, marker, per_step, groups, batch, card,
                                  f"cells_{cell}_{os.path.basename(tree.rstrip('/')) or 'tree'}"
                                  ".trace.json", graphed=False)
    rec.update({k: summary[k] for k in ("window_ms", "device_busy_ms", "idle_share",
                                        "steps", "launches", "device_ms_by_group")})
    rec["step_ms"] = summary["window_ms"] / summary["steps"]
with open(out, "a") as f:
    f.write(json.dumps(rec) + "\n")
'''


def cell_spec(cs, cell: str):
    """(argv, tokens per example, profile spec or None) of a cell, from
    chip_smoke's (cs) argv functions; the profile spec is _profile_trainer's
    (marker, per_step, groups, batch, steps)."""
    if cell == "lm":
        return (cs.lm_argv(6), cs.SEQ,
                (cs.LM_STEP_MARKER, cs.LAYERS, cs.LM_GROUPS, cs.BATCH, 6))
    if cell == "bert":
        model, seq, batch, layers = cs.BERT_RUNS[0]
        return (cs.bert_argv(model, seq, batch, 6), seq,
                (cs.LM_STEP_MARKER, layers, cs.LM_GROUPS, batch, 6))
    if cell in ("moe-sparse", "moe-dense"):
        return (cs.moe_argv(cell.split("-")[1], steps=6), cs.MOE_SEQ,
                (cs.LM_STEP_MARKER, cs.MOE_LAYERS, cs.MOE_GROUPS, cs.MOE_BATCH, 6))
    if cell == "resnet50":
        return (cs.resnet_argv(6), 1,
                (("softmax", "forward"), 1, cs.RESNET_GROUPS, cs.RN_BATCH, 6))
    if cell == "lm64k":
        _, seq, _, extra, k1_per_step, _ = cs.LONGCTX_RUNS[0]
        return (cs.longctx_argv(seq, 5, extra), seq,
                (cs.LM_STEP_MARKER, k1_per_step, cs.LM_GROUPS, 1, 5))
    if cell == "lm128k":
        _, seq, steps, extra, _, _ = cs.LONGCTX_RUNS[3]
        return cs.longctx_argv(seq, steps, extra), seq, None
    raise ValueError(f"unknown cell {cell!r} (one of {CELLS})")


def run(tree: Path, cell: str, mode: str, out: Path, timeout: float) -> int:
    cmd = [sys.executable, "-c", _CHILD, str(tree), str(ROOT), cell, mode, str(out)]
    t0 = time.time()
    try:
        rc = subprocess.run(cmd, cwd=str(ROOT), timeout=timeout).returncode
    except subprocess.TimeoutExpired:
        rc = 124
    print(f"graph_cells: {tree} {cell} {mode}: rc {rc} in {time.time() - t0:.1f} s",
          flush=True)
    return rc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", default=".,artifacts/parent",
                    help="two trees, comma-separated, relative to the repo root")
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--no-profile", action="store_true")
    ap.add_argument("--out", default="artifacts/graph_cells/graph_cells.jsonl")
    ap.add_argument("--timeout", type=float, default=600)
    args = ap.parse_args()
    trees = [(ROOT / t).resolve() for t in args.trees.split(",")]
    out = (ROOT / args.out).resolve()
    out.parent.mkdir(parents=True, exist_ok=True)
    shared = ROOT / "build" / "torch_kernels"
    shared.mkdir(parents=True, exist_ok=True)
    for tree in trees:
        link = tree / "build" / "torch_kernels"
        if tree != ROOT and not link.exists():
            link.parent.mkdir(parents=True, exist_ok=True)
            link.symlink_to(shared)
    # Build every kernel once, in parallel (chip_smoke's build phase).
    subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke.build_phase()"],
                   cwd=str(ROOT), check=True)
    failed = 0
    for cell in args.cells.split(","):
        for tree in (trees[0], trees[1], trees[1], trees[0]):
            failed += run(tree, cell, "timed", out, args.timeout) != 0
        if not args.no_profile and cell != "lm128k":
            for tree in trees:
                failed += run(tree, cell, "profiled", out, args.timeout) != 0
    print(f"graph_cells: {failed} failed runs; records in {out}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
