#!/usr/bin/env python3
"""The port's trainer on four GPUs, one a rank over NCCL, from several trees
of the repo, or one tree on each of its routes: each rank's graphed step
against a tree (or a route) whose ranks step eagerly.

    python3 tools/world_cells.py --trees .,artifacts/parent
    python3 tools/world_cells.py --trees .,artifacts/parent --cells lm-dp4-pod,bert-dp4
    python3 tools/world_cells.py --trees .,.:eager,artifacts/parent --cells lm64k-sp4

A tree is a checkout (e.g. a `git archive` of a parent commit unpacked
under a git-ignored directory); `TREE:eager` runs it with every rank sent
eager (chip_smoke.dist_child's CHIP_SMOKE_STEP_ROUTE). Each run starts the
cell's ranks (or its pod) as fresh processes that import the tree's
`tf_operator_tpu_torch` and this checkout's chip_smoke.py
(chip_smoke._TREE_CHILD), each rank through chip_smoke.dist_child (a pod
through chip_smoke.pod_child), at the cell's arguments from chip_smoke's
own argv functions, STEPS steps in chunks of 2:

  lm-dp4-pod  the full-width LM, seq 8192, batch 4, at dp 4 as one pod of
              four GPUs (its supervisor starts the ranks)
  lm-dp-tp    the LM at dp x tp = 2 x 2
  bert-dp4    BERT-base at seq 512, batch 32, dp 4
  bert-fsdp4  the same at fsdp 4
  moe-ep4     the MoE cell (12 layers, sparse dispatch) at ep 4
  lm64k-sp4   the 64k LM, batch 1, --remat --remat-save-flash, sp 4 (ring)

A run reports global tokens/s (rank 0's examples/s x seq over the
trainer's timed window) and its mean step time, rank 0's every step's
loss and gradient norm, and for each rank its route, its peak allocated
and reserved memory (torch.cuda.max_memory_*) and its device's idle share
over the last chunk, which the trainer profiles outside the timed window
(--profile-dir): one minus the union of its kernels, copies and sets over
the span from the first to the last. At lm64k-sp4 each rank also records
what the allocator holds after its last chunk, by pool (a CUDA graph's own
or the allocator's) and by block size (chip_smoke.memory_pools). The trees
rotate their order from cell to cell, one run each. Each run's record is
a JSON line in --out, the card's name and power limit in each.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

STEPS = 10
CELLS = ("lm-dp4-pod", "lm-dp-tp", "bert-dp4", "bert-fsdp4", "moe-ep4", "lm64k-sp4")


def _with(argv: list[str], **flags) -> list[str]:
    """argv with each --flag's value replaced."""
    argv = list(argv)
    for flag, value in flags.items():
        argv[argv.index("--" + flag.replace("_", "-")) + 1] = str(value)
    return argv


def cell_spec(cell: str) -> tuple[list[str], int, dict, dict]:
    """(argv, tokens an example, mesh, extra env) of a cell."""
    if cell.startswith("lm-"):
        mesh = {"dp": 4} if cell == "lm-dp4-pod" else {"dp": 2, "tp": 2}
        return cs.lm_argv(STEPS), cs.SEQ, mesh, {}
    if cell.startswith("bert-"):
        model, seq, batch, _ = cs.BERT_RUNS[0]
        mesh = {"dp": 4} if cell == "bert-dp4" else {"fsdp": 4}
        return cs.bert_argv(model, seq, batch, STEPS), seq, mesh, {}
    if cell == "moe-ep4":
        return (_with(cs.moe_argv("sparse", steps=STEPS), log_every=2), cs.MOE_SEQ,
                {"ep": 4}, {})
    if cell == "lm64k-sp4":
        argv = cs.longctx_argv(cs.LONG_SEQ, STEPS, ["--remat", "--remat-save-flash"])
        return _with(argv, log_every=2), cs.LONG_SEQ, {"sp": 4}, {"TPUJOB_SP_MODE": "ring"}
    raise ValueError(f"unknown cell {cell!r} (one of {CELLS})")


def idle_share(trace: Path) -> dict:
    """The device's busy and idle time over a Chrome trace's device events
    (kernels, copies, sets): the union of their spans against the span
    from the first start to the last end."""
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0))
                   for e in json.loads(trace.read_text()).get("traceEvents", [])
                   if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                                "gpu_memset"))
    if not spans:
        return {"window_ms": None, "busy_ms": None, "idle_share": None, "events": 0}
    busy, start, end = 0.0, spans[0][0], spans[0][0]
    for lo, hi in spans:
        if lo > end:
            busy += end - start
            start = lo
        end = max(end, hi)
    busy += end - start
    window = max(hi for _, hi in spans) - spans[0][0]
    return {"window_ms": window / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / window if window else None, "events": len(spans)}


# The cells whose ranks record their allocator's pools.
SNAPSHOT_CELLS = ("lm64k-sp4",)


def run_cell(tree: Path, cell: str, out: Path, timeout: float, card: str,
             route: str = "") -> dict:
    """One run of `cell` on `tree`'s package (every rank sent to `route`
    when given): its record (module docstring)."""
    argv, tokens, mesh, env = cell_spec(cell)
    n = int(math.prod(mesh.values()))
    tag = f"cells_{cell}_{tree.name or 'tree'}" + (f"_{route}" if route else "")
    prof_dir = cs.OUT_DIR / tag
    shutil.rmtree(prof_dir, ignore_errors=True)
    argv = argv + ["--profile-dir", str(prof_dir)]
    env = {**env, "CHIP_SMOKE_DIST_ROLE": "measure"}
    if route:
        env["CHIP_SMOKE_STEP_ROUTE"] = route
    if cell in SNAPSHOT_CELLS:
        env["CHIP_SMOKE_MEMORY_SNAPSHOT"] = "1"
    t0 = time.time()
    if cell.endswith("-pod"):
        cs.link_build(tree)
        pod = cs.start_child([str(tree), "pod_child", *argv], f"_{tag}",
                             {**env, "CUDA_VISIBLE_DEVICES": ",".join(map(str, range(n))),
                              "TPUJOB_MESH": json.dumps(mesh)}, cs._TREE_CHILD)
        rc, events, _ = cs.finish_child(pod, timeout)
        rcs = [rc]
        ranks = [json.loads(Path(f"{pod[2]}.{i}").read_text()) if rc == 0 else {}
                 for i in range(n)]
        traces = [prof_dir / ("local-0" + (f"-local{i}" if i else "")) / "trace.json"
                  for i in range(n)]
    else:
        children = cs.start_tree_world(tree, tag, argv, mesh, env)
        done = [cs.finish_child(c, timeout) for c in children]
        rcs = [rc for rc, _, _ in done]
        events = done[0][1]
        ranks = [rec for _, _, rec in done]
        traces = [prof_dir / f"local-{i}" / "trace.json" for i in range(n)]
    by = {e["event"]: e for e in events}
    eps = by.get("done", {}).get("examples_per_sec")
    rec = {"cell": cell, "tree": str(tree), "forced_route": route or None, "mesh": mesh,
           "exit_codes": rcs, "route": [r.get("step_route") for r in ranks],
           "tokens_per_s": eps * tokens if eps else None,
           "step_time_s": (by.get("done", {}).get("step_time_s") or {}).get("mean"),
           "final_loss": by.get("done", {}).get("final_loss"),
           "losses": {e["step"]: e["loss"] for e in events if e["event"] == "progress"},
           "grad_norms": ranks[0].get("grad_norms") if ranks else None,
           "peak_allocated_gb": [r.get("peak_gb") for r in ranks],
           "peak_reserved_gb": [r.get("peak_reserved_gb") for r in ranks],
           "device": [idle_share(t) if t.exists() else None for t in traces],
           "memory_pools": [r.get("memory_pools") for r in ranks],
           "wall_s": time.time() - t0, "card": card}
    with out.open("a") as f:
        f.write(json.dumps(rec) + "\n")
    print(f"world_cells: {json.dumps(rec)}", flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", default=".,artifacts/parent",
                    help="trees, comma-separated, relative to the repo root, each TREE or "
                         "TREE:eager")
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--out", default="artifacts/world_cells/world_cells.jsonl")
    ap.add_argument("--timeout", type=float, default=900)
    args = ap.parse_args()
    import torch

    if torch.cuda.device_count() < 4:
        print(f"world_cells: needs four GPUs, sees {torch.cuda.device_count()}",
              file=sys.stderr)
        return 1
    trees = [((ROOT / t.partition(":")[0]).resolve(), t.partition(":")[2])
             for t in args.trees.split(",")]
    out = (ROOT / args.out).resolve()
    out.parent.mkdir(parents=True, exist_ok=True)
    card = cs.card_line()
    cs.build_phase()
    failed = 0
    for i, cell in enumerate(args.cells.split(",")):
        k = i % len(trees)
        for tree, route in trees[k:] + trees[:k]:
            rec = run_cell(tree, cell, out, args.timeout, card, route)
            failed += any(rc != 0 for rc in rec["exit_codes"])
    print(f"world_cells: {failed} failed runs; records in {out}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
