#!/usr/bin/env python3
"""The port's serve cell on one CUDA card, from two trees of the repo, in
alternating runs: a server that replays CUDA graphs against a tree whose
server runs eagerly.

    python3 tools/serve_cells.py --trees .,artifacts/parent --out artifacts/serve_cells.jsonl

A tree is a checkout (e.g. a `git archive` of a parent commit unpacked
under a git-ignored directory). The checkpoint is written once, by this
checkout's trainer at chip_smoke's serve cell (serve_train_argv: the
full-width LM, 2 steps at seq 2048). Each run is a fresh process that
imports the tree's `tf_operator_tpu_torch` and this checkout's
chip_smoke.py, and drives the tree's server on that checkpoint:

  - the server as a pod runs it, started from the tree
    (chip_smoke.run_server): time to ready, request a (8 rows, 64 new
    tokens each), the 24 concurrent rows of b, p50 and p99;
  - request a through the tree's InferenceServer in this process
    (chip_smoke.reference_answers): the load's seconds, every prefill and
    tick of the server's own functions (each synchronised), the peak
    allocated and reserved memory over the load and the request;
  - chip_smoke.device_profile on that server's weights and cache: its
    prefill at (8, 2048) and its tick at every slot beside the eager
    models/decode.py functions, in turn, then each tick under
    torch.profiler and, on the graph route, the launch census of the
    server's tick.

The runs go A, B, B, A. Each run's record is a JSON line in --out, with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_LOAD = r'''
import importlib.util, os, sys
root = sys.argv[1]
spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
sys.modules["chip_smoke"] = cs
spec.loader.exec_module(cs)
'''

_TRAIN = _LOAD + r'''
import shutil
sys.path.insert(0, root)
ckpt_dir = cs.SERVE_DIR / "ckpt"
shutil.rmtree(ckpt_dir, ignore_errors=True)
cs.run_trainer(cs.serve_train_argv(cs.SERVE, ckpt_dir), tag="_serve")
'''

_RUN = _LOAD + r'''
import json
from pathlib import Path
tree, out = sys.argv[2:4]
sys.path.insert(0, tree)
import torch
import tf_operator_tpu_torch
assert os.path.realpath(tf_operator_tpu_torch.__file__).startswith(os.path.realpath(tree))
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cell = cs.SERVE
ckpt_dir = cs.SERVE_DIR / "ckpt"
a_rows, b_reqs = cs.serve_requests(cell)
served = cs.run_server(cell, ckpt_dir, a_rows, b_reqs, tree=Path(tree))
ref = cs.reference_answers(ckpt_dir, cell, a_rows, cell.a_new)
held = cs.held_answers(served["a_answers"], ref["answers"], ref["margins"])
prof = cs.device_profile(ref, cell, a_rows)
tick_ms = sorted(t * 1e3 for t in ref["times"]["tick"])
prefill_s = sum(prof["prefill_s"]["server"]) / len(prof["prefill_s"]["server"])
census = prof["tick_census"]
rec = {
    "tree": tree, "route": ref["route"], "card": cs.card_line(),
    "ready_s": served["ready_s"], "a_s": served["a_s"],
    "b_ms": {"p50": served["b_p50_s"] * 1e3, "p99": served["b_p99_s"] * 1e3},
    "server_stats": {k: served["stats"][k] for k in (
        "served_total", "decode_steps", "tokens_total", "latency_p50_ms", "latency_p99_ms")},
    "load_s": ref["load_s"],
    "tick_ms": {"mean": sum(tick_ms) / len(tick_ms), "p50": cs._percentile(tick_ms, 0.5),
                "p99": cs._percentile(tick_ms, 0.99), "n": len(tick_ms)},
    "decode_tokens_per_s": len(a_rows) * 1e3 / (sum(tick_ms) / len(tick_ms)),
    "prefill_ms": prefill_s * 1e3, "prefill_tokens_per_s": sum(cell.a_lengths) / prefill_s,
    "tick_bound_ms": cs.tick_bound_bytes(ref["params"], ref["cfg"], cell.slots + 1, cell.seq)
    / cs.PEAK_BYTES_PER_S * 1e3,
    "peak_allocated_bytes": ref["peak_bytes"], "peak_reserved_bytes": ref["peak_reserved_bytes"],
    "answers_held": held, "repeats": {"prefill_s": prof["prefill_s"], "tick_ms": prof["tick_ms"]},
    "tick_profile": prof["tick"], "eager_tick_profile": prof["eager_tick"],
    "tick_census": census,
}
with open(out, "a") as f:
    f.write(json.dumps(rec) + "\n")
print(json.dumps({k: rec[k] for k in ("tree", "route", "ready_s", "tick_ms",
                                       "decode_tokens_per_s", "prefill_ms", "b_ms")}))
'''


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", required=True, help="A,B: two checkouts, run A, B, B, A")
    ap.add_argument("--out", required=True, help="the JSON-lines file the records are appended to")
    args = ap.parse_args(argv)
    trees = [str(Path(t).resolve()) for t in args.trees.split(",")]
    if len(trees) != 2:
        raise SystemExit("--trees takes two checkouts")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([sys.executable, "-c", _TRAIN, str(ROOT)], check=True, timeout=900)
    for tree in (trees[0], trees[1], trees[1], trees[0]):
        subprocess.run([sys.executable, "-c", _RUN, str(ROOT), tree, args.out], check=True,
                       timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
