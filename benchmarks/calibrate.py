"""The readings the limits are set from, at a cell's own size, on the card.

    python3 benchmarks/calibrate.py --workload <cell> --seeds 11,12,13 [--variants ...]

For each seed, the plain reference in float32 (as in a run) and, in the
program's place, each variant, held to it by compare.readings:

  control     the reference computed in float8 (reference/lowp.py), the
              precision below the configurations' bfloat16;
  control_replays
              the same from the second step on, the first in float32: a
              lower precision in the replayed graph alone, which the numbers
              read from the first step cannot see;
  half_batch  a fault: the loss over the first half of each batch's rows,
              the mean taken over them;
  token       a fault: the first token of every row altered where the
              batch is made.

A step that leaves the state unchanged reads 1 on change_gap and grad_gap
by their definition and needs no run. One JSON line a (seed, variant);
nothing of the program runs here.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import cells, compare, weights  # noqa: E402
from benchmarks.reference import train as ref_train  # noqa: E402

VARIANTS = ("control", "control_replays", "half_batch", "token")


def half_batch(batch: dict) -> dict:
    rows = batch["tokens"].shape[0] // 2
    return {k: v[:rows] for k, v in batch.items()}


def altered_token(arch: dict):
    def alter(batch: dict) -> dict:
        tokens = batch["tokens"].clone()
        tokens[:, 0] = (tokens[:, 0] + 1) % arch["vocab"]
        return dict(batch, tokens=tokens)

    return alter


def variant_readings(cell: dict, seed: int, device, variants=VARIANTS) -> dict:
    """{variant: compare.readings of it against the float32 reference}."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch, shape, opt = cell["arch"], cell["shape"], cell["optimizer"]
    init = weights.make(arch, cell["cfg"]["init_std"], seed, device)
    ref = ref_train.observe(init, arch, shape, opt, seed, device)
    del ref["last_state"]
    kwargs = {"control": {"precision": "fp8"},
              "control_replays": {"precision": "fp8", "from_step": 1},
              "half_batch": {"alter": half_batch}, "token": {"alter": altered_token(arch)}}
    found = {}
    for v in variants:
        got = ref_train.observe(init, arch, shape, opt, seed, device, **kwargs[v])
        # The last step's gradient is judged at the state that step started
        # from, as a run judges the program's.
        at = ref_train.last_gradient(got.pop("last_state"), arch, shape, seed, device)
        found[v] = compare.readings(got, dict(ref, **at))
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        found = variant_readings(cell, seed, device, args.variants.split(","))
        for variant, values in found.items():
            print(json.dumps({"workload": cell["name"], "seed": seed, "variant": variant,
                              "seconds": time.time() - t0, **values}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
