"""Helpers of the sequence-parallel attention tests (tests/test_torch_ring_attention.py,
tests/test_torch_ulysses.py).

`attention_world` runs one gloo world (tests/torch_dist.py's run_world,
through the operator's env) in which every rank takes its part of the same
global q, k, v and output cotangent w (made from a seed with numpy): its
rows over dp, its heads over tp, its sequence block over sp. For each case
(scheme, causal, block) it runs the port's ring_attention or
ulysses_attention and the gradients of sum(o * w), and `attention_world`
reassembles every rank's o, dq, dk and dv into global arrays.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
from torch_dist import assert_ok, run_world

SHAPE = (2, 4, 64, 32)  # [B, H, T, D]
SEED = 0

_CHILD = """
import json, sys, numpy as np, torch
from tf_operator_tpu_torch.parallel import distributed, mesh as mesh_lib
from tf_operator_tpu_torch.parallel.ring_attention import ring_attention
from tf_operator_tpu_torch.parallel.ulysses import ulysses_attention
from tf_operator_tpu_torch.parallel.collectives import local_slice
torch.set_num_threads(1)
distributed.initialize_from_env()
mesh = mesh_lib.mesh_from_env()
out_path, shape, seed, cases = sys.argv[1], json.loads(sys.argv[2]), int(sys.argv[3]), \\
    json.loads(sys.argv[4])
rng = np.random.default_rng(seed)
q, k, v, w = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
              for _ in range(4))

def part(x):
    for dim, axis in ((0, "dp"), (1, "tp"), (2, "sp")):
        x = local_slice(x, dim, mesh.coord(axis), mesh.shape.get(axis, 1))
    return x.contiguous()

out = {"coords": {a: mesh.coord(a) for a in ("dp", "tp", "sp")}}
for scheme, causal, block in cases:
    ql, kl, vl = (part(x).requires_grad_() for x in (q, k, v))
    if scheme == "ring":
        o = ring_attention(ql, kl, vl, mesh, causal=causal, block_impl=block)
    else:
        o = ulysses_attention(ql, kl, vl, mesh, causal=causal)
    dq, dk, dv = torch.autograd.grad((o * part(w)).sum(), (ql, kl, vl))
    out[f"{scheme}-{causal}-{block}"] = [t.detach().numpy().tolist() for t in (o, dq, dk, dv)]
with open(f"{out_path}.{mesh.rank}.json", "w") as f:
    json.dump(out, f)
distributed.distributed_goodbye()
"""


def inputs(shape=SHAPE, seed: int = SEED) -> list[np.ndarray]:
    """The global q, k, v and w every rank draws."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def attention_world(tmp: Path, mesh: dict, cases: list, shape=SHAPE,
                    seed: int = SEED) -> dict:
    """{case key: (o, dq, dk, dv) as global arrays} from a world over `mesh`;
    cases are (scheme, causal, block) triples, keyed "scheme-causal-block"."""
    import json

    n = math.prod(mesh.values())
    path = tmp / "attn"
    runs = run_world(tmp, [str(path), json.dumps(list(shape)), str(seed), json.dumps(cases)],
                     n, mesh, code=_CHILD, tag="attn")
    assert_ok(runs)
    ranks = [json.loads(Path(f"{path}.{r}.json").read_text()) for r in range(n)]
    counts = {"dp": mesh.get("dp", 1), "tp": mesh.get("tp", 1), "sp": mesh.get("sp", 1)}
    out = {}
    for scheme, causal, block in cases:
        key = f"{scheme}-{causal}-{block}"
        arrays = [np.zeros(shape, np.float32) for _ in range(4)]
        for rank in ranks:
            c = rank["coords"]
            idx = tuple(slice(c[a] * (shape[d] // counts[a]), (c[a] + 1) * (shape[d] // counts[a]))
                        for d, a in ((0, "dp"), (1, "tp"), (2, "sp")))
            for arr, part in zip(arrays, rank[key]):
                arr[idx] = np.asarray(part, np.float32)
        out[key] = tuple(arrays)
    return out
