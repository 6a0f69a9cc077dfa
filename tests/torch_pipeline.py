"""One rank of tests/test_torch_pipeline.py's two-process gloo world.

    python tests/torch_pipeline.py <inputs.npz> <out.json>

with the operator's JAX_* env for a world of two and TPUJOB_MESH {"pp": 2}.
Runs every claim that needs the world and writes this rank's readings as
JSON (rank 0 also writes the pipelined LM's logits beside it as .npy).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tf_operator_tpu_torch import optim  # noqa: E402
from tf_operator_tpu_torch.models import transformer as tfm  # noqa: E402
from tf_operator_tpu_torch.parallel import collectives, distributed  # noqa: E402
from tf_operator_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from tf_operator_tpu_torch.parallel import pipeline as pl  # noqa: E402

WIDTH = 16
LM_CFG = dict(vocab_size=128, num_layers=2, hidden=64, num_heads=2, max_len=32, causal=True,
              dtype=torch.float32)


def mlp_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def sequential(stacked, x):
    for i in range(next(iter(stacked.values())).shape[0]):
        x = mlp_stage({k: v[i] for k, v in stacked.items()}, x)
    return x


def max_err(a, b) -> float:
    return float((a.detach() - b.detach()).abs().max())


def schedule_case(mesh, inputs, m: int, remat: bool = False) -> dict:
    """Outputs and gradients of pipeline_apply against the sequential run,
    and the microbatch order each rank ran."""
    stacked = {k: torch.from_numpy(inputs[k]).clone().requires_grad_() for k in ("w", "b")}
    ref_params = {k: v.detach().clone().requires_grad_() for k, v in stacked.items()}
    x = torch.from_numpy(inputs[f"x{m}"])
    seen = []

    def stage(p, h):
        seen.append(h.shape[0])
        return mlp_stage(p, h)

    got = pl.pipeline_apply(stage, stacked, x, mesh, m, remat=remat)
    (got ** 2).mean().backward()
    grads = collectives.all_reduce_flat([stacked[k].grad for k in ("w", "b")],
                                        mesh.group("pp"))
    want = sequential(ref_params, x)
    (want ** 2).mean().backward()
    return {"out": max_err(got, want), "out_scale": float(want.abs().max()),
            "grads": max(max_err(g, ref_params[k].grad) for g, k in zip(grads, ("w", "b"))),
            "grad_scale": max(float(ref_params[k].grad.abs().max()) for k in ("w", "b")),
            "stage_calls": len(seen), "rows": seen[:1],
            "remat_out": got.detach().numpy().tolist() if m == 4 else None}


def main(argv: list[str]) -> int:
    torch.set_num_threads(1)
    inputs = dict(np.load(argv[0]))
    distributed.initialize_from_env(force=True)
    mesh = mesh_lib.mesh_from_env()
    rank = mesh.rank
    out: dict = {"rank": rank, "stage": mesh.coord("pp")}
    for m in (2, 4, 8):
        out[f"m{m}"] = schedule_case(mesh, inputs, m)
    out["remat"] = schedule_case(mesh, inputs, 4, remat=True)
    for case, (b, m, stages) in {"bad_microbatches": (6, 4, 2),
                                 "stages_vs_pp": (8, 4, 3)}.items():
        stacked = {"w": torch.zeros(stages, WIDTH, WIDTH), "b": torch.zeros(stages, WIDTH)}
        try:
            pl.pipeline_apply(mlp_stage, stacked, torch.zeros(b, WIDTH), mesh, m)
            out[case] = None
        except ValueError as e:
            out[case] = str(e)

    cfg = tfm.TransformerConfig(**LM_CFG)
    model, loss_fn = pl.make_pipelined_lm(cfg, mesh, 2)
    model.load_state_dict({k[len("lm/"):]: torch.from_numpy(v) for k, v in inputs.items()
                           if k.startswith("lm/")})
    tokens = torch.from_numpy(inputs["tokens"]).long()
    with torch.no_grad():
        logits = model(tokens)
    if rank == 0:
        np.save(argv[1] + ".logits.npy", logits.numpy())
    ref = tfm.TransformerLM(cfg)
    ref.load_state_dict(pl.lm_state_dict(model.state_dict(), cfg.num_layers))
    with torch.no_grad():
        out["lm_vs_unpipelined"] = max_err(logits, ref(tokens))
    tx = optim.make_optimizer(optim.OptimizerConfig(learning_rate=1e-3, name="adam"))
    params = list(model.parameters())
    state = tx.init(params)
    losses = []
    for _ in range(8):
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model, {"tokens": tokens})
        loss.backward()
        model.reduce_grads()
        new, state = tx.update([p.grad for p in params], state, params)
        with torch.no_grad():
            for p, n in zip(params, new):
                p.copy_(n)
        losses.append(float(loss))
    out["losses"] = losses
    # Every rank holds the same replicated parameters after the steps.
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    summed = collectives.all_reduce(flat, mesh.group("pp"))
    out["replicas_equal"] = bool(torch.equal(summed, flat * 2))
    Path(argv[1]).write_text(json.dumps(out))
    distributed.distributed_goodbye()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
