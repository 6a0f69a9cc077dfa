"""The reference's first training steps: the batches worked out again from
the seed, f32 AdamW, and the observations the comparison reads.

The batch rule is the one the trainer documents for its synthetic data:
step s of a run seeded `seed` draws its batch (the family's make_batch) from
a generator on the device seeded with (seed x 0x9E3779B97F4A7C15 + s) mod
2^63.
"""

from __future__ import annotations

import torch

from benchmarks import reference

STEPS = 3


def batch_seed(seed: int, step: int) -> int:
    return (seed * 0x9E3779B97F4A7C15 + step) % (1 << 63)


def make_batch(arch: dict, shape: dict, seed: int, step: int, device) -> dict:
    g = torch.Generator(device=device).manual_seed(batch_seed(seed, step))
    return reference.family(arch["family"]).make_batch(arch, shape, g)


@torch.no_grad()
def adamw_(p: dict, g: dict, m: dict, v: dict, count: int, opt: dict) -> None:
    """One AdamW step in float32, in place: bias-corrected moments, the
    decay on every parameter."""
    b1, b2 = opt["b1"], opt["b2"]
    bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    for n in p:
        m[n].mul_(b1).add_(g[n], alpha=1.0 - b1)
        v[n].mul_(b2).addcmul_(g[n], g[n], value=1.0 - b2)
        step = (m[n] / bc1) / ((v[n] / bc2).sqrt() + opt["eps"])
        p[n].sub_(opt["lr"] * (step + opt["weight_decay"] * p[n]))


def grad_readings(g: dict, embed: str, prefix: str = "") -> dict:
    """Each leaf's norm of a gradient {name: tensor} and the norms of the
    embedding's rows, accumulated in float64 (a float32 sum over millions of
    elements on the host drifts by a percent)."""
    return {f"{prefix}grad_norms": {n: torch.linalg.vector_norm(t, dtype=torch.float64).item()
                                    for n, t in g.items()},
            f"{prefix}embed_rows": torch.linalg.vector_norm(g[embed], dim=1,
                                                            dtype=torch.float64).cpu()}


def observe(weights: dict, arch: dict, shape: dict, opt: dict, seed: int, device,
            precision: str = "f32", alter=None, from_step: int = 0) -> dict:
    """The reference's readings over the first STEPS steps from `weights`:
    each step's loss; the readings of the first step's gradient and of the
    last's (grad_readings; "last_"); each leaf's change after the last step;
    and `last_state`, the parameters the last step started from, on the
    host. `precision` and `alter(batch) -> batch` (a fault planted in the
    batch as it is made) act on the steps from `from_step` (0 is the first)
    on; the steps before it run in float32."""
    fam = reference.family(arch["family"])
    p = {n: w.detach().float().clone() for n, w in weights.items()}
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    out = {"losses": []}
    for step in range(STEPS):
        batch = make_batch(arch, shape, seed, step, device)
        late = step >= from_step
        if alter is not None and late:
            batch = alter(batch)
        if step == STEPS - 1:
            out["last_state"] = {n: t.to("cpu", copy=True) for n, t in p.items()}
        loss, g = fam.loss_and_grads(p, batch, arch, shape["reference_rows"],
                                     precision if late else "f32")
        out["losses"].append(loss)
        if step in (0, STEPS - 1):
            out.update(grad_readings(g, fam.EMBED, "" if step == 0 else "last_"))
        adamw_(p, g, m, v, step + 1, opt)
        del g
    out["change_norms"] = {n: (p[n] - weights[n].float()).norm().item() for n in p}
    return out


def last_gradient(state: dict, arch: dict, shape: dict, seed: int, device) -> dict:
    """The readings ("last_") of the float32 gradient of the last checked
    step's batch at `state`: the parameters that step started from, on
    either side, so that the comparison of the last step's gradient judges
    that step alone and not the trajectory before it."""
    fam = reference.family(arch["family"])
    p = {n: t.to(device, torch.float32) for n, t in state.items()}
    batch = make_batch(arch, shape, seed, STEPS - 1, device)
    _, g = fam.loss_and_grads(p, batch, arch, shape["reference_rows"])
    return grad_readings(g, fam.EMBED, "last_")
