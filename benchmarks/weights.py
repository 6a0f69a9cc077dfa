"""The weights both sides start from, made on the device from the seed.

One generator on the run's device draws every random parameter in one
call, in float32 (the type the trainer keeps them in: the master copy of
the LM, BERT's parameters); each leaf is a view of that draw scaled by the
configuration's init_std. LayerNorm scales are 1, biases 0."""

from __future__ import annotations

import math

import torch

from benchmarks import reference


def make(arch: dict, init_std: float, seed: int, device) -> dict[str, torch.Tensor]:
    spec = reference.family(arch["family"]).param_spec(arch)
    drawn = sum(math.prod(shape) for _, shape, init in spec if init in ("matrix", "embed"))
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(drawn, generator=gen, device=device, dtype=torch.float32)
    flat.mul_(init_std)
    out, at = {}, 0
    for name, shape, init in spec:
        if init in ("matrix", "embed"):
            n = math.prod(shape)
            out[name] = flat[at:at + n].view(shape)
            at += n
        elif init == "one":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
