"""Mixed-precision Adam/AdamW: counterpart of tf_operator_tpu/optim.py.

Two knobs on `OptimizerConfig`:

  moment_dtype    storage dtype of the Adam moments (mu, nu): f32 or bf16.
                  The update arithmetic is always f32; moments are upcast,
                  updated and cast back for storage.
  master_weights  keep the authoritative f32 parameters ("master") in the
                  optimizer state; the model holds the bf16 compute copy,
                  re-derived from the master every step.

`update` has replacement semantics, as in the JAX package: it returns the
NEW parameters, not a delta, because deriving bf16 params from the f32
master is a cast and `p + (new - p)` in low precision need not round back
to `new`. `update_in_place` is the same arithmetic on the live tensors:
it bumps the step count, writes mu, nu and the master and copies the new
parameters into the given ones, so a CUDA graph of a whole train step
(parallel/graphed_step.py) replays it. The count is an int32 tensor on the
parameters' device and the f32 bias corrections are computed from it
there, so a replay never reuses the corrections of the step it captured.
`update` is `update_in_place` on copies.

Parameters, gradients and moments are flat lists of tensors in the model's
parameter order. State field order (count, mu, nu, master) is kept. Under
fsdp the lists hold this rank's shards (parallel/train_step.py's plan):
the update is elementwise, so it runs per shard as it is, and mu, nu and
the master are sharded like their parameter.
`state_from_jax` carries the JAX package's optimizer state across.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple

import torch

_DTYPE_ALIASES = {
    "f32": torch.float32, "float32": torch.float32, "fp32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
}


def canonical_dtype(d) -> torch.dtype | None:
    """Accept 'bf16'/'f32'-style strings or torch dtypes; None passes
    through (each parameter keeps its own dtype)."""
    if d is None or isinstance(d, torch.dtype):
        return d
    if isinstance(d, str) and d.strip().lower() in _DTYPE_ALIASES:
        return _DTYPE_ALIASES[d.strip().lower()]
    raise ValueError(
        f"unknown optimizer dtype {d!r} (use one of {sorted(_DTYPE_ALIASES)})")


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"              # "adam" | "adamw"
    learning_rate: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4       # adamw only
    moment_dtype: Any = None         # None = each param's own dtype
    master_weights: bool = False
    compute_dtype: Any = field(default=torch.bfloat16)  # params under master_weights

    def __post_init__(self):
        if self.name not in ("adam", "adamw"):
            raise ValueError(f"optimizer must be adam|adamw, got {self.name!r}")
        object.__setattr__(self, "moment_dtype", canonical_dtype(self.moment_dtype))
        object.__setattr__(self, "compute_dtype",
                           canonical_dtype(self.compute_dtype) or torch.bfloat16)


class MixedAdamState(NamedTuple):
    count: torch.Tensor  # int32, 0-dim, on the parameters' device
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    master: list[torch.Tensor]  # f32 copies under master_weights, else []


class MixedPrecisionTransformation(NamedTuple):
    init: Callable[[list[torch.Tensor]], MixedAdamState]
    update: Callable[..., tuple[list[torch.Tensor], MixedAdamState]]
    config: OptimizerConfig
    update_in_place: Callable[..., None]


def bias_corrections(cfg: OptimizerConfig, count: torch.Tensor):
    """(1 - b1^count, 1 - b2^count) as f32 tensors on count's device, as
    the JAX update computes them."""
    c = count.float()
    return 1.0 - torch.pow(cfg.b1, c), 1.0 - torch.pow(cfg.b2, c)


def _divide(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """x / d for a bias correction d, rounded as the update rounded it when
    d was a host float: PyTorch's CUDA division by a host scalar multiplies
    by the scalar's f32 reciprocal, its CPU division divides. So the card's
    trajectories stay those of the update before it went on the device (a
    routing-sensitive model, the MoE, amplifies one ulp into its routing)."""
    return x * torch.reciprocal(d) if x.is_cuda else x / d


def make_optimizer(cfg: OptimizerConfig) -> MixedPrecisionTransformation:
    def init(params: list[torch.Tensor]) -> MixedAdamState:
        def moments_like(p):
            return torch.zeros_like(p, dtype=cfg.moment_dtype or p.dtype)

        device = params[0].device if params else None
        return MixedAdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu=[moments_like(p) for p in params],
            nu=[moments_like(p) for p in params],
            master=([p.detach().float().clone() for p in params]
                    if cfg.master_weights else []),
        )

    @torch.no_grad()
    def update_in_place(grads: list[torch.Tensor], state: MixedAdamState,
                        params: list[torch.Tensor]) -> None:
        state.count.add_(1)
        bc1, bc2 = bias_corrections(cfg, state.count)
        masters = state.master if cfg.master_weights else params
        for g, mu, nu, p, m in zip(grads, state.mu, state.nu, params, masters):
            g32 = g.float()
            mu32 = cfg.b1 * mu.float() + (1.0 - cfg.b1) * g32
            nu32 = cfg.b2 * nu.float() + (1.0 - cfg.b2) * g32 * g32
            step = _divide(mu32, bc1) / (torch.sqrt(_divide(nu32, bc2)) + cfg.eps)
            target = m.float()
            if cfg.name == "adamw" and cfg.weight_decay:
                step = step + cfg.weight_decay * target
            upd = target - cfg.learning_rate * step
            mu.copy_(mu32)
            nu.copy_(nu32)
            if cfg.master_weights:
                m.copy_(upd)
            p.copy_(upd)

    @torch.no_grad()
    def update(grads: list[torch.Tensor], state: MixedAdamState,
               params: list[torch.Tensor]):
        new = MixedAdamState(*(f.clone() if isinstance(f, torch.Tensor) else
                               [t.clone() for t in f] for f in state))
        new_params = [p.detach().clone() for p in params]
        update_in_place(grads, new, new_params)
        return new_params, new

    return MixedPrecisionTransformation(init=init, update=update, config=cfg,
                                        update_in_place=update_in_place)


def compute_dtype(tx: MixedPrecisionTransformation) -> torch.dtype | None:
    """The dtype the model's parameters are held in under master_weights
    (None: they stay as initialised)."""
    return tx.config.compute_dtype if tx.config.master_weights else None


def state_from_jax(count, mu, nu, master, to_named: Callable[[Any], dict],
                   names: list[str], like: MixedAdamState) -> MixedAdamState:
    """The port's optimizer state from the JAX package's MixedAdamState,
    given as numpy trees in the params layout (count, then the mu, nu and
    master trees; master None or empty without master weights). Each tree
    goes through the model's `params_from_flax` (`to_named`, which renames
    and transposes as for the parameters: Adam is elementwise) and is
    listed in parameter order (`names`), each tensor at the dtype and on
    the device of its counterpart in `like`, a freshly built state of the
    same optimizer config."""
    def carry(tree, template):
        named = to_named(tree)
        return [named[n].to(device=t.device, dtype=t.dtype) for n, t in zip(names, template)]

    return MixedAdamState(
        count=torch.tensor(int(count), dtype=torch.int32, device=like.count.device),
        mu=carry(mu, like.mu), nu=carry(nu, like.nu),
        master=carry(master, like.master) if like.master else [])
