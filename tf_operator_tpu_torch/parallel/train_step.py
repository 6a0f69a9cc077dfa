"""Single-device train step: counterpart of tf_operator_tpu/parallel/train_step.py.

`TrainState` holds the model (its parameters are the compute copy, its
buffers the model state, such as batch-norm running statistics), the
optimizer state and the step. `train_step` runs loss, gradients, the
optimizer update and the gradient norm; the optimizer's replacement
parameters are copied into the model's parameters in place, so the step
allocates no second parameter set. The loss runs with the model in train
mode, so a model with running statistics updates them once per step, as
the JAX step's `mutable=["batch_stats"]` does. `make_chunked_train_step` is the
`--log-every` loop: batches are made on the device from a generator seeded
from (seed, global step), so how the steps are chunked does not change the
stream. With `remat=True` the loss runs under a non-reentrant
torch.utils.checkpoint (the JAX step's `jax.checkpoint(loss_fn)`): the
forward keeps only its inputs and the backward replays it; a model that
also remats per block (TransformerConfig.remat_layers) nests its blocks'
checkpoints inside it, as the JAX trainer's --remat does. `state_tensors` and `load_state_tensors` turn a TrainState into a
flat, named dict of tensors and back, for checkpoints. Sharding, meshes
and torch.distributed are not ported yet.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch import nn

from tf_operator_tpu_torch import optim as optim_lib

LossFn = Callable[[nn.Module, Any], torch.Tensor]
# signature: loss_fn(model, batch) -> scalar loss


@dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: optim_lib.MixedAdamState

    @property
    def params(self) -> list[torch.Tensor]:
        return list(self.model.parameters())


def create_train_state(model: nn.Module,
                       tx: optim_lib.MixedPrecisionTransformation) -> TrainState:
    # Init BEFORE the compute cast: under master_weights the optimizer's f32
    # master copy comes from the full-precision init parameters, and the
    # model then holds the bf16 compute copy. Only parameters are cast:
    # buffers (running statistics) stay f32, as the JAX model_state does.
    opt_state = tx.init(list(model.parameters()))
    dtype = optim_lib.compute_dtype(tx)
    if dtype is not None:
        with torch.no_grad():
            for p in model.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(dtype)
    return TrainState(step=0, model=model, opt_state=opt_state)


def state_tensors(state: TrainState) -> dict[str, Any]:
    """The state as a flat dict: `params/<name>` (the compute copy),
    `buffers/<name>` (e.g. batch-norm running statistics), `mu/<name>`,
    `nu/<name>` and, under master weights, `master/<name>` under the
    parameters' names, and the ints `count` and `step`. Tensors are the
    live ones (detached), not copies."""
    names = [n for n, _ in state.model.named_parameters()]
    out: dict[str, Any] = {f"params/{n}": p.detach()
                           for n, p in state.model.named_parameters()}
    out.update({f"buffers/{n}": b for n, b in state.model.named_buffers()})
    for field in ("mu", "nu", "master"):
        out.update({f"{field}/{n}": t for n, t in zip(names, getattr(state.opt_state, field))})
    out["count"] = int(state.opt_state.count)
    out["step"] = int(state.step)
    return out


def load_state_tensors(state: TrainState, tensors: dict[str, Any]) -> TrainState:
    """The inverse of state_tensors into a freshly built `state`: the
    parameters and buffers are copied into the model in place, the
    optimizer's tensors replaced, each cast to the dtype and device it has
    in `state`. ValueError when the names differ from the state's (a
    trainstate written without master weights, restored with them)."""
    want = state_tensors(state)
    if set(tensors) != set(want):
        missing, extra = sorted(set(want) - set(tensors)), sorted(set(tensors) - set(want))
        raise ValueError(f"the tensors do not match the train state: missing "
                         f"{missing[:4]}{'...' if len(missing) > 4 else ''}, unexpected "
                         f"{extra[:4]}{'...' if len(extra) > 4 else ''}")
    with torch.no_grad():
        for key, live in want.items():
            if key.startswith(("params/", "buffers/")):
                live.copy_(tensors[key])
    names = [n for n, _ in state.model.named_parameters()]

    def field(name):
        return [tensors[f"{name}/{n}"].to(device=t.device, dtype=t.dtype)
                for n, t in zip(names, getattr(state.opt_state, name))]

    opt = optim_lib.MixedAdamState(int(tensors["count"]), field("mu"), field("nu"),
                                   field("master"))
    return TrainState(int(tensors["step"]), state.model, opt)


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


def train_step(state: TrainState, batch, loss_fn: LossFn,
               tx: optim_lib.MixedPrecisionTransformation):
    """One optimizer step; returns (state, {"loss", "grad_norm"}) with the
    metrics as device scalars (no host sync)."""
    params = state.params
    state.model.train()
    loss = loss_fn(state.model, batch)
    grads = torch.autograd.grad(loss, params)
    new_params, new_opt = tx.update(list(grads), state.opt_state, params)
    with torch.no_grad():
        for p, new in zip(params, new_params):
            p.copy_(new)
    metrics = {"loss": loss.detach(), "grad_norm": global_norm(grads)}
    return TrainState(state.step + 1, state.model, new_opt), metrics


def batch_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of global step `step`'s batch: its seed depends on
    (seed, step) only, never on how the steps are chunked."""
    return torch.Generator(device=device).manual_seed(
        (seed * 0x9E3779B97F4A7C15 + step) % (1 << 63))


@contextlib.contextmanager
def _buffers_kept(model: nn.Module):
    """Restore the model's buffers on exit: the replay of a rematerialised
    loss must not move batch-norm running statistics a second time (the JAX
    step returns them from the checkpointed function, computed once)."""
    saved = [b.clone() for b in model.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, s in zip(model.buffers(), saved):
                b.copy_(s)


def remat_loss(loss_fn: LossFn) -> LossFn:
    """loss_fn under a non-reentrant checkpoint: its activations are
    recomputed in the backward instead of kept."""
    from torch.utils.checkpoint import checkpoint

    def rematted(model: nn.Module, batch) -> torch.Tensor:
        def contexts():
            return contextlib.nullcontext(), _buffers_kept(model)

        return checkpoint(loss_fn, model, batch, use_reentrant=False, context_fn=contexts)

    return rematted


def make_chunked_train_step(loss_fn: LossFn,
                            tx: optim_lib.MixedPrecisionTransformation,
                            make_batch: Callable[[torch.Generator], Any],
                            device, seed: int = 0, remat: bool = False):
    """run(state, n) -> (state, metrics of the last of its n steps)."""
    if remat:
        loss_fn = remat_loss(loss_fn)

    def run(state: TrainState, n: int):
        metrics = None
        for _ in range(n):
            batch = make_batch(batch_generator(seed, state.step, device))
            state, metrics = train_step(state, batch, loss_fn, tx)
        return state, metrics

    return run
