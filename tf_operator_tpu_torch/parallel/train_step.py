"""The train step: counterpart of tf_operator_tpu/parallel/train_step.py.

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
flat, named dict of tensors and back, for checkpoints.

Across processes (`parallelize`, a `ParallelPlan` over a mesh.Mesh), each
parameter is laid out by sharding_rules' spec:

  - tp: the model holds its tensor-parallel shard, and the layers run
    Megatron's collectives (models/transformer.py's Dense and Embed);
    attention runs on this rank's heads;
  - fsdp: the optimizer state (mu, nu, the f32 master) holds this rank's
    fsdp shard, and the update is per shard: the fsdp-sharded gradients
    are reduce-scattered to this rank's shards in one f32 bucket, and the
    updated shards all-gathered into the compute copy in one bucket (the
    compute copy stays whole on every rank: zero-3's per-layer gather
    before use is not ported);
  - dp, fsdp: each rank takes its rows of the global batch that
    batch_generator(seed, step) makes, and its loss is its share of the
    global batch's loss (rows, or a `mask`'s count for the MLM loss), so
    the shards' gradients SUM to the one-process gradient: the other
    gradients are all-reduced over the data axes in one f32 bucket, and
    the fsdp shards over dp. Batch norm all-reduces its moments, dropout
    draws the global batch's masks.

The reported loss is the global batch's and `grad_norm` the global norm, so
a 2-process run follows the 1-process run at the same global batch.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
from torch import nn

from tf_operator_tpu_torch import optim as optim_lib
from tf_operator_tpu_torch.parallel import collectives
from tf_operator_tpu_torch.parallel import mesh as mesh_lib
from tf_operator_tpu_torch.parallel import sharding_rules

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


@dataclass
class ParallelPlan:
    """How this rank holds each parameter (in model.parameters() order):
    its spec (port dimension order, of the full parameter), the dimension
    sharded over tp (the model holds that shard) and over fsdp (the
    optimizer state holds that shard of the tp shard), and whether its
    gradient is a partial sum over tp (a column-parallel layer's
    replicated bias, sliced in the forward). The default plan is one
    process's: nothing sharded, no collective."""

    mesh: mesh_lib.Mesh = field(default_factory=lambda: mesh_lib.Mesh({"dp": 1}))
    names: list[str] = field(default_factory=list)
    specs: dict[str, tuple] = field(default_factory=dict)
    full_shapes: dict[str, tuple] = field(default_factory=dict)
    tp_dims: list = field(default_factory=list)
    fsdp_dims: list = field(default_factory=list)
    tp_partial: list = field(default_factory=list)
    device: Any = None

    @property
    def n_data(self) -> int:
        return self.mesh.size(*mesh_lib.data_axes(self.mesh))

    @property
    def data_index(self) -> int:
        return self.mesh.index(*mesh_lib.data_axes(self.mesh))

    @property
    def data_group(self):
        return self.mesh.group(*mesh_lib.data_axes(self.mesh))

    @property
    def sharded(self) -> bool:
        """Whether some parameter or optimizer leaf is a shard here."""
        return any(d is not None for d in self.tp_dims + self.fsdp_dims)

    def _dim(self, dims: list, i: int):
        return dims[i] if dims else None

    def shard(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """The fsdp shard (a view) of parameter i's tp-local tensor t."""
        d = self._dim(self.fsdp_dims, i)
        if d is None:
            return t
        return collectives.local_slice(t, d, self.mesh.coord("fsdp"), self.mesh.shape["fsdp"])

    def unshard(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """Parameter i's tp-local tensor from its fsdp shards."""
        d = self._dim(self.fsdp_dims, i)
        return t if d is None else collectives.all_gather(t, d, self.mesh.group("fsdp"))

    def full(self, i: int, t: torch.Tensor, shard: bool) -> torch.Tensor:
        """The full tensor of parameter i from this rank's tp-local tensor
        (shard=False) or its fsdp shard (shard=True); a collective over
        every rank of the groups involved."""
        if shard:
            t = self.unshard(i, t)
        d = self._dim(self.tp_dims, i)
        return t if d is None else collectives.all_gather(t, d, self.mesh.group("tp"))

    def local(self, i: int, t: torch.Tensor, shard: bool) -> torch.Tensor:
        """The inverse of full: this rank's part of parameter i's full t."""
        d = self._dim(self.tp_dims, i)
        if d is not None:
            t = collectives.local_slice(t, d, self.mesh.coord("tp"), self.mesh.shape["tp"])
        return self.shard(i, t) if shard else t

    def local_rows(self, batch: dict) -> dict:
        """This rank's rows of a global batch (a scalar passes through)."""
        n = self.n_data
        if n == 1:
            return batch
        return {k: collectives.local_slice(v, 0, self.data_index, n) if v.dim() else v
                for k, v in batch.items()}

    def loss_weight(self, batch: dict) -> torch.Tensor | float:
        """This rank's share of the global batch's loss: its count of a
        `mask` (the MLM loss is a masked mean) over the global count,
        else its share of the rows."""
        if "mask" not in batch:
            return 1.0 / self.n_data
        local = batch["mask"].float().sum()
        return local / collectives.all_reduce(local, self.data_group).clamp_min(1.0)

    def _fsdp_split(self, n: int) -> tuple[list[int], list[int]]:
        """The indices of the parameters with an fsdp shard, and the rest."""
        split = [i for i in range(n) if self._dim(self.fsdp_dims, i) is not None]
        return split, [i for i in range(n) if i not in set(split)]

    def reduce_grads(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """The global batch's gradients as this rank's optimizer takes
        them: partial tp sums completed; the fsdp-sharded parameters'
        reduce-scattered over fsdp to this rank's shards (one f32 bucket),
        then summed over dp; every other gradient summed over the data
        axes in one f32 bucket."""
        tp_group = self.mesh.group("tp")
        grads = [collectives.all_reduce(g, tp_group) if self._dim(self.tp_partial, i) else g
                 for i, g in enumerate(grads)]
        split, whole = self._fsdp_split(len(grads))
        out = list(grads)
        for i, g in zip(whole, collectives.all_reduce_flat([grads[i] for i in whole],
                                                           self.data_group)):
            out[i] = g
        if split:
            shards = collectives.reduce_scatter_flat([grads[i] for i in split],
                                                     [self.fsdp_dims[i] for i in split],
                                                     self.mesh.group("fsdp"))
            for i, g in zip(split, collectives.all_reduce_flat(shards, self.mesh.group("dp"))):
                out[i] = g
        return out

    def set_params(self, params: list[torch.Tensor], new: list[torch.Tensor]) -> None:
        """Copy the optimizer's new parameters (fsdp shards where the
        parameter has one) into the model's: the shards through one
        all-gather over fsdp."""
        split, whole = self._fsdp_split(len(params))
        with torch.no_grad():
            for i in whole:
                params[i].copy_(new[i])
            collectives.all_gather_into([new[i] for i in split], [params[i] for i in split],
                                        [self.fsdp_dims[i] for i in split],
                                        self.mesh.group("fsdp"))

    def global_norm(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """The norm of the full gradient from reduce_grads' gradients
        (fsdp shards, tp shards where the parameter is tp-sharded): each
        part's squares summed over the groups that split it."""
        zero = torch.zeros((), device=grads[0].device)
        sq = [[zero, zero], [zero, zero]]  # [tp-sharded][fsdp-sharded]
        for i, g in enumerate(grads):
            tp = int(self._dim(self.tp_dims, i) is not None)
            fs = int(self._dim(self.fsdp_dims, i) is not None)
            sq[tp][fs] = sq[tp][fs] + g.float().pow(2).sum()
        fsdp = collectives.all_reduce(torch.stack([sq[1][1], sq[0][1]]),
                                      self.mesh.group("fsdp"))
        tp = collectives.all_reduce(sq[1][0] + fsdp[0], self.mesh.group("tp"))
        return torch.sqrt(tp + sq[0][0] + fsdp[1])


def parallelize(model: nn.Module, mesh: mesh_lib.Mesh, rules=None,
                device=None) -> ParallelPlan:
    """Lay a freshly built, full model out on `mesh` by `rules`
    (sharding_rules): slice each tp-sharded parameter to this rank's shard
    and give its layer the tensor-parallel mode; point batch norms at the
    data group and the trunk's dropout at this rank's rows. Every rank
    must build the same full model first (a seeded init)."""
    names = [n for n, _ in model.named_parameters()]
    plan = ParallelPlan(mesh=mesh, names=names, device=device,
                        specs=sharding_rules.tree_shardings(model, mesh.shape, rules),
                        full_shapes={n: tuple(p.shape) for n, p in model.named_parameters()})
    modules = dict(model.named_modules())
    tp_group, tp_i, tp_n = mesh.group("tp"), mesh.coord("tp"), mesh_lib.axis_size(mesh, "tp")
    col_biases = set()
    for name, p in model.named_parameters():
        spec = plan.specs[name]
        tp_dim = spec.index("tp") if "tp" in spec else None
        plan.tp_dims.append(tp_dim)
        plan.fsdp_dims.append(spec.index("fsdp") if "fsdp" in spec else None)
        if tp_dim is None:
            continue
        with torch.no_grad():
            p.data = collectives.local_slice(p.data, tp_dim, tp_i, tp_n).clone()
        mod_name = name.rpartition(".")[0]
        mod = modules[mod_name]
        if type(mod).__name__ == "Embed":
            mod.tp = collectives.TpShard("rows", tp_group, tp_i, tp_n)
        elif tp_dim == 0:
            # A column-parallel Dense; the vocabulary head gathers its logits.
            mod.tp = collectives.TpShard("col", tp_group, tp_i, tp_n,
                                         gather=mod_name.endswith("lm_head"))
            if mod.bias is not None:
                col_biases.add(f"{mod_name}.bias")
        else:
            mod.tp = collectives.TpShard("row", tp_group, tp_i, tp_n)
    plan.tp_partial = [n in col_biases for n in names]
    if plan.n_data > 1:
        for mod in modules.values():
            if hasattr(mod, "sync"):
                mod.sync = (plan.data_group, plan.n_data)
            if hasattr(mod, "batch_rows"):
                mod.batch_rows = (plan.data_index, plan.n_data)
    return plan


def create_train_state(model: nn.Module,
                       tx: optim_lib.MixedPrecisionTransformation,
                       plan: ParallelPlan | None = None) -> TrainState:
    # Init BEFORE the compute cast: under master_weights the optimizer's f32
    # master copy comes from the full-precision init parameters, and the
    # model then holds the bf16 compute copy. Only parameters are cast:
    # buffers (running statistics) stay f32, as the JAX model_state does.
    # Under fsdp the optimizer state is built from this rank's shards.
    plan = plan or ParallelPlan()
    opt_state = tx.init([plan.shard(i, p) for i, p in enumerate(model.parameters())])
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


_OPT_FIELDS = ("mu/", "nu/", "master/")


def _state_map(tensors: dict, plan: ParallelPlan, to_full: bool) -> dict:
    """state_tensors-keyed `tensors` mapped leaf by leaf between this
    rank's parts and the full tensors (params: the tp-local compute copy;
    mu, nu, master: the fsdp shard of it)."""
    index = {n: i for i, n in enumerate(plan.names)}
    out = {}
    for key, t in tensors.items():
        prefix, _, name = key.partition("/")
        i = index.get(name)
        if i is None or prefix == "buffers" or not isinstance(t, torch.Tensor):
            out[key] = t
            continue
        shard = f"{prefix}/" in _OPT_FIELDS
        out[key] = plan.full(i, t, shard) if to_full else plan.local(i, t, shard)
    return out


def full_state_tensors(state: TrainState, plan: ParallelPlan | None = None) -> dict[str, Any]:
    """state_tensors with every sharded leaf gathered to its full tensor:
    what a checkpoint holds whatever the mesh. A collective on every rank
    of a sharded world; the live tensors where nothing is sharded."""
    tensors = state_tensors(state)
    if plan is None or not plan.sharded:
        return tensors
    return _state_map(tensors, plan, to_full=True)


def local_state_tensors(full: dict[str, Any], plan: ParallelPlan) -> dict[str, Any]:
    """The inverse of full_state_tensors, for load_state_tensors: this
    rank's parts of a checkpoint's full tensors (no collective)."""
    if not plan.sharded:
        return full
    return _state_map(full, plan, to_full=False)


def train_step(state: TrainState, batch, loss_fn: LossFn,
               tx: optim_lib.MixedPrecisionTransformation,
               plan: ParallelPlan | None = None):
    """One optimizer step on this rank's rows `batch`; returns (state,
    {"loss", "grad_norm"}) with the metrics as device scalars (no host sync
    in one process). Under a plan of several data ranks the loss is
    weighted to this rank's share of the global loss, and the metrics are
    the global batch's."""
    plan = plan or ParallelPlan()
    params = state.params
    state.model.train()
    loss = loss_fn(state.model, batch)
    if plan.n_data > 1:
        loss = loss * plan.loss_weight(batch)
    grads = plan.reduce_grads(list(torch.autograd.grad(loss, params)))
    new_shards, new_opt = tx.update(grads, state.opt_state,
                                    [plan.shard(i, p) for i, p in enumerate(params)])
    plan.set_params(params, new_shards)
    metrics = {"loss": collectives.all_reduce(loss.detach(), plan.data_group),
               "grad_norm": plan.global_norm(grads)}
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
                            device, seed: int = 0, remat: bool = False,
                            plan: ParallelPlan | None = None):
    """run(state, n) -> (state, metrics of the last of its n steps). Under
    a plan each step trains on this rank's rows of the global batch."""
    if remat:
        loss_fn = remat_loss(loss_fn)

    def run(state: TrainState, n: int):
        metrics = None
        for _ in range(n):
            batch = make_batch(batch_generator(seed, state.step, device))
            if plan is not None:
                batch = plan.local_rows(batch)
            state, metrics = train_step(state, batch, loss_fn, tx, plan)
        return state, metrics

    return run
