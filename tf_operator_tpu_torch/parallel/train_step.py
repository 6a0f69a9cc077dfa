"""The train step: counterpart of tf_operator_tpu/parallel/train_step.py.

`TrainState` holds the model (its parameters are the compute copy, its
buffers the model state, such as batch-norm running statistics), the
optimizer state and the step. `train_step` runs loss, gradients, the
optimizer update and the gradient norm; the optimizer updates its state
and the model's parameters in place (`update_in_place`), so the step
allocates no second parameter set and a CUDA graph of it replays against
the live state. The loss runs with the model in train
mode, so a model with running statistics updates them once per step, as
the JAX step's `mutable=["batch_stats"]` does. `make_chunked_train_step` is the
`--log-every` loop, the counterpart of the JAX `make_scanned_train_step`:
batches are made on the device from a generator seeded
from (seed, global step), so how the steps are chunked does not change the
stream. With `graphed=True` (one process on CUDA, or a rank of an NCCL
world: graphed_step.step_route) it captures one step as a CUDA graph, its
collectives included, and replays it for every later step.
With `remat=True` the loss runs under a non-reentrant
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
  - ep (an MoE layer's experts, models/moe.py): the model holds its
    experts (E / ep of them, from ep index x E / ep on), and the layer sums
    its ranks' parts of its output over ep (and tp); ep ranks hold the same
    rows, as ep is no data axis in the JAX package;
  - fsdp (zero-3, the JAX layout): the model holds this rank's fsdp shard
    of each fsdp-sharded parameter, and so do mu, nu and the f32 master.
    A layer's full tensors exist only while it runs: its forward
    all-gathers its shards in one flat bucket (a transformer Block or a
    ResNet block is one bucket, any other parameter its own module's) and
    its backward reduce-scatters their gradients to the shards. Without
    remat autograd keeps the gathered tensors that the layer's backward
    reads until that backward has run; under remat the replay gathers
    again. The update is per shard and copies shards: nothing is gathered
    after it;
  - dp, fsdp: each rank takes its rows of the global batch that
    batch_generator(seed, step) makes, and its loss is its share of the
    global batch's loss (rows, or a `mask`'s count for the MLM loss), so
    the shards' gradients SUM to the one-process gradient: the other
    gradients are all-reduced over the data axes in one f32 bucket, and
    the fsdp shards over dp. Batch norm all-reduces its moments, dropout
    draws the global batch's masks;
  - sp (a model with a `seq_shard`, the transformer trunk): each rank runs
    its T/sp columns of its rows (its loss function slices them from the
    whole rows, which every rank holds), attention crosses the ranks
    (parallel/ring_attention.py, parallel/ulysses.py), and the gradients
    are summed over sp too, in the same buckets. A model without one
    (MNIST, ResNet) runs the same rows on every sp rank, whose gradients
    are then not summed over sp: the JAX step replicates its batch there.

The reported loss is the global batch's and `grad_norm` the global norm, so
a 2-process run follows the 1-process run at the same global batch.
"""

from __future__ import annotations

import contextlib
import functools
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
    sharded over tp and over ep (the model holds that shard) and over fsdp
    (the model and the optimizer state hold that shard of the tp and ep
    shard), and whether its gradient is a partial sum over tp (a
    column-parallel layer's replicated bias, sliced in the forward); `seq`:
    the model splits its sequence over sp. The default plan is one
    process's: nothing sharded, no collective."""

    mesh: mesh_lib.Mesh = field(default_factory=lambda: mesh_lib.Mesh({"dp": 1}))
    names: list[str] = field(default_factory=list)
    specs: dict[str, tuple] = field(default_factory=dict)
    full_shapes: dict[str, tuple] = field(default_factory=dict)
    tp_dims: list = field(default_factory=list)
    ep_dims: list = field(default_factory=list)
    fsdp_dims: list = field(default_factory=list)
    tp_partial: list = field(default_factory=list)
    device: Any = None
    seq: bool = False

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
    def seq_shard(self) -> tuple[int, int]:
        """(index, count) of this rank's sequence columns."""
        if not self.seq:
            return 0, 1
        return self.mesh.coord("sp"), self.mesh.shape["sp"]

    def _summed(self, axes: tuple[str, ...]):
        return self.mesh.group(*(a for a in axes if a != "sp" or self.seq))

    @property
    def loss_group(self):
        """The ranks whose losses (and gradients) sum to the global
        batch's: the data axes, and sp under `seq`."""
        return self._summed(mesh_lib.GRAD_AXES)

    @property
    def sharded(self) -> bool:
        """Whether some parameter or optimizer leaf is a shard here."""
        return any(d is not None for d in self.tp_dims + self.ep_dims + self.fsdp_dims)

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

    def full(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """The full tensor of parameter i from this rank's part of it (its
        fsdp shard of its tp and ep shard); a collective over every rank of
        the groups involved."""
        t = self.unshard(i, t)
        for axis, dims in (("tp", self.tp_dims), ("ep", self.ep_dims)):
            d = self._dim(dims, i)
            if d is not None:
                t = collectives.all_gather(t, d, self.mesh.group(axis))
        return t

    def model_part(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """This rank's tp and ep shard (a view) of parameter i's full t."""
        for axis, dims in (("ep", self.ep_dims), ("tp", self.tp_dims)):
            d = self._dim(dims, i)
            if d is not None:
                t = collectives.local_slice(t, d, self.mesh.coord(axis),
                                            mesh_lib.axis_size(self.mesh, axis))
        return t

    def local(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """The inverse of full: this rank's part of parameter i's full t."""
        return self.shard(i, self.model_part(i, t))

    def local_rows(self, batch: dict) -> dict:
        """This rank's rows of a global batch (a scalar passes through)."""
        n = self.n_data
        if n == 1:
            return batch
        return {k: collectives.local_slice(v, 0, self.data_index, n) if v.dim() else v
                for k, v in batch.items()}

    def loss_weight(self, batch: dict) -> torch.Tensor | float:
        """This rank's share of the global batch's loss: its count of a
        `mask` (the MLM loss is a masked mean; under `seq`, of its columns)
        over the global count, else its share of the rows (a sequence
        shard's loss is already its part of its rows' mean)."""
        if "mask" not in batch:
            return 1.0 / self.n_data
        local = seq_slice(batch["mask"], self.seq_shard).float().sum()
        return local / collectives.all_reduce(local, self.loss_group).clamp_min(1.0)

    def _fsdp_split(self, n: int) -> tuple[list[int], list[int]]:
        """The indices of the parameters with an fsdp shard, and the rest."""
        split = [i for i in range(n) if self._dim(self.fsdp_dims, i) is not None]
        return split, [i for i in range(n) if i not in set(split)]

    def reduce_grads(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        """The global batch's gradients as this rank's optimizer takes
        them: partial tp sums completed; the fsdp shards' gradients, which
        their layers' backward reduce-scattered over fsdp, summed over dp
        (and sp); every other gradient over the data axes (and sp), each
        set in one f32 bucket."""
        tp_group = self.mesh.group("tp")
        grads = [collectives.all_reduce(g, tp_group) if self._dim(self.tp_partial, i) else g
                 for i, g in enumerate(grads)]
        out = list(grads)
        for idx, axes in zip(self._fsdp_split(len(grads)),
                             (mesh_lib.SHARD_GRAD_AXES, mesh_lib.GRAD_AXES)):
            summed = collectives.all_reduce_flat([grads[i] for i in idx], self._summed(axes))
            for i, g in zip(idx, summed):
                out[i] = g
        return out

    def global_norm(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """The norm of the full gradient from reduce_grads' gradients
        (fsdp shards, tp and ep shards where the parameter has them): the
        squares summed by which of fsdp, tp and ep split the parameter,
        each sum then over the groups of those axes in turn."""
        axes = (("fsdp", self.fsdp_dims), ("tp", self.tp_dims), ("ep", self.ep_dims))
        sq: dict[tuple, torch.Tensor] = {}
        for i, g in enumerate(grads):
            key = tuple(self._dim(dims, i) is not None for _, dims in axes)
            sq[key] = sq.get(key, 0.0) + g.float().pow(2).sum()
        keys = sorted(sq)  # the same on every rank: the specs are
        vals = [sq[k] for k in keys]
        for j, (axis, _) in enumerate(axes):
            idx = [n for n, k in enumerate(keys) if k[j]]
            if idx:
                summed = collectives.all_reduce(torch.stack([vals[n] for n in idx]),
                                                self.mesh.group(axis))
                for n, v in zip(idx, summed):
                    vals[n] = v
        return torch.sqrt(torch.stack(vals).sum())


def seq_slice(x: torch.Tensor, seq: tuple[int, int]) -> torch.Tensor:
    """Columns (dimension 1) of shard `seq` = (index, count) of x."""
    index, count = seq
    return x if count == 1 else collectives.local_slice(x, 1, index, count)


# Module classes whose parameters zero-3 gathers as one bucket; any other
# parameter is gathered with its own module's.
FSDP_UNITS = ("Block", "MoEBlock", "BottleneckBlock")


@dataclass
class FsdpUnit:
    """The fsdp-sharded parameters of one bucket: (module, name, dim)."""

    members: list
    group: Any

    @contextlib.contextmanager
    def gathered(self):
        """The members' full tensors in place of their shards (in
        `_parameters`, so the modules read them as their own) for the
        duration; differentiable back to the shards."""
        shards = [m._parameters[leaf] for m, leaf, _ in self.members]
        fulls = collectives.gather_params(shards, [d for *_, d in self.members], self.group)
        for (m, leaf, _), full in zip(self.members, fulls):
            m._parameters[leaf] = full
        try:
            yield
        finally:
            for (m, leaf, _), shard in zip(self.members, shards):
                m._parameters[leaf] = shard


def _unit_forward(unit: FsdpUnit, forward, *args, **kwargs):
    with unit.gathered():
        return forward(*args, **kwargs)


def full_params(module: nn.Module):
    """A context in which `module` holds its full parameters, for a caller
    that reads them outside the module's forward (the chunked LM head)."""
    unit = module.__dict__.get("fsdp_unit")
    return contextlib.nullcontext() if unit is None else unit.gathered()


def _install_fsdp(model: nn.Module, plan: ParallelPlan) -> None:
    """Cut each fsdp-sharded parameter to this rank's shard and make every
    bucket's owner gather its members around its forward."""
    group = plan.mesh.group("fsdp")
    if group is None:
        return
    modules = dict(model.named_modules())
    units: dict[str, list] = {}
    for i, (name, p) in enumerate(model.named_parameters()):
        d = plan.fsdp_dims[i]
        if d is None:
            continue
        with torch.no_grad():
            p.data = plan.shard(i, p.data).clone()
        mod_name, _, leaf = name.rpartition(".")
        parts = mod_name.split(".")
        owner = next((".".join(parts[:k]) for k in range(1, len(parts) + 1)
                      if type(modules[".".join(parts[:k])]).__name__ in FSDP_UNITS), mod_name)
        units.setdefault(owner, []).append((modules[mod_name], leaf, d))
    for owner, members in units.items():
        mod = modules[owner]
        mod.fsdp_unit = FsdpUnit(members, group)
        mod.forward = functools.partial(_unit_forward, mod.fsdp_unit, mod.forward)


def _place_experts(mod: nn.Module, plan: ParallelPlan, name: str) -> None:
    """An MoE layer's share of the experts on this rank: the first of its
    experts, the group of the axes that split them (ep, tp: those its
    experts_in spec names), and the group and size over which its Switch
    fraction is averaged (the data axes, and sp under `seq`)."""
    mesh = plan.mesh
    spec = plan.specs[f"{name}.experts_in"]
    if "ep" in spec:
        mod.first_expert = mesh.coord("ep") * mod.experts_in.shape[0]
    mod.group = mesh.group(*(a for a in mesh_lib.EXPERT_AXES if a in spec))
    axes = tuple(a for a in mesh_lib.GRAD_AXES if a != "sp" or plan.seq)
    mod.stats = (mesh.group(*axes), mesh.size(*axes))
    if plan.seq:
        mod.sp_group = mesh.group("sp")


def parallelize(model: nn.Module, mesh: mesh_lib.Mesh, rules=None,
                device=None) -> ParallelPlan:
    """Lay a freshly built, full model out on `mesh` by `rules`
    (sharding_rules): slice each tp-sharded parameter to this rank's shard
    and give its layer the tensor-parallel mode; keep each fsdp-sharded
    one's shard (_install_fsdp); point batch norms at the data group, the
    trunk's dropout at this rank's rows and, under sp, its positions and
    dropout at this rank's columns. Every rank must build the same full
    model first (a seeded init)."""
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
        ep_dim = spec.index("ep") if "ep" in spec else None
        plan.tp_dims.append(tp_dim)
        plan.ep_dims.append(ep_dim)
        plan.fsdp_dims.append(spec.index("fsdp") if "fsdp" in spec else None)
        if tp_dim is None and ep_dim is None:
            continue
        with torch.no_grad():
            p.data = plan.model_part(len(plan.tp_dims) - 1, p.data).clone()
        mod_name = name.rpartition(".")[0]
        mod = modules[mod_name]
        if type(mod).__name__ == "MoEMlp":
            continue  # its experts' groups are set below, with the sp ones
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
    plan.seq = (mesh_lib.axis_size(mesh, "sp") > 1
                and any(hasattr(mod, "seq_shard") for mod in modules.values()))
    for mod_name, mod in modules.items():
        if type(mod).__name__ == "MoEMlp":
            _place_experts(mod, plan, mod_name)
    _install_fsdp(model, plan)
    for mod in modules.values():
        if plan.n_data > 1 and hasattr(mod, "sync"):
            mod.sync = (plan.data_group, plan.n_data)
        if plan.n_data > 1 and hasattr(mod, "batch_rows"):
            mod.batch_rows = (plan.data_index, plan.n_data)
        if plan.seq and hasattr(mod, "seq_shard"):
            mod.seq_shard = plan.seq_shard
    return plan


def create_train_state(model: nn.Module,
                       tx: optim_lib.MixedPrecisionTransformation,
                       plan: ParallelPlan | None = None) -> TrainState:
    # `plan` is taken for the callers' symmetry; parallelize already laid
    # the parameters out. Init BEFORE the compute cast: under master_weights the optimizer's f32
    # master copy comes from the full-precision init parameters, and the
    # model then holds the bf16 compute copy. Only parameters are cast:
    # buffers (running statistics) stay f32, as the JAX model_state does.
    # Under fsdp the parameters, and so the optimizer state, are this
    # rank's shards.
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
    """The inverse of state_tensors into `state`: the parameters, buffers
    and optimizer tensors are copied in place, each cast to the dtype and
    device it has in `state` (so a restore into a live state allocates
    nothing on the device). ValueError when the names differ from the
    state's (a trainstate written without master weights, restored with
    them)."""
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
        # The live count too: a graph captured on this state reads it.
        state.opt_state.count.fill_(int(tensors["count"]))
    names = [n for n, _ in state.model.named_parameters()]

    def field(name):
        with torch.no_grad():
            return [t.copy_(tensors[f"{name}/{n}"])
                    for n, t in zip(names, getattr(state.opt_state, name))]

    opt = optim_lib.MixedAdamState(state.opt_state.count, field("mu"), field("nu"),
                                   field("master"))
    return TrainState(int(tensors["step"]), state.model, opt)


def _state_map(tensors: dict, plan: ParallelPlan, to_full: bool) -> dict:
    """state_tensors-keyed `tensors` mapped leaf by leaf between this
    rank's parts (params, mu, nu, master: the fsdp shard of the tp-local
    tensor) and the full tensors."""
    index = {n: i for i, n in enumerate(plan.names)}
    out = {}
    for key, t in tensors.items():
        prefix, _, name = key.partition("/")
        i = index.get(name)
        if i is None or prefix == "buffers" or not isinstance(t, torch.Tensor):
            out[key] = t
            continue
        out[key] = plan.full(i, t) if to_full else plan.local(i, t)
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
    """One optimizer step on this rank's rows `batch`, written into the
    state's tensors (the model's parameters and buffers, the optimizer
    state); returns (the state at the next step, {"loss", "grad_norm"})
    with the metrics as device scalars (no host sync in one process).
    Under a plan of several data (or sequence) ranks the loss is weighted
    to this rank's share of the global loss, and the metrics are the
    global batch's."""
    plan = plan or ParallelPlan()
    params = state.params
    state.model.train()
    loss = loss_fn(state.model, batch)
    if plan.loss_group is not None:
        loss = loss * plan.loss_weight(batch)
    grads = plan.reduce_grads(list(torch.autograd.grad(loss, params)))
    tx.update_in_place(grads, state.opt_state, params)
    metrics = {"loss": collectives.all_reduce(loss.detach(), plan.loss_group),
               "grad_norm": plan.global_norm(grads)}
    return TrainState(state.step + 1, state.model, state.opt_state), metrics


def batch_seed(seed: int, step: int) -> int:
    """The seed of global step `step`'s batch: it depends on (seed, step)
    only, never on how the steps are chunked."""
    return (seed * 0x9E3779B97F4A7C15 + step) % (1 << 63)


def batch_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of global step `step`'s batch."""
    return torch.Generator(device=device).manual_seed(batch_seed(seed, step))


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
                            plan: ParallelPlan | None = None, graphed: bool = False):
    """run(state, n, every=None) -> (state, metrics of the last of its n
    steps); with a list `every`, each step's metrics are appended to it.
    Under a plan each step trains on this rank's rows of the global batch.

    graphed: one generator, re-seeded on the host with batch_seed(seed,
    step) before each step, makes the batch inside a CUDA graph of the
    whole step (graphed_step.GraphedStep); the stream of batches is
    batch_generator's bit for bit. The graph is captured on the first
    call's state, and every later call must pass that state."""
    if remat:
        loss_fn = remat_loss(loss_fn)
    if graphed:
        from tf_operator_tpu_torch.parallel import graphed_step

        return graphed_step.graphed_chunks(loss_fn, tx, make_batch, device, seed, plan)

    def run(state: TrainState, n: int, every: list | None = None):
        metrics = None
        for _ in range(n):
            batch = make_batch(batch_generator(seed, state.step, device))
            if plan is not None:
                batch = plan.local_rows(batch)
            state, metrics = train_step(state, batch, loss_fn, tx, plan)
            if every is not None:
                every.append(metrics)
        return state, metrics

    return run


def make_multislice_step_fns(loss_fn: LossFn,
                             tx: optim_lib.MixedPrecisionTransformation,
                             make_batch: Callable[[torch.Generator], Any],
                             device, rows: int, seed: int = 0, remat: bool = False,
                             plan: ParallelPlan | None = None, graphed: bool = False,
                             flat: bool = False):
    """(gen_batch, backward, apply) of the multi-slice step loop
    (models/train.py's _train_multislice): the optimizer step split at the
    gradient boundary, so that the cross-slice exchange
    (parallel/multislice.py) runs between the two halves, one microbatch at
    a time.

      gen_batch(i) -> global step i's whole batch, made once from
        batch_generator(seed, i) as make_chunked_train_step makes it; every
        slice makes the same one.
      backward(state, batch, offset) -> (loss, grads) over `rows` rows of
        that batch from `offset`: this rank's part of them under `plan`
        (the slice's world), the gradients reduced over the slice as
        train_step reduces them, the loss the rows' mean; with `flat`, one
        flat f32 tensor of them instead, the loss first, then each gradient
        in state.params' order (the trainer's wire to the host). Fresh
        tensors on every eager call (torch.autograd.grad), so each
        microbatch's gradients go to the exchange alone. The mean over every
        slice x microbatch block of the global batch is the global batch's
        mean.
      apply(state, grads) -> (state', grad_norm): the exchange's mean
        gradients (host arrays or tensors, f32 on the wire) cast to each
        parameter's dtype, then AdamW, as train_step applies it.

    graphed (graphed_step.step_route): each is a graphed_step.GraphedStep,
    captured at its first call, in one memory pool, replayed in the order
    of the captures. gen_batch's graph draws the batch from one generator,
    re-seeded on the host with batch_seed(seed, i) before each replay (its
    first call is its warm-up, its capture and its first replay), and
    returns the graph's static batch; backward has a graph a microbatch
    offset, reading that static batch, its flat output valid until its
    next call; apply's graph reads one static f32 buffer, into which the
    exchange's gradients are staged (graphed_step.stage) before each
    replay. The graphs are captured on the first call's state, and every
    later call must pass that state (a slice rewind restores it in place).
    Without `flat`, a graphed backward's loss and gradients are views of its
    flat output. The batch, the backward's outputs and the norm are the
    eager ones bit for bit."""
    plan = plan or ParallelPlan()
    if remat:
        loss_fn = remat_loss(loss_fn)

    def gen_batch(i: int):
        return make_batch(batch_generator(seed, i, device))

    def backward(state: TrainState, batch, offset: int):
        sub = {k: v[offset:offset + rows] if v.dim() else v for k, v in batch.items()}
        sub = plan.local_rows(sub)
        state.model.train()
        loss = loss_fn(state.model, sub)
        if plan.loss_group is not None:
            loss = loss * plan.loss_weight(sub)
        grads = plan.reduce_grads(list(torch.autograd.grad(loss, state.params)))
        return collectives.all_reduce(loss.detach(), plan.loss_group), grads

    def flat_backward(state: TrainState, batch, offset: int) -> torch.Tensor:
        loss, grads = backward(state, batch, offset)
        return torch.cat([g.detach().reshape(-1).float() for g in [loss.reshape(1), *grads]])

    def split(state: TrainState, out: torch.Tensor):
        """(loss, grads) as views of a flat backward's output."""
        grads, at = [], 1
        for p in state.params:
            grads.append(out[at:at + p.numel()].view(p.shape))
            at += p.numel()
        return out[0], grads

    def update(state: TrainState, grads):
        """AdamW on the mean gradients (device f32 tensors) -> grad_norm."""
        params = state.params
        grads = [g.to(dtype=p.dtype) for g, p in zip(grads, params)]
        tx.update_in_place(grads, state.opt_state, params)
        return plan.global_norm(grads)

    if not graphed:
        def apply(state: TrainState, grads):
            grads = [torch.as_tensor(g).to(device=p.device, dtype=torch.float32)
                     for g, p in zip(grads, state.params)]
            return TrainState(state.step + 1, state.model, state.opt_state), update(state, grads)

        return gen_batch, flat_backward if flat else backward, apply

    from tf_operator_tpu_torch.parallel import graphed_step as gs

    gen = torch.Generator(device=device)
    pool = torch.cuda.graph_pool_handle()
    held: dict = {}

    def graphed_gen_batch(i: int):
        if "batch" not in held:
            # The first call's warm-up and capture, then the first replay:
            # the backward graphs read the captured batch.
            held["batch"] = gs.GraphedStep(lambda: make_batch(gen), [gen], pool=pool)
            gs._reseed(gen, seed, i)
            held["batch"]()
        gs._reseed(gen, seed, i)
        return held["batch"]()

    def captured_state(state: TrainState) -> TrainState:
        held.setdefault("state", state)
        gs._same_state(state, held["state"])
        return held["state"]

    def graphed_backward(state: TrainState, batch, offset: int):
        captured = captured_state(state)
        if "batch" not in held or held["batch"].metrics is not batch:
            raise RuntimeError("a graphed backward reads the static batch of gen_batch")
        key = ("backward", offset)
        if key not in held:
            held[key] = gs.GraphedStep(
                lambda: {"flat": flat_backward(captured, batch, offset)}, pool=pool,
                watch=gs.world_watch(device))
        out = held[key]()["flat"]
        return out if flat else split(state, out)

    def graphed_apply(state: TrainState, grads):
        captured = captured_state(state)
        if "apply" not in held:
            static = gs.StaticInputs({i: tuple(p.shape) for i, p in enumerate(state.params)},
                                     torch.device(device), torch.float32)

            def body() -> dict:
                return {"grad_norm": update(captured, [static.views[i]
                                                       for i in range(len(static.views))])}

            held["apply"] = static, gs.GraphedStep(body, pool=pool,
                                                   watch=gs.world_watch(device))
        static, step = held["apply"]
        gs.stage(static, dict(enumerate(grads)))
        norm = step()["grad_norm"]
        return TrainState(state.step + 1, state.model, state.opt_state), norm

    return graphed_gen_batch, graphed_backward, graphed_apply
