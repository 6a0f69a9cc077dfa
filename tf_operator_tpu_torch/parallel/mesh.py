"""The device mesh: counterpart of tf_operator_tpu/parallel/mesh.py.

The operator injects TPUJOB_MESH (logical axes, e.g. {"dp": 2, "tp": 4});
this module turns it into a `Mesh` over the job's torch.distributed world.
One process drives one device, so the world's ranks are the mesh's devices,
laid out as np.arange(world).reshape(sizes) in the canonical axis order.
A pod of N local ranks (parallel/launch.py) numbers them p * N + i, pod
major, as JAX orders `jax.devices()` process by process: the grid's
innermost axes then stay inside a pod, so a {"dp": P, "tp": N} mesh keeps
every tp group on one pod's GPUs (NVLink) and crosses pods only over dp,
the layout the JAX package gets from its process-major devices.
Axis semantics, as in the JAX package:

  dp    pure data parallel (params replicated)
  fsdp  data parallel with sharded params and optimizer state
  tp    tensor parallel (megatron-style within attention and the MLP)
  sp    sequence parallel (ring attention or Ulysses over the sequence)
  ep    expert parallel (the MoE LM's experts; not a data axis)
  pp    pipeline parallel: the trainer replicates over it, as the JAX
        trainer does (neither the batch nor a parameter is split over it;
        parallel/pipeline.py runs the GPipe schedule over a pp group)
  data  the outermost data axis; across slices, the cross-slice axis
        (hierarchical_mesh; a multi-slice job's slices are separate worlds
        joined by parallel/multislice.py's exchange)

Batches split over (data, dp, fsdp), and a transformer's sequence over sp;
parameters shard over (fsdp, ep, tp) by sharding_rules. An unknown axis is
refused by name.

`Mesh` is a rank grid with one process group for each axis this rank
needs a collective over, made with the backend of the world's group.
torch's DeviceMesh is not used: on CUDA it would create NCCL groups where
the backend rule chose gloo (two ranks on one GPU), and it needs an
initialised world where a one-process job has none.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np
import torch.distributed as dist

from tf_operator_tpu_torch.parallel.distributed import ENV_MESH

AXIS_ORDER = ("data", "pp", "dp", "fsdp", "ep", "sp", "tp")
# tp innermost, dp outermost (the JAX package's reasons: tensor-parallel
# collectives are latency-bound, the gradient all-reduce crosses the slowest
# links only at the slowest level); "data" is the cross-slice axis.
DATA_AXIS = "data"
# The axes a sequence-parallel model sums its gradients over, beside the
# fsdp-less ones its fsdp shards are summed over after their reduce-scatter.
GRAD_AXES = ("data", "dp", "fsdp", "sp")
SHARD_GRAD_AXES = ("data", "dp", "sp")
# The axes whose ranks each hold part of an MoE layer's experts, and sum
# their parts of its output.
EXPERT_AXES = ("ep", "tp")


class UnportedAxisError(ValueError):
    """A mesh axis the port does not know."""


def normalize_axes(axes: dict[str, int]) -> dict[str, int]:
    """The axes with explicit sizes, in canonical order (unknown names
    last, in their given order)."""
    out: dict[str, int] = {}
    for name in AXIS_ORDER:
        if name in axes:
            out[name] = int(axes[name])
    for name, size in axes.items():
        if name not in out:
            out[name] = int(size)
    return out


def check_axes(axes: dict[str, int], world: int) -> dict[str, int]:
    """The normalised axes, or the error that refuses them: an unknown
    axis (UnportedAxisError, naming it), or sizes whose product is not the
    world's (the JAX message)."""
    axes = normalize_axes(axes) if axes else {"dp": world}
    for name in axes:
        if name not in AXIS_ORDER:
            raise UnportedAxisError(f"unknown mesh axis {name!r} (axes: {AXIS_ORDER})")
    n = int(np.prod(list(axes.values())))
    if n != world:
        devices = [f"rank{r}" for r in range(world)]
        raise ValueError(f"mesh axes {axes} need {n} devices, have {world} "
                         f"({devices[:4]}...)")
    return axes


def env_axes() -> dict[str, int] | None:
    """TPUJOB_MESH's axes, None when unset."""
    raw = os.environ.get(ENV_MESH, "")
    return json.loads(raw) if raw else None


@dataclass
class Mesh:
    """The axes (canonical order), this process's rank, the rank grid
    (np.arange over the axes by default) and the process groups this rank
    belongs to, keyed by axis tuple (absent where the axes span one rank).
    Mesh({"dp": 1}) is one process's."""

    shape: dict[str, int]
    rank: int = 0
    grid: np.ndarray | None = None
    groups: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.grid is None:
            self.grid = np.arange(int(np.prod(list(self.shape.values())))).reshape(
                tuple(self.shape.values()))

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def world(self) -> int:
        return int(self.grid.size)

    def coord(self, axis: str) -> int:
        """This rank's index along `axis` (0 for an axis the mesh lacks)."""
        if axis not in self.shape:
            return 0
        where = np.argwhere(self.grid == self.rank)[0]
        return int(where[self.axis_names.index(axis)])

    def size(self, *axes: str) -> int:
        return int(np.prod([axis_size(self, a) for a in axes]))

    def index(self, *axes: str) -> int:
        """This rank's index over `axes` taken together, the first
        outermost."""
        i = 0
        for a in axes:
            i = i * axis_size(self, a) + self.coord(a)
        return i

    def group(self, *axes: str):
        """The process group over `axes` that holds this rank, or None when
        they span one rank."""
        return self.groups.get(tuple(a for a in axes if axis_size(self, a) > 1))


def make_mesh(axes: dict[str, int] | None = None) -> Mesh:
    """A Mesh in the canonical axis order over the torch.distributed world
    (one rank when none is initialised). With axes None, pure dp over the
    world. Every rank makes every group, in the same order, as new_group
    requires."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    axes = check_axes(axes or {}, world)
    mesh = Mesh(dict(axes), rank)
    if world == 1:
        return mesh
    names, grid = mesh.axis_names, mesh.grid
    wanted = [(a,) for a in names if axes[a] > 1]
    for combo in (data_axes(mesh), GRAD_AXES, SHARD_GRAD_AXES, ("data", "dp"), EXPERT_AXES):
        sub = tuple(a for a in combo if axes.get(a, 1) > 1)
        if len(sub) > 1 and sub not in wanted:
            wanted.append(sub)
    backend = dist.get_backend()
    for sub in wanted:
        keep = [names.index(a) for a in sub]
        rest = [i for i in range(len(names)) if i not in keep]
        # One group per setting of the other axes: the ranks that differ
        # only along `sub`.
        moved = np.moveaxis(grid, rest + keep, range(len(names)))
        for ranks in moved.reshape(-1, int(np.prod([axes[a] for a in sub]))):
            g = dist.new_group([int(r) for r in ranks], backend=backend)
            if rank in ranks:
                mesh.groups[sub] = g
    return mesh


def mesh_from_env() -> Mesh:
    """Mesh from the operator-injected TPUJOB_MESH (pure dp when unset)."""
    return make_mesh(env_axes())


def hierarchical_mesh(axes: dict[str, int] | None, num_slices: int,
                      world: int | None = None) -> Mesh:
    """The mesh of one world spanning every slice: the cross-slice `data`
    axis outermost over the per-slice `axes` (pure dp over a slice's ranks
    when None), so the ranks group by slice. `world` defaults to the
    torch.distributed world's size; the groups are made when it is that
    world. A multi-slice trainer does not use this: each slice is its own
    world there, and the data axis is parallel/multislice.py's exchange."""
    if num_slices < 1:
        raise ValueError(f"num_slices must be >= 1, got {num_slices}")
    live = dist.get_world_size() if dist.is_initialized() else 1
    world = live if world is None else world
    if world % num_slices:
        raise ValueError(f"{world} devices do not partition into {num_slices} slices")
    inner = dict(axes) if axes else {"dp": world // num_slices}
    if DATA_AXIS in inner:
        raise ValueError("mesh axes describe ONE slice; the cross-slice 'data' axis is "
                         "implied by num_slices and may not appear in them")
    full = {DATA_AXIS: num_slices, **inner}
    if world == live:
        return make_mesh(full)
    return Mesh(check_axes(full, world))


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """Axes the global batch is split over."""
    return tuple(a for a in (DATA_AXIS, "dp", "fsdp") if a in mesh.axis_names)


def axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def shape_dict(mesh: Mesh) -> dict[str, int]:
    """Plain-dict {axis: size} view of a mesh: what the checkpoint sharding
    manifest records and the reshape-aware resume compares."""
    return {name: int(size) for name, size in mesh.shape.items()}


def local_batch_size(mesh: Mesh, global_batch: int) -> int:
    denom = 1
    for a in data_axes(mesh):
        denom *= axis_size(mesh, a)
    if global_batch % denom:
        raise ValueError(f"global batch {global_batch} not divisible by dp size {denom}")
    return global_batch // denom
