"""Parameter sharding rules: counterpart of tf_operator_tpu/parallel/sharding_rules.py.

Megatron-style tensor parallelism with fsdp composed on top, written as
ordered (regex, spec) rules over flattened parameter paths. The first match
wins; unmatched parameters are replicated, then fsdp-sharded on their
largest evenly divisible dimension. A spec is a tuple with one entry per
dimension: None, an axis name, or a tuple of axis names (PartitionSpec's
entries).

The rules, and `sharding_for`, are written for the flax parameter tree:
paths like `trunk/layer_0/attn/query/kernel` and Dense kernels of shape
[in, out]. The port's modules mirror those names (`trunk.layers.0.attn.
query.weight`) but store Dense weights [out, in] and convolutions OIHW.
`param_layout` gives each port parameter its flax path and the permutation
from its dimensions to flax's, so `tree_shardings` runs the JAX algorithm
on the flax view (the same dimension is "largest not yet sharded") and
returns each spec in the port's dimension order.
"""

from __future__ import annotations

import re
from typing import Iterable

import numpy as np
from torch import nn

Spec = tuple
Rules = list[tuple[str, Spec]]

# Megatron TP for the transformer family (models/transformer.py naming):
#   qkv / mlp-in kernels: split the output dim over tp (column parallel)
#   attn-out / mlp-out kernels: split the input dim over tp (row parallel)
#   embeddings: split the vocabulary (or positions) over tp
TRANSFORMER_TP_RULES: Rules = [
    (r".*(query|key|value|qkv)/kernel$", (None, "tp")),
    (r".*attn_out/kernel$", ("tp", None)),
    (r".*mlp_in/kernel$", (None, "tp")),
    (r".*mlp_out/kernel$", ("tp", None)),
    (r".*embed/embedding$", ("tp", None)),
    (r".*lm_head/kernel$", (None, "tp")),
    (r".*(bias|scale)$", ()),
]

# MoE (models/moe.py naming): stacked expert FFN weights [E, in, out] shard
# the experts over ep and the matmul dims over tp; the router stays
# replicated so every dp shard routes identically.
MOE_RULES: Rules = [
    (r".*experts_in$", ("ep", None, "tp")),
    (r".*experts_out$", ("ep", "tp", None)),
    (r".*/router$", ()),
] + TRANSFORMER_TP_RULES


def path_str(path) -> str:
    """A parameter path as the rules read it: entries joined by "/"; a
    dotted module name is split at its dots."""
    if isinstance(path, str):
        return path.replace(".", "/")
    return "/".join(str(p) for p in path)


def _mesh_axes(axes: dict[str, int], spec: Spec) -> Spec:
    """Drop axes the mesh doesn't have (rules are mesh-agnostic)."""
    cleaned = []
    for entry in spec:
        if entry is None:
            cleaned.append(None)
        elif isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in axes)
            cleaned.append(kept if kept else None)
        else:
            cleaned.append(entry if entry in axes else None)
    return tuple(cleaned)


def _apply_fsdp(spec: Spec, shape: tuple[int, ...], axes: dict[str, int]) -> Spec:
    """Compose fsdp onto the largest dimension not already sharded, when it
    divides evenly (zero-3 parameter sharding)."""
    if axes.get("fsdp", 1) == 1:
        return spec
    fsdp = axes["fsdp"]
    entries = list(spec) + [None] * (len(shape) - len(spec))
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if entries[i] is None and shape[i] % fsdp == 0 and shape[i] >= fsdp:
            entries[i] = "fsdp"
            break
    return tuple(entries)


def sharding_for(path: str, shape: tuple[int, ...], axes: dict[str, int],
                 rules: Rules | None) -> Spec:
    """The spec of a parameter at flax `path` of flax `shape` on a mesh of
    `axes` ({name: size}): the JAX function's result, as a tuple (entries
    past the rule's length are None, as PartitionSpec reads them)."""
    spec: Spec = ()
    for pattern, candidate in rules or []:
        if re.match(pattern, path):
            spec = _mesh_axes(axes, candidate)
            break
    spec = _apply_fsdp(spec, shape, axes)
    # Drop shardings that don't divide the dim evenly (small models on big tp).
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, entry in enumerate(entries):
        if entry is None:
            continue
        size = axes[entry] if isinstance(entry, str) else int(np.prod([axes[a] for a in entry]))
        if shape[i] % size:
            entries[i] = None
    return tuple(entries)


def _flax_leaf(module: nn.Module, leaf: str, ndim: int) -> tuple[str, tuple[int, ...]]:
    """(flax leaf name, perm) of a port parameter: perm[i] is the flax
    dimension of the port's dimension i. A Dense weight with leading
    dimensions (a pipeline stage's stack) keeps them in place."""
    kind = type(module).__name__
    if leaf == "weight":
        if kind == "Dense":
            return "kernel", tuple(range(ndim - 2)) + (ndim - 1, ndim - 2)
        if kind == "Conv":
            return "kernel", (3, 2, 0, 1)  # OIHW -> HWIO
        if kind == "Embed":
            return "embedding", (0, 1)
        return "scale", tuple(range(ndim))  # LayerNorm, TpuBatchNorm
    return leaf, tuple(range(ndim))


def param_layout(model: nn.Module) -> dict[str, tuple[str, tuple[int, ...]]]:
    """{port parameter name: (flax path, perm)} for every parameter.
    `layers.i` reads as flax's `layer_i`; other module names are the
    flax names' own spelling where the rules look at them."""
    modules = dict(model.named_modules())
    out = {}
    for name, p in model.named_parameters():
        mod_name, _, leaf = name.rpartition(".")
        flax_leaf, perm = _flax_leaf(modules[mod_name], leaf, p.dim())
        path = re.sub(r"(^|\.)layers\.(\d+)", r"\1layer_\2", mod_name)
        out[name] = (path_str(path) + "/" + flax_leaf if path else flax_leaf, perm)
    return out


def to_port_order(spec: Spec, perm: tuple[int, ...]) -> Spec:
    """A flax-order spec in the port's dimension order."""
    return tuple(spec[perm[i]] for i in range(len(perm)))


def tree_shardings(model: nn.Module, axes: dict[str, int],
                   rules: Rules | None = None) -> dict[str, Spec]:
    """{parameter name: spec in the port's dimension order}."""
    layout = param_layout(model)
    out = {}
    for name, p in model.named_parameters():
        path, perm = layout[name]
        flax_shape = tuple(p.shape[perm.index(j)] for j in range(p.dim()))
        out[name] = to_port_order(sharding_for(path, flax_shape, axes, rules), perm)
    return out


def describe(model: nn.Module, axes: dict[str, int], rules: Rules | None = None) -> Iterable[str]:
    for name, spec in tree_shardings(model, axes, rules).items():
        yield f"{name}: {spec}"
