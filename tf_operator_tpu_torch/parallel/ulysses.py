"""Ulysses sequence parallelism: all-to-all heads <-> sequence resharding.

Counterpart of ``tf_operator_tpu/parallel/ulysses.py``, the second
sequence-parallel scheme beside ring attention (parallel/ring_attention.py).
Sequences arrive sharded over `sp` ([B, H, T/n, D] a rank), one all-to-all
turns them into full sequences for a subset of heads ([B, H/n, T, D]), the
flash kernels run on those heads unsharded, and a second all-to-all
restores the sequence sharding. The all-to-alls are collectives.all_to_all
(JAX's tiled lax.all_to_all), whose backward is the reverse all-to-all.

Against ring: Ulysses moves Q, K, V and O once each, needs the local heads
to divide by sp, and holds full-T activations for its heads; ring moves
K/V n - 1 times and keeps O(T/n) per rank. `sp_mode` picks between them as
the JAX function does.
"""

from __future__ import annotations

import os

from tf_operator_tpu_torch.parallel import collectives


def _ulysses_sharded(q, k, v, group, causal: bool):
    """This rank's body: q, k, v are [B, H, T/n, D] shards; returns the
    same-shape output shard."""
    from tf_operator_tpu_torch.ops.attention import flash_attention

    def a2a_in(x):  # heads -> ranks, the full sequence here: [B, H/n, T, D]
        return collectives.all_to_all(x, 1, 2, group)

    o = flash_attention(a2a_in(q), a2a_in(k), a2a_in(v), causal=causal)
    # and back: sequence -> ranks, every head here: [B, H, T/n, D]
    return collectives.all_to_all(o, 2, 1, group)


def ulysses_attention(q, k, v, mesh, axis_name: str = "sp", causal: bool = False):
    """Exact attention over sequences sharded along `axis_name` of `mesh`
    (the contract of ring_attention): q, k, v are this rank's [B, H_local,
    T/sp, D] shards, and H_local (the heads after tp) must divide by sp."""
    sp = mesh.shape.get(axis_name, 1)
    heads_local = q.shape[1]
    if heads_local % sp:
        raise ValueError(
            f"ulysses needs local heads ({heads_local}) divisible by "
            f"sp={sp}; use ring attention for this shape")
    return _ulysses_sharded(q, k, v, mesh.group(axis_name), causal)


# Past this GLOBAL sequence length, auto-selection prefers ring even when
# the head count allows Ulysses: Ulysses holds full-T Q/K/V/O a rank (sp x
# the activation bytes of ring's O(T/sp) blocks). Override via env or
# TPUJOB_SP_MODE.
ENV_ULYSSES_MAX_SEQ = "TPUJOB_ULYSSES_MAX_SEQ"
DEFAULT_ULYSSES_MAX_SEQ = 131072


def sp_mode(mesh, num_heads: int | None = None, axis_name: str = "sp",
            head_axis: str = "tp", seq_len: int | None = None) -> str:
    """Which scheme to use: 'ulysses' when the head count (after tp)
    divides by sp AND the sequence is short enough to hold full-T
    activations a rank; 'ring' otherwise. TPUJOB_SP_MODE=ring|ulysses
    forces, then TPUJOB_ULYSSES_MAX_SEQ moves the length limit. `mesh` is
    anything with `axis_names` and `shape` (parallel.mesh.Mesh)."""
    forced = os.environ.get("TPUJOB_SP_MODE", "").lower()
    if forced in ("ring", "ulysses"):
        return forced
    if mesh is None or num_heads is None:
        return "ring"
    max_seq = int(os.environ.get(ENV_ULYSSES_MAX_SEQ, DEFAULT_ULYSSES_MAX_SEQ))
    if seq_len is not None and seq_len > max_seq:
        return "ring"
    sp = mesh.shape[axis_name] if axis_name in mesh.axis_names else 1
    tp = mesh.shape[head_axis] if head_axis in mesh.axis_names else 1
    if sp > 1 and (num_heads // tp) % sp == 0:
        return "ulysses"
    return "ring"
