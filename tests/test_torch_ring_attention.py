"""The PyTorch port's ring attention against the JAX package's (CPU).

`merge_partials` against JAX's on numpy inputs, empty (NEG_INF) partials
included; `resolve_block_impl`'s values and errors; and `ring_attention`'s
forward and its q/k/v gradients (of sum(o * w) for a fixed cotangent w) in
gloo worlds of 2 and 4 processes at {sp: n} and 8 at {dp: 2, sp: 2, tp: 2}
(tests/torch_sp.py), with the plain block and with the flash kernels'
plain versions through FlashAttentionWithLse (whose lse cotangent the
merge makes nonzero), against JAX's ring_attention on a CPU mesh of the
same axes and against single-device attention: [2, 4, 64, 32] f32, causal
and full, atol 2e-5 (the JAX package's own tolerance for its ring).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_sp import SHAPE, attention_world, inputs

from tf_operator_tpu.parallel import mesh as jmesh
from tf_operator_tpu.parallel import ring_attention as jring
from tf_operator_tpu_torch.ops.flash_attention import NEG_INF
from tf_operator_tpu_torch.parallel import mesh as mesh_lib
from tf_operator_tpu_torch.parallel import ring_attention as ring

ATOL = 2e-5
MESHES = {"sp2": {"sp": 2}, "sp4": {"sp": 4}, "dp-sp-tp": {"dp": 2, "sp": 2, "tp": 2}}
CASES = [("ring", causal, block) for causal in (False, True) for block in ("naive", "flash")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {name: attention_world(tmp_path_factory.mktemp(name), mesh, CASES)
            for name, mesh in MESHES.items()}


@functools.lru_cache(maxsize=None)
def _jax_results(mesh_name: str, causal: bool):
    """(ring, reference): JAX's ring_attention on a CPU mesh of the axes,
    and single-device attention; each (o, dq, dk, dv) of sum(o * w)."""
    axes = MESHES[mesh_name]
    m = jmesh.make_mesh(axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])
    q, k, v, w = (jnp.asarray(x) for x in inputs())

    def run(attn):
        def loss(q, k, v):
            o = attn(q, k, v)
            return jnp.sum(o * w), o

        grads, o = jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
        return tuple(np.asarray(x) for x in (o, *grads))

    return (run(lambda q, k, v: jring.ring_attention(q, k, v, mesh=m, causal=causal)),
            run(lambda q, k, v: jring.attention_reference(q, k, v, causal=causal)))


def _ids(case):
    return f"{'causal' if case[1] else 'full'}-{case[2]}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_ring_matches_the_jax_ring(mesh_name, case, worlds):
    got = worlds[mesh_name]["-".join(map(str, case))]
    want, _ = _jax_results(mesh_name, case[1])
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_ring_matches_single_device_attention(mesh_name, case, worlds):
    got = worlds[mesh_name]["-".join(map(str, case))]
    _, want = _jax_results(mesh_name, case[1])
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=name)
    assert got[1].shape == SHAPE and np.abs(got[1]).max() > 0


def _partials(seed: int, empty_rows=()):
    """(o1, lse1, o2, lse2) on [2, 3, 5, 4] with the given (which, row)
    partials empty: lse NEG_INF and o 0."""
    rng = np.random.default_rng(seed)
    o1, o2 = (rng.standard_normal((2, 3, 5, 4)).astype(np.float32) for _ in range(2))
    lse1, lse2 = (rng.standard_normal((2, 3, 5)).astype(np.float32) * 3 for _ in range(2))
    for which, row in empty_rows:
        (lse1 if which == 1 else lse2)[..., row] = NEG_INF
        (o1 if which == 1 else o2)[..., row, :] = 0.0
    return o1, lse1, o2, lse2


@pytest.mark.parametrize("empty", [(), ((1, 0),), ((2, 1), (2, 3)), ((1, 2), (2, 2)),
                                   ((1, 0), (2, 0), (1, 4), (2, 4))],
                         ids=["none", "first-row", "second-rows", "both-one-row", "both-rows"])
def test_merge_partials_is_jax(empty):
    arrs = _partials(len(empty), empty)
    got = ring.merge_partials(*(torch.from_numpy(a) for a in arrs))
    want = jring.merge_partials(*(jnp.asarray(a) for a in arrs))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    # An all-empty row stays empty: o = 0, lse = NEG_INF.
    for row in {r for w, r in empty if (1, r) in empty and (2, r) in empty}:
        assert (got[0][..., row, :] == 0).all() and (got[1][..., row] == NEG_INF).all()


@pytest.mark.parametrize("causal", [False, True])
def test_block_norm_naive_is_jax(causal):
    q, k, v, _ = inputs((1, 2, 16, 8), seed=3)
    got = ring._block_norm_naive(*(torch.from_numpy(x) for x in (q, k, v)), causal, 8 ** -0.5)
    want = jring._block_norm_naive(*(jnp.asarray(x) for x in (q, k, v)), causal, 8 ** -0.5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("arg,env,device,want", [
    (None, None, "cpu", "naive"), ("auto", None, "cpu", "naive"),
    (None, "flash", "cpu", "flash"), ("naive", "flash", "cpu", "naive"),
    (None, None, "cuda", "flash"), (None, "FLASH ", "cuda", "flash"),
    ("flash", None, "cuda", "flash"),
])
def test_resolve_block_impl(arg, env, device, want, monkeypatch):
    if env is None:
        monkeypatch.delenv("TPUJOB_RING_BLOCK", raising=False)
    else:
        monkeypatch.setenv("TPUJOB_RING_BLOCK", env)
    assert ring.resolve_block_impl(arg, torch.device(device)) == want


def test_resolve_block_impl_errors(monkeypatch):
    """An unknown value raises JAX's message; the plain block is refused on
    a CUDA tensor rather than run there."""
    monkeypatch.setenv("TPUJOB_RING_BLOCK", "pallas")
    with pytest.raises(ValueError) as want:
        jring.resolve_block_impl(None, 1024, 128)
    with pytest.raises(ValueError) as got:
        ring.resolve_block_impl(None, torch.device("cpu"))
    assert str(got.value) == str(want.value)
    monkeypatch.setenv("TPUJOB_RING_BLOCK", "naive")
    with pytest.raises(ValueError, match="CUDA"):
        ring.resolve_block_impl(None, torch.device("cuda"))


def test_one_rank_ring_is_its_diagonal_block():
    """sp = 1 (no group): the body computes the diagonal block alone, which
    is exact attention."""
    q, k, v, _ = (torch.from_numpy(x) for x in inputs((1, 2, 16, 8), seed=4))
    got = ring.ring_attention(q, k, v, mesh_lib.Mesh({"sp": 1}), causal=True)
    torch.testing.assert_close(got, ring.attention_reference(q, k, v, causal=True),
                               atol=1e-6, rtol=1e-6)
