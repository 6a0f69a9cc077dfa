"""The PyTorch port's Ulysses attention against the JAX package's (CPU).

`ulysses_attention`'s forward and q/k/v gradients in gloo worlds of 2 and
4 processes at {sp: n} and 8 at {dp: 2, sp: 2, tp: 2} (tests/torch_sp.py)
against JAX's ulysses_attention on a CPU mesh of the same axes and against
single-device attention, [2, 4, 64, 32] f32, causal and full, atol 2e-5;
the indivisible-heads error with JAX's text; and `sp_mode` against JAX's
over the cases of tests/test_parallel.py, both environment overrides
included.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_sp import attention_world, inputs

from tf_operator_tpu.parallel import mesh as jmesh
from tf_operator_tpu.parallel import ring_attention as jring
from tf_operator_tpu.parallel import ulysses as julysses
from tf_operator_tpu_torch.parallel import mesh as mesh_lib
from tf_operator_tpu_torch.parallel import ulysses

ATOL = 2e-5
MESHES = {"sp2": {"sp": 2}, "sp4": {"sp": 4}, "dp-sp-tp": {"dp": 2, "sp": 2, "tp": 2}}
CASES = [("ulysses", causal, None) for causal in (False, True)]


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
    """(ulysses, reference), each (o, dq, dk, dv) of sum(o * w)."""
    axes = MESHES[mesh_name]
    m = jmesh.make_mesh(axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])
    q, k, v, w = (jnp.asarray(x) for x in inputs())

    def run(attn):
        def loss(q, k, v):
            o = attn(q, k, v)
            return jnp.sum(o * w), o

        grads, o = jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
        return tuple(np.asarray(x) for x in (o, *grads))

    return (run(lambda q, k, v: julysses.ulysses_attention(q, k, v, mesh=m, causal=causal)),
            run(lambda q, k, v: jring.attention_reference(q, k, v, causal=causal)))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_ulysses_matches_the_jax_ulysses(mesh_name, causal, worlds):
    got = worlds[mesh_name][f"ulysses-{causal}-None"]
    want, _ = _jax_results(mesh_name, causal)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_ulysses_matches_single_device_attention(mesh_name, causal, worlds):
    got = worlds[mesh_name][f"ulysses-{causal}-None"]
    _, want = _jax_results(mesh_name, causal)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=name)


def test_indivisible_heads_raise_the_jax_error():
    """4 heads over sp = 8: JAX's ValueError text, before any collective."""
    jm = jmesh.make_mesh({"sp": 8})
    with pytest.raises(ValueError) as want:
        julysses.ulysses_attention(jnp.zeros((1, 4, 32, 16)), jnp.zeros((1, 4, 32, 16)),
                                   jnp.zeros((1, 4, 32, 16)), mesh=jm)
    q = torch.zeros(1, 4, 4, 16)  # this rank's [B, H, T/sp, D]
    with pytest.raises(ValueError) as got:
        ulysses.ulysses_attention(q, q, q, mesh_lib.Mesh({"sp": 8}))
    assert str(got.value) == str(want.value) and "divisible" in str(got.value)


# (axes, num_heads, seq_len, env): tests/test_parallel.py's sp_mode cases.
SP_MODE_CASES = [
    ({"dp": 2, "sp": 2, "tp": 2}, 8, None, {}),
    ({"dp": 2, "sp": 2, "tp": 2}, 2, None, {}),
    (None, None, None, {}),
    ({"dp": 2, "sp": 2, "tp": 2}, 8, None, {"TPUJOB_SP_MODE": "ring"}),
    ({"dp": 2, "sp": 2, "tp": 2}, 2, None, {"TPUJOB_SP_MODE": "ulysses"}),
    ({"dp": 2, "sp": 4}, 4, None, {}),
    ({"sp": 8}, 8, 4096, {}),
    ({"sp": 8}, 8, 1 << 20, {}),
    ({"sp": 8}, 8, 4096, {"TPUJOB_ULYSSES_MAX_SEQ": "2048"}),
    ({"sp": 8}, 8, 1 << 20, {"TPUJOB_SP_MODE": "ulysses"}),
    ({"dp": 8}, 8, None, {}),
]


@pytest.mark.parametrize("axes,heads,seq,env", SP_MODE_CASES)
def test_sp_mode_is_jax(axes, heads, seq, env, monkeypatch):
    for name in ("TPUJOB_SP_MODE", "TPUJOB_ULYSSES_MAX_SEQ"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    jm = pm = None
    if axes is not None:
        jm = jmesh.make_mesh(axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])
        pm = mesh_lib.Mesh(mesh_lib.normalize_axes(axes))
    assert ulysses.sp_mode(pm, heads, seq_len=seq) == julysses.sp_mode(jm, heads, seq_len=seq)
