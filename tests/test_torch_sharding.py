"""The PyTorch port's mesh and sharding rules against the JAX package's, on CPU.

Rules parity: for every parameter of bert-tiny, the tiny LM, ResNet-18 and
the MNIST MLP, on each mesh of MESHES, the port's `tree_shardings` (run on
the port's modules, whose Dense weights are [out, in] and convolutions
OIHW) gives the spec of JAX's `sharding_for` on the flax parameter,
permuted to the port's dimension order. Pure: the flax shapes come from
jax.eval_shape, the meshes are the test session's virtual CPU devices, and
no process group is made.

Mesh parity: `normalize_axes`, `local_batch_size` (value and error) and the
error for axes whose product is not the device count are JAX's. The axes
the port does not run yet (pp, data above 1) are refused by name; sp and
ep, which it runs, get their groups.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tf_operator_tpu.models import mnist as jmnist
from tf_operator_tpu.models import resnet as jresnet
from tf_operator_tpu.models import transformer as jtfm
from tf_operator_tpu.parallel import mesh as jmesh
from tf_operator_tpu.parallel import sharding_rules as jrules
from tf_operator_tpu_torch.models import mnist, resnet
from tf_operator_tpu_torch.models import transformer as tfm
from tf_operator_tpu_torch.parallel import mesh as mesh_lib
from tf_operator_tpu_torch.parallel import sharding_rules as rules

MESHES = [{"dp": 2}, {"fsdp": 2}, {"tp": 2}, {"dp": 2, "tp": 4}, {"fsdp": 2, "tp": 2},
          {"fsdp": 4, "tp": 2}]


def _models():
    """name -> (flax module, init input, port model, port params_from_flax,
    rules), the trainer's choice of rules for each."""
    tp = rules.TRANSFORMER_TP_RULES
    return {
        "bert-tiny": (jtfm.BertMLM(jtfm.TINY), jnp.zeros((1, 8), jnp.int32),
                      lambda: tfm.BertMLM(tfm.TINY), tfm.params_from_flax, tp),
        "tiny-lm": (jtfm.TransformerLM(jtfm.TINY_LM), jnp.zeros((1, 8), jnp.int32),
                    lambda: tfm.TransformerLM(tfm.TINY_LM), tfm.params_from_flax, tp),
        "resnet18": (jresnet.ResNet18(num_classes=1000), jnp.zeros((1, 32, 32, 3)),
                     lambda: resnet.ResNet18(num_classes=1000),
                     lambda p: resnet.params_from_flax(p), None),
        "mnist-mlp": (jmnist.MLP(), jnp.zeros((1, 28, 28)), lambda: mnist.MLP(),
                      mnist.params_from_flax, None),
    }


def _flax_to_port_names(params, to_port) -> dict:
    """flax path -> (port name, flax shape): each leaf is filled with its
    own index and carried through the port's params_from_flax, which
    renames (and transposes) it."""
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    marked = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [np.full(leaf.shape, i, np.float32) for i, (_, leaf) in enumerate(flat)])
    port = {float(t.flatten()[0]) if t.numel() else None: n for n, t in to_port(marked).items()}
    return {jrules.path_str(path): (port[float(i)], tuple(leaf.shape))
            for i, (path, leaf) in enumerate(flat)}


def _to_port_order(spec: tuple, flax_leaf: str, ndim: int) -> tuple:
    if flax_leaf == "kernel" and ndim == 2:
        return spec[::-1]  # [in, out] -> [out, in]
    if flax_leaf == "kernel" and ndim == 4:
        return tuple(spec[j] for j in (3, 2, 0, 1))  # HWIO -> OIHW
    return spec


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "-".join(f"{k}{v}" for k, v in a.items()))
@pytest.mark.parametrize("model", ["bert-tiny", "tiny-lm", "resnet18", "mnist-mlp"])
def test_rules_match_jax_on_every_parameter(model, axes):
    jmodule, x, build, to_port, table = _models()[model]
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.key(0), x))["params"]
    n = int(np.prod(list(axes.values())))
    jm = jmesh.make_mesh(axes, devices=jax.devices()[:n])
    jtable = None if table is None else jrules.TRANSFORMER_TP_RULES
    port_specs = rules.tree_shardings(build(), axes, table)
    names = _flax_to_port_names(shapes, to_port)
    assert sorted(n for n, _ in names.values()) == sorted(port_specs)
    for path, (name, shape) in names.items():
        jspec = tuple(jrules.sharding_for(path, shape, jm, jtable).spec)
        jspec = jspec + (None,) * (len(shape) - len(jspec))
        want = _to_port_order(jspec, path.rsplit("/", 1)[-1], len(shape))
        assert port_specs[name] == want, (path, name, port_specs[name], jspec)


def test_the_rules_shard_what_megatron_shards():
    """One spot check of the table itself at {tp: 2}: query column-, attn_out
    row-parallel, the vocabulary split, LayerNorm replicated."""
    specs = rules.tree_shardings(tfm.BertMLM(tfm.TINY), {"tp": 2}, rules.TRANSFORMER_TP_RULES)
    assert specs["trunk.layers.0.attn.query.weight"] == ("tp", None)
    assert specs["trunk.layers.0.attn.attn_out.weight"] == (None, "tp")
    assert specs["trunk.embed.weight"] == ("tp", None)
    assert specs["lm_head.weight"] == ("tp", None)
    assert specs["trunk.layers.0.ln1.weight"] == (None,)
    assert specs["mlm_transform.weight"] == (None, None)
    assert "trunk.embed.weight: ('tp', None)" in list(
        rules.describe(tfm.BertMLM(tfm.TINY), {"tp": 2}, rules.TRANSFORMER_TP_RULES))


@pytest.mark.parametrize("axes", [{"tp": 2, "dp": 4}, {"sp": 1, "fsdp": 2, "data": 1},
                                  {"foo": 2, "dp": 1}, {}])
def test_normalize_axes_is_jax(axes):
    assert list(mesh_lib.normalize_axes(axes).items()) == list(jmesh.normalize_axes(axes).items())


@pytest.mark.parametrize("axes,batch", [({"dp": 2}, 8), ({"fsdp": 2, "tp": 2}, 6),
                                        ({"dp": 2, "fsdp": 2, "tp": 2}, 8),
                                        ({"dp": 2, "tp": 4}, 5)])
def test_local_batch_size_is_jax(axes, batch):
    n = int(np.prod(list(axes.values())))
    jm = jmesh.make_mesh(axes, devices=jax.devices()[:n])
    pm = mesh_lib.Mesh(mesh_lib.normalize_axes(axes), 0, np.arange(n).reshape(
        tuple(mesh_lib.normalize_axes(axes).values())))
    try:
        want = jmesh.local_batch_size(jm, batch)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh_lib.local_batch_size(pm, batch)
        assert str(got.value) == str(e)
    else:
        assert mesh_lib.local_batch_size(pm, batch) == want
        assert mesh_lib.data_axes(pm) == jmesh.data_axes(jm)
        assert mesh_lib.shape_dict(pm) == jmesh.shape_dict(jm)


@pytest.mark.parametrize("axes,world", [({"dp": 4}, 2), ({"dp": 2, "tp": 2}, 8),
                                        ({"fsdp": 3}, 2)])
def test_axes_that_miss_the_world_raise_the_jax_message(axes, world):
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(axes, devices=jax.devices()[:world])
    with pytest.raises(ValueError) as got:
        mesh_lib.check_axes(axes, world)
    head = str(want.value).split(" (")[0]
    assert str(got.value).split(" (")[0] == head, (got.value, want.value)


@pytest.mark.parametrize("axis,item", [("pp", "A12"), ("data", "A12")])
def test_unported_axes_are_refused_by_name(axis, item):
    """pp and data are ported (A12 = `item`): accepted at any size, in the
    JAX package's canonical order; only an axis the port does not know is
    refused, by name."""
    axes = mesh_lib.check_axes({"dp": 1, axis: 2}, 2)
    assert axes == {axis: 2, "dp": 1} and list(axes) == list(jmesh.normalize_axes(axes))
    assert mesh_lib.check_axes({axis: 1, "dp": 2}, 2)[axis] == 1
    with pytest.raises(mesh_lib.UnportedAxisError, match=f"unknown mesh axis '{axis}x'"):
        mesh_lib.check_axes({f"{axis}x": 2}, 2)


def test_ep_is_run_in_the_canonical_order():
    """ep is ported (the MoE LM's experts): accepted at any size, placed
    between fsdp and sp, as the JAX package orders it."""
    axes = mesh_lib.check_axes({"tp": 2, "ep": 2, "dp": 2}, 8)
    assert list(axes) == ["dp", "ep", "tp"] == list(jmesh.normalize_axes(axes))
    assert mesh_lib.check_axes({"ep": 4}, 4) == {"ep": 4}


def test_sp_is_run_in_the_canonical_order():
    """sp is ported: accepted at any size, placed between ep and tp."""
    axes = mesh_lib.check_axes({"tp": 2, "sp": 2, "dp": 2}, 8)
    assert list(axes) == ["dp", "sp", "tp"] == list(jmesh.normalize_axes(axes))
    assert mesh_lib.check_axes({"sp": 4}, 4) == {"sp": 4}


def test_a_world_of_one_makes_a_mesh_without_groups():
    mesh = mesh_lib.make_mesh(None)
    assert mesh.shape == {"dp": 1} and mesh.world == 1 and mesh.groups == {}
    assert mesh.group("dp", "fsdp") is None and mesh.index("dp", "fsdp") == 0


def test_the_operators_env_names_one_world(monkeypatch):
    """distributed_env reads the JAX contract's names; a one-process job
    joins no world; the backend rule gives gloo on the CPU whatever the
    store holds."""
    import torch
    import torch.distributed as dist

    from tf_operator_tpu_torch.parallel import distributed

    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "pod-0.svc:8476")
    monkeypatch.setenv("JAX_PROCESS_ID", "3")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    assert distributed.distributed_env() == ("pod-0.svc:8476", 3, 4)
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    assert distributed.initialize_from_env() is None and not dist.is_initialized()
    assert distributed.choose_backend(dist.HashStore(), 0, 2, torch.device("cpu")) == "gloo"
    distributed.distributed_goodbye()  # no world: nothing to close
