"""The PyTorch port's fsdp holds parameter shards, as the JAX trainer does (gloo, CPU).

Under the JAX trainer fsdp is zero-3: sharding_rules shards each parameter
over fsdp on its largest divisible dimension, and a device holds only that
shard. Here the port's trainer runs as two (or four) processes through the
operator's env at fsdp = 2 (and fsdp = 2 x tp = 2 for the LM), and after
every step each rank's `model.parameters()` must have the per-device shard
shape that the JAX package gives the same leaf (`sharding.shard_shape` of
`tree_shardings` on a JAX CPU mesh of the same axes, in the port's [out,
in] order), and hold that shard's bytes.
The losses stay the one-process run's (tests/test_torch_dist_lm.py and
tests/test_torch_dist_jax.py hold the rest of the fsdp path).
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dist import assert_ok, assert_same_losses, run_world

from tf_operator_tpu.models import mnist as jmnist
from tf_operator_tpu.models import transformer as jtfm
from tf_operator_tpu.parallel import mesh as jmesh
from tf_operator_tpu.parallel import sharding_rules as jrules
from tf_operator_tpu_torch.models import mnist, train
from tf_operator_tpu_torch.models import transformer as tfm

STEPS = 3
# A trainer rank that writes, after every step, each parameter's shape and
# bytes to argv[1].<rank>.json; f32 compute, as tests/torch_dist.py's child.
_CHILD = """
import json, os, sys, torch
from tf_operator_tpu_torch.models import train
from tf_operator_tpu_torch.parallel import train_step as ts
train.COMPUTE_DTYPE = torch.float32
torch.set_num_threads(1)
seen, real = [], ts.train_step

def train_step(state, *args, **kwargs):
    state, metrics = real(state, *args, **kwargs)
    seen.append({n: [list(p.shape), p.numel() * p.element_size()]
                 for n, p in state.model.named_parameters()})
    return state, metrics

ts.train_step = train_step
rc = train.main(sys.argv[2:])
with open(f"{sys.argv[1]}.{os.environ.get('JAX_PROCESS_ID', '0')}.json", "w") as f:
    json.dump(seen, f)
sys.exit(rc)
"""

MODELS = {
    "transformer-lm": (
        ["--seq", "32", "--batch", "4", "--layers", "2", "--hidden", "64", "--heads", "4"],
        lambda: jtfm.TransformerLM(jtfm.TransformerConfig(
            vocab_size=train.VOCAB, num_layers=2, hidden=64, num_heads=4, max_len=32,
            causal=True)),
        jnp.zeros((1, 32), jnp.int32), jrules.TRANSFORMER_TP_RULES),
    "bert-tiny": (["--seq", "32", "--batch", "4"],
                  lambda: jtfm.BertMLM(dataclasses.replace(jtfm.TINY, max_len=32)),
                  jnp.zeros((1, 32), jnp.int32), jrules.TRANSFORMER_TP_RULES),
    "mnist-mlp": (["--batch", "8"], lambda: jmnist.MLP(), jnp.zeros((1, 28, 28)), None),
}
RUNS = [("transformer-lm", {"fsdp": 2}), ("transformer-lm", {"fsdp": 2, "tp": 2}),
        ("bert-tiny", {"fsdp": 2}), ("mnist-mlp", {"fsdp": 2})]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _argv(model: str) -> list[str]:
    return (["--device", "cpu", "--model", model, "--steps", str(STEPS), "--log-every", "1"]
            + MODELS[model][0])


def jax_shard_shapes(model: str, axes: dict) -> tuple[dict, dict]:
    """({port parameter name: the JAX per-device shard shape in the port's
    dimension order}, {name: the full shape}): each flax leaf, at its shard
    shape and at its full shape, carried through the port's
    params_from_flax, which renames and transposes it."""
    _, build, x, table = MODELS[model]
    shapes = jax.eval_shape(lambda: build().init(jax.random.key(0), x))["params"]
    jm = jmesh.make_mesh(axes, devices=jax.devices()[:math.prod(axes.values())])
    shardings = jrules.tree_shardings(shapes, jm, table)
    to_port = mnist.params_from_flax if model == "mnist-mlp" else tfm.params_from_flax

    def port_shapes(shape_of):
        tree = jax.tree.map(lambda leaf, s: np.zeros(shape_of(leaf, s), np.float32),
                            shapes, shardings)
        return {n: list(t.shape) for n, t in to_port(tree).items()}

    return (port_shapes(lambda leaf, s: s.shard_shape(leaf.shape)),
            port_shapes(lambda leaf, s: leaf.shape))


@pytest.mark.parametrize("model,mesh", RUNS, ids=lambda v: v if isinstance(v, str) else
                         "-".join(f"{k}{n}" for k, n in v.items()))
def test_ranks_hold_the_jax_shards(model, mesh, tmp_path):
    n = math.prod(mesh.values())
    argv = _argv(model)
    one = run_world(tmp_path, argv, 1, tag="one")
    runs = run_world(tmp_path, [str(tmp_path / "shapes")] + argv, n, mesh, code=_CHILD)
    assert_ok(one + runs)
    assert_same_losses(runs, one, rtol=1e-4)
    want, full = jax_shard_shapes(model, mesh)
    sharded = [k for k in want if want[k] != full[k]]
    assert sharded, "the fsdp rules shard nothing here"
    for rank in range(n):
        seen = json.loads((tmp_path / f"shapes.{rank}.json").read_text())
        assert len(seen) == STEPS
        for step in seen:
            assert sorted(step) == sorted(want)
            for name, (shape, nbytes) in step.items():
                assert shape == want[name], (rank, name, shape, want[name])
                assert nbytes == 4 * int(np.prod(want[name])), (rank, name)
        held = sum(nbytes for _, nbytes in seen[-1].values())
        whole = 4 * sum(int(np.prod(full[k])) for k in full)
        assert held < whole, (held, whole)
    if mesh == {"fsdp": 2}:
        # Every sharded leaf is held at half its bytes.
        assert all(int(np.prod(want[k])) * 2 == int(np.prod(full[k])) for k in sharded)
