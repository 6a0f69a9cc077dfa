"""The port trainer's chunked-loss cutover against the JAX trainer's.

The JAX trainer runs the LM's and the MoE LM's loss through the chunked
head when the per-device f32 logits reach 6e9 bytes
(``tf_operator_tpu.models.train._logits_bytes``: 4 x batch x seq x vocab
over dp x fsdp, tp and sp left out). The port's ``_build_model`` must take
the same decision on every mesh. ``_logits_bytes`` reads only ``.shape``
and ``.axis_names`` of its mesh, so a stand-in serves on one CPU device;
the port gets its own ``Mesh`` of the same axes (no process groups are
needed to build a model).
"""

import types

import pytest
import torch

from tf_operator_tpu.models import train as jtrain
from tf_operator_tpu_torch.models import train
from tf_operator_tpu_torch.parallel.mesh import Mesh

VOCAB = 32000
MESHES = ({}, {"dp": 2}, {"dp": 4}, {"fsdp": 2}, {"dp": 2, "tp": 2}, {"sp": 2})
# (batch, seq): global f32 logits of 4.19e9, 6.0e9 exactly, 6.29e9, 8.39e9
# (twice), 1.68e10 and 3.36e10 bytes, so each mesh sees cases on both sides
# of 6e9. (8, 8192) at dp 2 is 4.19e9 a device: JAX runs the one-shot head
# there.
SIZES = ((4, 8192), (3, 15625), (6, 8192), (8, 8192), (2, 32768), (16, 8192), (32, 8192))


def _args(model: str, batch: int, seq: int):
    return train.build_parser().parse_args(
        ["--device", "cpu", "--model", model, "--batch", str(batch), "--seq", str(seq),
         "--layers", "2", "--hidden", "16", "--heads", "2"])


def _jax_chunked(args, axes: dict) -> bool:
    mesh = types.SimpleNamespace(shape=dict(axes), axis_names=tuple(axes))
    return jtrain._logits_bytes(args, mesh, VOCAB) >= 6e9


def _closure(fn, name: str):
    cells = dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))
    return cells[name]


@pytest.mark.parametrize("batch,seq", SIZES)
@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "x".join(f"{k}{v}" for k, v in a.items())
                         or "one")
@pytest.mark.parametrize("model", ("transformer-lm", "moe-lm"))
def test_build_model_takes_the_jax_cutover(model, axes, batch, seq):
    args = _args(model, batch, seq)
    mesh = Mesh(dict(axes) or {"dp": 1})
    _, loss_fn, _ = train._build_model(args, torch.device("cpu"), mesh)
    assert _closure(loss_fn, "chunked_loss") is _jax_chunked(args, axes)


@pytest.mark.parametrize("batch,seq", SIZES)
def test_no_mesh_is_one_process(batch, seq):
    args = _args("transformer-lm", batch, seq)
    assert train.use_chunked_loss(args, None, VOCAB) is _jax_chunked(args, {})


def test_the_cases_straddle_the_cutover():
    """The grid holds a case where the global bytes cross 6e9 and the
    per-device bytes do not (the port's old rule and JAX's part there), and
    one on each side of the cutover on every mesh."""
    args = _args("transformer-lm", 8, 8192)
    assert 4.0 * 8 * 8192 * VOCAB >= train.CHUNKED_LOSS_BYTES
    assert not _jax_chunked(args, {"dp": 2})
    for axes in MESHES:
        seen = {_jax_chunked(_args("transformer-lm", b, s), axes) for b, s in SIZES}
        assert seen == {True, False}, axes
