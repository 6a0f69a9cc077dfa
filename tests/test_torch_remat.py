"""Rematerialisation in the PyTorch port (--remat, --remat-save-flash[-layers]), on CPU.

Per-block remat (TransformerConfig.remat_layers) runs each block under a
non-reentrant torch.utils.checkpoint; save-flash gives all blocks, or the
first K, a selective policy that keeps the flash forward's (o, lse)
(ops.flash_attention.flash_save_context); the loss-level remat of the
trainer's --remat wraps the whole loss (parallel.train_step.remat_loss).
Recomputation replays the same ops on the same inputs, so the port's loss
and every gradient equal the port without remat bit for bit. Against the
JAX model under the same config (its attention forced onto the Pallas
kernel in interpret mode, TPUJOB_ATTENTION=flash TPUJOB_FLASH_INTERPRET=1,
so its flash_o/flash_lse tags exist) they agree at the f32 LM tolerance of
tests/test_torch_transformer.py (atol 1e-4). A count of the plain forward's
calls shows the policy: the backward replays it once per block without
save-flash, never with it, in the last L - K blocks with K saved, and the
loss-level replay runs every block's forward once more.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import train as jtrain
from tf_operator_tpu.models import transformer as jtfm
from tf_operator_tpu.ops import attention as jattention
from tf_operator_tpu_torch.models import train
from tf_operator_tpu_torch.models import transformer as tfm
from tf_operator_tpu_torch.ops import flash_attention as fa
from tf_operator_tpu_torch.parallel.ring_attention import make_attention_fn
from tf_operator_tpu_torch.parallel.train_step import remat_loss


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module's tests and fixtures
    (tests/test_torch_flash_attention.py
    says why: a first multi-threaded torch.exp can be off by 1.5e-4, which
    bit-for-bit checks would see)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


T, BATCH = 128, 2
# Two layers, head width 64 (a width the Pallas kernel takes as it is).
SHAPE = dict(num_layers=2, hidden=128, num_heads=2, max_len=T)
CONFIGS = {
    "layers": dict(remat_layers=True),
    "save_flash": dict(remat_layers=True, remat_save_flash=True),
    "save_flash_layers_1": dict(remat_layers=True, remat_save_flash_layers=1),
}


def _tokens():
    return np.random.default_rng(0).integers(0, 1024, (BATCH, T)).astype(np.int32)


@pytest.fixture(scope="module")
def flax_params():
    cfg = dataclasses.replace(jtfm.TINY_LM, dtype=jnp.float32, **SHAPE)
    params = jtfm.TransformerLM(cfg).init(jax.random.key(0), jnp.zeros((1, T), jnp.int32))
    return params["params"]


def _port(flax_params, **remat):
    cfg = dataclasses.replace(tfm.TINY_LM, dtype=torch.float32, **SHAPE, **remat)
    model = tfm.TransformerLM(cfg, attn_fn=make_attention_fn(causal=True))
    model.load_state_dict(tfm.params_from_flax(jax.tree.map(np.array, flax_params)))
    return model


def _port_loss_and_grads(model, loss_remat=False):
    def loss_fn(m, tok):
        return tfm.lm_loss(m(tok), tok)

    if loss_remat:
        loss_fn = remat_loss(loss_fn)
    tok = torch.from_numpy(_tokens()).long()
    loss = loss_fn(model, tok)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.detach(), dict(zip(names, grads))


@pytest.fixture(scope="module")
def port_reference(flax_params):
    return _port_loss_and_grads(_port(flax_params))


@pytest.mark.parametrize("loss_remat", [False, True], ids=["block", "block+loss"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_remat_is_bit_for_bit_the_port_without_remat(flax_params, port_reference, config,
                                                     loss_remat):
    loss, grads = _port_loss_and_grads(_port(flax_params, **CONFIGS[config]), loss_remat)
    ref_loss, ref_grads = port_reference
    assert torch.equal(loss, ref_loss)
    for name, g in grads.items():
        assert torch.equal(g, ref_grads[name]), name


@pytest.mark.parametrize("config,loss_remat", [("layers", False), ("save_flash", False),
                                               ("save_flash_layers_1", False),
                                               ("save_flash", True)])
def test_remat_matches_the_jax_model(flax_params, monkeypatch, config, loss_remat):
    monkeypatch.setenv("TPUJOB_ATTENTION", "flash")
    monkeypatch.setenv("TPUJOB_FLASH_INTERPRET", "1")
    monkeypatch.setenv("TPUJOB_FLASH_BLOCK", "128")
    jcfg = dataclasses.replace(jtfm.TINY_LM, dtype=jnp.float32, **SHAPE, **CONFIGS[config])
    jmodel = jtfm.TransformerLM(
        jcfg, attn_fn=functools.partial(jattention.flash_attention, causal=True))
    tok = jnp.asarray(_tokens())

    def loss_fn(p):
        return jtfm.lm_loss(jmodel.apply({"params": p}, tok), tok)

    if loss_remat:
        loss_fn = jax.checkpoint(loss_fn)
    loss_j, grads_j = jax.value_and_grad(loss_fn)(flax_params)
    grads_j = tfm.params_from_flax(jax.tree.map(np.array, grads_j))
    loss_t, grads_t = _port_loss_and_grads(_port(flax_params, **CONFIGS[config]), loss_remat)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), atol=1e-4)
    for name, g in grads_t.items():
        np.testing.assert_allclose(g.numpy(), grads_j[name].numpy(), atol=1e-4, err_msg=name)


@pytest.mark.parametrize("config,loss_remat,backward_calls", [
    ("none", False, 0),                  # no remat: the forward's residuals serve
    ("layers", False, 2),                # each block replays its forward
    ("save_flash", False, 0),            # (o, lse) kept: no replay of the kernel
    ("save_flash_layers_1", False, 1),   # the second block replays, the first not
    ("layers", True, 4),                 # the loss replay runs both blocks, then each
    ("save_flash", True, 2),             # replays itself; save-flash only the former
])
def test_flash_forward_calls_show_the_policy(flax_params, monkeypatch, config, loss_remat,
                                             backward_calls):
    calls = []
    plain = fa.flash_fwd_plain
    monkeypatch.setattr(fa, "flash_fwd_plain", lambda *a, **k: calls.append(1) or plain(*a, **k))
    model = _port(flax_params, **CONFIGS.get(config, {}))
    loss_fn = (lambda m, tok: tfm.lm_loss(m(tok), tok))
    if loss_remat:
        loss_fn = remat_loss(loss_fn)
    tok = torch.from_numpy(_tokens()).long()
    loss = loss_fn(model, tok)
    forward_calls = len(calls)
    torch.autograd.grad(loss, list(model.parameters()))
    assert forward_calls == SHAPE["num_layers"]
    assert len(calls) - forward_calls == backward_calls


@pytest.mark.parametrize("config,saved_blocks", [
    ("none", 0), ("layers", 0), ("save_flash", 2), ("save_flash_layers_1", 1),
])
def test_dispatcher_op_runs_only_where_the_policy_keeps_flash(flax_params, monkeypatch,
                                                              config, saved_blocks):
    """The forward goes through the dispatcher op tfo_torch::flash_fwd only
    inside flash_save_context: once a kept block in the forward and once
    more in its recompute (served from the kept outputs); everywhere else
    the bindings launch directly."""
    ops = []
    op = fa.flash_fwd_op
    monkeypatch.setattr(fa, "flash_fwd_op", lambda *a: ops.append(1) or op(*a))
    model = _port(flax_params, **CONFIGS.get(config, {}))
    tok = torch.from_numpy(_tokens()).long()
    loss = tfm.lm_loss(model(tok), tok)
    assert len(ops) == saved_blocks
    torch.autograd.grad(loss, list(model.parameters()))
    assert len(ops) == 2 * saved_blocks


def test_no_grad_forward_skips_remat_and_lse(flax_params, monkeypatch):
    """The evaluator's path: under no_grad the blocks run plainly and the
    forward keeps no lse (the dispatcher op, which returns it, is not run)."""
    ops = []
    op = fa.flash_fwd_op
    monkeypatch.setattr(fa, "flash_fwd_op", lambda *a: ops.append(1) or op(*a))
    model = _port(flax_params, **CONFIGS["save_flash"])
    tok = torch.from_numpy(_tokens()).long()
    with torch.no_grad():
        logits = model(tok)
    assert not ops
    torch.testing.assert_close(logits, _port(flax_params)(tok).detach(), rtol=0, atol=0)


@pytest.mark.parametrize("flags", [
    ["--remat-save-flash"],
    ["--remat-save-flash-layers", "2"],
    ["--remat", "--remat-save-flash", "--remat-save-flash-layers", "2"],
    ["--remat", "--remat-save-flash-layers", "-1"],
], ids=["save-flash-without-remat", "layers-without-remat", "both", "negative"])
def test_flag_errors_are_the_jax_trainers(flags, capsys):
    def error_line(main):
        with pytest.raises(SystemExit) as e:
            main(["--model", "transformer-lm", *flags])
        assert e.value.code == 2
        return capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1]

    assert error_line(train.main) == error_line(jtrain.main)


def test_config_errors_are_the_jax_models():
    for kw in (dict(remat_save_flash=True), dict(remat_layers=True, remat_save_flash=True,
                                                 remat_save_flash_layers=1),
               dict(remat_layers=True, remat_save_flash_layers=-1)):
        with pytest.raises(ValueError):
            dataclasses.replace(jtfm.TINY_LM, **kw)
        with pytest.raises(ValueError):
            dataclasses.replace(tfm.TINY_LM, **kw)


def test_trainer_with_remat_ends_on_the_trainer_without(tmp_path):
    args = ["--device", "cpu", "--model", "transformer-lm", "--batch", "2", "--seq", "64",
            "--layers", "2", "--hidden", "128", "--heads", "2", "--steps", "3",
            "--log-every", "1"]
    finals = []
    for extra in ([], ["--remat"], ["--remat", "--remat-save-flash"],
                  ["--remat", "--remat-save-flash-layers", "1"]):
        out: dict = {}
        assert train.main(args + extra, out) == 0
        finals.append([p.detach().clone() for p in out["state"].model.parameters()])
    for other in finals[1:]:
        assert all(torch.equal(a, b) for a, b in zip(finals[0], other))


def test_loss_remat_moves_batch_norm_statistics_once():
    """The loss replay runs the batch-norm forward again; the running
    statistics must move once a step, as without remat (the JAX step returns
    them from the checkpointed function)."""
    from tf_operator_tpu_torch.models import mnist, resnet

    def step(remat):
        model = resnet.ResNet([1, 1], num_classes=10, width=8,
                              generator=torch.Generator().manual_seed(0))
        model.train()
        x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
        y = torch.tensor([3, 7])

        def loss_fn(m, batch):
            return mnist.cross_entropy_loss(m(batch[0]), batch[1])

        loss = (remat_loss(loss_fn) if remat else loss_fn)(model, (x, y))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return grads, [b.clone() for b in model.buffers()]

    (g0, b0), (g1, b1) = step(False), step(True)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(b0, b1))
    assert any(not torch.equal(b, torch.zeros_like(b)) for b in b1)
