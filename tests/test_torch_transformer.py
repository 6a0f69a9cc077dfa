"""The PyTorch port's causal transformer LM against the flax model, on CPU.

Weights are made by the flax init and carried across with
params_from_flax; tokens are numpy. In f32 the logits, lm_loss and every
parameter gradient agree at atol 1e-4 (float summation order only). In
bf16 compute both sides round at slightly different places (bias adds,
GELU), so logits are held at atol 0.1 and the loss at rtol 1e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import transformer as jtfm
from tf_operator_tpu_torch.models import transformer as tfm
from tf_operator_tpu_torch.parallel.ring_attention import make_attention_fn

torch.set_num_threads(2)

T = 64
BATCH = 2


def _pair(dtype_name: str, attn: bool = False):
    """(flax model, flax params, torch model with the same weights)."""
    jcfg = dataclasses.replace(jtfm.TINY_LM, dtype=getattr(jnp, dtype_name))
    tcfg = dataclasses.replace(tfm.TINY_LM, dtype=getattr(torch, dtype_name))
    jmodel = jtfm.TransformerLM(jcfg)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, T), jnp.int32))["params"]
    tmodel = tfm.TransformerLM(tcfg, attn_fn=make_attention_fn(causal=True) if attn else None)
    tmodel.load_state_dict(tfm.params_from_flax(jax.tree.map(np.array, params)))
    return jmodel, params, tmodel


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, 1024, (BATCH, T)).astype(np.int32)


def test_params_from_flax_covers_the_state_dict():
    _, params, tmodel = _pair("float32")
    converted = tfm.params_from_flax(jax.tree.map(np.array, params))
    assert set(converted) == set(tmodel.state_dict())
    w = params["trunk"]["layer_1"]["attn"]["query"]["kernel"]
    np.testing.assert_array_equal(
        converted["trunk.layers.1.attn.query.weight"].numpy(), np.array(w).T)
    assert "lm_head.bias" not in converted


@pytest.mark.parametrize("attn", [False, True], ids=["reference", "flash"])
def test_logits_loss_and_grads_f32(attn):
    jmodel, params, tmodel = _pair("float32", attn)
    tok = _tokens()

    def loss_fn(p):
        return jtfm.lm_loss(jmodel.apply({"params": p}, jnp.asarray(tok)), jnp.asarray(tok))

    logits_j = jmodel.apply({"params": params}, jnp.asarray(tok))
    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)

    tt = torch.from_numpy(tok).long()
    logits_t = tmodel(tt)
    loss_t = tfm.lm_loss(logits_t, tt)
    loss_t.backward()
    np.testing.assert_allclose(logits_t.detach().numpy(), np.array(logits_j), atol=1e-4)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), atol=1e-4)
    grads_j = tfm.params_from_flax(jax.tree.map(np.array, grads_j))
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads_j[name].numpy(), atol=1e-4,
                                   err_msg=name)


def test_logits_and_loss_bf16():
    jmodel, params, tmodel = _pair("bfloat16", attn=True)
    tok = _tokens(1)
    logits_j = jmodel.apply({"params": params}, jnp.asarray(tok))
    tt = torch.from_numpy(tok).long()
    with torch.no_grad():
        logits_t = tmodel(tt)
    assert logits_t.dtype == torch.float32
    np.testing.assert_allclose(logits_t.numpy(), np.array(logits_j), atol=0.1)
    np.testing.assert_allclose(float(tfm.lm_loss(logits_t, tt)),
                               float(jtfm.lm_loss(logits_j, jnp.asarray(tok))), rtol=1e-2)


def test_lm_loss_chunked_equals_lm_loss_both_sides():
    jmodel, params, tmodel = _pair("float32")
    tok = _tokens(2)
    h_j = jmodel.apply({"params": params}, jnp.asarray(tok), method="hidden")
    chunked_j = jtfm.lm_loss_chunked(h_j, params["lm_head"]["kernel"], jnp.asarray(tok),
                                     chunk=16)
    full_j = jtfm.lm_loss(jmodel.apply({"params": params}, jnp.asarray(tok)), jnp.asarray(tok))

    tt = torch.from_numpy(tok).long()
    full_t = tfm.lm_loss(tmodel(tt), tt)
    g_full = torch.autograd.grad(full_t, list(tmodel.parameters()))
    chunked_t = tfm.lm_loss_chunked(tmodel.hidden(tt), tmodel.lm_head.weight, tt, chunk=16)
    g_chunked = torch.autograd.grad(chunked_t, list(tmodel.parameters()))

    np.testing.assert_allclose(float(chunked_j), float(full_j), atol=1e-5)
    np.testing.assert_allclose(chunked_t.item(), full_t.item(), atol=1e-5)
    np.testing.assert_allclose(chunked_t.item(), float(chunked_j), atol=1e-4)
    for a, b in zip(g_chunked, g_full):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


def test_init_is_flax_like_in_distribution():
    cfg = dataclasses.replace(tfm.TINY_LM, hidden=256, num_heads=4)
    m = tfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0))
    w = m.trunk.layers[0].mlp_in.weight.detach()  # fan_in 256: std 1/16
    assert abs(float(w.std()) - 1 / 16) < 0.005
    assert float(w.abs().max()) <= 2 / 16 / 0.87962566103423978 + 1e-6
    emb = m.trunk.embed.weight.detach()
    assert abs(float(emb.std()) - 1 / 16) < 0.005
    assert torch.all(m.trunk.ln_f.weight == 1) and torch.all(m.trunk.layers[0].attn.query.bias == 0)
    again = tfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(again.trunk.embed.weight, emb, rtol=0, atol=0)


@pytest.mark.parametrize("kw,err", [
    ({"remat_save_flash": True}, ValueError),
    ({"remat_layers": True, "remat_save_flash": True, "remat_save_flash_layers": 2}, ValueError),
    ({"remat_layers": True}, NotImplementedError),
    ({"remat_layers": True, "remat_save_flash_layers": 3}, NotImplementedError),
    ({"dropout_rate": 0.1}, NotImplementedError),
])
def test_config_validation(kw, err):
    with pytest.raises(err):
        tfm.TransformerConfig(**kw)
