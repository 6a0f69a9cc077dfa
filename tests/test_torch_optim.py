"""The PyTorch port's mixed-precision Adam/AdamW against tf_operator_tpu.optim.

The same f32 init parameters and the same per-step numpy gradients go into
both optimizers for several steps. f32 moments without master weights agree
at atol 1e-6 (f32 arithmetic in a different order); bf16 moments with f32
master weights keep the masters at atol 1e-6 and the bf16 compute params
and moments within one bf16 ulp (a master a rounding apart can round to
neighbouring bf16 values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu import optim as joptim
from tf_operator_tpu_torch import optim

torch.set_num_threads(2)

SHAPES = [(16, 8), (8,), (3, 5, 2)]
STEPS = 4


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) * 0.1 for s in SHAPES]
             for _ in range(STEPS)]
    return params, grads


def _within_one_bf16_ulp(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(a - b) <= ulp), np.max(np.abs(a - b) / ulp)


def _run_jax(cfg_kw, params, grads):
    tx = joptim.make_optimizer(joptim.OptimizerConfig(**cfg_kw))
    p = [jnp.asarray(x) for x in params]
    state = tx.init(p)
    p = joptim.compute_params(tx, p)
    for g in grads:
        g = [jnp.asarray(x).astype(pp.dtype) for x, pp in zip(g, p)]
        updates, state = tx.update(g, state, p)
        p = joptim.apply_updates(tx, p, updates)
    return p, state


def _run_torch(cfg_kw, params, grads):
    tx = optim.make_optimizer(optim.OptimizerConfig(**cfg_kw))
    p = [torch.from_numpy(x.copy()) for x in params]
    state = tx.init(p)
    if optim.compute_dtype(tx) is not None:
        p = [x.to(optim.compute_dtype(tx)) for x in p]
    for g in grads:
        g = [torch.from_numpy(x).to(pp.dtype) for x, pp in zip(g, p)]
        p, state = tx.update(g, state, p)
    return p, state


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_f32_moments_no_master(name):
    cfg = {"name": name, "learning_rate": 1e-2, "moment_dtype": "f32"}
    params, grads = _problem()
    pj, sj = _run_jax(cfg, params, grads)
    pt, st = _run_torch(cfg, params, grads)
    assert st.count == int(sj.count) == STEPS and st.master == []
    for a, b in zip(pt, pj):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6)
    for a, b in zip(st.mu + st.nu, list(sj.mu) + list(sj.nu)):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6)


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_bf16_moments_with_master_weights(name):
    cfg = {"name": name, "learning_rate": 1e-2, "moment_dtype": "bf16",
           "master_weights": True}
    params, grads = _problem(1)
    pj, sj = _run_jax(cfg, params, grads)
    pt, st = _run_torch(cfg, params, grads)
    for a, b in zip(st.master, sj.master):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6)
    for a, b in zip(pt, pj):
        assert a.dtype == torch.bfloat16
        _within_one_bf16_ulp(_np(a), _np(b))
    for a, b in zip(st.mu + st.nu, list(sj.mu) + list(sj.nu)):
        assert a.dtype == torch.bfloat16
        _within_one_bf16_ulp(_np(a), _np(b))


def test_state_field_order_and_dtypes():
    assert optim.MixedAdamState._fields == joptim.MixedAdamState._fields
    cfg = optim.OptimizerConfig(moment_dtype="bf16", master_weights=True)
    assert cfg.moment_dtype is torch.bfloat16 and cfg.compute_dtype is torch.bfloat16
    with pytest.raises(ValueError):
        optim.OptimizerConfig(name="sgd")
    with pytest.raises(ValueError):
        optim.OptimizerConfig(moment_dtype="int8")
