"""The PyTorch port's MoE LM and grouped matmul against the JAX package's, on CPU.

Inputs and weights are numpy arrays made from a seed, handed to both sides;
flax-initialised weights cross with moe_params_from_flax. Everything is
held in f32, where the two differ only in the order of float sums:

  - routing (topk_routing: combine, dispatch, aux) and the sparse
    dispatch's forward and every gradient at atol 1e-5 (values of order 1);
  - the grouped matmul's plain version and its VJP against
    jax.lax.ragged_dot at atol 1e-5, an empty group included;
  - the hand VJPs (a gather by the inverse permutation) against autograd
    of a plain index_select: equal up to the order of the k-sum (1e-6);
  - both dispatches against the per-token oracle (moe_reference_forward)
    with no token dropped, at atol 1e-5;
  - the TINY_MOE LM's logits, loss (chunked and not) and every parameter
    gradient against flax at atol 1e-4, as the LM's test holds them;
  - a three-step AdamW trajectory against make_train_step: loss and grad
    norm at rtol 1e-4;
  - the MOE_RULES layout against the JAX sharding_for on every parameter.

On CPU tensors the grouped matmul runs its plain version, so these tests
reach every line of the port but the CUDA kernel, which chip_smoke.py
holds against the same plain version on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu import optim as joptim
from tf_operator_tpu.models import moe as jmoe
from tf_operator_tpu.parallel import mesh as jmesh
from tf_operator_tpu.parallel import sharding_rules as jrules
from tf_operator_tpu.parallel import train_step as jts
from tf_operator_tpu_torch import optim
from tf_operator_tpu_torch.models import moe, train
from tf_operator_tpu_torch.ops import grouped_matmul as gm
from tf_operator_tpu_torch.parallel import sharding_rules as rules
from tf_operator_tpu_torch.parallel import train_step as ts

T, BATCH = 32, 2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _cfgs(**kw):
    """(JAX config, port config) of the same fields, f32."""
    jcfg = dataclasses.replace(jmoe.TINY_MOE, dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(moe.TINY_MOE, dtype=torch.float32, **kw)
    return jcfg, tcfg


def _ffn_weights(rng, h: int, e: int, f: int):
    return (rng.standard_normal((h, e)).astype(np.float32) * h ** -0.5,
            rng.standard_normal((e, h, f)).astype(np.float32) * h ** -0.5,
            rng.standard_normal((e, f, h)).astype(np.float32) * f ** -0.5)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("top_k,capacity", [(1, 6), (2, 5), (2, 64)],
                         ids=["top1-drops", "top2-drops", "top2-room"])
def test_topk_routing_matches_jax(top_k, capacity):
    logits = np.random.default_rng(1).standard_normal((BATCH, T, 4)).astype(np.float32) * 2
    jc, jd, ja = jmoe.topk_routing(jnp.asarray(logits), top_k, capacity)
    tc, td, ta = moe.topk_routing(_t(logits), top_k, capacity)
    np.testing.assert_allclose(tc.numpy(), np.array(jc), atol=1e-6)
    np.testing.assert_array_equal(td.numpy(), np.array(jd))
    for key in ("fraction", "prob"):
        np.testing.assert_allclose(ta[key].numpy(), np.array(ja[key]), atol=1e-6)
    if capacity < T:  # the tight capacity drops some choices
        assert td.sum() < BATCH * T * top_k


def test_routing_over_sequence_shards_is_the_whole_rows():
    """Each sp shard's combine, with the slots assigned over the whole rows
    (row_logits), is that shard's columns of the whole rows' combine."""
    logits = _t(np.random.default_rng(2).standard_normal((BATCH, T, 4)).astype(np.float32))
    whole, _, _ = moe.topk_routing(logits, 2, 7)
    parts = [moe.topk_routing(logits[:, i * T // 4:(i + 1) * T // 4], 2, 7, logits, (i, 4))[0]
             for i in range(4)]
    torch.testing.assert_close(torch.cat(parts, 1), whole, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The grouped matmul's plain version and its VJP
# ---------------------------------------------------------------------------

GROUPS = [[3, 0, 5, 1], [0, 0, 9, 0], [1, 1, 1, 6], [9, 0, 0, 0]]


@pytest.mark.parametrize("sizes", GROUPS, ids=lambda s: "-".join(map(str, s)))
def test_grouped_matmul_and_vjp_match_ragged_dot(sizes):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12, 10)).astype(np.float32)
    ct = rng.standard_normal((9, 10)).astype(np.float32)
    gs = np.array(sizes, np.int32)
    jy, vjp = jax.vjp(lambda a, b: jax.lax.ragged_dot(a, b, jnp.asarray(gs)), x, w)
    jdx, jdw = vjp(jnp.asarray(ct))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    ty = gm.grouped_matmul(tx, tw, torch.from_numpy(gs))
    ty.backward(_t(ct))
    np.testing.assert_allclose(ty.detach().numpy(), np.array(jy), atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.array(jdx), atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.array(jdw), atol=1e-5)
    for e, size in enumerate(sizes):
        if size == 0:  # an empty group leaves its weight's gradient zero
            assert not tw.grad[e].any()


def test_grouped_matmul_of_some_groups_zeroes_the_other_rows():
    """An expert-parallel rank's call: weights of groups 1-2 only; their rows
    are ragged_dot's, every other row (and every row past the groups'
    sum) is zero."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((11, 8)).astype(np.float32)
    w = rng.standard_normal((4, 8, 6)).astype(np.float32)
    gs = np.array([2, 3, 4, 1], np.int32)
    full = np.array(jax.lax.ragged_dot(x, w, jnp.asarray(gs)))
    got = gm.grouped_matmul(_t(x), _t(w[1:3]), torch.from_numpy(gs), 1).numpy()
    np.testing.assert_allclose(got[2:9], full[2:9], atol=1e-5)
    assert not got[:2].any() and not got[9:].any()


def test_hand_vjps_are_index_selects_gradients():
    rng = np.random.default_rng(5)
    n, k, h = 6, 2, 4
    xf = _t(rng.standard_normal((n, h)).astype(np.float32))
    order = torch.argsort(torch.from_numpy(rng.integers(0, 3, n * k)), stable=True)
    inv = torch.argsort(order, stable=True)
    g = _t(rng.standard_normal((n * k, h)).astype(np.float32))
    a, b = xf.clone().requires_grad_(), xf.clone().requires_grad_()
    moe._DispatchGather.apply(a, order // k, inv, k).backward(g)
    b.index_select(0, order // k).backward(g)
    torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-6)
    y = g.clone().requires_grad_()
    z = g.clone().requires_grad_()
    moe._PermuteRows.apply(y, inv, order).backward(g)
    z.index_select(0, inv).backward(g)
    torch.testing.assert_close(y.grad, z.grad, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The dispatches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("top_k", [1, 2])
def test_sparse_moe_ffn_forward_and_grads_match_jax(top_k):
    jcfg, tcfg = _cfgs(hidden=32, mlp_ratio=2, top_k=top_k)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((BATCH, T, 32)).astype(np.float32)
    ws = _ffn_weights(rng, 32, 4, 64)
    ct = rng.standard_normal((BATCH, T, 32)).astype(np.float32)

    def jloss(x, wr, wi, wo):
        y, aux = jmoe.sparse_moe_ffn(x, wr, wi, wo, jcfg)
        return (y * ct).sum() + jmoe.load_balance_loss(aux, 4) + jmoe.router_z_loss(aux), y

    (jl, jy), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(x, *ws)
    args = [_t(a).requires_grad_() for a in (x, *ws)]
    ty, aux = moe.sparse_moe_ffn(*args, tcfg)
    tl = (ty * _t(ct)).sum() + moe.load_balance_loss(aux, 4) + moe.router_z_loss(aux)
    tl.backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.array(jy), atol=1e-5)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)  # a sum of 2048 products
    for name, a, want in zip(("x", "router", "experts_in", "experts_out"), args, jg):
        np.testing.assert_allclose(a.grad.numpy(), np.array(want), atol=1e-5, err_msg=name)


@pytest.mark.parametrize("dispatch", ["dense", "sparse"])
def test_dispatches_match_the_per_token_oracle(dispatch):
    """With a capacity of every token (capacity_factor = E / top_k) the
    dense dispatch drops nothing, and both equal the JAX oracle."""
    jcfg, tcfg = _cfgs(capacity_factor=2.0, dispatch=dispatch)
    h, e = tcfg.hidden, tcfg.num_experts
    rng = np.random.default_rng(7)
    x = rng.standard_normal((BATCH, T, h)).astype(np.float32)
    wr, wi, wo = _ffn_weights(rng, h, e, tcfg.ffn)
    params = {"router": wr, "experts_in": wi, "experts_out": wo}
    want = np.array(jmoe.moe_reference_forward(params, jcfg, jnp.asarray(x)))
    layer = moe.MoEMlp(tcfg)
    layer.load_state_dict({k: _t(v) for k, v in params.items()})
    with torch.no_grad():
        got = layer(_t(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    balance, zloss = layer.losses
    assert np.isfinite(balance.item()) and np.isfinite(zloss.item())


# ---------------------------------------------------------------------------
# The LM
# ---------------------------------------------------------------------------

def _pair(dispatch: str):
    jcfg, tcfg = _cfgs(dispatch=dispatch)
    jmodel = jmoe.MoETransformerLM(jcfg)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, T), jnp.int32))["params"]
    tmodel = moe.MoETransformerLM(tcfg)
    tmodel.load_state_dict(moe.moe_params_from_flax(jax.tree.map(np.array, params)))
    return jmodel, params, tmodel


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, 1024, (BATCH, T)).astype(np.int32)


def test_moe_params_from_flax_covers_the_state_dict():
    _, params, tmodel = _pair("sparse")
    converted = moe.moe_params_from_flax(jax.tree.map(np.array, params))
    assert set(converted) == set(tmodel.state_dict())
    np.testing.assert_array_equal(converted["trunk.layers.1.moe.experts_in"].numpy(),
                                  np.array(params["layer_1"]["moe"]["experts_in"]))


def test_init_has_flax_fan_ins():
    """flax's lecun_normal (truncated at 2 sigma): fan-in h for the router
    and experts_in, ffn for experts_out (batch_axis 0 for the experts)."""
    cfg = dataclasses.replace(moe.TINY_MOE, hidden=256, num_experts=8)
    layer = moe.MoETransformerLM(cfg, generator=torch.Generator().manual_seed(0))
    mlp = layer.trunk.layers[0].moe
    for w, fan_in in ((mlp.router, 256), (mlp.experts_in, 256), (mlp.experts_out, 1024)):
        np.testing.assert_allclose(w.std().item(), fan_in ** -0.5, rtol=0.05)


@pytest.mark.parametrize("chunked", [False, True], ids=["full", "chunked"])
@pytest.mark.parametrize("dispatch", ["dense", "sparse"])
def test_logits_loss_and_grads_f32(dispatch, chunked):
    jmodel, params, tmodel = _pair(dispatch)
    tok = _tokens()

    def loss_fn(p):
        return jmoe.moe_lm_loss(jmodel, p, jnp.asarray(tok), chunked=chunked, chunk=8)

    logits_j = jmodel.apply({"params": params}, jnp.asarray(tok))
    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    tt = torch.from_numpy(tok).long()
    with torch.no_grad():
        logits_t = tmodel(tt)
    for m in tmodel.moe_layers():
        m.losses = None
    loss_t = moe.moe_lm_loss(tmodel, tt, chunked=chunked, chunk=8)
    loss_t.backward()
    np.testing.assert_allclose(logits_t.numpy(), np.array(logits_j), atol=1e-4)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), atol=1e-5)
    grads_j = moe.moe_params_from_flax(jax.tree.map(np.array, grads_j))
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads_j[name].numpy(), atol=1e-4,
                                   err_msg=name)
    assert all(m.losses is None for m in tmodel.moe_layers())


@pytest.mark.parametrize("dispatch", ["dense", "sparse"])
def test_three_step_trajectory(dispatch):
    """The port's train_step against the JAX make_train_step (1-device CPU
    mesh) from the same init and numpy batches, f32 AdamW: loss and grad
    norm at rtol 1e-4."""
    jmodel, params, tmodel = _pair(dispatch)

    def jloss(p, model_state, batch, rng):
        return jmoe.moe_lm_loss(jmodel, p, batch["tokens"]), model_state

    opt_kw = {"learning_rate": 1e-2}
    jtx = joptim.make_optimizer(joptim.OptimizerConfig(**opt_kw))
    mesh = jmesh.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    step, _ = jts.make_train_step(jloss, jtx, mesh)
    step = jax.jit(step)
    jstate = jts.create_train_state(params, jtx)
    ttx = optim.make_optimizer(optim.OptimizerConfig(**opt_kw))
    tstate = ts.create_train_state(tmodel, ttx)

    def tloss(model, batch):
        return moe.moe_lm_loss(model, batch["tokens"])

    out = {"jax": [], "torch": [], "jax_gn": [], "torch_gn": []}
    tok = _tokens(1)
    for _ in range(3):
        jstate, jm = step(jstate, {"tokens": jnp.asarray(tok)}, jax.random.key(0))
        tstate, tm = ts.train_step(tstate, {"tokens": torch.from_numpy(tok).long()}, tloss,
                                   ttx)
        for side, m in (("jax", jm), ("torch", tm)):
            out[side].append(float(m["loss"]))
            out[f"{side}_gn"].append(float(m["grad_norm"]))
    assert out["torch"][-1] < out["torch"][0]
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=1e-4)
    np.testing.assert_allclose(out["torch_gn"], out["jax_gn"], rtol=1e-4)


# ---------------------------------------------------------------------------
# Layout and trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axes", [{"dp": 2, "ep": 2, "tp": 2}, {"fsdp": 2, "ep": 2, "tp": 2},
                                  {"ep": 4}, {"fsdp": 4}],
                         ids=lambda a: "-".join(f"{k}{v}" for k, v in a.items()))
def test_moe_rules_match_jax_on_every_parameter(axes):
    """tree_shardings on the port's MoE LM (through param_layout: the MoE
    leaves in flax order, Dense weights transposed) gives JAX's sharding_for
    of MOE_RULES on every flax parameter, in the port's order."""
    cfg = dataclasses.replace(jmoe.TINY_MOE, num_experts=8)
    jmodule = jmoe.MoETransformerLM(cfg)
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.key(0),
                                                 jnp.zeros((1, 8), jnp.int32)))["params"]
    n = int(np.prod(list(axes.values())))
    jm = jmesh.make_mesh(axes, devices=jax.devices()[:n])
    port = rules.tree_shardings(moe.MoETransformerLM(dataclasses.replace(moe.TINY_MOE,
                                                                         num_experts=8)),
                                axes, rules.MOE_RULES)
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert sorted(_port_name(jrules.path_str(path)) for path, _ in flat) == sorted(port)
    for path, leaf in flat:
        p = jrules.path_str(path)
        jspec = tuple(jrules.sharding_for(p, tuple(leaf.shape), jm, jrules.MOE_RULES).spec)
        jspec = jspec + (None,) * (leaf.ndim - len(jspec))
        want = jspec[::-1] if p.endswith("/kernel") else jspec
        assert port[_port_name(p)] == want, (p, port[_port_name(p)], jspec)
    if "ep" in axes:
        assert port["trunk.layers.1.moe.experts_in"][0] == "ep"


def _port_name(flax_path: str) -> str:
    """The port parameter of a flax MoE LM path."""
    *mods, leaf = flax_path.split("/")
    mods = [f"layers.{m[len('layer_'):]}" if m.startswith("layer_") else m for m in mods]
    leaf = {"kernel": "weight", "embedding": "weight", "scale": "weight"}.get(leaf, leaf)
    name = ".".join(mods + [leaf])
    return name if name.startswith("lm_head.") else f"trunk.{name}"


@pytest.mark.parametrize("dispatch", ["dense", "sparse"])
def test_the_trainer_trains_moe_lm(dispatch, capsys):
    """--model moe-lm and --moe-dispatch are the JAX trainer's: parsed, no
    refusal, and the JAX branch's model (8 experts, top-2, every 2nd
    block) trains to the done event."""
    out: dict = {}
    rc = train.main(["--device", "cpu", "--model", "moe-lm", "--moe-dispatch", dispatch,
                     "--batch", "2", "--seq", "16", "--layers", "2", "--hidden", "32",
                     "--heads", "2", "--steps", "3", "--log-every", "1"], out)
    assert rc == 0
    model = out["state"].model
    assert isinstance(model, moe.MoETransformerLM) and model.cfg.dispatch == dispatch
    assert model.cfg.num_experts == 8 and model.cfg.top_k == 2 and model.cfg.moe_every == 2
    assert [type(b).__name__ for b in model.trunk.layers] == ["MoEBlock", "MoEBlock"]
    assert not hasattr(model.trunk.layers[0], "moe") and hasattr(model.trunk.layers[1], "moe")
    assert '"event": "done"' in capsys.readouterr().out
