"""The PyTorch port's BERT (BertMLM, TransformerClassifier, mlm_loss,
make_mlm_batch, dropout) against the flax models, on CPU.

Weights are made by the flax init of TINY (2 layers, hidden 128, 4 heads
of 32, vocab 1024) and carried across with params_from_flax; tokens, MLM
targets and masks are numpy. In f32 the logits, mlm_loss and every
parameter gradient agree at atol 1e-4 (summation order only), with the
reference attention on both sides and with the flash kernels (the JAX
package's Pallas kernels in interpret mode, the port's plain versions),
causal=False. In bf16 compute both sides round at slightly different
places, so logits are held at atol 0.1 and the loss at rtol 1e-2, as the
LM's test holds them. A five-step f32 training trajectory of the port's
train_step follows the JAX make_train_step at rtol 1e-4 (loss and grad
norm), and the trainer runs `--model bert-tiny` as a pod would.
"""

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu import optim as joptim
from tf_operator_tpu.models import transformer as jtfm
from tf_operator_tpu.ops.attention import flash_attention as jflash
from tf_operator_tpu.parallel import mesh as mesh_lib
from tf_operator_tpu.parallel import train_step as jts
from tf_operator_tpu_torch import optim
from tf_operator_tpu_torch.models import transformer as tfm
from tf_operator_tpu_torch.parallel import train_step as ts
from tf_operator_tpu_torch.parallel.ring_attention import make_attention_fn


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module (tests/test_torch_flash_attention.py
    says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
T, BATCH = 64, 2


def _mlm_batch(seed: int):
    """tokens, targets, mask as numpy: 15% of positions [MASK]ed (103)."""
    rng = np.random.default_rng(seed)
    targets = rng.integers(0, 1024, (BATCH, T)).astype(np.int32)
    mask = (rng.random((BATCH, T)) < 0.15).astype(np.float32)
    tokens = np.where(mask > 0, 103, targets).astype(np.int32)
    return tokens, targets, mask


def _torch_batch(tokens, targets, mask):
    return {"tokens": torch.from_numpy(tokens).long(), "targets": torch.from_numpy(targets),
            "mask": torch.from_numpy(mask)}


def _pair(dtype_name: str, flash: bool = False, cls=False):
    """(flax model, flax params, port model with the same weights): BertMLM,
    or the classifier with cls=True."""
    jcfg = dataclasses.replace(jtfm.TINY, dtype=getattr(jnp, dtype_name))
    tcfg = dataclasses.replace(tfm.TINY, dtype=getattr(torch, dtype_name))
    jattn = (functools.partial(jflash, causal=False, force_pallas=True, interpret=True)
             if flash else None)
    if cls:
        jmodel = jtfm.TransformerClassifier(jcfg, num_classes=3, attn_fn=jattn)
    else:
        jmodel = jtfm.BertMLM(jcfg, attn_fn=jattn)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, T), jnp.int32))["params"]
    tattn = make_attention_fn(causal=False) if flash else None
    tmodel = (tfm.TransformerClassifier(tcfg, num_classes=3, attn_fn=tattn) if cls
              else tfm.BertMLM(tcfg, attn_fn=tattn))
    tmodel.load_state_dict(tfm.params_from_flax(jax.tree.map(np.array, params)))
    return jmodel, params, tmodel


@pytest.mark.parametrize("cls", [False, True], ids=["BertMLM", "TransformerClassifier"])
def test_params_from_flax_covers_the_state_dict(cls):
    _, params, tmodel = _pair("float32", cls=cls)
    converted = tfm.params_from_flax(jax.tree.map(np.array, params))
    assert set(converted) == set(tmodel.state_dict())
    assert "lm_head.bias" not in converted
    head = ("pooler", "cls") if cls else ("mlm_transform", "lm_head")
    for name in head + ("trunk/layer_1/attn/value",):
        node = params
        for key in name.split("/"):
            node = node[key]
        key = ".".join(["layers.1" if k == "layer_1" else k for k in name.split("/")])
        np.testing.assert_array_equal(converted[f"{key}.weight"].numpy(),
                                      np.array(node["kernel"]).T)
    if not cls:
        np.testing.assert_array_equal(converted["mlm_ln.weight"].numpy(),
                                      np.array(params["mlm_ln"]["scale"]))


@pytest.mark.parametrize("flash", [False, True], ids=["reference", "flash"])
def test_logits_loss_and_grads_f32(flash):
    jmodel, params, tmodel = _pair("float32", flash)
    tokens, targets, mask = _mlm_batch(0)

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(tokens))
        return jtfm.mlm_loss(logits, jnp.asarray(targets), jnp.asarray(mask)), logits

    (loss_j, logits_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(params)
    b = _torch_batch(tokens, targets, mask)
    logits_t = tmodel(b["tokens"])
    loss_t = tfm.mlm_loss(logits_t, b["targets"], b["mask"])
    loss_t.backward()
    assert logits_t.dtype == torch.float32 and logits_t.shape == (BATCH, T, 1024)
    np.testing.assert_allclose(logits_t.detach().numpy(), np.array(logits_j), atol=1e-4)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), atol=1e-4)
    grads_j = tfm.params_from_flax(jax.tree.map(np.array, grads_j))
    assert set(grads_j) == {n for n, _ in tmodel.named_parameters()}
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads_j[name].numpy(), atol=1e-4,
                                   err_msg=name)


def test_logits_and_loss_bf16():
    jmodel, params, tmodel = _pair("bfloat16")
    tokens, targets, mask = _mlm_batch(1)
    logits_j = jmodel.apply({"params": params}, jnp.asarray(tokens))
    b = _torch_batch(tokens, targets, mask)
    with torch.no_grad():
        logits_t = tmodel(b["tokens"])
    assert logits_t.dtype == torch.float32
    np.testing.assert_allclose(logits_t.numpy(), np.array(logits_j), atol=0.1)
    np.testing.assert_allclose(
        float(tfm.mlm_loss(logits_t, b["targets"], b["mask"])),
        float(jtfm.mlm_loss(logits_j, jnp.asarray(targets), jnp.asarray(mask))), rtol=1e-2)


def test_classifier_logits_f32():
    jmodel, params, tmodel = _pair("float32", cls=True)
    tokens, _, _ = _mlm_batch(2)
    logits_j = jmodel.apply({"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        logits_t = tmodel(torch.from_numpy(tokens).long())
    assert logits_t.shape == (BATCH, 3) and logits_t.dtype == torch.float32
    np.testing.assert_allclose(logits_t.numpy(), np.array(logits_j), atol=1e-4)


def test_mlm_loss_counts_only_masked_positions():
    """Changing the logits at unmasked positions moves nothing, and the
    loss is the mean over masked positions of the JAX loss's nll."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 8, 16)).astype(np.float32)
    targets = rng.integers(0, 16, (2, 8)).astype(np.int32)
    mask = np.zeros((2, 8), np.float32)
    mask[0, 1] = mask[1, 5] = 1.0
    got = float(tfm.mlm_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                             torch.from_numpy(mask)))
    moved = logits.copy()
    moved[mask == 0] += rng.standard_normal(moved[mask == 0].shape).astype(np.float32) * 5
    assert float(tfm.mlm_loss(torch.from_numpy(moved), torch.from_numpy(targets),
                              torch.from_numpy(mask))) == pytest.approx(got, abs=1e-6)
    want = float(jtfm.mlm_loss(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask)))
    assert got == pytest.approx(want, abs=1e-6)
    # No masked position: the denominator is floored at 1, the loss is 0.
    zero = torch.zeros((2, 8))
    assert float(tfm.mlm_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                              zero)) == 0.0


def test_make_mlm_batch_rate_and_mask_token():
    g = torch.Generator().manual_seed(0)
    b = tfm.make_mlm_batch(g, 64, 128, 1024)
    masked = b["mask"].bool()
    rate = float(b["mask"].mean())
    n = b["mask"].numel()
    assert abs(rate - 0.15) <= 3 * math.sqrt(0.15 * 0.85 / n)
    assert torch.all(b["tokens"][masked] == 103)
    assert torch.equal(b["tokens"][~masked], b["targets"][~masked])
    assert int(b["targets"].min()) >= 0 and int(b["targets"].max()) < 1024
    again = tfm.make_mlm_batch(torch.Generator().manual_seed(0), 64, 128, 1024)
    assert all(torch.equal(b[k], again[k]) for k in b)


def test_dropout_deterministic_is_no_dropout_and_flax():
    """A deterministic forward of a config with dropout equals the forward
    of the same weights without dropout, and the flax model's."""
    jcfg = dataclasses.replace(jtfm.TINY, dtype=jnp.float32, dropout_rate=0.1)
    jmodel = jtfm.BertMLM(jcfg)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, T), jnp.int32))["params"]
    tokens, _, _ = _mlm_batch(4)
    state = tfm.params_from_flax(jax.tree.map(np.array, params))
    with_dropout = tfm.BertMLM(dataclasses.replace(tfm.TINY, dtype=torch.float32,
                                                   dropout_rate=0.1))
    without = tfm.BertMLM(dataclasses.replace(tfm.TINY, dtype=torch.float32))
    with_dropout.load_state_dict(state)
    without.load_state_dict(state)
    tt = torch.from_numpy(tokens).long()
    with torch.no_grad():
        got = with_dropout(tt)
        torch.testing.assert_close(got, without(tt), rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), np.array(jmodel.apply({"params": params}, tokens)),
                               atol=1e-4)
    # In training mode the masks come from the generator, and only then.
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        train = with_dropout(tt, deterministic=False, generator=g)
        again = with_dropout(tt, deterministic=False,
                             generator=torch.Generator().manual_seed(1))
    assert not torch.equal(train, got)
    torch.testing.assert_close(train, again, rtol=0, atol=0)
    with pytest.raises(ValueError, match="generator"):
        with_dropout(tt, deterministic=False)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keeps_one_minus_rate_scaled(rate):
    x = torch.full((200_000,), 2.0)
    out = tfm.Dropout(rate)(x, deterministic=False, generator=torch.Generator().manual_seed(0))
    kept = out != 0
    share = float(kept.float().mean())
    assert abs(share - (1 - rate)) <= 3 * math.sqrt(rate * (1 - rate) / x.numel())
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 2.0 / (1 - rate)))
    assert torch.equal(tfm.Dropout(rate)(x), x)


def test_dropout_replays_its_masks_under_remat():
    """Per-block remat replays a block's forward in the backward: its
    dropout masks must be the forward's, so the gradients equal those
    without remat."""
    cfg = dataclasses.replace(tfm.TINY, dtype=torch.float32, dropout_rate=0.2)
    grads = []
    for remat in (False, True):
        model = tfm.BertMLM(dataclasses.replace(cfg, remat_layers=remat),
                            generator=torch.Generator().manual_seed(0))
        tokens, targets, mask = _mlm_batch(5)
        b = _torch_batch(tokens, targets, mask)
        logits = model(b["tokens"], deterministic=False,
                       generator=torch.Generator().manual_seed(3))
        tfm.mlm_loss(logits, b["targets"], b["mask"]).backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


STEPS = 5


def test_five_step_trajectory_f32():
    """The port's train_step against the JAX make_train_step on BertMLM
    (TINY, f32, AdamW), the same numpy MLM batches and initial weights:
    loss and grad norm at rtol 1e-4."""
    jcfg = dataclasses.replace(jtfm.TINY, dtype=jnp.float32)
    jmodel = jtfm.BertMLM(jcfg)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, T), jnp.int32))["params"]

    def jloss(p, model_state, batch, rng):
        logits = jmodel.apply({"params": p}, batch["tokens"])
        return jtfm.mlm_loss(logits, batch["targets"], batch["mask"]), model_state

    opt_kw = {"learning_rate": 1e-2}
    jtx = joptim.make_optimizer(joptim.OptimizerConfig(**opt_kw))
    mesh = mesh_lib.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    step, _ = jts.make_train_step(jloss, jtx, mesh)
    step = jax.jit(step)
    jstate = jts.create_train_state(params, jtx)

    tmodel = tfm.BertMLM(dataclasses.replace(tfm.TINY, dtype=torch.float32))
    tmodel.load_state_dict(tfm.params_from_flax(jax.tree.map(np.array, params)))
    ttx = optim.make_optimizer(optim.OptimizerConfig(**opt_kw))
    tstate = ts.create_train_state(tmodel, ttx)

    def tloss(model, batch):
        return tfm.mlm_loss(model(batch["tokens"]), batch["targets"], batch["mask"])

    out = {"jax": [], "torch": [], "jax_gn": [], "torch_gn": []}
    # One batch, five times: the loss falls only where the model learns it
    # (fresh uniform targets would leave it at about log(vocab)).
    tokens, targets, mask = _mlm_batch(10)
    for _ in range(STEPS):
        jstate, jm = step(jstate, {"tokens": jnp.asarray(tokens),
                                   "targets": jnp.asarray(targets),
                                   "mask": jnp.asarray(mask)}, jax.random.key(0))
        tstate, tm = ts.train_step(tstate, _torch_batch(tokens, targets, mask), tloss, ttx)
        out["jax"].append(float(jm["loss"]))
        out["torch"].append(float(tm["loss"]))
        out["jax_gn"].append(float(jm["grad_norm"]))
        out["torch_gn"].append(float(tm["grad_norm"]))
    assert out["torch"][-1] < out["torch"][0]
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=1e-4)
    np.testing.assert_allclose(out["torch_gn"], out["jax_gn"], rtol=1e-4)


def test_trainer_runs_bert_tiny_on_cpu(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               TPUJOB_METRICS_FILE=str(tmp_path / "events.jsonl"),
               TPUJOB_HEARTBEAT_FILE=str(tmp_path / "hb.json"))
    proc = subprocess.run(
        [sys.executable, "-m", "tf_operator_tpu_torch.models.train", "--model", "bert-tiny",
         "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "32",
         "--log-every", "1", "--layers", "7", "--hidden", "96", "--heads", "3"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    events = [json.loads(x) for x in (tmp_path / "events.jsonl").read_text().splitlines()]
    names = [e["event"] for e in events]
    assert names[:4] == ["start", "jax_ready", "model_ready", "first_step"]
    by = {e["event"]: e for e in events}
    assert by["start"]["model"] == "bert-tiny"
    assert [e["step"] for e in events if e["event"] == "progress"] == [2, 3]
    done = by["done"]
    assert done["steps"] == 3 and math.isfinite(done["final_loss"])
    # BERT's own widths (--layers/--hidden/--heads do not apply): the
    # first loss is about log(vocab) = log(1024) for a fresh model.
    assert abs(by["first_step"]["loss"] - math.log(1024)) < 1.0
    assert json.loads((tmp_path / "hb.json").read_text())["step"] == 3


def test_trainer_builds_bert_as_the_jax_trainer():
    """The JAX trainer's branch: the config's own widths whatever --layers,
    --hidden and --heads say, full attention, max_len max(seq, 8)."""
    from tf_operator_tpu_torch.models import train

    args = train.build_parser().parse_args(
        ["--model", "bert-tiny", "--seq", "4", "--batch", "2", "--layers", "1",
         "--hidden", "64", "--heads", "2", "--device", "cpu"])
    model, loss_fn, make_batch = train._build_model(args, torch.device("cpu"))
    assert isinstance(model, tfm.BertMLM)
    cfg = model.cfg
    assert (cfg.num_layers, cfg.hidden, cfg.num_heads, cfg.vocab_size) == (
        tfm.TINY.num_layers, tfm.TINY.hidden, tfm.TINY.num_heads, tfm.TINY.vocab_size)
    assert cfg.max_len == 8 and not cfg.causal and cfg.dropout_rate == 0.0
    batch = make_batch(torch.Generator().manual_seed(0))
    assert batch["tokens"].shape == (2, 4) and set(batch) == {"tokens", "targets", "mask"}
    with torch.no_grad():
        assert math.isfinite(float(loss_fn(model, batch)))
    base = tfm.BERT_BASE
    assert (base.num_layers, base.hidden, base.num_heads, base.vocab_size, base.max_len) == (
        12, 768, 12, 30522, 512)
