"""The PyTorch port's MNIST and ResNet models against the flax ones, on CPU.

Inputs are numpy arrays from fixed seeds handed to both sides; parameters
are flax's, carried across by params_from_flax. Tolerances:

- MNIST logits, f32: 1e-5 (the same f32 sums in another order);
- TpuBatchNorm, f32: outputs and running statistics at 2e-4, as
  tests/test_parallel.py holds TpuBatchNorm against flax's BatchNorm;
  bf16 with a channel whose |mean| >> std: the recovered batch variance
  against the float64 one of the same input (the port at 2e-2, the JAX
  one at test_parallel.py's rtol 0.15; the test says why) and the output
  at rtol 0.15 / atol 0.3, as there;
- ResNet, f32: logits, loss, every parameter gradient and the new
  batch_stats at 2e-4; bf16 logits at 0.1 (bf16 rounding at different
  places in XLA and PyTorch).

The ResNet cases run at image sizes 32 and 36: the stride-2 3x3 of the
second stage sees an even (8) and an odd (9) input, so XLA's SAME padding
is (0, 1) in one and (1, 1) in the other; the stem's SAME max-pool pads
(0, 1) at both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import mnist as jmnist
from tf_operator_tpu.models import resnet as jresnet
from tf_operator_tpu_torch.models import mnist
from tf_operator_tpu_torch.models import resnet

torch.set_num_threads(2)

BATCH, CLASSES = 2, 10


def _np(tree):
    return jax.tree.map(np.array, tree)


def _perturb_scales(params, seed=0):
    """BN scales moved off their init (the last BN of a block starts at 0,
    which would zero the block's gradients), from a numpy generator."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        if "scale" in jax.tree_util.keystr(path):
            return a + jnp.asarray(0.3 * rng.standard_normal(a.shape), a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(move, params)


@pytest.mark.parametrize("name", ["MLP", "ConvNet"])
def test_mnist_logits_match_flax(name):
    x = np.random.default_rng(1).standard_normal((3, 28, 28)).astype(np.float32)
    jmodel = getattr(jmnist, name)(dtype=jnp.float32)
    params = jmodel.init(jax.random.key(0), jnp.asarray(x))["params"]
    tmodel = getattr(mnist, name)(dtype=torch.float32)
    tmodel.load_state_dict(mnist.params_from_flax(_np(params)))
    want = np.array(jmodel.apply({"params": params}, jnp.asarray(x)))
    got = tmodel(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_mnist_loss_and_accuracy_match_flax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((8, CLASSES)).astype(np.float32)
    labels = rng.integers(0, CLASSES, 8)
    np.testing.assert_allclose(
        float(mnist.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels))),
        float(jmnist.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)
    assert float(mnist.accuracy(torch.from_numpy(logits), torch.from_numpy(labels))) == \
        float(jmnist.accuracy(jnp.asarray(logits), jnp.asarray(labels)))


def _bn_pair(x_nhwc: np.ndarray, dtype_j, dtype_t):
    """(JAX TpuBatchNorm outputs, port outputs) in train mode and then in
    eval mode from the updated statistics, on the same input."""
    xj = jnp.asarray(x_nhwc).astype(dtype_j)
    jbn = jresnet.TpuBatchNorm(use_running_average=False, momentum=0.9)
    variables = jbn.init(jax.random.key(1), xj)
    yj, mut = jbn.apply(variables, xj, mutable=["batch_stats"])
    ej = jresnet.TpuBatchNorm(use_running_average=True).apply(
        {"params": variables["params"], "batch_stats": mut["batch_stats"]}, xj)
    tbn = resnet.TpuBatchNorm(x_nhwc.shape[-1])
    xt = torch.from_numpy(x_nhwc).to(dtype_t).permute(0, 3, 1, 2)
    yt = tbn.train()(xt)
    et = tbn.eval()(xt)
    return ((np.array(yj.astype(jnp.float32)), _np(mut["batch_stats"]),
             np.array(ej.astype(jnp.float32))),
            (yt.detach().float().permute(0, 2, 3, 1).numpy(),
             {"mean": tbn.mean.numpy(), "var": tbn.var.numpy()},
             et.detach().float().permute(0, 2, 3, 1).numpy()))


def test_tpu_batchnorm_f32_matches_jax():
    x = np.random.default_rng(0).standard_normal((4, 8, 8, 16)).astype(np.float32)
    (yj, sj, ej), (yt, st, et) = _bn_pair(x, jnp.float32, torch.float32)
    np.testing.assert_allclose(yt, yj, rtol=2e-4, atol=2e-4)
    for k in ("mean", "var"):
        np.testing.assert_allclose(st[k], sj[k], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(et, ej, rtol=2e-4, atol=2e-4)


def test_tpu_batchnorm_bf16_offset_channel():
    """|mean| ~ 10 >> std ~ 0.1: the variance survives (statistics of the
    upcast input), as the JAX one's does. Here E[x^2] - m^2 cancels 100.01
    against 100, so each side's batch variance carries its f32 sum's
    error: XLA:CPU's mean of squares is ~1.3e-3 low on this input (its
    variance 12-14% low), PyTorch's within 1e-5. So each side is held
    against the float64 variance of the same bf16 input: the port at 2e-2,
    the JAX one at test_parallel.py's rtol 0.15."""
    rng = np.random.default_rng(0)
    x = (10.0 + 0.1 * rng.standard_normal((8, 16, 16, 4))).astype(np.float32)
    (yj, sj, _), (yt, st, _) = _bn_pair(x, jnp.bfloat16, torch.bfloat16)
    vt = (st["var"] - 0.9) / 0.1
    vj = (sj["var"] - 0.9) / 0.1
    x_bf16 = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    truth = x_bf16.var(axis=(0, 1, 2))
    np.testing.assert_allclose(vt, truth, rtol=2e-2)
    np.testing.assert_allclose(vj, truth, rtol=0.15)
    np.testing.assert_allclose(vt, 0.01, rtol=0.5)
    assert np.all(np.abs(yt) < 8.0)
    np.testing.assert_allclose(yt, yj, rtol=0.15, atol=0.3)
    assert st["mean"].dtype == st["var"].dtype == np.float32


def _tiny_pair(image_size: int, dtype_name: str):
    """A [1, 1]-stage, width-8 ResNet on both sides with perturbed BN
    scales, and a numpy batch."""
    jmodel = jresnet.ResNet(stage_sizes=[1, 1], width=8, num_classes=CLASSES,
                            dtype=getattr(jnp, dtype_name))
    params, stats = jresnet.init_resnet(jmodel, jax.random.key(0), image_size=image_size)
    params = _perturb_scales(params)
    tmodel = resnet.ResNet([1, 1], num_classes=CLASSES, width=8,
                           dtype=getattr(torch, dtype_name))
    tmodel.load_state_dict(resnet.params_from_flax(_np(params), _np(stats)))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((BATCH, image_size, image_size, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, BATCH)
    return jmodel, params, stats, tmodel, x, y


@pytest.mark.parametrize("image_size", [32, 36])
def test_resnet_f32_forward_grads_and_stats_match_flax(image_size):
    jmodel, params, stats, tmodel, x, y = _tiny_pair(image_size, "float32")

    def jloss(p):
        logits, mut = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                                   train=True, mutable=["batch_stats"])
        return jmnist.cross_entropy_loss(logits, jnp.asarray(y)), (logits, mut)

    (lj, (logits_j, mut)), gj = jax.value_and_grad(jloss, has_aux=True)(params)
    tmodel.train()
    logits_t = tmodel(torch.from_numpy(x))
    lt = mnist.cross_entropy_loss(logits_t, torch.from_numpy(y))
    lt.backward()
    np.testing.assert_allclose(logits_t.detach().numpy(), np.array(logits_j),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=2e-4)
    want_grads = resnet.params_from_flax(_np(gj))
    got_grads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(got_grads) == set(want_grads)
    for name, g in got_grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=name)
    want_stats = resnet.params_from_flax({}, _np(mut["batch_stats"]))
    got = dict(tmodel.named_buffers())
    assert set(got) == set(want_stats)
    for name, buf in got.items():
        np.testing.assert_allclose(buf.numpy(), want_stats[name].numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


@pytest.mark.parametrize("image_size", [32, 36])
def test_resnet_bf16_logits_match_flax(image_size):
    jmodel, params, stats, tmodel, x, _ = _tiny_pair(image_size, "bfloat16")
    logits_j = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                            train=False)
    logits_t = tmodel.eval()(torch.from_numpy(x))
    assert logits_t.dtype == torch.float32
    np.testing.assert_allclose(logits_t.detach().numpy(), np.array(logits_j), atol=0.1)


def test_params_from_flax_covers_the_state_dict():
    jmodel = jresnet.ResNet(stage_sizes=[2, 1], width=8, num_classes=CLASSES)
    params, stats = jresnet.init_resnet(jmodel, jax.random.key(0), image_size=32)
    sd = resnet.params_from_flax(_np(params), _np(stats))
    want = resnet.ResNet([2, 1], num_classes=CLASSES, width=8).state_dict()
    assert set(sd) == set(want)
    for name, t in want.items():
        assert tuple(sd[name].shape) == tuple(t.shape), name
        assert sd[name].dtype == torch.float32


def test_resnet50_param_count():
    with torch.device("meta"):
        model = resnet.ResNet50(num_classes=1000)
    n = sum(p.numel() for p in model.parameters())
    assert 25.4e6 < n < 25.8e6, n  # canonical ResNet-50 ~25.56M params


def test_resnet18_is_built_from_bottleneck_blocks():
    with torch.device("meta"):
        model = resnet.ResNet18(num_classes=1000)
    assert len(model.blocks) == 8
    assert all(isinstance(b, resnet.BottleneckBlock) for b in model.blocks)


def test_init_is_flax_like_in_distribution():
    """Per tensor: the same shape, and the std of conv and dense kernels
    within 10% of flax's; BN scales 1 (0 for each block's last), biases
    0, running mean 0 and var 1."""
    jmodel = jresnet.ResNet(stage_sizes=[1, 1], width=32, num_classes=CLASSES)
    params, stats = jresnet.init_resnet(jmodel, jax.random.key(0), image_size=32)
    flax_sd = resnet.params_from_flax(_np(params), _np(stats))
    tmodel = resnet.ResNet([1, 1], num_classes=CLASSES, width=32,
                           generator=torch.Generator().manual_seed(0))
    sd = tmodel.state_dict()
    assert set(sd) == set(flax_sd)
    for name, t in sd.items():
        ref = flax_sd[name]
        assert t.shape == ref.shape, name
        if name.endswith("weight") and t.dim() > 1:
            assert abs(float(t.std()) / float(ref.std()) - 1) < 0.1, name
            assert float(t.abs().max()) <= 2 * float(t.std()) * 1.2, name  # truncated at 2 sigma
        else:
            torch.testing.assert_close(t, ref, rtol=0, atol=0, msg=name)
    assert all(not b.bn_2.weight.detach().any() for b in tmodel.blocks)
