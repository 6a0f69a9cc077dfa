"""ResNet family (v1.5 bottleneck): counterpart of tf_operator_tpu/models/resnet.py.

bf16 compute, f32 parameters and f32 batch-norm statistics, as the flax
modules. The public input is NHWC ``[B, S, S, 3]`` as in the JAX package;
inside, activations are NCHW views in channels-last memory, which is what
``F.conv2d`` takes. Convolutions, pools and the head are stock PyTorch.

``TpuBatchNorm`` is not ``nn.BatchNorm2d``: its statistics are f32 moments
of the upcast input with v = max(E[x^2] - m^2, 0) (the biased variance),
the running averages move as ``0.9 * old + 0.1 * batch`` in train mode
only, and the apply is subtract-then-scale in the activation dtype with the
mean's rounding residual folded into the bias. Running statistics are f32
buffers ``mean`` and ``var``; casting the model's parameters to bf16 (master
weights) leaves them f32.

SAME padding is XLA's (``mnist.same_pads``): a 3x3 stride-2 window over an
even size pads (0, 1), not PyTorch's (1, 1), and the stem's SAME max-pool
pads with -inf the same way.

``ResNet18`` here is built from bottleneck blocks, ``[2, 2, 2, 2]``, as in
the JAX package; it is not torchvision's basic-block ResNet-18. Module names
follow the flax tree (``stem``, ``stem_bn``, ``BottleneckBlock_<i>`` ->
``blocks.<i>`` with ``Conv_k`` -> ``conv_k``, ``TpuBatchNorm_k`` -> ``bn_k``,
``proj``, ``proj_bn``, ``head``); ``params_from_flax`` maps a flax
(params, batch_stats) pair onto the state dict. Under data parallelism each
batch norm all-reduces its moments (``TpuBatchNorm.sync``), so its
statistics are the global batch's, as under JAX's SPMD mean.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tf_operator_tpu_torch.models.mnist import (
    Conv,
    init_flax_like,
    max_pool_same,
    state_dict_from_flax,
)
from tf_operator_tpu_torch.models.transformer import Dense
from tf_operator_tpu_torch.parallel import collectives


class TpuBatchNorm(nn.Module):
    """Batch norm over NCHW with f32 statistics and an apply in x's dtype
    (resnet.py's TpuBatchNorm). `weight`/`bias` are flax's scale/bias;
    buffers `mean`/`var` are the running averages."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5,
                 scale_init: float = 1.0, device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.full((channels,), scale_init, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))
        # (group, count): average the moments over the data-parallel group
        # (set by parallel.train_step.parallelize).
        self.sync: tuple | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            # Convert before squaring: E[x^2] - E[x]^2 cancels if the squares
            # carry bf16 rounding.
            xf = x.float()
            red = (0, 2, 3)
            m = xf.mean(red)
            m2 = xf.square().mean(red)
            if self.sync is not None:
                # The moments of the global batch, as the JAX mean over a
                # batch sharded across devices computes them.
                group, count = self.sync
                m, m2 = collectives.sum_across(torch.stack([m, m2]), group) / count
            v = torch.clamp_min(m2 - m.square(), 0.0)
            with torch.no_grad():
                mom = self.momentum
                self.mean.copy_(mom * self.mean + (1.0 - mom) * m)
                self.var.copy_(mom * self.var + (1.0 - mom) * v)
        else:
            m, v = self.mean, self.var
        inv = self.weight.float() * torch.rsqrt(v + self.eps)
        # Subtract-then-scale: with |mean| >> std a y = x*a + b fold cancels
        # in bf16; the residual of rounding the mean goes into the bias.
        mh = m.to(x.dtype)
        a = inv.to(x.dtype)
        b = (self.bias.float() + (mh.float() - m) * inv).to(x.dtype)
        shape = (1, -1, 1, 1)
        return (x - mh.view(shape)) * a.view(shape) + b.view(shape)


class BottleneckBlock(nn.Module):
    """1x1 -> BN -> relu -> 3x3 (stride here, v1.5) -> BN -> relu -> 1x1
    (x4) -> BN (scale 0 at init) -> + residual (projected when the shape
    changes) -> relu."""

    def __init__(self, in_ch: int, filters: int, stride: int, dtype: torch.dtype,
                 norm, device=None):
        super().__init__()
        conv = functools.partial(Conv, dtype=dtype, bias=False, device=device)
        self.conv_0 = conv(in_ch, filters, 1)
        self.bn_0 = norm(filters, device=device)
        self.conv_1 = conv(filters, filters, 3, stride=stride)
        self.bn_1 = norm(filters, device=device)
        self.conv_2 = conv(filters, filters * 4, 1)
        self.bn_2 = norm(filters * 4, scale_init=0.0, device=device)
        self.proj = self.proj_bn = None
        if stride != 1 or in_ch != filters * 4:
            self.proj = conv(in_ch, filters * 4, 1, stride=stride)
            self.proj_bn = norm(filters * 4, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        y = F.relu(self.bn_0(self.conv_0(x)))
        y = F.relu(self.bn_1(self.conv_1(y)))
        y = self.bn_2(self.conv_2(y))
        if self.proj is not None:
            residual = self.proj_bn(self.proj(residual))
        return F.relu(residual + y)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 width: int = 64, dtype: torch.dtype = torch.bfloat16,
                 bn_momentum: float = 0.9, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        norm = functools.partial(TpuBatchNorm, momentum=bn_momentum)
        self.stem = Conv(3, width, 7, dtype, stride=2, padding=((3, 3), (3, 3)),
                         bias=False, device=device)
        self.stem_bn = norm(width, device=device)
        blocks, in_ch = [], width
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                filters = width * 2 ** i
                blocks.append(BottleneckBlock(
                    in_ch, filters, 2 if i > 0 and j == 0 else 1, dtype, norm,
                    device=device))
                in_ch = filters * 4
        self.blocks = nn.ModuleList(blocks)
        self.head = Dense(in_ch, num_classes, dtype, device=device)
        init_flax_like(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> f32 logits. Batch statistics (and running-average
        updates) in train mode, running averages in eval mode."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW, channels-last
        x = F.relu(self.stem_bn(self.stem(x)))
        x = max_pool_same(x, 3, 2)
        for block in self.blocks:
            x = block(x)
        return self.head(x.mean((2, 3))).float()


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2])  # bottleneck blocks
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3])
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3])
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3])


def _torch_name(flax_name: str) -> str:
    if flax_name.startswith("BottleneckBlock_"):
        return "blocks." + flax_name[len("BottleneckBlock_"):]
    if flax_name.startswith("Conv_"):
        return "conv_" + flax_name[len("Conv_"):]
    if flax_name.startswith("TpuBatchNorm_"):
        return "bn_" + flax_name[len("TpuBatchNorm_"):]
    return flax_name


def params_from_flax(params, batch_stats=None) -> dict[str, torch.Tensor]:
    """state_dict of ResNet from flax `params` and `batch_stats` trees of
    numpy arrays, by the names in the module docstring; batch_stats
    `mean`/`var` become the buffers."""
    return state_dict_from_flax([params, batch_stats or {}], _torch_name)
