"""MNIST models and the classification loss: counterpart of
tf_operator_tpu/models/mnist.py.

``MLP`` is the dist-mnist example's 784-500-10 shape; ``ConvNet`` the
mnist_with_summaries-style CNN (5x5 SAME convolutions, 2x2 VALID pools,
dense 1024). Parameters are f32 and every layer computes in ``dtype``
(bf16 by default); logits come back in f32, as the flax modules return
them. Inputs are ``[B, 28, 28]`` (or ``[B, 28, 28, 1]``), as in the JAX
package.

Module names follow flax's auto-names (``Dense_0``, ``Conv_0`` ...) in
lower case, so ``params_from_flax`` carries a flax param tree across:
Dense kernels ``[in, out]`` become ``weight [out, in]``, conv kernels
HWIO become OIHW. Dense layers are ``transformer.Dense``.

``cross_entropy_loss`` and ``accuracy`` are the losses the ResNet trainer
uses too.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tf_operator_tpu_torch.models.transformer import Dense, lecun_normal_


class Conv(nn.Module):
    """flax nn.Conv over NCHW activations, computed in `dtype`. The weight
    is OIHW. `padding` is ((top, bottom), (left, right)), or "SAME" to pad
    as XLA does: out = ceil(in / stride), the odd pixel at the end."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, dtype: torch.dtype,
                 stride: int = 1, padding="SAME", bias: bool = True, device=None):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        if self.padding == "SAME":
            (pt, pb), (pl, pr) = (same_pads(n, k, self.stride) for n in x.shape[-2:])
        else:
            (pt, pb), (pl, pr) = self.padding
        x = x.to(self.dtype)
        if (pt, pl) == (pb, pr):
            pad = (pt, pl)
        else:
            x, pad = F.pad(x, (pl, pr, pt, pb)), 0
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), b, self.stride, pad)


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial dimension: (low, high) with the
    extra pixel, when the total is odd, at the high end. A 3x3 stride-2
    window over an even size pads (0, 1), not (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """flax nn.max_pool with padding="SAME" over NCHW: pads with -inf as
    XLA does (same_pads), then a VALID pool."""
    (pt, pb), (pl, pr) = (same_pads(n, window, stride) for n in x.shape[-2:])
    x = F.pad(x, (pl, pr, pt, pb), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


class MLP(nn.Module):
    """The dist-mnist example's 784-500-10 shape."""

    def __init__(self, hidden: int = 500, classes: int = 10,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.dense_0 = Dense(28 * 28, hidden, dtype, device=device)
        self.dense_1 = Dense(hidden, classes, dtype, device=device)
        init_flax_like(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        x = F.relu(self.dense_0(x))
        return self.dense_1(x).float()


class ConvNet(nn.Module):
    """The mnist_with_summaries-style small CNN."""

    def __init__(self, classes: int = 10, dtype: torch.dtype = torch.bfloat16,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.conv_0 = Conv(1, 32, 5, dtype, device=device)
        self.conv_1 = Conv(32, 64, 5, dtype, device=device)
        self.dense_0 = Dense(7 * 7 * 64, 1024, dtype, device=device)
        self.dense_1 = Dense(1024, classes, dtype, device=device)
        init_flax_like(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if x.dim() == 3:
            x = x[..., None]
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW (a channels-last view)
        x = F.max_pool2d(F.relu(self.conv_0(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.conv_1(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten as NHWC
        x = F.relu(self.dense_0(x))
        return self.dense_1(x).float()


@torch.no_grad()
def init_flax_like(model: nn.Module, generator: torch.Generator | None = None) -> None:
    """flax's default initialisers, in distribution: Dense and Conv kernels
    lecun-normal, biases 0."""
    for mod in model.modules():
        if isinstance(mod, (Dense, Conv)):
            lecun_normal_(mod.weight, generator)
            if mod.bias is not None:
                mod.bias.zero_()


def state_dict_from_flax(trees, rename: Callable[[str], str]) -> dict[str, torch.Tensor]:
    """A state_dict from flax variable trees of numpy arrays (params, and
    batch_stats where there are any): each module name through `rename`;
    a Dense `kernel` [in, out] -> `weight` [out, in], a Conv `kernel` HWIO
    -> `weight` OIHW, a norm's `scale` -> `weight`; other leaves keep
    their names."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        if hasattr(node, "items"):
            for key, child in node.items():
                walk(child, path + [key])
            return
        *mods, leaf = path
        arr = np.array(node)
        if leaf == "kernel":
            arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        out[".".join([rename(m) for m in mods] + [leaf])] = torch.from_numpy(
            np.ascontiguousarray(arr))

    for tree in trees:
        walk(tree, [])
    return out


def params_from_flax(params) -> dict[str, torch.Tensor]:
    """state_dict of MLP or ConvNet from its flax param tree: `Dense_i` ->
    `dense_i`, `Conv_i` -> `conv_i`."""
    return state_dict_from_flax([params], str.lower)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[:, None].long()).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()
