"""BERT's MLM decoder and masked cross entropy, with the logits made once in
the compute dtype at an aligned pitch: a hand-written kernel for the loss
and its gradient (``csrc/mlm_xent.cu``) and its plain version.

``linear_masked_xent(h, weight, targets, mask)`` is
``mlm_loss(F.linear(h, weight.to(h.dtype)).float(), targets, mask)`` (the
masked mean of the cross entropy over the vocabulary of ``weight`` [V, H])
with the same rounding points: logits in h's dtype from the product, the
softmax in f32, the gradient rounded once to h's dtype after its scale by
mask / count. It differs in layout and traffic:

- the decoder's cast copy is padded with zero rows to Vp = V rounded up to
  a multiple of ``PITCH`` (64), so the logits [N, Vp] have 16-byte aligned
  rows and cuBLAS runs its TMA/wgmma products on them (at V = 30522 the
  unpadded pitch of 61044 bytes sends all three to sm80 kernels);
- one pass over each row (``masked_xent_``) turns the logits into the
  loss and, when a gradient is wanted, overwrites them in place with the
  gradient of the loss in the logits; the backward is then the two
  products, dh = G Wp and dWp = G^T h, times the loss's cotangent, with dWp
  cut back to V rows in the weight's dtype.

On CPU tensors ``masked_xent_`` runs its plain version (any float dtype).
On CUDA tensors it launches the kernel (bf16 logits; counted in
``LAUNCHES``) or raises. The count of masked positions is a device tensor
(clamped to 1 in the kernel), so nothing syncs and the call can be
captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# Row pitch of the logits, in elements: a multiple of 8 (16 bytes of bf16)
# is what TMA needs; 64 keeps every row 128-byte aligned.
PITCH = 64

# Launches of the kernel, incremented where the wrapper launches it.
LAUNCHES = {"mlm_xent": 0}
# The C interface's code for arguments the kernel does not take.
_BAD_ARGUMENTS = 1000

_lib_handle = None


def reset_launches() -> None:
    LAUNCHES["mlm_xent"] = 0


def padded_vocab(vocab: int) -> int:
    """The logits' row pitch for a vocabulary of `vocab`: the next multiple
    of PITCH (vocab itself when it is one)."""
    return -(-vocab // PITCH) * PITCH


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        from tf_operator_tpu_torch.ops import _build

        lib = _build.load("mlm_xent")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.tfo_mlm_xent.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
        lib.tfo_mlm_xent.restype = i32
        _lib_handle = lib
    return _lib_handle


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def masked_xent_reference_(logits: torch.Tensor, vocab: int, targets: torch.Tensor,
                           mask: torch.Tensor, want_grad: bool) -> torch.Tensor:
    """The kernel's arithmetic: the f32 loss sum(mask * (lse - z[target])) /
    max(sum(mask), 1) over the first `vocab` columns of `logits` [N, Vp];
    with want_grad, logits overwritten in place by the gradient
    (softmax - onehot) * mask * (1 / max(sum(mask), 1)), 0 in the pad."""
    z = logits[:, :vocab].float()
    count = mask.sum().clamp_min(1.0)
    lse = torch.logsumexp(z, dim=-1)
    nll = lse - torch.gather(z, -1, targets[:, None])[:, 0]
    loss = (nll * mask).sum() / count
    if want_grad:
        g = torch.exp(z - lse[:, None])
        g.scatter_add_(-1, targets[:, None], torch.full_like(g[:, :1], -1.0))
        logits[:, :vocab] = (g * (mask * (1.0 / count))[:, None]).to(logits.dtype)
        logits[:, vocab:] = 0
    return loss


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def masked_xent_(logits: torch.Tensor, vocab: int, targets: torch.Tensor,
                 mask: torch.Tensor, want_grad: bool) -> torch.Tensor:
    """The f32 loss of `logits` [N, Vp] (the first `vocab` columns) at
    `targets` [N] over the positions where `mask` [N] is 1; with want_grad
    the logits become the loss's gradient in place (masked_xent_reference_
    says what is computed)."""
    n, vp = logits.shape
    if not 0 < vocab <= vp or targets.shape != (n,) or mask.shape != (n,):
        raise ValueError(f"logits {tuple(logits.shape)}, vocab {vocab}, targets "
                         f"{tuple(targets.shape)} and mask {tuple(mask.shape)} do not fit")
    targets = targets.to(torch.int64).contiguous()
    mask = mask.to(torch.float32).contiguous()
    if logits.device.type == "cpu":
        return masked_xent_reference_(logits, vocab, targets, mask, want_grad)
    if logits.dtype != torch.bfloat16:
        raise ValueError(f"the MLM cross-entropy kernel takes bf16 logits, got {logits.dtype}")
    if not logits.is_contiguous() or vp % 8 or logits.data_ptr() % 16:
        raise ValueError("the MLM cross-entropy kernel takes contiguous logits with 16-byte "
                         f"aligned rows; got strides {logits.stride()} at pitch {vp}")
    if n >= 2 ** 31:
        raise ValueError(f"{n} rows do not fit the kernel's grid")
    dev = logits.device
    loss = torch.empty((), dtype=torch.float32, device=dev)
    count = mask.sum()
    partial = torch.empty(n, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev)
    with torch.cuda.device(dev):
        err = _lib().tfo_mlm_xent(_ptr(logits), _ptr(targets), _ptr(mask), _ptr(count),
                                  _ptr(partial), _ptr(loss), n, vocab, vp, int(want_grad),
                                  ctypes.c_void_p(stream.cuda_stream))
    if err == _BAD_ARGUMENTS:
        raise ValueError(f"the MLM cross-entropy kernel refused logits {tuple(logits.shape)} "
                         f"at vocab {vocab}")
    if err != 0:
        raise RuntimeError(f"MLM cross-entropy kernel launch failed: error {err}")
    LAUNCHES["mlm_xent"] += 1
    return loss


class LinearMaskedXent(torch.autograd.Function):
    """The decoder's product into padded logits and masked_xent_ on them;
    the backward is two products on the gradient the forward left in the
    logits."""

    @staticmethod
    def forward(ctx, h, weight, targets, mask, want_grad):
        vocab, hidden = weight.shape
        vp = padded_vocab(vocab)
        if vp == vocab:
            wp = weight.to(h.dtype)
        else:
            wp = torch.empty((vp, hidden), dtype=h.dtype, device=h.device)
            wp[:vocab].copy_(weight)
            wp[vocab:].zero_()
        logits = F.linear(h, wp)
        loss = masked_xent_(logits, vocab, targets, mask, want_grad)
        if want_grad:
            ctx.save_for_backward(h, wp, logits)
        ctx.vocab, ctx.weight_dtype = vocab, weight.dtype
        return loss

    @staticmethod
    def backward(ctx, g_loss):
        h, wp, grad = ctx.saved_tensors
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = (grad @ wp).mul_(g_loss)
        if ctx.needs_input_grad[1]:
            dw = (grad.t() @ h)[:ctx.vocab].to(ctx.weight_dtype).mul_(g_loss)
        return dh, dw, None, None, None


def linear_masked_xent(h: torch.Tensor, weight: torch.Tensor, targets: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """mlm_loss(F.linear(h, weight.to(h.dtype)).float(), targets, mask):
    h [..., H] (the MLM transform's output), weight [V, H] (the decoder),
    targets and mask of h's leading shape. The gradient is written only
    when autograd will ask for it (grad enabled and h or weight requiring
    it)."""
    want = torch.is_grad_enabled() and (h.requires_grad or weight.requires_grad)
    return LinearMaskedXent.apply(h.reshape(-1, h.shape[-1]), weight, targets.reshape(-1),
                                  mask.reshape(-1), want)
