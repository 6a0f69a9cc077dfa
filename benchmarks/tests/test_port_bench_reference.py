"""The plain reference against the port on the CPU, in float32 at tiny
sizes: the batches each step draws, the loss, every gradient and one AdamW
step, for every cell's configuration."""

import pytest
import torch

from benchmarks import cells, weights
from benchmarks.reference import bert_mlm as ref_model
from benchmarks.reference import train as ref_train
from benchmarks.tests.tiny import tiny_cell
from tf_operator_tpu_torch import optim as optim_lib
from tf_operator_tpu_torch.models import transformer as tfm
from tf_operator_tpu_torch.parallel.ring_attention import make_attention_fn
from tf_operator_tpu_torch.parallel.train_step import batch_generator

CELLS = tuple(w["name"] for w in cells.benchmark()["workloads"])
SEED = 2 ** 31 + 7


def port_model(arch: dict):
    cfg = tfm.TransformerConfig(vocab_size=arch["vocab"], num_layers=arch["layers"],
                                hidden=arch["hidden"], num_heads=arch["heads"],
                                mlp_ratio=arch["mlp_ratio"], max_len=arch["max_len"],
                                causal=False, dtype=torch.float32)
    return tfm.BertMLM(cfg, attn_fn=make_attention_fn(None, causal=False))


def port_batch(arch: dict, shape: dict, step: int) -> dict:
    g = batch_generator(SEED, step, "cpu")
    return tfm.make_mlm_batch(g, shape["batch"], shape["seq"], arch["vocab"],
                              arch["mask_rate"], arch["mask_token"])


def port_loss(model, arch: dict, batch: dict) -> torch.Tensor:
    return tfm.mlm_loss(model(batch["tokens"]), batch["targets"], batch["mask"])


@pytest.fixture(params=CELLS)
def setup(request):
    cell = tiny_cell(request.param)
    arch, shape = cell["arch"], cell["shape"]
    init = weights.make(arch, cell["cfg"]["init_std"], SEED, "cpu")
    model = port_model(arch)
    model.load_state_dict(init, strict=True)
    return cell, arch, shape, init, model


@pytest.mark.parametrize("step", [0, 1, 2])
def test_batches_are_the_trainers(setup, step):
    _, arch, shape, _, _ = setup
    got = ref_train.make_batch(arch, shape, SEED, step, "cpu")
    want = port_batch(arch, shape, step)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_loss_and_gradients_match_the_port(setup):
    _, arch, shape, init, model = setup
    batch = port_batch(arch, shape, 0)
    loss = port_loss(model, arch, batch)
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    ref_loss, ref_grads = ref_model.loss_and_grads(init, batch, arch, rows=3)
    assert ref_loss == pytest.approx(loss.item(), rel=1e-5)
    assert set(ref_grads) == set(names)
    median = torch.tensor([g.norm() for g in ref_grads.values()]).median()
    for n in names:
        gap = (grads[n] - ref_grads[n]).norm()
        assert gap <= 1e-4 * max(ref_grads[n].norm(), median), n


def test_one_adamw_step_matches_the_port(setup):
    cell, arch, shape, init, model = setup
    opt = cell["optimizer"]
    batch = port_batch(arch, shape, 0)
    _, grads = ref_model.loss_and_grads(init, batch, arch, rows=shape["batch"])
    names = [n for n, _ in model.named_parameters()]
    tx = optim_lib.make_optimizer(optim_lib.OptimizerConfig(
        name=opt["name"], learning_rate=opt["lr"], b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
        weight_decay=opt["weight_decay"]))
    params = [init[n].clone() for n in names]
    tx.update_in_place([grads[n] for n in names], tx.init(params), params)
    p = {n: t.clone() for n, t in init.items()}
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    ref_train.adamw_(p, grads, m, v, 1, opt)
    for n, got in zip(names, params):
        torch.testing.assert_close(p[n], got, rtol=1e-6, atol=1e-8, msg=n)


def test_blocked_attention_is_exact_attention():
    """BlockAttention in blocks of heads and in blocks of rows against one
    softmax over all heads."""
    torch.manual_seed(0)
    q, k, v = (torch.randn(2, 3, 40, 16, dtype=torch.float64, requires_grad=True)
               for _ in range(3))
    want = torch.softmax(q @ k.transpose(-1, -2) / 4.0, -1) @ v
    do = torch.randn_like(want)
    ref = torch.autograd.grad(want, (q, k, v), do)
    old = ref_model.ATTN_BLOCK_ELEMENTS
    try:
        for elements in (40 * 40, 2 * 40 * 40, 3 * 40 * 40):  # 1 or 2 heads, one row
            ref_model.ATTN_BLOCK_ELEMENTS = elements
            out = ref_model.BlockAttention.apply(q, k, v)
            torch.testing.assert_close(out, want)
            got = torch.autograd.grad(out, (q, k, v), do)
            for a, b in zip(got, ref):
                torch.testing.assert_close(a, b)
        assert [(r.start, r.stop) for r, _ in ref_model._blocks(5, 3, 40)] == [
            (0, 1), (1, 2), (2, 3), (3, 4), (4, 5)]
        ref_model.ATTN_BLOCK_ELEMENTS = 2 * 3 * 40 * 40  # two rows a block
        assert [(r.start, r.stop) for r, _ in ref_model._blocks(5, 3, 40)] == [
            (0, 2), (2, 4), (4, 5)]
    finally:
        ref_model.ATTN_BLOCK_ELEMENTS = old
