"""The MLM head's fused decoder and loss (tf_operator_tpu_torch/ops/mlm_xent.py)
and its route (models/transformer.py::mlm_head_loss).

On the CPU the plain version runs: it is held against the unfused
mlm_loss(model(tokens)) that it replaces, at a vocabulary that needs the
pad (1021, at a pitch of 1024) and at one that does not (1024), for
the loss and every parameter's gradient, bit for bit, with fully unmasked
rows, with no masked position at all (the count clamped to 1), with a loss
cotangent other than 1 and without a gradient. The route keeps the
unfused path where the decoder is sharded (tp, fsdp) or the head computes
in f32.

The tests marked `card` hold the CUDA kernel against the plain version on
an NVIDIA card (`python -m pytest tests/test_torch_mlm_xent.py -m card`)
and skip elsewhere, decided when they run.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from tf_operator_tpu_torch.models import transformer as tfm
from tf_operator_tpu_torch.ops import mlm_xent
from tf_operator_tpu_torch.parallel import collectives, graphed_step


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Bit-steady CPU arithmetic: one intra-op thread for the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided when the test
    runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run `python -m pytest "
                    "tests/test_torch_mlm_xent.py -m card` on the chip")
    return torch.device("cuda", 0)


def _model(vocab: int, seed: int = 0) -> tfm.BertMLM:
    cfg = dataclasses.replace(tfm.TINY, vocab_size=vocab, num_layers=1)
    return tfm.BertMLM(cfg, generator=torch.Generator().manual_seed(seed))


def _batch(vocab: int, seed: int = 1, batch: int = 4, seq: int = 16) -> dict:
    return tfm.make_mlm_batch(torch.Generator().manual_seed(seed), batch, seq, vocab)


def _grads(model, loss) -> dict:
    names = [n for n, _ in model.named_parameters()]
    return dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))


def _both(model, b, scale: float = 1.0):
    """(loss, grads) of the unfused path and of mlm_head_loss, each times
    `scale` before the backward."""
    ref = tfm.mlm_loss(model(b["tokens"]), b["targets"], b["mask"])
    got = tfm.mlm_head_loss(model, b["tokens"], b["targets"], b["mask"])
    return (ref, _grads(model, ref * scale)), (got, _grads(model, got * scale))


@pytest.mark.parametrize("vocab,pitch", [(1, 64), (1021, 1024), (1024, 1024),
                                         (30522, 30528), (50257, 50304)])
def test_padded_vocab_is_the_next_multiple_of_64(vocab, pitch):
    assert mlm_xent.padded_vocab(vocab) == pitch


@pytest.mark.parametrize("vocab", [1021, 1024])
def test_fused_route_equals_the_unfused_loss_and_gradients(vocab):
    model = _model(vocab)
    (ref, ref_g), (got, got_g) = _both(model, _batch(vocab))
    assert torch.equal(got, ref), (got, ref)
    for name in ref_g:
        assert torch.equal(got_g[name], ref_g[name]), name


@pytest.mark.parametrize("vocab", [1021, 1024])
def test_linear_masked_xent_gives_dh_and_dw_of_the_unfused_head(vocab):
    gen = torch.Generator().manual_seed(3)
    h = torch.randn(40, 32, generator=gen).bfloat16().requires_grad_()
    w = (0.2 * torch.randn(vocab, 32, generator=gen)).requires_grad_()
    targets = torch.randint(0, vocab, (40,), generator=gen)
    mask = (torch.rand(40, generator=gen) < 0.3).float()
    ref = tfm.mlm_loss(F.linear(h, w.to(torch.bfloat16)).float(), targets, mask)
    ref_dh, ref_dw = torch.autograd.grad(ref, (h, w))
    got = mlm_xent.linear_masked_xent(h, w, targets, mask)
    dh, dw = torch.autograd.grad(got, (h, w))
    assert torch.equal(got, ref)
    assert dh.dtype == torch.bfloat16 and dw.dtype == torch.float32
    assert dw.shape == (vocab, 32)
    assert torch.equal(dh, ref_dh) and torch.equal(dw, ref_dw)


@pytest.mark.parametrize("case", ["unmasked_rows", "no_masked_position"])
def test_masks_with_unmasked_rows_and_with_none_masked(case):
    vocab = 1021
    model = _model(vocab)
    b = _batch(vocab)
    if case == "unmasked_rows":
        b["mask"][0] = 0.0  # a whole row of the batch without a masked position
        b["mask"][1, :3] = 1.0
    else:
        b["mask"].zero_()  # count 0, clamped to 1: loss 0, gradients 0
    (ref, ref_g), (got, got_g) = _both(model, b)
    assert torch.equal(got, ref)
    for name in ref_g:
        assert torch.equal(got_g[name], ref_g[name]), name
    if case == "no_masked_position":
        assert float(got) == 0.0
        assert all(float(g.abs().max()) == 0.0 for g in got_g.values())


def test_a_loss_cotangent_other_than_one_scales_the_gradients():
    # The fused backward multiplies the products by the cotangent after
    # their bf16 rounding, where the unfused one scales the logits'
    # gradient before it: one bf16 rounding apart in the head (~0.3% in
    # norm), which the trunk's bf16 backward carries on (~1%). The key
    # biases' gradient is rounding noise on both routes (softmax does not
    # see them) and is left out.
    vocab = 1021
    model = _model(vocab)
    b = _batch(vocab)
    (ref, ref_g), (got, got_g) = _both(model, b, scale=2.5)
    assert torch.equal(got, ref)
    for name, g in ref_g.items():
        if not name.endswith("attn.key.bias"):
            rel = float((got_g[name] - g).norm() / g.norm())
            assert rel <= 2e-2, (name, rel)
    # The decoder's gradient is the f32 product times the cotangent.
    (_, one), (_, fused_one) = _both(model, b)
    assert torch.equal(got_g["lm_head.weight"], fused_one["lm_head.weight"] * 2.5)
    # A power of two scales exactly on both routes.
    (ref, ref_g), (got, got_g) = _both(model, b, scale=4.0)
    for name in ref_g:
        assert torch.equal(got_g[name], ref_g[name]), name


def test_without_grad_only_the_loss_is_taken(monkeypatch):
    vocab = 1021
    model = _model(vocab)
    b = _batch(vocab)
    seen = []
    real = mlm_xent.masked_xent_

    def spy(logits, vocab_, targets, mask, want_grad):
        before = logits.clone()
        loss = real(logits, vocab_, targets, mask, want_grad)
        seen.append((want_grad, torch.equal(before, logits)))
        return loss

    monkeypatch.setattr(mlm_xent, "masked_xent_", spy)
    with torch.no_grad():
        ref = tfm.mlm_loss(model(b["tokens"]), b["targets"], b["mask"])
        got = tfm.mlm_head_loss(model, b["tokens"], b["targets"], b["mask"])
    assert torch.equal(got, ref)
    assert seen == [(False, True)]
    tfm.mlm_head_loss(model, b["tokens"], b["targets"], b["mask"])
    assert seen[-1] == (True, False)


def test_the_plain_version_writes_the_gradient_and_zeros_the_pad():
    gen = torch.Generator().manual_seed(5)
    vocab, n = 61, 6
    logits = torch.randn(n, 64, generator=gen).bfloat16()
    logits[:, vocab:] = 7.0  # the pad is never read
    targets = torch.randint(0, vocab, (n,), generator=gen)
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0, 1.0])
    z = logits[:, :vocab].float().clone()
    loss = mlm_xent.masked_xent_(logits, vocab, targets, mask, True)
    assert torch.equal(loss, tfm.mlm_loss(z, targets, mask))
    p = torch.softmax(z, -1) - F.one_hot(targets, vocab)
    want = (p * (mask / 4.0)[:, None]).bfloat16()
    assert torch.equal(logits[:, :vocab], want)
    assert torch.equal(logits[:, vocab:], torch.zeros(n, 64 - vocab, dtype=torch.bfloat16))
    assert float(logits[1].abs().max()) == 0.0  # an unmasked row's gradient


def test_a_nan_logit_makes_the_loss_nan_as_mlm_loss_does():
    logits = torch.zeros(2, 64, dtype=torch.bfloat16)
    logits[0, 5] = float("nan")
    targets, mask = torch.tensor([1, 2]), torch.tensor([1.0, 1.0])
    z = logits.float().clone()
    loss = mlm_xent.masked_xent_(logits, 64, targets, mask, False)
    assert torch.isnan(loss) and torch.isnan(tfm.mlm_loss(z, targets, mask))


def test_shapes_that_do_not_fit_are_refused():
    logits = torch.zeros(4, 64)
    with pytest.raises(ValueError):
        mlm_xent.masked_xent_(logits, 65, torch.zeros(4, dtype=torch.long), torch.ones(4),
                              True)
    with pytest.raises(ValueError):
        mlm_xent.masked_xent_(logits, 64, torch.zeros(3, dtype=torch.long), torch.ones(4),
                              True)


def _forbid_fused(monkeypatch):
    def fused(*args, **kwargs):
        raise AssertionError("the fused head ran on a route that must keep mlm_loss")

    monkeypatch.setattr(mlm_xent, "linear_masked_xent", fused)


@pytest.mark.parametrize("sharding", ["tp", "fsdp"])
def test_a_sharded_decoder_keeps_the_unfused_route(monkeypatch, sharding):
    vocab = 1024
    model = _model(vocab)
    b = _batch(vocab)
    want = tfm.mlm_loss(model(b["tokens"]), b["targets"], b["mask"])
    if sharding == "tp":
        model.lm_head.tp = collectives.TpShard("col", None, 0, 1)
    else:
        model.lm_head.fsdp_unit = object()
    # The unfused route runs model(tokens); a one-rank shard computes what
    # the whole decoder does.
    monkeypatch.setattr(model, "forward", lambda tokens: F.linear(
        model.head_hidden(tokens), model.lm_head.weight.to(torch.bfloat16)).float())
    _forbid_fused(monkeypatch)
    got = tfm.mlm_head_loss(model, b["tokens"], b["targets"], b["mask"])
    assert torch.equal(got, want)


def test_an_f32_head_keeps_the_unfused_route(monkeypatch):
    vocab = 1021
    cfg = dataclasses.replace(tfm.TINY, vocab_size=vocab, num_layers=1, dtype=torch.float32)
    model = tfm.BertMLM(cfg, generator=torch.Generator().manual_seed(0))
    b = _batch(vocab)
    want = tfm.mlm_loss(model(b["tokens"]), b["targets"], b["mask"])
    _forbid_fused(monkeypatch)
    assert torch.equal(tfm.mlm_head_loss(model, b["tokens"], b["targets"], b["mask"]), want)


def test_the_trainers_bert_loss_takes_the_fused_route(monkeypatch):
    from tf_operator_tpu_torch.models import train

    args = train.build_parser().parse_args(["--model", "bert-tiny", "--seq", "16",
                                            "--batch", "2", "--device", "cpu"])
    model, loss_fn, make_batch = train._build_model(args, torch.device("cpu"))
    b = make_batch(torch.Generator().manual_seed(2))
    calls = []
    real = mlm_xent.linear_masked_xent

    def spy(*args_):
        calls.append(1)
        return real(*args_)

    monkeypatch.setattr(mlm_xent, "linear_masked_xent", spy)
    got = loss_fn(model, b)
    assert calls == [1]
    assert torch.equal(got, tfm.mlm_loss(model(b["tokens"]), b["targets"], b["mask"]))


def test_the_graphed_step_counts_the_kernels_launches():
    counters = graphed_step.launch_counters()
    assert any(c is mlm_xent.LAUNCHES for c in counters)


def test_the_cpu_path_launches_nothing():
    mlm_xent.reset_launches()
    model = _model(1021)
    b = _batch(1021)
    tfm.mlm_head_loss(model, b["tokens"], b["targets"], b["mask"]).backward()
    assert mlm_xent.LAUNCHES["mlm_xent"] == 0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card_case(device, n: int, vocab: int, seed: int):
    gen = torch.Generator(device=device).manual_seed(seed)
    vp = mlm_xent.padded_vocab(vocab)
    z = torch.zeros((n, vp), dtype=torch.bfloat16, device=device)
    z[:, :vocab] = (2.0 * torch.randn((n, vocab), generator=gen, device=device)).bfloat16()
    targets = torch.randint(0, vocab, (n,), generator=gen, device=device)
    mask = (torch.rand((n,), generator=gen, device=device) < 0.15).float()
    return z, targets, mask


@pytest.mark.card
@pytest.mark.parametrize("n,vocab", [(2048, 30522), (512, 1021), (512, 50257)])
def test_the_kernel_agrees_with_its_plain_version(card, n, vocab):
    z, targets, mask = _card_case(card, n, vocab, 7)
    got, ref = z.clone(), z.clone()
    before = mlm_xent.LAUNCHES["mlm_xent"]
    loss = mlm_xent.masked_xent_(got, vocab, targets, mask, True)
    assert mlm_xent.LAUNCHES["mlm_xent"] == before + 1
    want = mlm_xent.masked_xent_reference_(ref, vocab, targets, mask, True)
    assert abs(float(loss) - float(want)) <= 1e-5 * abs(float(want))
    # Within one bf16 rounding step of the plain gradient (ex2.approx
    # against torch.exp, f32 sums in another order).
    torch.testing.assert_close(got.float(), ref.float(), rtol=2.0 ** -7, atol=1e-30)
    assert torch.equal(got[:, vocab:], torch.zeros_like(got[:, vocab:]))
    kept = z.clone()
    loss_only = mlm_xent.masked_xent_(kept, vocab, targets, mask, False)
    assert torch.equal(kept, z) and torch.equal(loss_only, loss)


@pytest.mark.card
def test_a_graph_replay_equals_the_eager_call_bit_for_bit(card):
    gen = torch.Generator(device=card).manual_seed(11)
    vocab, n, hidden = 30522, 1024, 768
    h = torch.randn((n, hidden), generator=gen, device=card).bfloat16().requires_grad_()
    w = (0.05 * torch.randn((vocab, hidden), generator=gen, device=card)).requires_grad_()
    targets = torch.randint(0, vocab, (n,), generator=gen, device=card)
    mask = (torch.rand((n,), generator=gen, device=card) < 0.15).float()

    def body():
        loss = mlm_xent.linear_masked_xent(h, w, targets, mask)
        dh, dw = torch.autograd.grad(loss, (h, w))
        return loss, dh, dw

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = [t.clone() for t in body()]
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = body()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(static, eager):
            assert torch.equal(a, b)
