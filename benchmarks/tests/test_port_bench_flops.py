"""flops.py and the reference's step FLOPs against counts made by hand at
the cells' shapes."""

import pytest

from benchmarks import cells, flops, reference


def hand_step_flops(batch, seq, layers, hidden, vocab, mlp):
    """Every product of a BERT MLM step, listed: 2 FLOPs a multiply-add, the
    backward twice the forward."""
    tokens = batch * seq
    per_layer = (4 * hidden * hidden          # query, key, value, attn_out
                 + 2 * hidden * mlp * hidden)  # mlp_in, mlp_out
    dense = layers * per_layer + hidden * hidden + hidden * vocab  # MLM transform, decoder
    pairs = batch * seq * seq                  # full attention: every pair
    forward = 2 * dense * tokens + layers * 2 * (2 * pairs * hidden)  # QK^T and PV
    return 3 * forward


@pytest.mark.parametrize("name,expected", [
    ("bert-base.seq512", 46_557_781_032_960.0),
])
def test_step_flops(name, expected):
    s = cells.load(name)["shape"]
    hand = hand_step_flops(s["batch"], s["seq"], s["layers"], s["hidden"], s["vocab"],
                           s["mlp_ratio"])
    assert hand == expected
    got = reference.family(s["family"]).step_flops(s)
    assert got == pytest.approx(expected, rel=1e-12)


@pytest.mark.parametrize("name", [w["name"] for w in cells.benchmark()["workloads"]])
def test_every_cells_step_flops_is_the_hand_count(name):
    s = cells.load(name)["shape"]
    hand = hand_step_flops(s["batch"], s["seq"], s["layers"], s["hidden"], s["vocab"],
                           s["mlp_ratio"])
    assert reference.family(s["family"]).step_flops(s) == pytest.approx(hand, rel=1e-12)


def test_attention_bounds_at_a_long_causal_row():
    s = {"batch": 4, "heads": 12, "seq": 8192, "hidden": 768, "dtype": "bfloat16",
         "causal": True, "layers": 12}
    pairs = 4 * 12 * 8192 * 8193 // 2
    fwd_ms, by = flops.attention_fwd(s)
    assert by == "operations"
    assert fwd_ms == pytest.approx(12 * 2 * 2 * pairs * 64 / 989e12 * 1e3, rel=1e-12)
    bwd_ms, by = flops.attention_bwd(s)
    assert by == "operations"
    assert bwd_ms == pytest.approx(fwd_ms * 5 / 2, rel=1e-12)


def test_attention_bound_by_bytes_at_a_short_row():
    shape = {"batch": 1, "heads": 1, "seq": 16, "hidden": 64, "dtype": "bfloat16",
             "causal": True, "layers": 1}
    ms, by = flops.attention_fwd(shape)
    nbytes = 4 * 16 * 64 * 2 + 16 * 4   # q, k, v, o and the lse
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)


def test_bert_attention_is_not_causal_and_bound_by_bytes():
    s = cells.load("bert-base.seq512")["shape"]
    b = s["batch"]
    ms, by = flops.attention_fwd(s)
    ops_ms = 12 * 4 * b * 12 * 512 * 512 * 64 / 989e12 * 1e3
    bytes_ms = 12 * (4 * b * 12 * 512 * 64 * 2 + b * 12 * 512 * 4) / 3.35e12 * 1e3
    assert bytes_ms > ops_ms
    assert (ms, by) == (pytest.approx(bytes_ms, rel=1e-12), "bytes")
