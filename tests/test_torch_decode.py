"""The port's KV-cache decode (tf_operator_tpu_torch/models/decode.py) held
against the JAX package's (tf_operator_tpu/models/decode.py) on the same
weights: a tiny causal LM made by the JAX TransformerLM's init from a seed,
carried across by transformer.params_from_flax, with numpy inputs from a
seed.

f32: prefill's K/V, logits and next tokens, write_slots' caches and
decode_step's caches, logits and next tokens within atol 1e-5 (summation
order only); greedy chains equal token for token to the JAX decode's and to
a re-forward of the port's TransformerLM. bf16: the JAX side runs in a
child process with XLA's excess precision off (tests/test_torch_train.py
says why); K/V and logits within atol 0.06 (two bf16 steps of values up to
~4, where the two sides round a LayerNorm output or an accumulation the
other way), next tokens equal wherever JAX's top-2 margin exceeds 0.1.
config_from_params is held to the JAX derivation, env rule and messages.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tf_operator_tpu.models import decode as jdecode
from tf_operator_tpu.models.transformer import TransformerConfig as JConfig
from tf_operator_tpu.models.transformer import TransformerLM as JLM
from tf_operator_tpu_torch.models import decode
from tf_operator_tpu_torch.models import transformer as tfm

ROOT = Path(__file__).resolve().parents[1]
F32_ATOL = 1e-5
BF16_ATOL = 0.06
BF16_MARGIN = 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jcfg(dtype=jnp.float32, **kw) -> JConfig:
    base = dict(vocab_size=61, num_layers=2, hidden=32, num_heads=2, max_len=32,
                causal=True, dtype=dtype)
    base.update(kw)
    return JConfig(**base)


def jparams(cfg: JConfig, seed: int = 0):
    return jax.device_get(JLM(cfg).init(jax.random.PRNGKey(seed),
                                        jnp.zeros((1, 4), jnp.int32))["params"])


def tcfg(sd, dtype=torch.float32, heads: int = 2):
    return dataclasses.replace(decode.config_from_params(sd, num_heads=heads), dtype=dtype)


def prompts(vocab: int, lengths, t: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((len(lengths), t), np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(0, vocab, n)
    return tokens, np.asarray(lengths, np.int32)


def f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


@pytest.fixture(scope="module")
def lm():
    cfg = jcfg()
    params = jparams(cfg)
    sd = tfm.params_from_flax(params)
    return cfg, params, sd, tcfg(sd)


# ------------------------------------------------------------ config


@pytest.mark.parametrize("hidden,heads,mlp_ratio,num_heads", [
    (64, 1, 2, None), (128, 2, 4, None), (64, 4, 2, 4), (96, 3, 4, 3)])
def test_config_from_params_matches_jax(hidden, heads, mlp_ratio, num_heads):
    params = jparams(jcfg(hidden=hidden, num_heads=heads, mlp_ratio=mlp_ratio, num_layers=3))
    want = jdecode.config_from_params(params, num_heads=num_heads)
    got = decode.config_from_params(tfm.params_from_flax(params), num_heads=num_heads)
    fields = ("vocab_size", "num_layers", "hidden", "num_heads", "mlp_ratio", "max_len",
              "causal")
    assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16


def test_config_env_override_matches_jax(monkeypatch):
    params = jparams(jcfg(hidden=64, num_heads=1))
    monkeypatch.setenv(decode.ENV_NUM_HEADS, "4")
    assert decode.ENV_NUM_HEADS == jdecode.ENV_NUM_HEADS
    want = jdecode.config_from_params(params)
    got = decode.config_from_params(tfm.params_from_flax(params))
    assert got.num_heads == want.num_heads == 4 and got.head_dim == 16


@pytest.mark.parametrize("case", ["indivisible", "uninferable", "not_an_lm"])
def test_config_errors_match_jax(case, monkeypatch):
    monkeypatch.delenv(decode.ENV_NUM_HEADS, raising=False)
    if case == "not_an_lm":
        jtree, ttree, kw = {"dense": {}}, {"dense.weight": torch.zeros(2, 2)}, {}
    else:
        jtree = jparams(jcfg(hidden=64 if case == "indivisible" else 48, num_heads=1))
        ttree = tfm.params_from_flax(jtree)
        kw = {"num_heads": 3} if case == "indivisible" else {}
    with pytest.raises(ValueError) as want:
        jdecode.config_from_params(jtree, **kw)
    with pytest.raises(ValueError) as got:
        decode.config_from_params(ttree, **kw)
    if case == "not_an_lm":  # the missing key is named in each package's layout
        for e in (want, got):
            assert str(e.value).startswith("param tree is not a TransformerLM checkpoint")
    else:
        assert str(got.value) == str(want.value)


# ------------------------------------------------------------ f32 parity


def test_prefill_matches_jax(lm):
    jc, params, sd, cfg = lm
    tokens, lengths = prompts(jc.vocab_size, [7, 1, 12, 4], 16)
    jk, jv, jn, jl = jdecode.prefill(params, jnp.asarray(tokens), jnp.asarray(lengths), jc)
    k, v, n, logits = decode.prefill(sd, tokens, lengths, cfg)
    assert k.shape == jk.shape == (2, 4, 2, 16, 16) and n.dtype == torch.int32
    np.testing.assert_allclose(f32(k), f32(jk), atol=F32_ATOL)
    np.testing.assert_allclose(f32(v), f32(jv), atol=F32_ATOL)
    np.testing.assert_allclose(f32(logits), f32(jl), atol=F32_ATOL)
    assert n.tolist() == np.asarray(jn).tolist()


def test_write_slots_matches_jax(lm):
    jc, params, sd, cfg = lm
    tokens, lengths = prompts(jc.vocab_size, [7, 3, 12], 16)
    jk, jv, _, _ = jdecode.prefill(params, jnp.asarray(tokens), jnp.asarray(lengths), jc)
    k, v, _, _ = decode.prefill(sd, tokens, lengths, cfg)
    # Slot 4 is the scratch slot (the cache's last): only it repeats.
    ids = np.array([2, 4, 0], np.int32)
    jkc, jvc = jdecode.init_kv_cache(jc, 5, jc.max_len)
    kc, vc = decode.init_kv_cache(cfg, 5, cfg.max_len, device="cpu")
    jkc, jvc = jdecode.write_slots(jkc, jvc, jk, jv, jnp.asarray(ids))
    out = decode.write_slots(kc, vc, k, v, ids)
    assert out[0] is kc and out[1] is vc  # in place
    np.testing.assert_allclose(f32(kc), f32(jkc), atol=F32_ATOL)
    np.testing.assert_allclose(f32(vc), f32(jvc), atol=F32_ATOL)
    ids = np.array([1, 4, 4], np.int32)
    jkc, jvc = jdecode.write_slots(jkc, jvc, jk, jv, jnp.asarray(ids))
    decode.write_slots(kc, vc, k, v, ids)
    # The repeated scratch slot's contents are unordered; every other slot
    # is the JAX cache's.
    np.testing.assert_allclose(f32(kc[:, :4]), f32(jkc[:, :4]), atol=F32_ATOL)
    np.testing.assert_allclose(f32(vc[:, :4]), f32(jvc[:, :4]), atol=F32_ATOL)


@pytest.mark.parametrize("ids,needle", [([1, 1, 4], "repeat a slot other than"),
                                        ([0, 5, 4], "outside"), ([-1, 0, 4], "outside")])
def test_write_slots_refuses_repeated_or_outside_slots(lm, ids, needle):
    _, _, sd, cfg = lm
    k, v = decode.init_kv_cache(cfg, 5, cfg.max_len, device="cpu")
    chunk = torch.ones((2, 3, 2, 4, 16))
    with pytest.raises(ValueError, match=needle):
        decode.write_slots(k, v, chunk, chunk, np.array(ids))


def test_decode_steps_match_jax(lm):
    jc, params, sd, cfg = lm
    tokens, lengths = prompts(jc.vocab_size, [7, 1, 12, 4], 16)
    ids = np.arange(4, dtype=np.int32)
    jkc, jvc = jdecode.init_kv_cache(jc, 5, jc.max_len)
    kc, vc = decode.init_kv_cache(cfg, 5, cfg.max_len, device="cpu")
    jkc, jvc, first, _ = jdecode.prefill_into_slots(
        params, jkc, jvc, jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(ids), jc)
    decode.prefill_into_slots(sd, kc, vc, tokens, lengths, ids, cfg)
    last = np.append(np.asarray(first), 0).astype(np.int32)
    pos = np.append(lengths, 0).astype(np.int32)
    for _ in range(4):
        jkc, jvc, jn, jl = jdecode.decode_step(params, jkc, jvc, jnp.asarray(last),
                                               jnp.asarray(pos), jc)
        _, _, n, logits = decode.decode_step(sd, kc, vc, last, pos, cfg)
        np.testing.assert_allclose(f32(logits), f32(jl), atol=F32_ATOL)
        np.testing.assert_allclose(f32(kc), f32(jkc), atol=F32_ATOL)
        np.testing.assert_allclose(f32(vc), f32(jvc), atol=F32_ATOL)
        assert n.tolist() == np.asarray(jn).tolist()
        last, pos = np.asarray(jn).astype(np.int32), pos + 1


def test_greedy_chains_equal_jax_and_a_port_reforward():
    """prefill_into_slots + decode_step chains, rows of several lengths
    sharing a cache, against the JAX decode's chains and a naive re-forward
    of the port's TransformerLM (plain attention), f32, token for token."""
    jc = jcfg()
    params = jparams(jc, seed=1)
    sd = tfm.params_from_flax(params)
    cfg = tcfg(sd)
    rng = np.random.default_rng(11)
    rows = [rng.integers(0, jc.vocab_size, n).tolist() for n in (3, 8, 5)]
    steps = 6
    model = tfm.TransformerLM(cfg, device="cpu")
    model.load_state_dict(sd)

    def naive(prompt):
        seq, out = list(prompt), []
        with torch.no_grad():
            for _ in range(steps):
                out.append(int(model(torch.tensor([seq]))[0, -1].argmax()))
                seq.append(out[-1])
        return out

    def chains(mod, p, c, kv, asarray):
        tokens, lengths = np.zeros((3, 8), np.int32), np.array([len(r) for r in rows], np.int32)
        for i, r in enumerate(rows):
            tokens[i, :len(r)] = r
        k, v, first, _ = mod.prefill_into_slots(p, *kv, asarray(tokens), asarray(lengths),
                                                asarray(np.arange(3, dtype=np.int32)), c)
        got = [[int(x)] for x in np.asarray(first)]
        last, pos = np.asarray(first, np.int32), lengths.copy()
        for _ in range(steps - 1):
            k, v, nxt, _ = mod.decode_step(p, k, v, asarray(last), asarray(pos), c)
            last, pos = np.asarray(nxt, np.int32), pos + 1
            for g, t in zip(got, last):
                g.append(int(t))
        return got

    want = [naive(r) for r in rows]
    assert chains(jdecode, params, jc, jdecode.init_kv_cache(jc, 3, jc.max_len),
                  jnp.asarray) == want
    assert chains(decode, sd, cfg, decode.init_kv_cache(cfg, 3, cfg.max_len, device="cpu"),
                  lambda a: a) == want


def test_prefill_logits_match_the_port_forward(lm):
    _, _, sd, cfg = lm
    tokens, lengths = prompts(cfg.vocab_size, [7, 1, 12, 4], 12)
    model = tfm.TransformerLM(cfg, device="cpu")
    model.load_state_dict(sd)
    with torch.no_grad():
        full = model(torch.from_numpy(tokens).long())
    want = full[torch.arange(4), torch.from_numpy(lengths).long() - 1]
    np.testing.assert_allclose(f32(decode.prefill(sd, tokens, lengths, cfg)[3]), f32(want),
                               atol=F32_ATOL)


def test_token_kv_index_shape_is_numpys_and_jaxs():
    """cache[i, s, :, positions, :] mixes an int, two advanced indices and
    slices: the advanced ones broadcast to [S] and go first, so the
    indexed value is [S, H, D] on all three, and the write lands in the
    same cells as JAX's .at[...].set."""
    rng = np.random.default_rng(5)
    cache = rng.standard_normal((3, 5, 2, 7, 4)).astype(np.float32)
    kv = rng.standard_normal((5, 2, 4)).astype(np.float32)
    s, pos = np.arange(5), np.array([0, 6, 2, 3, 6])
    assert cache[1, s, :, pos, :].shape == (5, 2, 4)
    assert jnp.asarray(cache)[1, s, :, pos, :].shape == (5, 2, 4)
    t = torch.from_numpy(cache.copy())
    assert t[1, torch.from_numpy(s), :, torch.from_numpy(pos), :].shape == (5, 2, 4)
    decode.write_token_kv(t, 1, torch.from_numpy(pos), torch.from_numpy(kv))
    want = jnp.asarray(cache).at[1, s, :, pos, :].set(kv)
    np.testing.assert_array_equal(t.numpy(), np.asarray(want))


@pytest.mark.parametrize("pos", [[0, 32], [-1, 3]])
def test_decode_step_refuses_positions_outside_the_cache(lm, pos):
    """An index past the cache is a device-side assert on CUDA (JAX drops
    the write and fills the read): the port refuses it on the host."""
    _, _, sd, cfg = lm
    k, v = decode.init_kv_cache(cfg, 2, cfg.max_len, device="cpu")
    with pytest.raises(ValueError, match="outside the cache"):
        decode.decode_step(sd, k, v, np.array([1, 2]), np.array(pos), cfg)


def test_prepared_params_give_the_same_bits(lm):
    """Casting the dense weights once (prepare_params) is the per-call
    cast's bits: prefill and decode outputs are equal bit for bit."""
    jc, _, sd, _ = lm
    cfg = tcfg(sd, torch.bfloat16)
    prep = decode.prepare_params(sd, cfg)
    assert prep["trunk.layers.0.attn.query.weight"].dtype == torch.bfloat16
    assert prep["lm_head.weight"].dtype == torch.bfloat16
    assert prep["trunk.layers.0.mlp_in.bias"].dtype == torch.bfloat16
    assert prep["trunk.layers.0.ln1.weight"].dtype == torch.float32
    assert prep["trunk.embed.weight"].dtype == torch.float32
    tokens, lengths = prompts(jc.vocab_size, [7, 1, 12], 16)
    outs = []
    for p in (sd, prep):
        k, v = decode.init_kv_cache(cfg, 4, cfg.max_len, device="cpu")
        _, _, first, l0 = decode.prefill_into_slots(p, k, v, tokens, lengths, [0, 1, 2], cfg)
        _, _, nxt, l1 = decode.decode_step(p, k, v, np.append(first.numpy(), 0),
                                           np.append(lengths, 0), cfg)
        outs.append((k, v, l0, l1, nxt))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_init_kv_cache_layout(lm):
    _, _, _, cfg = lm
    k, v = decode.init_kv_cache(dataclasses.replace(cfg, dtype=torch.bfloat16), 9, 24,
                                device="cpu")
    assert k.shape == v.shape == (2, 9, 2, 24, 16)
    assert k.dtype == torch.bfloat16 and not k.any()


# ------------------------------------------------------------ bf16 parity

# The JAX side of the bf16 cases, with excess precision off: a tiny LM from
# a seed, prefill of four rows, their write into slots of a cache of 5
# (slot 4 scratch), and three decode ticks; params and outputs to an npz.
_JAX_BF16 = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from flax import traverse_util
from tf_operator_tpu.models import decode
from tf_operator_tpu.models.transformer import TransformerConfig, TransformerLM

cfg = TransformerConfig(vocab_size=61, num_layers=2, hidden=32, num_heads=2, max_len=32,
                        causal=True, dtype=jnp.bfloat16)
params = jax.device_get(TransformerLM(cfg).init(jax.random.PRNGKey(4),
                                                jnp.zeros((1, 4), jnp.int32))["params"])
rng = np.random.default_rng(9)
lengths = np.array([7, 1, 12, 4], np.int32)
tokens = np.zeros((4, 16), np.int32)
for i, n in enumerate(lengths):
    tokens[i, :n] = rng.integers(0, 61, n)
out = {"p/" + k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}
out["tokens"], out["lengths"] = tokens, lengths
k, v, n, logits = decode.prefill(params, jnp.asarray(tokens), jnp.asarray(lengths), cfg)
out.update(pk=k, pv=v, pn=n, pl=logits)
kc, vc = decode.init_kv_cache(cfg, 5, 32)
kc, vc = decode.write_slots(kc, vc, k, v, jnp.asarray([0, 1, 2, 3], jnp.int32))
out.update(wk=kc, wv=vc)
last, pos = np.append(np.asarray(n), 0).astype(np.int32), np.append(lengths, 0)
for t in range(3):
    out[f"in{t}"], out[f"pos{t}"] = last, pos
    kc, vc, n, logits = decode.decode_step(params, kc, vc, jnp.asarray(last), jnp.asarray(pos),
                                           cfg)
    out.update({f"dk{t}": kc, f"dv{t}": vc, f"dn{t}": n, f"dl{t}": logits})
    last, pos = np.asarray(n).astype(np.int32), pos + 1
np.savez(sys.argv[1], **{k: np.asarray(v, np.float32) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def jax_bf16(tmp_path_factory):
    path = tmp_path_factory.mktemp("bf16") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               XLA_FLAGS="--xla_allow_excess_precision=false")
    proc = subprocess.run([sys.executable, "-c", _JAX_BF16, str(path)], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = dict(np.load(path))
    tree = traverse_util.unflatten_dict(
        {k[2:]: v for k, v in ref.items() if k.startswith("p/")}, sep="/")
    sd = tfm.params_from_flax(tree)
    return ref, sd, tcfg(sd, torch.bfloat16)


def _margin(logits: np.ndarray) -> np.ndarray:
    top = np.sort(logits, axis=-1)
    return top[..., -1] - top[..., -2]


def _tokens_agree(got, ref_tokens, ref_logits):
    sure = _margin(ref_logits) > BF16_MARGIN
    assert sure.any()
    np.testing.assert_array_equal(np.asarray(got)[sure], ref_tokens.astype(np.int64)[sure])


def test_bf16_prefill_and_write_match_jax(jax_bf16):
    ref, sd, cfg = jax_bf16
    k, v, n, logits = decode.prefill(sd, ref["tokens"], ref["lengths"], cfg)
    np.testing.assert_allclose(f32(k), ref["pk"], atol=BF16_ATOL)
    np.testing.assert_allclose(f32(v), ref["pv"], atol=BF16_ATOL)
    np.testing.assert_allclose(f32(logits), ref["pl"], atol=BF16_ATOL)
    _tokens_agree(n.numpy(), ref["pn"], ref["pl"])
    kc, vc = decode.init_kv_cache(cfg, 5, 32, device="cpu")
    decode.write_slots(kc, vc, k, v, [0, 1, 2, 3])
    np.testing.assert_allclose(f32(kc), ref["wk"], atol=BF16_ATOL)
    np.testing.assert_allclose(f32(vc), ref["wv"], atol=BF16_ATOL)


def test_bf16_decode_steps_match_jax(jax_bf16):
    """Each tick is fed JAX's tokens and positions, so a near tie broken the
    other way on one side cannot carry into the next tick's inputs."""
    ref, sd, cfg = jax_bf16
    kc, vc = decode.init_kv_cache(cfg, 5, 32, device="cpu")
    decode.prefill_into_slots(sd, kc, vc, ref["tokens"], ref["lengths"], [0, 1, 2, 3], cfg)
    for t in range(3):
        _, _, n, logits = decode.decode_step(sd, kc, vc, ref[f"in{t}"].astype(np.int64),
                                             ref[f"pos{t}"].astype(np.int64), cfg)
        np.testing.assert_allclose(f32(logits), ref[f"dl{t}"], atol=BF16_ATOL)
        np.testing.assert_allclose(f32(kc), ref[f"dk{t}"], atol=BF16_ATOL)
        np.testing.assert_allclose(f32(vc), ref[f"dv{t}"], atol=BF16_ATOL)
        _tokens_agree(n.numpy(), ref[f"dn{t}"], ref[f"dl{t}"])


def test_bf16_reference_is_bf16(jax_bf16):
    """The child really computed in bf16: its K/V are bf16 values (the f32
    npz holds them exactly) and differ from an f32 prefill of the same
    weights by more than f32 noise."""
    ref, sd, cfg = jax_bf16
    assert np.array_equal(ref["pk"], torch.from_numpy(ref["pk"]).bfloat16().float().numpy())
    k32 = decode.prefill(sd, ref["tokens"], ref["lengths"],
                         dataclasses.replace(cfg, dtype=torch.float32))[0]
    assert np.abs(f32(k32) - ref["pk"]).max() > 1e-3
    assert cfg.num_heads == 2 and cfg.head_dim == 16
