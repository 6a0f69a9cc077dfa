"""The port's GPipe pipeline (parallel/pipeline.py), on the CPU.

The claims of tests/test_pipeline.py, in one two-process gloo world at
pp = 2 (tests/torch_pipeline.py, started as the operator starts pods):
pipeline_apply's output and gradients equal the sequential run of the same
stages (M = 2, 4, 8), remat gives the same numbers, a bad microbatch count
and a stage count off the pp size raise, the schedule takes M + S - 1
ticks, the pipelined LM's logits equal the JAX make_pipelined_lm's on
carried weights (f32) and the unpipelined port LM's, and its loss
decreases with the replicas equal. The rest needs no world: the
single-stage path, the layer-count refusal, the rule table.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import transformer as jtfm
from tf_operator_tpu.parallel import mesh as jmesh
from tf_operator_tpu.parallel import pipeline as jpl
from tf_operator_tpu_torch.models import transformer as tfm
from tf_operator_tpu_torch.parallel import mesh as mesh_lib
from tf_operator_tpu_torch.parallel import pipeline as pl
from tf_operator_tpu_torch.parallel import sharding_rules

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))

from torch_dist import PY, ROOT, free_port  # noqa: E402
from torch_pipeline import LM_CFG, WIDTH, mlp_stage, sequential  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The two ranks' readings, and the JAX pipelined LM's logits on the
    weights both sides were given."""
    tmp = tmp_path_factory.mktemp("pp")
    rng = np.random.default_rng(0)
    inputs = {"w": (rng.standard_normal((2, WIDTH, WIDTH)) * 0.3).astype(np.float32),
              "b": (rng.standard_normal((2, WIDTH)) * 0.1).astype(np.float32)}
    for m in (2, 4, 8):
        inputs[f"x{m}"] = rng.standard_normal((m * 4, WIDTH)).astype(np.float32)
    jcfg = jtfm.TransformerConfig(**{**LM_CFG, "dtype": jnp.float32})
    mesh = jmesh.make_mesh({"pp": 2}, devices=jax.devices()[:2])
    init, _, apply_fn = jpl.make_pipelined_lm(jcfg, mesh, num_microbatches=2)
    params = jax.device_get(init(jax.random.key(0)))
    tokens = rng.integers(0, jcfg.vocab_size, (4, jcfg.max_len)).astype(np.int32)
    want = np.asarray(apply_fn(params, jnp.asarray(tokens)))
    inputs["tokens"] = tokens
    inputs.update({f"lm/{k}": v.numpy() for k, v in pl.params_from_flax(params).items()})
    np.savez(tmp / "inputs.npz", **inputs)
    port, procs = free_port(), []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "TPUJOB_"))}
        env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                   JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_PROCESS_ID=str(rank),
                   JAX_NUM_PROCESSES="2", TPUJOB_MESH=json.dumps({"pp": 2}))
        procs.append(subprocess.Popen(
            [PY, str(TESTS / "torch_pipeline.py"), str(tmp / "inputs.npz"),
             str(tmp / f"rank{rank}.json")], env=env, cwd=tmp, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True))
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=240)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), [e[-3000:] for e in errs]
    ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]
    return {"ranks": ranks, "jax_logits": want,
            "logits": np.load(tmp / "rank0.json.logits.npy")}


@pytest.mark.parametrize("m", [2, 4, 8])
def test_output_and_grads_match_sequential(world, m):
    for r in world["ranks"]:
        got = r[f"m{m}"]
        assert got["out"] <= 1e-5 * max(1.0, got["out_scale"]), got
        assert got["grads"] <= 1e-5 * max(1.0, got["grad_scale"]), got


def test_remat_same_numerics(world):
    for r in world["ranks"]:
        np.testing.assert_allclose(r["remat"]["remat_out"], r["m4"]["remat_out"],
                                   rtol=1e-6, atol=1e-6)
        assert r["remat"]["grads"] <= 1e-5 * max(1.0, r["remat"]["grad_scale"])


def test_bad_microbatch_count(world):
    for r in world["ranks"]:
        assert "not divisible" in r["bad_microbatches"]
        assert "must match" in r["stages_vs_pp"]


@pytest.mark.parametrize("s,m", [(2, 2), (2, 4), (4, 8), (3, 1)])
def test_schedule_takes_m_plus_s_minus_1_ticks(s, m):
    ticks = pl.gpipe_schedule(s, m)
    assert len(ticks) == m + s - 1
    for stage in range(s):
        mine = [(t, mb) for t, tick in enumerate(ticks) for st, mb in tick if st == stage]
        assert [mb for _, mb in mine] == list(range(m))
        assert [t for t, _ in mine] == list(range(stage, stage + m))
    assert pl.bubble_fraction(s, m) == pytest.approx((s - 1) / (m + s - 1))


def test_each_rank_runs_its_stage_once_a_microbatch(world):
    for r in world["ranks"]:
        for m in (2, 4, 8):
            assert r[f"m{m}"]["stage_calls"] == m and r[f"m{m}"]["rows"] == [4]


def test_pipelined_lm_matches_jax(world):
    """f32 logits of the port's pipelined LM equal the JAX
    make_pipelined_lm's on carried weights, and the unpipelined port LM's
    on the same weights (lm_state_dict)."""
    np.testing.assert_allclose(world["logits"], world["jax_logits"], rtol=1e-4, atol=1e-4)
    for r in world["ranks"]:
        assert r["lm_vs_unpipelined"] <= 1e-4


def test_trains_loss_decreases(world):
    for r in world["ranks"]:
        assert r["losses"][-1] < r["losses"][0], r["losses"]
        assert r["replicas_equal"]
    assert world["ranks"][0]["losses"] == world["ranks"][1]["losses"]


def test_degenerate_no_pp_axis():
    rng = np.random.default_rng(1)
    stacked = {"w": torch.from_numpy((rng.standard_normal((3, WIDTH, WIDTH)) * 0.3)
                                     .astype(np.float32)),
               "b": torch.zeros(3, WIDTH)}
    x = torch.from_numpy(rng.standard_normal((4, WIDTH)).astype(np.float32))
    for mesh in (None, mesh_lib.Mesh({"dp": 1})):
        got = pl.pipeline_apply(mlp_stage, stacked, x, mesh, num_microbatches=2)
        torch.testing.assert_close(got, sequential(stacked, x), rtol=1e-6, atol=1e-6)


def test_layer_count_must_divide():
    cfg = tfm.TransformerConfig(vocab_size=64, num_layers=3, hidden=32, num_heads=2,
                                max_len=32, causal=True)
    with pytest.raises(ValueError, match="not divisible"):
        pl.make_pipelined_lm(cfg, mesh_lib.Mesh({"pp": 2}), num_microbatches=2)


def test_params_from_flax_keeps_the_stack_and_maps_to_the_plain_lm():
    jcfg = jtfm.TransformerConfig(**{**LM_CFG, "dtype": jnp.float32, "num_layers": 4})
    mesh = jmesh.make_mesh({"pp": 2}, devices=jax.devices()[:2])
    init, _, _ = jpl.make_pipelined_lm(jcfg, mesh, num_microbatches=2)
    params = jax.device_get(init(jax.random.key(3)))
    state = pl.params_from_flax(params)
    model = pl.PipelinedLM(tfm.TransformerConfig(**{**LM_CFG, "num_layers": 4}),
                           mesh_lib.Mesh({"pp": 2}), 2)
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}
    kernel = np.asarray(params["stages"]["block_1"]["mlp_in"]["kernel"])
    np.testing.assert_array_equal(state["stages.block_1.mlp_in.weight"].numpy(),
                                  kernel.transpose(0, 2, 1))
    plain = pl.lm_state_dict(state, 4)
    np.testing.assert_array_equal(plain["trunk.layers.3.mlp_in.weight"].numpy(), kernel[1].T)
    assert set(plain) == set(tfm.TransformerLM(tfm.TransformerConfig(
        **{**LM_CFG, "num_layers": 4})).state_dict())


@pytest.mark.parametrize("tp", [False, True])
def test_pipeline_rules_give_the_jax_specs(tp):
    """The JAX table through the port's rule machinery: every parameter's
    spec equals the JAX sharding_for of its flax path and shape (on a pp x
    tp mesh), in the port's dimension order; the stage stacks lead with
    pp."""
    from tf_operator_tpu.parallel import sharding_rules as jrules

    mesh = jmesh.make_mesh({"pp": 2, "tp": 2}, devices=jax.devices()[:4])
    jcfg = jtfm.TransformerConfig(**{**LM_CFG, "dtype": jnp.float32})
    init, _, _ = jpl.make_pipelined_lm(jcfg, mesh, num_microbatches=2)
    params = jax.eval_shape(init, jax.random.key(0))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        spec = jrules.sharding_for(jrules.path_str(path), leaf.shape, mesh,
                                   jpl.pipeline_rules(tp=tp)).spec
        want[jrules.path_str(path)] = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
    model = pl.PipelinedLM(tfm.TransformerConfig(**LM_CFG), mesh_lib.Mesh({"pp": 2}), 2)
    got = sharding_rules.tree_shardings(model, {"pp": 2, "tp": 2}, pl.pipeline_rules(tp=tp))
    layout = sharding_rules.param_layout(model)
    for name, spec in got.items():
        path, perm = layout[name]
        flax_path = {"embed/embedding": "embed/embed/embedding",
                     "pos_embed/embedding": "embed/pos_embed/embedding",
                     "ln_f/scale": "head/ln_f/scale", "ln_f/bias": "head/ln_f/bias",
                     "lm_head/kernel": "head/lm_head/kernel"}.get(path, path)
        assert sharding_rules.to_port_order(want[flax_path], perm) == spec, (name, spec)
        if name.startswith("stages."):
            assert spec[0] == "pp", (name, spec)
    assert len(got) == len(want)
