"""The PyTorch port's train step and trainer, on CPU.

Step parity: from the same flax init (carried across by params_from_flax)
and the same numpy batches, the port's train_step follows the JAX
package's make_train_step (1-device CPU mesh): five TINY_LM steps, and
three steps of a tiny ResNet whose batch-norm running statistics are the
model state, at rtol 1e-4 in f32 compute with f32 AdamW. bf16 compute with
master weights is held at rtol 2e-3 (bf16 rounding at different places on
the two sides; 2.1e-4 was seen on the LM), ResNet's running statistics at
5e-3 of their scale (the test says why). The trainer runs as a pod would
run it, in a subprocess with TPUJOB_METRICS_FILE and TPUJOB_HEARTBEAT_FILE
set.
"""

import ast
import dataclasses
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
from tf_operator_tpu.models import mnist as jmnist
from tf_operator_tpu.models import resnet as jresnet
from tf_operator_tpu.models import transformer as jtfm
from tf_operator_tpu.parallel import mesh as mesh_lib
from tf_operator_tpu.parallel import train_step as jts
from tf_operator_tpu_torch import optim
from tf_operator_tpu_torch.models import mnist, resnet, train
from tf_operator_tpu_torch.models import transformer as tfm
from tf_operator_tpu_torch.parallel import train_step as ts

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
T, BATCH, STEPS = 64, 2, 5
TINY_ARGS = ["--device", "cpu", "--model", "transformer-lm", "--batch", "2", "--seq",
             "64", "--layers", "2", "--hidden", "128", "--heads", "4"]


def _batches():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 1024, (BATCH, T)).astype(np.int32) for _ in range(STEPS)]


def _trajectories(dtype_name: str, opt_kw: dict):
    jcfg = dataclasses.replace(jtfm.TINY_LM, dtype=getattr(jnp, dtype_name))
    jmodel = jtfm.TransformerLM(jcfg)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, T), jnp.int32))["params"]

    def jloss(p, model_state, batch, rng):
        logits = jmodel.apply({"params": p}, batch["tokens"])
        return jtfm.lm_loss(logits, batch["tokens"]), model_state

    jtx = joptim.make_optimizer(joptim.OptimizerConfig(**opt_kw))
    mesh = mesh_lib.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    step, _ = jts.make_train_step(jloss, jtx, mesh)
    step = jax.jit(step)
    jstate = jts.create_train_state(params, jtx)

    tcfg = dataclasses.replace(tfm.TINY_LM, dtype=getattr(torch, dtype_name))
    tmodel = tfm.TransformerLM(tcfg)
    tmodel.load_state_dict(tfm.params_from_flax(jax.tree.map(np.array, params)))
    ttx = optim.make_optimizer(optim.OptimizerConfig(**opt_kw))
    tstate = ts.create_train_state(tmodel, ttx)

    def tloss(model, batch):
        return tfm.lm_loss(model(batch["tokens"]), batch["tokens"])

    out = {"jax": [], "torch": [], "jax_gn": [], "torch_gn": []}
    for b in _batches():
        jstate, jm = step(jstate, {"tokens": jnp.asarray(b)}, jax.random.key(0))
        tstate, tm = ts.train_step(tstate, {"tokens": torch.from_numpy(b).long()}, tloss, ttx)
        out["jax"].append(float(jm["loss"]))
        out["torch"].append(float(tm["loss"]))
        out["jax_gn"].append(float(jm["grad_norm"]))
        out["torch_gn"].append(float(tm["grad_norm"]))
    assert tstate.step == STEPS
    return out


def test_five_step_trajectory_f32():
    out = _trajectories("float32", {"learning_rate": 1e-2})
    assert out["torch"][-1] < out["torch"][0]
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=1e-4)
    np.testing.assert_allclose(out["torch_gn"], out["jax_gn"], rtol=1e-4)


def test_five_step_trajectory_bf16_master_weights():
    out = _trajectories("bfloat16", {"learning_rate": 1e-2, "moment_dtype": "bf16",
                                     "master_weights": True})
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=2e-3)


RN_SIZE, RN_STEPS = 32, 3


def _rn_batches():
    rng = np.random.default_rng(0)
    return [(rng.standard_normal((BATCH, RN_SIZE, RN_SIZE, 3)).astype(np.float32),
             rng.integers(0, 10, BATCH)) for _ in range(RN_STEPS)]


def _jax_resnet_trajectory(dtype_name: str, opt_kw: dict, out_path: str) -> None:
    """RN_STEPS steps of a [1, 1]-stage, width-8 ResNet through the JAX
    make_train_step; saves to out_path the init (port names, "init/...")
    and, after the steps, the losses and the running statistics."""
    jmodel = jresnet.ResNet(stage_sizes=[1, 1], width=8, num_classes=10,
                            dtype=getattr(jnp, dtype_name))
    params, stats = jresnet.init_resnet(jmodel, jax.random.key(0), image_size=RN_SIZE)
    init = resnet.params_from_flax(jax.tree.map(np.array, params),
                                   jax.tree.map(np.array, stats))

    def jloss(p, model_state, batch, rng):
        logits, mut = jmodel.apply({"params": p, **model_state}, batch["x"], train=True,
                                   mutable=["batch_stats"])
        return jmnist.cross_entropy_loss(logits, batch["y"]), dict(mut)

    jtx = joptim.make_optimizer(joptim.OptimizerConfig(**opt_kw))
    mesh = mesh_lib.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    step, _ = jts.make_train_step(jloss, jtx, mesh)
    step = jax.jit(step)
    state = jts.create_train_state(params, jtx, model_state={"batch_stats": stats})
    losses = []
    for x, y in _rn_batches():
        state, m = step(state, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, jax.random.key(0))
        losses.append(float(m["loss"]))
    final = resnet.params_from_flax({}, jax.tree.map(
        np.array, state.model_state["batch_stats"]))
    np.savez(out_path, losses=np.array(losses),
             **{f"init/{k}": v.numpy() for k, v in init.items()},
             **{f"stats/{k}": v.numpy() for k, v in final.items()})


# Adam's eps is 1e-3 here, not 1e-8: a few gradients of this net are ~1e-7
# of noise (stem_bn.bias at a channel the relu nearly closes), their sign
# differs between the two frameworks, and with eps 1e-8 Adam's first step
# turns each into a full +-lr move, so the two trajectories part there.
# With eps 1e-3 such a gradient moves nothing, while the real ones (>=1e-2)
# still take Adam-sized steps.
#
# The JAX side runs in a child process with XLA's excess precision off.
# XLA:CPU otherwise keeps the bf16 intermediates of a fusion in f32 (the
# batch norm's (x - m) * a + b, the relu and the residual add round once),
# where the JAX code as written, and the port, round each op to bf16: with
# it on, the bf16 losses part by 3.2e-3 at step 3; with it off, step 1
# agrees bit for bit and step 3 within 6.4e-4. f32 is not affected.
#
# The running statistics are held at stats_rtol of their scale. In bf16
# each side rounds its own f32 master weights to the compute copy, and a
# master weight a hair apart may round one bf16 step (0.4%) the other
# way, which moves a conv output's mean by ~1e-3 of its scale (3.3e-3 was
# seen): 5e-3 in bf16, 1e-4 in f32.
RN_CASES = {  # dtype -> (optimizer config, loss rtol, statistics rtol)
    "float32": ({"learning_rate": 1e-2, "eps": 1e-3}, 1e-4, 1e-4),
    "bfloat16": ({"learning_rate": 1e-2, "eps": 1e-3, "moment_dtype": "bf16",
                  "master_weights": True}, 2e-3, 5e-3),
}


@pytest.fixture(scope="module")
def jax_resnet_refs(tmp_path_factory):
    """{dtype: path of the JAX trajectory's npz}, both from one child."""
    out = tmp_path_factory.mktemp("jax_resnet")
    paths = {dt: str(out / f"{dt}.npz") for dt in RN_CASES}
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'tests')!r}]\n"
            "import test_torch_train as t\n"
            f"for dt, path in {paths!r}.items():\n"
            "    t._jax_resnet_trajectory(dt, t.RN_CASES[dt][0], path)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return paths


@pytest.mark.parametrize("dtype_name", list(RN_CASES))
def test_resnet_trajectory_and_running_stats(jax_resnet_refs, dtype_name):
    opt_kw, rtol, stats_rtol = RN_CASES[dtype_name]
    ref = np.load(jax_resnet_refs[dtype_name])

    model = resnet.ResNet([1, 1], num_classes=10, width=8, dtype=getattr(torch, dtype_name))
    model.load_state_dict({k[len("init/"):]: torch.from_numpy(ref[k])
                           for k in ref.files if k.startswith("init/")})
    tx = optim.make_optimizer(optim.OptimizerConfig(**opt_kw))
    state = ts.create_train_state(model, tx)

    def loss_fn(model, batch):
        return mnist.cross_entropy_loss(model(batch["x"]), batch["y"])

    losses = []
    for x, y in _rn_batches():
        state, m = ts.train_step(state, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
                                 loss_fn, tx)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, ref["losses"], rtol=rtol)
    stats = dict(state.model.named_buffers())
    assert {f"stats/{k}" for k in stats} == {k for k in ref.files if k.startswith("stats/")}
    for name, buf in stats.items():
        # The statistics stay f32 under master weights, as JAX's model_state.
        assert buf.dtype == torch.float32, name
        # A running mean is held against its channel's scale, sqrt(var):
        # the means here (~5e-3) are what is left after the +-1 activations
        # cancel, so their own size is no scale for their error.
        want = ref[f"stats/{name}"]
        scale = np.abs(want)
        if name.endswith(".mean"):
            scale = np.maximum(scale, np.sqrt(ref[f"stats/{name[:-len('mean')]}var"]))
        err = np.abs(buf.numpy() - want)
        assert np.all(err <= stats_rtol * scale), (name, float((err / scale).max()))
    if opt_kw.get("master_weights"):
        assert all(p.dtype == torch.bfloat16 for p in state.params)


def test_master_weights_state_layout():
    model = tfm.TransformerLM(tfm.TINY_LM, generator=torch.Generator().manual_seed(0))
    init = [p.detach().clone() for p in model.parameters()]
    tx = optim.make_optimizer(optim.OptimizerConfig(moment_dtype="bf16", master_weights=True))
    state = ts.create_train_state(model, tx)
    for p, m, p0 in zip(state.params, state.opt_state.master, init):
        assert p.dtype == torch.bfloat16 and m.dtype == torch.float32
        torch.testing.assert_close(m, p0, rtol=0, atol=0)  # master from the f32 init


def test_chunking_does_not_change_the_stream():
    """Batches come from a generator seeded by (seed, global step): 2 + 3
    steps and 5 steps give the same parameters and last loss."""
    def run(chunks):
        model = tfm.TransformerLM(tfm.TINY_LM, attn_fn=None,
                                  generator=torch.Generator().manual_seed(0))
        tx = optim.make_optimizer(optim.OptimizerConfig())
        state = ts.create_train_state(model, tx)

        def make_batch(gen):
            return {"tokens": torch.randint(0, 1024, (BATCH, 32), generator=gen)}

        step = ts.make_chunked_train_step(
            lambda m, b: tfm.lm_loss(m(b["tokens"]), b["tokens"]), tx, make_batch, "cpu")
        for n in chunks:
            state, metrics = step(state, n)
        return state, float(metrics["loss"])

    (s1, l1), (s2, l2) = run([2, 3]), run([5])
    assert s1.step == s2.step == 5 and l1 == l2
    for a, b in zip(s1.params, s2.params):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _run_trainer(tmp_path, extra, env_extra=None):
    env = dict(os.environ, OMP_NUM_THREADS="2",
               TPUJOB_METRICS_FILE=str(tmp_path / "events.jsonl"),
               TPUJOB_HEARTBEAT_FILE=str(tmp_path / "hb.json"), **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "-m", "tf_operator_tpu_torch.models.train", *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_trainer_on_cpu_writes_events_and_heartbeat(tmp_path):
    proc = _run_trainer(tmp_path, ["--model", "transformer-lm", "--steps", "5",
                                   "--log-every", "2", "--moment-dtype", "bf16",
                                   "--master-weights", *TINY_ARGS])
    assert proc.returncode == 0, proc.stderr
    events = [json.loads(x) for x in (tmp_path / "events.jsonl").read_text().splitlines()]
    names = [e["event"] for e in events]
    assert names[:4] == ["start", "jax_ready", "model_ready", "first_step"]
    by = {e["event"]: e for e in events}
    first = by["first_step"]
    assert isinstance(first["startup_s"], float) and first["startup_s"] > 0
    assert first["backend"] == "cpu" and first["steps_in_first_call"] == 2
    assert by["jax_ready"]["backend"] == "cpu"
    progress = [e["step"] for e in events if e["event"] == "progress"]
    assert progress == [4, 5]
    done = by["done"]
    assert done["steps"] == 5 and math.isfinite(done["final_loss"])
    assert done["step_time_s"]["mean"] > 0 and done["phase_breakdown"]["steps"] == 2
    assert json.loads((tmp_path / "hb.json").read_text())["step"] == 5
    # Events also reach stdout, one JSON object per line.
    assert [json.loads(x)["event"] for x in proc.stdout.splitlines()] == names


@pytest.mark.parametrize("model,extra", [
    ("mnist-mlp", ["--batch", "8"]),
    ("resnet18", ["--batch", "2", "--image-size", "32"]),
])
def test_trainer_runs_vision_models_on_cpu(tmp_path, model, extra):
    proc = _run_trainer(tmp_path, ["--model", model, "--device", "cpu", "--steps", "3",
                                   "--log-every", "1", *extra])
    assert proc.returncode == 0, proc.stderr
    events = [json.loads(x) for x in (tmp_path / "events.jsonl").read_text().splitlines()]
    names = [e["event"] for e in events]
    assert names[:4] == ["start", "jax_ready", "model_ready", "first_step"]
    by = {e["event"]: e for e in events}
    assert by["start"]["model"] == model
    assert [e["step"] for e in events if e["event"] == "progress"] == [2, 3]
    done = by["done"]
    assert done["steps"] == 3 and math.isfinite(done["final_loss"])
    assert done["examples_per_sec"] > 0
    assert json.loads((tmp_path / "hb.json").read_text())["step"] == 3


def test_trainer_default_model_is_the_jax_trainers():
    assert train.build_parser().parse_args([]).model == "mnist-mlp"


def test_trainer_refuses_cuda_without_a_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the trainer would use it")
    proc = _run_trainer(tmp_path, TINY_ARGS[2:] + ["--steps", "1"])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "events.jsonl").exists()


@pytest.mark.parametrize("flag,env,says", [
    (["--model", "moe-lm", "--moe-dispatch", "sorted"], {}, ["invalid choice", "--moe-dispatch"]),
    (["--xla-option", "a=b"], {}, ["unrecognized arguments", "--xla-option"]),
    ([], {"TPUJOB_NUM_SLICES": "2"},
     ["TPUJOB_NUM_SLICES=2 but TPUJOB_DCN_DIR is unset: the cross-slice exchange needs a "
      "shared rendezvous directory"]),
    (["--model", "transformer-lm", "--seq", "33"],
     {"JAX_NUM_PROCESSES": "2", "TPUJOB_MESH": '{"sp": 2}'}, ["sp=2 does not divide --seq 33"]),
    (["--model", "transformer-lm", "--heads", "3", "--hidden", "96", "--seq", "32"],
     {"JAX_NUM_PROCESSES": "2", "TPUJOB_MESH": '{"sp": 2}', "TPUJOB_SP_MODE": "ulysses"},
     ["ulysses needs local heads (3) divisible by sp=2; use ring attention"]),
    (["--model", "bert-tiny", "--seq", "32"],
     {"JAX_NUM_PROCESSES": "8", "TPUJOB_MESH": '{"sp": 4, "tp": 2}',
      "TPUJOB_SP_MODE": "ulysses"},
     ["ulysses needs local heads (2) divisible by sp=4"]),
    (["--data-dir", "/nonexistent"], {"JAX_NUM_PROCESSES": "2", "TPUJOB_MESH": '{"sp": 2}'},
     ["--data-dir under sp=2"]),
    (["--model", "resnet18"], {"TPUJOB_NUM_SLICES": "2", "TPUJOB_DCN_DIR": "dcn"},
     ["--model resnet18 carries mutable model state (batch stats), which does not cross the "
      "DCN exchange"]),
    (["--data-dir", "/nonexistent"], {"TPUJOB_NUM_SLICES": "2", "TPUJOB_DCN_DIR": "dcn"},
     ["multi-slice training (TPUJOB_NUM_SLICES > 1) drives the synthetic on-device batch "
      "path; --data-dir is not supported yet"]),
    ([], {"JAX_NUM_PROCESSES": "2", "TPUJOB_MESH": '{"dp": 4}'},
     ["mesh axes {'dp': 4} need 4 devices, have 2"]),
    (["--heads", "3", "--hidden", "96"], {"JAX_NUM_PROCESSES": "2", "TPUJOB_MESH": '{"tp": 2}'},
     ["tp=2 does not divide the 3 attention heads"]),
    (["--batch", "3"], {"JAX_NUM_PROCESSES": "2"}, ["global batch 3 not divisible by dp size 2"]),
])
def test_trainer_refuses_what_is_not_ported(flag, env, says, capsys, monkeypatch):
    """A dispatch the JAX trainer does not have and a JAX-only flag; a
    multi-slice job without its exchange directory, with a model of
    mutable state (ResNet's batch statistics) or with --data-dir (the JAX
    messages), a mesh whose axes do not multiply to the process count, a
    tp that splits a head, a global batch the data axes do not divide, a
    sequence sp does not divide, Ulysses forced on local heads sp does not
    divide (the JAX message) and --data-dir under sp, by the operator's
    env: exit 2 before any event, with a message naming what is wrong."""
    argv = list(TINY_ARGS) + flag
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    with pytest.raises(SystemExit) as e:
        train.main(argv)
    assert e.value.code == 2
    out = capsys.readouterr()
    assert all(s in out.err for s in says), out.err
    assert '"event"' not in out.out


def test_a_two_process_job_trains_one_model(tmp_path):
    """Two Workers of a job, as the operator starts them (no TPUJOB_MESH:
    pure dp over the two processes), train one model: the same loss on
    both ranks at every step, the first one (before any update) the
    one-process run's, the events' mesh {dp: 2}, and both exit 0 after the
    closing barrier. A one-process job's JAX_NUM_PROCESSES=1 trains alone.
    tests/test_torch_dist_*.py hold whole trajectories at f32."""
    from torch_dist import assert_ok, progress_losses, run_world

    argv = ["--model", "mnist-mlp", "--device", "cpu", "--steps", "3", "--batch", "8",
            "--log-every", "1"]
    two = run_world(tmp_path, argv, 2, f32=False, tag="two")
    one = run_world(tmp_path, argv, 1, f32=False, env={"JAX_NUM_PROCESSES": "1"}, tag="one")
    assert_ok(two + one)
    assert progress_losses(two[0]["events"]) == progress_losses(two[1]["events"])
    firsts = [next(e for e in r["events"] if e["event"] == "first_step") for r in two + one]
    assert [f["mesh"] for f in firsts] == [{"dp": 2}, {"dp": 2}, {"dp": 1}]
    np.testing.assert_allclose(firsts[0]["loss"], firsts[2]["loss"], rtol=1e-5)


@pytest.mark.parametrize("axis", ["data", "pp"])
def test_a_data_or_pp_world_of_two_trains_as_one_process(tmp_path, axis):
    """TPUJOB_MESH {"data": 2} splits the batch as dp does (the outermost
    data axis); {"pp": 2} is the JAX trainer's replicated axis (both ranks
    train on the whole batch). Either world of two follows one process at
    the same global batch (f32, rtol 1e-5) and reports its mesh."""
    from torch_dist import assert_ok, progress_losses, run_world

    argv = ["--model", "mnist-mlp", "--device", "cpu", "--steps", "3", "--batch", "8",
            "--log-every", "1"]
    two = run_world(tmp_path, argv, 2, mesh={axis: 2}, tag=axis)
    one = run_world(tmp_path, argv, 1, tag="one")
    assert_ok(two + one)
    want = progress_losses(one[0]["events"])
    for r in two:
        got = progress_losses(r["events"])
        assert sorted(got) == sorted(want) == [2, 3]
        np.testing.assert_allclose([got[s] for s in want], list(want.values()), rtol=1e-5)
        first = next(e for e in r["events"] if e["event"] == "first_step")
        assert first["mesh"] == {axis: 2}


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tf_operator_tpu")


def test_import_hygiene_in_a_fresh_process():
    code = (
        "import json, pkgutil, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import tf_operator_tpu_torch, tf_operator_tpu_torch.models.train, chip_smoke\n"
        "names = [m.name for m in pkgutil.walk_packages(tf_operator_tpu_torch.__path__,\n"
        "                                                 'tf_operator_tpu_torch.')]\n"
        "assert 'tf_operator_tpu_torch.data.staging' in names, names\n"
        "assert {'tf_operator_tpu_torch.parallel.' + m for m in ('distributed', 'mesh',\n"
        "        'sharding_rules', 'collectives', 'train_step', 'ring_attention',\n"
        "        'ulysses', 'multislice', 'pipeline', 'launch',\n"
        "        'graphed_step', 'peer_watch')} <= set(names), names\n"
        "assert {'tf_operator_tpu_torch.models.moe',\n"
        "        'tf_operator_tpu_torch.ops.grouped_matmul'} <= set(names), names\n"
        "assert {'tf_operator_tpu_torch.serve.server', 'tf_operator_tpu_torch.models.decode',\n"
        "        'tf_operator_tpu_torch.serve.decode_graphs',\n"
        "        'tf_operator_tpu_torch.status.metrics'} <= set(names), names\n"
        "for name in names:\n"
        "    __import__(name)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(json.dumps(bad))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=ROOT / "tests")
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.splitlines()[-1]) == []


def test_import_hygiene_ast_scan():
    # The port, chip_smoke.py and the tools that time the port's trainers
    # and servers on the card.
    tools = [ROOT / "tools" / f"{name}_cells.py"
             for name in ("graph", "serve", "world", "phase")]
    files = sorted((ROOT / "tf_operator_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    files += tools
    assert len(files) > 10 and all(path.exists() for path in tools)
    for name in ("dataset", "prefetch", "staging"):
        assert ROOT / "tf_operator_tpu_torch" / "data" / f"{name}.py" in files
    for name in ("distributed", "mesh", "sharding_rules", "collectives", "train_step",
                 "ring_attention", "ulysses", "multislice", "pipeline", "launch",
                 "graphed_step", "peer_watch"):
        assert ROOT / "tf_operator_tpu_torch" / "parallel" / f"{name}.py" in files
    for name in ("models/moe.py", "ops/grouped_matmul.py", "serve/server.py", "models/decode.py",
                 "serve/decode_graphs.py", "status/metrics.py"):
        assert ROOT / "tf_operator_tpu_torch" / name in files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"
