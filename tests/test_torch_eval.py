"""The PyTorch port's Evaluator (--eval, --eval-timeout), on CPU.

The evaluator follows --checkpoint-dir to FINAL, restores each step's
parameters and evaluates them on fixed batches (batch i from a generator
seeded 10_000 + i, every round the same), emitting one `eval` per step and
`eval_done`, and exits 0; without --checkpoint-dir it exits 2; a SIGTERM
ends its wait with the evaluator's `preempted` event and exit 143; with no
checkpoint before the timeout it exits 1. On the same numpy parameters and
batches its eval_loss (train.evaluate, rounded to 6 places as the event
carries it) is the JAX evaluator's (the mean of the JAX loss over the
batches) at the f32 tolerance of the models' parity tests (atol 1e-5 for
MNIST, 1e-4 for the LM and BERT).
"""

import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import mnist as jmnist
from tf_operator_tpu.models import transformer as jtfm
from tf_operator_tpu_torch.models import checkpoint as ckpt
from tf_operator_tpu_torch.models import mnist, train
from tf_operator_tpu_torch.models import transformer as tfm


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module's tests and fixtures
    (tests/test_torch_flash_attention.py
    says why: a first multi-threaded torch.exp can be off by 1.5e-4, which
    bit-for-bit checks would see)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
MNIST = ["--device", "cpu", "--model", "mnist-mlp", "--batch", "8", "--log-every", "2"]


def _main(tmp_path, monkeypatch, argv, tag):
    path = tmp_path / f"{tag}.jsonl"
    monkeypatch.setenv("TPUJOB_METRICS_FILE", str(path))
    rc = train.main(argv)
    return rc, [json.loads(x) for x in path.read_text().splitlines()]


def test_evaluator_follows_the_checkpoints_to_final(tmp_path, monkeypatch):
    d = str(tmp_path / "ckpt")
    out: dict = {}
    monkeypatch.setenv("TPUJOB_METRICS_FILE", str(tmp_path / "train.jsonl"))
    assert train.main(MNIST + ["--steps", "6", "--checkpoint-dir", d,
                               "--checkpoint-every", "2"], out) == 0
    rc, events = _main(tmp_path, monkeypatch, MNIST + ["--steps", "3", "--eval",
                                                      "--checkpoint-dir", d,
                                                      "--eval-timeout", "10"], "eval")
    assert rc == 0
    evals = [e for e in events if e["event"] == "eval"]
    assert [e["checkpoint_step"] for e in evals] == [2, 4, 6]
    assert all(e["n_batches"] == 3 for e in evals)
    assert events[-1] == {"event": "eval_done", "checkpoints_evaluated": 3}
    assert not any(e["event"] in ("model_ready", "done") for e in events)
    # The last round evaluates the final parameters on the fixed batches.
    args = train.build_parser().parse_args(MNIST + ["--steps", "3"])
    _, loss_fn, make_batch = train._build_model(args, torch.device("cpu"))
    here = train.evaluate(out["state"].model, loss_fn, make_batch, torch.device("cpu"), 3)
    assert evals[-1]["eval_loss"] == round(here, 6)


def test_eval_without_a_checkpoint_dir_exits_2(tmp_path, monkeypatch, capsys):
    rc, events = _main(tmp_path, monkeypatch, MNIST + ["--eval"], "noeval")
    assert rc == 2 and "--eval requires --checkpoint-dir" in capsys.readouterr().err
    assert not any(e["event"] == "eval" for e in events)


def test_no_checkpoint_before_the_timeout_exits_1(tmp_path, monkeypatch):
    rc, events = _main(tmp_path, monkeypatch, MNIST + ["--eval", "--checkpoint-dir",
                                                      str(tmp_path / "empty"),
                                                      "--eval-timeout", "0.5"], "timeout")
    assert rc == 1 and not any(e["event"] == "eval_done" for e in events)


def test_sigterm_gives_the_evaluators_preempted_event(tmp_path):
    events = tmp_path / "events.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT), TPUJOB_METRICS_FILE=str(events),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-m", "tf_operator_tpu_torch.models.train",
                             *MNIST, "--eval", "--checkpoint-dir", str(tmp_path / "ckpt"),
                             "--eval-timeout", "120"], cwd=tmp_path, env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and "jax_ready" not in (
                events.read_text() if events.exists() else ""):
            time.sleep(0.1)
        time.sleep(0.3)  # into the checkpoint wait
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    finally:
        proc.kill()
    assert rc == 143
    pre = [json.loads(x) for x in events.read_text().splitlines()
           if json.loads(x)["event"] == "preempted"]
    assert pre == [{"event": "preempted", "role": "evaluator", "signal": "SIGTERM",
                    "exit_code": 143, "checkpoints_evaluated": 0}]


def _jax_mnist(params, batches):
    model = jmnist.MLP()
    return [float(jmnist.cross_entropy_loss(model.apply({"params": params}, jnp.asarray(x)),
                                            jnp.asarray(y))) for x, y in batches]


def _jax_lm(params, batches, cfg):
    model = jtfm.TransformerLM(cfg)
    return [float(jtfm.lm_loss(model.apply({"params": params}, jnp.asarray(t)), jnp.asarray(t)))
            for (t,) in batches]


def _jax_bert(params, batches, cfg):
    model = jtfm.BertMLM(cfg)
    return [float(jtfm.mlm_loss(model.apply({"params": params}, jnp.asarray(t)),
                                jnp.asarray(tg), jnp.asarray(m))) for t, tg, m in batches]


@pytest.mark.parametrize("model_name", ["mnist-mlp", "transformer-lm", "bert-tiny"])
def test_eval_loss_is_the_jax_evaluators(model_name):
    rng = np.random.default_rng(7)
    if model_name == "mnist-mlp":
        params = jmnist.MLP().init(jax.random.key(3), jnp.zeros((1, 28, 28)))["params"]
        batches = [(rng.standard_normal((8, 28, 28)).astype(np.float32),
                    rng.integers(0, 10, 8).astype(np.int32)) for _ in range(3)]
        want = _jax_mnist(params, batches)
        model = mnist.MLP()
        model.load_state_dict(mnist.params_from_flax(jax.tree.map(np.array, params)))

        def loss_fn(m, b):
            return mnist.cross_entropy_loss(m(b["x"]), b["y"])

        def to_batch(b):
            return {"x": torch.from_numpy(b[0]), "y": torch.from_numpy(b[1]).long()}
        atol = 1e-5
    elif model_name == "bert-tiny":
        jcfg = dataclasses.replace(jtfm.TINY, dtype=jnp.float32, max_len=64)
        params = jtfm.BertMLM(jcfg).init(jax.random.key(3),
                                         jnp.zeros((1, 64), jnp.int32))["params"]
        batches = []
        for _ in range(3):
            targets = rng.integers(0, 1024, (2, 64)).astype(np.int32)
            mask = (rng.random((2, 64)) < 0.15).astype(np.float32)
            batches.append((np.where(mask > 0, 103, targets).astype(np.int32), targets, mask))
        want = _jax_bert(params, batches, jcfg)
        model = tfm.BertMLM(dataclasses.replace(tfm.TINY, dtype=torch.float32, max_len=64))
        model.load_state_dict(tfm.params_from_flax(jax.tree.map(np.array, params)))

        def loss_fn(m, b):
            return tfm.mlm_loss(m(b["tokens"]), b["targets"], b["mask"])

        def to_batch(b):
            return {"tokens": torch.from_numpy(b[0]).long(), "targets": torch.from_numpy(b[1]),
                    "mask": torch.from_numpy(b[2])}
        atol = 1e-4
    else:
        jcfg = dataclasses.replace(jtfm.TINY_LM, dtype=jnp.float32, max_len=64)
        params = jtfm.TransformerLM(jcfg).init(jax.random.key(3),
                                               jnp.zeros((1, 64), jnp.int32))["params"]
        batches = [(rng.integers(0, 1024, (2, 64)).astype(np.int32),) for _ in range(3)]
        want = _jax_lm(params, batches, jcfg)
        model = tfm.TransformerLM(dataclasses.replace(tfm.TINY_LM, dtype=torch.float32,
                                                      max_len=64))
        model.load_state_dict(tfm.params_from_flax(jax.tree.map(np.array, params)))

        def loss_fn(m, b):
            return tfm.lm_loss(m(b["tokens"]), b["tokens"])

        def to_batch(b):
            return {"tokens": torch.from_numpy(b[0]).long()}
        atol = 1e-4
    seeds = []

    def make_batch(gen):
        seeds.append(gen.initial_seed())
        return to_batch(batches[len(seeds) - 1])

    got = train.evaluate(model, loss_fn, make_batch, torch.device("cpu"), len(batches))
    assert seeds == [10_000, 10_001, 10_002]  # the JAX evaluator's batch keys
    np.testing.assert_allclose(round(got, 6), round(sum(want) / len(want), 6), atol=atol)


def test_eval_reads_params_of_a_step_only(tmp_path, monkeypatch):
    """A params-only restore: the evaluator needs step_<N> alone, not the
    trainstate beside it."""
    d = tmp_path / "ckpt"
    monkeypatch.setenv("TPUJOB_METRICS_FILE", str(tmp_path / "train.jsonl"))
    assert train.main(MNIST + ["--steps", "2", "--checkpoint-dir", str(d)]) == 0
    for name in ("trainstate_2", "trainstate_2" + ckpt.MANIFEST_SUFFIX):
        path = d / name
        if path.is_dir():
            shutil.rmtree(path)
        else:
            path.unlink()
    rc, events = _main(tmp_path, monkeypatch, MNIST + ["--steps", "1", "--eval",
                                                      "--checkpoint-dir", str(d),
                                                      "--eval-timeout", "5"], "p")
    assert rc == 0 and [e["checkpoint_step"] for e in events if e["event"] == "eval"] == [2]
