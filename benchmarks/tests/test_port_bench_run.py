"""run.py: no card means no result, and a run with the timed path broken
underneath comes out not correct.

The fault runs skip run.py's look for a card and drive the rest of a run
(run_cell) on the CPU at a tiny size, with one fault planted in the program
each: a step that leaves its state unchanged, half of each batch left out
(the mean taken over the rest), one token altered where the batch is made;
the last two also from the second step on alone, as a fault in the replayed
graph would be (the first step is the graphed step's eager warm-up). A cell
on one card has no exchange between chips to leave out."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmarks import cells, run
from benchmarks.tests.tiny import tiny_cell
from tf_operator_tpu_torch import optim as optim_lib
from tf_operator_tpu_torch.models import train

ROOT = Path(__file__).resolve().parents[2]
CELLS = tuple(w["name"] for w in cells.benchmark()["workloads"])
SEED = 2 ** 31 + 101


def run_cli(cwd, *args, env=None):
    return subprocess.run([sys.executable, "benchmarks/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = run_cli(ROOT, "--workload", CELLS[0], "--seed", str(SEED), "--seconds",
                   "1", "--trace", "0", env=env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "torch.cuda.is_available() is false" in proc.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmarks", tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = run_cli(tmp_path, "--workload", CELLS[0], "--seed", "3", "--seconds", "1",
                   env=env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_an_unknown_cell_is_refused():
    proc = run_cli(ROOT, "--workload", "no-such-cell", "--seed", "1", "--seconds", "1")
    assert proc.returncode == 2
    assert "no-such-cell" in proc.stderr and proc.stdout.strip() == ""


def test_jax_modules_are_found_by_whole_top_level_name(monkeypatch):
    assert not [m for m in run.forbidden_modules() if m.startswith("tf_operator_tpu_torch")]
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "tf_operator_tpu.models", object())
    assert {"jax.numpy", "tf_operator_tpu.models"} <= set(run.forbidden_modules())


def _no_update(monkeypatch):
    real = optim_lib.make_optimizer

    def make(cfg):
        return real(cfg)._replace(update_in_place=lambda grads, state, params: None)

    monkeypatch.setattr(optim_lib, "make_optimizer", make)


def _half_batch(monkeypatch, from_step=1):
    real = train._build_model

    def build(args, device, mesh=None):
        model, loss_fn, make_batch = real(args, device, mesh)
        calls = []

        def half(model, batch):
            calls.append(1)
            if len(calls) < from_step:
                return loss_fn(model, batch)
            return loss_fn(model, {k: v[:v.shape[0] // 2] for k, v in batch.items()})

        return model, half, make_batch

    monkeypatch.setattr(train, "_build_model", build)


def _token_altered(monkeypatch, from_step=1):
    real = train._build_model

    def build(args, device, mesh=None):
        model, loss_fn, make_batch = real(args, device, mesh)
        calls = []

        def altered(g):
            batch = make_batch(g)
            calls.append(1)
            if len(calls) < from_step:
                return batch
            tokens = batch["tokens"].clone()
            tokens[0, 0] = (tokens[0, 0] + 1) % model.cfg.vocab_size
            return dict(batch, tokens=tokens)

        return model, loss_fn, altered

    monkeypatch.setattr(train, "_build_model", build)


FAULTS = {"state_unchanged": _no_update, "half_batch": _half_batch,
          "token_altered": _token_altered,
          "half_batch_from_step_2": lambda mp: _half_batch(mp, from_step=2),
          "token_altered_from_step_2": lambda mp: _token_altered(mp, from_step=2)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    result = run.run_cell(tiny_cell(name), SEED, 0.2, False, torch.device("cpu"))
    assert result["correct"] is False
    assert list(result)[-1] == "checks"
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct_and_prints_the_result_line(name):
    cell = tiny_cell(name)
    result = run.run_cell(cell, SEED, 0.2, False, torch.device("cpu"))
    assert result["correct"] is True
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "tokens_per_s", "step_ms_p95"}
    assert result["device"]["platform"] == "cpu"
    assert set(result["checks"]) == {k for k, v in cell["limits"].items() if v is not None}


def test_a_traced_run_on_the_cpu_reads_no_device_metric():
    """The traced window runs under the profiler on the CPU too; with no
    device operation it has no window, so every per-layer reader is silent."""
    result = run.run_cell(tiny_cell(CELLS[0]), SEED, 0.2, True, torch.device("cpu"))
    assert result["correct"] is True and result["metrics"] == {}
    assert "breakdown" not in result and "busy_s" not in result["device"]
