"""The PyTorch port's checkpoints (models/checkpoint.py) and the trainer's
save and resume legs, on CPU.

The directory functions are held against the JAX package's on copies of
the same directories; tree_digest against the JAX digest on the same
numpy trees. The trainer saves every 2 steps to step 4 and resumes to 6,
and must end bit for bit on the uninterrupted 6-step run (the LM, and
ResNet-18 with its batch-norm running statistics). A checkpoint written
by the JAX trainer's own save and read back with the JAX package's
restore is carried into the port's state (params_from_flax and
optim.state_from_jax); both sides then take 3 steps on the same numpy
batches and agree at the tolerances of tests/test_torch_train.py's
trajectory tests (f32 1e-4, bf16 with master weights 2e-3).
"""

import dataclasses
import json
import os
import shutil
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file

from tf_operator_tpu import optim as joptim
from tf_operator_tpu.models import checkpoint as jckpt
from tf_operator_tpu.models import train as jtrain
from tf_operator_tpu.models import transformer as jtfm
from tf_operator_tpu.parallel import mesh as mesh_lib
from tf_operator_tpu.parallel import train_step as jts
from tf_operator_tpu_torch import optim
from tf_operator_tpu_torch.models import checkpoint as ckpt
from tf_operator_tpu_torch.models import resnet, train
from tf_operator_tpu_torch.models import transformer as tfm
from tf_operator_tpu_torch.parallel import train_step as ts

torch.set_num_threads(2)

LM_ARGS = ["--device", "cpu", "--model", "transformer-lm", "--batch", "2", "--seq", "32",
           "--layers", "2", "--hidden", "64", "--heads", "2", "--log-every", "2",
           "--moment-dtype", "bf16", "--master-weights"]
RN_ARGS = ["--device", "cpu", "--model", "resnet18", "--batch", "2", "--image-size", "32",
           "--log-every", "2", "--moment-dtype", "bf16", "--master-weights"]


def _resnet_state():
    """A tiny ResNet's state after one step, with bf16 moments, f32 master
    weights and moved running statistics."""
    model = resnet.ResNet([1, 1], num_classes=10, width=8,
                          generator=torch.Generator().manual_seed(0))
    tx = optim.make_optimizer(optim.OptimizerConfig(moment_dtype="bf16", master_weights=True))
    state = ts.create_train_state(model, tx)
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    y = torch.tensor([1, 3])

    def loss_fn(m, b):
        return torch.nn.functional.cross_entropy(m(b["x"]).float(), b["y"])

    state, _ = ts.train_step(state, {"x": x, "y": y}, loss_fn, tx)
    return state, tx


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------

def test_save_restore_is_bitwise_and_keeps_dtypes(tmp_path):
    state, _ = _resnet_state()
    tensors = ts.state_tensors(state)
    ckpt.save_named(str(tmp_path), "trainstate_1", tensors)
    back = ckpt.restore_named(str(tmp_path), "trainstate_1")
    assert set(back) == set(tensors)
    dtypes = {}
    for key, want in tensors.items():
        got = back[key]
        if isinstance(want, torch.Tensor):
            assert got.dtype == want.dtype and torch.equal(got, want), key
            dtypes.setdefault(key.split("/")[0], set()).add(got.dtype)
        else:
            assert got == want and type(got) is type(want), key
    assert dtypes == {"params": {torch.bfloat16}, "buffers": {torch.float32},
                      "mu": {torch.bfloat16}, "nu": {torch.bfloat16},
                      "master": {torch.float32}}
    assert ckpt.tree_digest(back) == ckpt.tree_digest(tensors)


def test_restore_casts_to_the_template_and_refuses_another_tree(tmp_path):
    tree = {"a": torch.randn(3, dtype=torch.float32), "b": {"c": torch.ones(2).bfloat16()}}
    ckpt.save_named(str(tmp_path), "x", tree)
    back = ckpt.restore_named(str(tmp_path), "x", template={"a": torch.bfloat16,
                                                             "b": {"c": torch.float32}})
    assert back["a"].dtype == torch.bfloat16 and back["b"]["c"].dtype == torch.float32
    with pytest.raises(ValueError, match="template"):
        ckpt.restore_named(str(tmp_path), "x", template={"a": torch.float32})
    with pytest.raises(FileNotFoundError):
        ckpt.restore_named(str(tmp_path), "y")


def test_files_are_safetensors_both_ways(tmp_path):
    """The safetensors package reads what the module writes, and the
    module reads what the package writes."""
    tree = {"w": torch.randn(4, 3).bfloat16(), "n": torch.arange(5), "s": 7}
    ckpt.save_named(str(tmp_path), "x", tree)
    with safe_open(str(tmp_path / "x" / ckpt.TREE_FILE), framework="pt") as f:
        assert torch.equal(f.get_tensor("['w']"), tree["w"])
        assert torch.equal(f.get_tensor("['n']"), tree["n"])
        assert "tree" in f.metadata()
    path = tmp_path / "other.safetensors"
    save_file({"a": torch.randn(2, 2), "b": torch.ones(3).bfloat16()}, str(path),
              metadata={"k": "v"})
    got, meta = ckpt.read_tensors(str(path))
    assert meta == {"k": "v"} and got["b"].dtype == torch.bfloat16
    assert torch.equal(got["b"], torch.ones(3).bfloat16())


@pytest.mark.parametrize("tree", [
    {"step": np.int32(4), "opt": {"mu": np.arange(6, dtype=np.float32).reshape(2, 3)}},
    {"params": {"layer_0": {"kernel": np.ones((3, 2), ml_dtypes.bfloat16),
                            "bias": np.zeros(2, np.float32)}},
     "count": np.asarray(3, np.int32)},
    {"b": np.arange(4, dtype=np.int64), "a": {"z": np.float32(1.5), "y": np.ones(0)}},
], ids=["f32", "bf16-nested", "order"])
def test_tree_digest_matches_jax(tree):
    assert ckpt.tree_digest(tree) == jckpt.tree_digest(tree)


def test_tree_digest_of_torch_bf16_matches_the_numpy_tree():
    arr = np.random.default_rng(0).standard_normal((3, 4)).astype(ml_dtypes.bfloat16)
    as_torch = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    assert ckpt.tree_digest({"w": as_torch}) == jckpt.tree_digest({"w": arr})


def _step_dir(tmp_path, steps=(2, 4, 6)):
    """A checkpoint dir with params and trainstate at each step, census and
    sharding manifests."""
    d = tmp_path / "ck"
    for s in steps:
        params = {"w": torch.full((2, 3), float(s))}
        ckpt.save_named(str(d), f"trainstate_{s}", {"step": s})
        ckpt.save(str(d), s, params)
        ckpt.write_sharding_manifest(str(d), f"step_{s}",
                                     {"processCount": 1, "deviceCount": 1,
                                      "mesh": {"dp": 1},
                                      "leaves": ckpt.leaf_shardings(params)})
    return d


def _tear(d, step, how):
    target = d / f"step_{step}" / ckpt.TREE_FILE
    if how == "truncate":
        with open(target, "r+b") as f:
            f.truncate(os.path.getsize(target) // 2)
    elif how == "missing":
        target.unlink()
    else:  # a torn census
        (d / f"step_{step}{ckpt.MANIFEST_SUFFIX}").write_text('{"files": ')


@pytest.mark.parametrize("how", ["truncate", "missing", "torn-manifest"])
def test_validate_step_rejects_a_torn_step(tmp_path, how):
    d = _step_dir(tmp_path)
    assert ckpt.validate_step(str(d), 6)
    _tear(d, 6, how)
    assert not ckpt.validate_step(str(d), 6)
    assert jckpt.validate_step(str(d), 6) is False  # the JAX check agrees
    assert ckpt.validate_step(str(d), 4)


def _both_on_copies(tmp_path, d, fn_port, fn_jax):
    """(port result, jax result, port listing, jax listing) of running each
    function on its own copy of d."""
    a, b = tmp_path / "port", tmp_path / "jax"
    shutil.copytree(d, a)
    shutil.copytree(d, b)
    return fn_port(str(a)), fn_jax(str(b)), sorted(os.listdir(a)), sorted(os.listdir(b))


@pytest.mark.parametrize("keep", [0, 1, 2, 5])
def test_prune_checkpoints_as_jax(tmp_path, keep):
    d = _step_dir(tmp_path)
    rp, rj, lp, lj = _both_on_copies(tmp_path, d, lambda x: ckpt.prune_checkpoints(x, keep),
                                     lambda x: jckpt.prune_checkpoints(x, keep))
    assert rp == rj and lp == lj
    if keep == 1:
        assert rp == [2, 4] and ckpt.list_steps(str(tmp_path / "port")) == [6]


def test_sweep_tmp_dirs_as_jax(tmp_path):
    d = _step_dir(tmp_path)
    stranded = d / f"step_8{ckpt.TMP_PUBLISH_MARKER}-publish"
    stranded.mkdir()
    (stranded / ckpt.TREE_FILE).write_bytes(b"partial")
    (d / f"step_4{ckpt.MANIFEST_SUFFIX}.tmp123").write_text("{")
    (d / f"step_4{ckpt.SHARDING_SUFFIX}.tmp9").write_text("{")
    (d / ".FINAL.tmp").write_text("4")
    rp, rj, lp, lj = _both_on_copies(tmp_path, d, ckpt.sweep_tmp_dirs, jckpt.sweep_tmp_dirs)
    assert sorted(rp) == sorted(rj) and len(rp) == 4
    assert lp == lj and ckpt.list_steps(str(tmp_path / "port")) == [2, 4, 6]


def test_a_save_over_a_stranded_tmp_dir_publishes(tmp_path):
    d = tmp_path / "ck"
    (d / f"step_3{ckpt.TMP_PUBLISH_MARKER}-publish").mkdir(parents=True)
    ckpt.save(str(d), 3, {"w": torch.ones(2)})
    assert ckpt.list_steps(str(d)) == [3] and ckpt.validate_step(str(d), 3)
    assert sorted(os.listdir(d)) == ["step_3", "step_3" + ckpt.MANIFEST_SUFFIX]


def test_mark_final_and_final_step_as_jax(tmp_path):
    d = _step_dir(tmp_path)
    assert ckpt.final_step(str(d)) is None and jckpt.final_step(str(d)) is None
    ckpt.mark_final(str(d), 6)
    assert ckpt.final_step(str(d)) == jckpt.final_step(str(d)) == 6
    jckpt.mark_final(str(d), 4)
    assert ckpt.final_step(str(d)) == 4
    (d / "FINAL").write_text("not a step")
    assert ckpt.final_step(str(d)) is None and jckpt.final_step(str(d)) is None


@pytest.mark.parametrize("torn,shapes,want", [
    (None, None, 6),
    (6, None, 4),
    (None, {"['w']": [2, 3]}, 6),
    (None, {"['w']": [4, 4]}, None),
    (6, {"['w']": [2, 3]}, 4),
], ids=["newest", "torn-newest", "shapes-match", "shapes-differ", "torn-and-shapes"])
def test_latest_valid_checkpoint_as_jax(tmp_path, torn, shapes, want):
    d = _step_dir(tmp_path)
    if torn is not None:
        _tear(d, torn, "truncate")
    assert ckpt.latest_valid_checkpoint(str(d), shapes) == want
    assert jckpt.latest_valid_checkpoint(str(d), shapes) == want


def test_wait_for_new_step_as_jax(tmp_path):
    d = _step_dir(tmp_path, steps=(2,))
    for fn in (ckpt.wait_for_new_step, jckpt.wait_for_new_step):
        assert fn(str(d), set(), timeout=1.0) == 2
        assert fn(str(d), {2}, timeout=0.2, poll=0.05) is None  # times out
        assert fn(str(d), {2}, timeout=5.0, should_stop=lambda: True) is None
    ckpt.mark_final(str(d), 2)
    t0 = time.monotonic()
    for fn in (ckpt.wait_for_new_step, jckpt.wait_for_new_step):
        assert fn(str(d), {2}, timeout=5.0, poll=0.05) is None  # stream complete
    assert time.monotonic() - t0 < 2.0
    (d / "FINAL").unlink()  # the stream goes on: a step that appears is returned
    later = threading.Timer(0.2, lambda: ckpt.save(str(d), 4, {"w": torch.ones(1)}))
    later.start()
    try:
        assert ckpt.wait_for_new_step(str(d), {2}, timeout=5.0, poll=0.05) == 4
    finally:
        later.join(timeout=5.0)
    assert not later.is_alive()


# ---------------------------------------------------------------------------
# The trainer's writer
# ---------------------------------------------------------------------------

def _item(step):
    return train._SaveItem(ckpt_dir="", step=step, host_params={}, host_aux={}, info={},
                           final=False, keep=0)


def test_writer_keeps_one_save_in_flight_with_backpressure():
    started, release = threading.Event(), threading.Event()
    active, peak, written = [0], [0], []
    lock = threading.Lock()

    def slow_write(item):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        started.set()
        assert release.wait(timeout=10.0)
        with lock:
            active[0] -= 1
        written.append(item.step)

    writer = train._CkptWriter(slow_write)
    try:
        writer.submit(_item(2))
        assert started.wait(timeout=10.0)
        blocked = threading.Thread(target=writer.submit, args=(_item(4),))
        blocked.start()
        blocked.join(timeout=0.3)
        assert blocked.is_alive()  # the second save waits for the first
        release.set()
        blocked.join(timeout=10.0)
        assert not blocked.is_alive()
        writer.drain()
    finally:
        release.set()
        writer.close()
    assert written == [2, 4] and peak[0] == 1
    stats = writer.stats()
    assert stats["saves"] == 2 and stats["drains"] == 1 and stats["drain_wait_s"] > 0
    assert 0.0 <= stats["hidden_fraction"] <= 1.0


def test_writer_latches_an_error_and_raises_it_again():
    def broken(item):
        raise OSError("disk full")

    writer = train._CkptWriter(broken)
    try:
        writer.submit(_item(2))
        with pytest.raises(RuntimeError, match="disk full") as first:
            writer.drain()
        assert isinstance(first.value.__cause__, OSError)
        with pytest.raises(RuntimeError, match="async checkpoint write failed"):
            writer.submit(_item(4))
    finally:
        writer.close()
    assert writer.saves == 0


def test_writer_stats_have_the_jax_done_blocks_keys():
    port = train._CkptWriter(lambda item: None)
    jax_writer = jtrain._CkptWriter()
    try:
        assert set(port.stats()) == set(jax_writer.stats())
    finally:
        port.close()
        jax_writer.close()
    ck = train._Checkpointing("", 0, digest=False)
    ck.sync_stats["saves"] = 1
    with jtrain._sync_ckpt_lock:
        saved = dict(jtrain._sync_ckpt_stats)
        jtrain._sync_ckpt_stats["saves"] = 1
    try:
        assert set(train._ckpt_done_stats(ck)) == set(jtrain._ckpt_done_stats())
    finally:
        with jtrain._sync_ckpt_lock:
            jtrain._sync_ckpt_stats.update(saved)


# ---------------------------------------------------------------------------
# The trainer's save and resume legs
# ---------------------------------------------------------------------------

def _run(args, tmp_path, tag, monkeypatch):
    """train.main in this process: (rc, events, final state)."""
    path = tmp_path / f"events_{tag}.jsonl"
    monkeypatch.setenv("TPUJOB_METRICS_FILE", str(path))
    monkeypatch.delenv("TPUJOB_HEARTBEAT_FILE", raising=False)
    out: dict = {}
    rc = train.main(args, out)
    events = [json.loads(x) for x in path.read_text().splitlines()] if path.exists() else []
    return rc, events, out.get("state")


def _by(events, name):
    return [e for e in events if e["event"] == name]


def _assert_same_state(a, b):
    ta, tb = ts.state_tensors(a), ts.state_tensors(b)
    assert set(ta) == set(tb)
    for key in ta:
        if isinstance(ta[key], torch.Tensor):
            assert torch.equal(ta[key], tb[key]), key
        else:
            assert ta[key] == tb[key], key


@pytest.mark.parametrize("base", [LM_ARGS, RN_ARGS], ids=["lm", "resnet18"])
def test_resume_ends_bit_for_bit_on_the_uninterrupted_run(tmp_path, monkeypatch, base):
    d = str(tmp_path / "ck")
    rc, ev_a, _ = _run([*base, "--steps", "4", "--checkpoint-dir", d,
                        "--checkpoint-every", "2"], tmp_path, "a", monkeypatch)
    assert rc == 0 and [e["step"] for e in _by(ev_a, "checkpoint")] == [2, 4]
    assert _by(ev_a, "done")[0]["checkpoint"]["mode"] == "async"
    rc, ev_b, resumed = _run([*base, "--steps", "6", "--checkpoint-dir", d,
                              "--checkpoint-every", "2"], tmp_path, "b", monkeypatch)
    assert rc == 0
    (event,) = _by(ev_b, "resumed")
    assert event["from_step"] == 4 and not event["params_only"]
    assert event["digest"] == event["saved_digest"]
    assert set(event["digest"]) == {"params", "trainstate"}
    rc, ev_u, whole = _run([*base, "--steps", "6"], tmp_path, "u", monkeypatch)
    assert rc == 0
    assert _by(ev_b, "done")[0]["final_loss"] == _by(ev_u, "done")[0]["final_loss"]
    assert resumed.step == whole.step == 6
    _assert_same_state(resumed, whole)
    assert ckpt.final_step(d) == 6


def test_torn_newest_step_is_skipped(tmp_path, monkeypatch):
    d = tmp_path / "ck"
    rc, _, _ = _run([*LM_ARGS, "--steps", "4", "--checkpoint-dir", str(d),
                     "--checkpoint-every", "2"], tmp_path, "a", monkeypatch)
    assert rc == 0
    _tear(d, 4, "truncate")
    rc, events, state = _run([*LM_ARGS, "--steps", "4", "--checkpoint-dir", str(d),
                              "--checkpoint-every", "2"], tmp_path, "b", monkeypatch)
    assert rc == 0
    (fallback,) = _by(events, "resume_fallback")
    assert fallback == {"event": "resume_fallback", "skipped_step": 4,
                        "reason": "invalid_checkpoint"}
    assert _by(events, "resumed")[0]["from_step"] == 2
    assert state.step == 4 and ckpt.validate_step(str(d), 4)  # re-saved


def test_start_step_at_the_target_is_resumed_complete(tmp_path, monkeypatch):
    d = tmp_path / "ck"
    rc, _, _ = _run([*LM_ARGS, "--steps", "2", "--checkpoint-dir", str(d)], tmp_path, "a",
                    monkeypatch)
    assert rc == 0
    (d / "FINAL").unlink()
    rc, events, state = _run([*LM_ARGS, "--steps", "2", "--checkpoint-dir", str(d)],
                             tmp_path, "b", monkeypatch)
    assert rc == 0 and state.step == 2
    (done,) = _by(events, "done")
    assert done["resumed_complete"] is True and done["steps"] == 2
    assert not _by(events, "first_step") and ckpt.final_step(str(d)) == 2


def test_keep_checkpoints_prunes(tmp_path, monkeypatch):
    d = tmp_path / "ck"
    rc, events, _ = _run([*LM_ARGS, "--steps", "6", "--checkpoint-dir", str(d),
                          "--checkpoint-every", "2", "--keep-checkpoints", "1",
                          "--checkpoint-mode", "sync"], tmp_path, "a", monkeypatch)
    assert rc == 0
    assert [e["steps"] for e in _by(events, "checkpoint_pruned")] == [[2], [4]]
    assert ckpt.list_steps(str(d)) == [6]
    assert not (d / "trainstate_2").exists() and not (d / "trainstate_4").exists()
    assert _by(events, "done")[0]["checkpoint"]["mode"] == "sync"


def test_async_and_sync_saves_are_bit_equal(tmp_path, monkeypatch):
    trees = {}
    for mode in ("async", "sync"):
        d = str(tmp_path / mode)
        rc, _, _ = _run([*LM_ARGS, "--steps", "4", "--checkpoint-dir", d,
                         "--checkpoint-every", "2", "--checkpoint-mode", mode],
                        tmp_path, mode, monkeypatch)
        assert rc == 0
        trees[mode] = {name: ckpt.restore_named(d, name)
                       for name in ("step_2", "trainstate_2", "step_4", "trainstate_4")}
    for name, tree in trees["async"].items():
        assert ckpt.tree_digest(tree) == ckpt.tree_digest(trees["sync"][name]), name


def test_trainstate_of_another_optimizer_layout_resumes_params_only(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    no_master = [a for a in LM_ARGS if a != "--master-weights"]
    rc, _, _ = _run([*no_master, "--steps", "2", "--checkpoint-dir", d], tmp_path, "a",
                    monkeypatch)
    assert rc == 0
    rc, events, state = _run([*LM_ARGS, "--steps", "3", "--checkpoint-dir", d], tmp_path,
                             "b", monkeypatch)
    assert rc == 0
    (event,) = _by(events, "resumed")
    assert event["from_step"] == 2 and event["params_only"] is True
    assert state.step == 3 and state.opt_state.count == 1  # a fresh optimizer
    assert all(m.dtype == torch.float32 for m in state.opt_state.master)


@pytest.mark.parametrize("allow_reshape", [False, True])
def test_foreign_gang_shape_is_skipped_unless_reshape_is_allowed(tmp_path, monkeypatch,
                                                                allow_reshape):
    """A step saved by another gang shape (here: two processes) is walked
    past like a torn one; --allow-reshape restores it once its per-leaf
    shapes match this model."""
    d = tmp_path / "ck"
    rc, _, _ = _run([*LM_ARGS, "--steps", "4", "--checkpoint-dir", str(d),
                     "--checkpoint-every", "2"], tmp_path, "a", monkeypatch)
    assert rc == 0
    path = d / f"step_4{ckpt.SHARDING_SUFFIX}"
    manifest = json.loads(path.read_text())
    path.write_text(json.dumps({**manifest, "processCount": 2}))
    flags = ["--allow-reshape"] if allow_reshape else []
    rc, events, _ = _run([*LM_ARGS, "--steps", "5", "--checkpoint-dir", str(d), *flags],
                         tmp_path, "b", monkeypatch)
    assert rc == 0
    skipped = [e for e in _by(events, "resume_fallback") if e.get("skipped_step") == 4]
    if allow_reshape:
        assert not skipped and _by(events, "resumed")[0]["from_step"] == 4
    else:
        assert skipped[0]["reason"].startswith("foreign_shape")
        assert _by(events, "resumed")[0]["from_step"] == 2


def test_is_checkpoint_writer_as_jax(monkeypatch):
    cases = [
        {}, {"TPUJOB_REPLICA_TYPE": "chief"}, {"TPUJOB_REPLICA_TYPE": "evaluator"},
        {"TPUJOB_REPLICA_TYPE": "worker", "TPUJOB_REPLICA_INDEX": "1"},
        {"TPUJOB_REPLICA_TYPE": "worker", "TPUJOB_REPLICA_INDEX": "0"},
        {"TPUJOB_REPLICA_TYPE": "worker", "TPUJOB_REPLICA_INDEX": "0",
         "TF_CONFIG": json.dumps({"cluster": {"chief": ["a:1"], "worker": ["b:1"]}})},
        {"TPUJOB_REPLICA_TYPE": "worker", "TF_CONFIG": "not json"},
    ]
    for env in cases:
        for k in ("TPUJOB_REPLICA_TYPE", "TPUJOB_REPLICA_INDEX", "TF_CONFIG"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert train._is_checkpoint_writer() == jtrain._is_checkpoint_writer(), env


# ---------------------------------------------------------------------------
# A JAX-written checkpoint resumed by the port
# ---------------------------------------------------------------------------

T, BATCH = 64, 2
CARRY_CASES = {  # dtype -> (optimizer config, loss rtol), as test_torch_train.py
    "float32": ({"learning_rate": 1e-2}, 1e-4),
    "bfloat16": ({"learning_rate": 1e-2, "moment_dtype": "bf16", "master_weights": True},
                 2e-3),
}


def _np32(tree):
    """A tree of jax arrays as f32 numpy (bf16 upcasts exactly)."""
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@pytest.mark.parametrize("dtype_name", list(CARRY_CASES))
def test_jax_checkpoint_carried_into_the_port_follows_jax(tmp_path, dtype_name):
    opt_kw, rtol = CARRY_CASES[dtype_name]
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 1024, (BATCH, T)).astype(np.int32) for _ in range(5)]
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
    for b in batches[:2]:
        jstate, _ = step(jstate, {"tokens": jnp.asarray(b)}, jax.random.key(0))

    d = str(tmp_path / "jax_ck")
    jtrain._save_checkpoint(d, 2, jstate, sync=True)
    # Read back with the JAX package, as its trainer's resume does.
    fresh = jts.create_train_state(params, jtx)
    p_template = jax.device_get(joptim.master_template(jtx, jax.device_get(fresh.params)))
    jparams = jckpt.restore(d, 2, template=p_template)
    aux = jckpt.restore_named(d, "trainstate_2")
    jopt = jax.tree.unflatten(jax.tree.structure(fresh.opt_state), aux["opt_leaves"])
    assert int(aux["step"]) == 2

    tcfg = dataclasses.replace(tfm.TINY_LM, dtype=getattr(torch, dtype_name))
    tmodel = tfm.TransformerLM(tcfg)
    ttx = optim.make_optimizer(optim.OptimizerConfig(**opt_kw))
    tstate = ts.create_train_state(tmodel, ttx)
    with torch.no_grad():
        named = tfm.params_from_flax(_np32(jparams))
        for n, p in tmodel.named_parameters():
            p.copy_(named[n])
    names = [n for n, _ in tmodel.named_parameters()]
    master = _np32(jopt.master) if opt_kw.get("master_weights") else None
    opt_state = optim.state_from_jax(np.asarray(jopt.count), _np32(jopt.mu), _np32(jopt.nu),
                                     master, tfm.params_from_flax, names, tstate.opt_state)
    assert opt_state.count == 2
    assert [t.dtype for t in opt_state.mu] == [t.dtype for t in tstate.opt_state.mu]
    tstate = ts.TrainState(int(aux["step"]), tmodel, opt_state)

    def tloss(model, batch):
        return tfm.lm_loss(model(batch["tokens"]), batch["tokens"])

    jl, tl = [], []
    for b in batches[2:]:
        jstate, jm = step(jstate, {"tokens": jnp.asarray(b)}, jax.random.key(0))
        tstate, tm = ts.train_step(tstate, {"tokens": torch.from_numpy(b).long()}, tloss, ttx)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    assert tstate.step == 5
    np.testing.assert_allclose(tl, jl, rtol=rtol)
