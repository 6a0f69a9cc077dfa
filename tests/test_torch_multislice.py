"""Multi-slice training in the PyTorch port (A12), on the CPU.

Held against the JAX package: the claims of tests/test_multislice.py's
TestDcnExchange, TestHierarchicalMesh and TestDcnTelemetry on the port's
copies; partition_buckets equal to JAX's; a JAX DcnExchange and the port's
in one directory reducing the same leaves to bit-equal means (the wire is
the JAX package's byte for byte); the port's backward/apply pair against
JAX make_multislice_step_fns on carried weights (rtol 1e-5, f32). Then the
trainer as the operator starts a 2-slice job's pods (tests/torch_dist.py:
each slice its own world, one TPUJOB_DCN_DIR), against one process at the
same global batch (rtol 1e-5 in f32); a chaos kill of slice 1, its
relaunch and slice 0's in-process rewind (loss-equal at rtol 1e-3, the JAX
e2e's); the refusals. The slow ones are the JAX file's slow ones: the
operator e2e (a LocalSession job of port pods) and the measured-overlap
acceptance.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_dist import (  # noqa: E402
    PY,
    ROOT,
    assert_ok,
    finish,
    progress_losses,
    read_events,
    run_slices,
    run_world,
    start_slice,
)

from tf_operator_tpu import optim as joptim  # noqa: E402
from tf_operator_tpu.models import transformer as jtfm  # noqa: E402
from tf_operator_tpu.parallel import mesh as jmesh  # noqa: E402
from tf_operator_tpu.parallel import multislice as jms  # noqa: E402
from tf_operator_tpu.parallel import train_step as jts  # noqa: E402
from tf_operator_tpu_torch import optim  # noqa: E402
from tf_operator_tpu_torch.models import train  # noqa: E402
from tf_operator_tpu_torch.models import transformer as tfm  # noqa: E402
from tf_operator_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from tf_operator_tpu_torch.parallel import train_step as ts  # noqa: E402
from tf_operator_tpu_torch.parallel.multislice import (  # noqa: E402
    DcnExchange,
    DcnInterrupted,
    SliceRewind,
    SliceWorld,
    partition_buckets,
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------- exchange


@pytest.mark.parametrize("nbytes,n", [([10, 10, 10, 10], 2), ([100, 1, 1], 3), ([5], 4),
                                      ([], 2), ([7, 3, 9, 1, 4, 4, 8], 3),
                                      ([1 << 20, 4, 4, 1 << 19, 1 << 21], 4)])
def test_partition_buckets_equal_the_jax_packages(nbytes, n):
    got = partition_buckets(nbytes, n)
    assert got == jms.partition_buckets(nbytes, n)
    assert [i for p in got for i in p] == list(range(len(nbytes))) and len(got) <= n


def test_partition_buckets():
    assert partition_buckets([10, 10, 10, 10], 2) == [[0, 1], [2, 3]]
    parts = partition_buckets([100, 1, 1], 3)
    assert [i for p in parts for i in p] == [0, 1, 2] and len(parts) <= 3
    assert partition_buckets([5], 4) == [[0]]
    with pytest.raises(ValueError):
        partition_buckets([1], 0)


def _run_pair(tmp_path, steps=2, microbatches=2, latency=0.0, compute_s=0.0, mods=None):
    """Two slices in threads over one directory, each submitting
    [slice * 10 + m] x 8 and [step] x (2, 2) per microbatch; the means
    they collect and their stats. `mods` picks each slice's module (the
    port's by default, the JAX package's to mix them)."""
    mods = mods or (None, None)
    results: dict = {}
    errors: list = []

    def run(sid):
        try:
            mod = mods[sid]
            world_cls, ex_cls = ((SliceWorld, DcnExchange) if mod is None
                                 else (mod.SliceWorld, mod.DcnExchange))
            w = world_cls(slice_id=sid, num_slices=2, dcn_dir=str(tmp_path), latency_s=latency)
            ex = ex_cls(w, resume_step=0, microbatches=microbatches, buckets=2,
                        peer_timeout_s=30)
            for step in range(1, steps + 1):
                ex.begin_step(step)
                for m in range(microbatches):
                    ex.submit(step, m, [np.full((8,), sid * 10 + m, np.float32),
                                        np.full((2, 2), step, np.float32)])
                    if compute_s:
                        time.sleep(compute_s)  # the "backward"
                out = ex.collect(step)
                ex.step_done(step)
                results.setdefault(sid, []).append([float(a.mean()) for a in out])
            results[f"stats{sid}"] = ex.stats()
            ex.close()
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(s,)) for s in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    return results


def test_allreduce_mean_correct(tmp_path):
    res = _run_pair(tmp_path, steps=3, microbatches=2)
    for sid in (0, 1):
        for step, (first, second) in enumerate(res[sid], start=1):
            assert first == pytest.approx(5.5)
            assert second == pytest.approx(step)
    assert res["stats0"]["transfers"] == 3 * 2 * 2  # steps x m x buckets


@pytest.mark.flaky
def test_overlap_hides_wire_behind_compute(tmp_path):
    res = _run_pair(tmp_path, steps=3, microbatches=3, latency=0.015, compute_s=0.06)
    st = res["stats0"]
    assert st["dcn_busy_s"] > 0
    assert st["hidden_fraction"] is not None and st["hidden_fraction"] >= 0.3, st


def test_jax_and_port_slices_share_one_directory(tmp_path):
    """A JAX exchange as slice 0 and the port's as slice 1 on the same
    wire: both reach the pair's means."""
    res = _run_pair(tmp_path, steps=2, microbatches=2, mods=(jms, None))
    assert res[0] == res[1] == [[5.5, 1.0], [5.5, 2.0]]


def test_jax_and_port_reduce_to_bit_equal_means(tmp_path):
    """The same random leaves through a JAX slice 0 and a port slice 1 (one
    microbatch, three buckets, a float64 and an int leaf beside f32 and
    f16 ones): both means equal (a + b) * 0.5 bit for bit, in the
    accumulator's dtype as numpy computes it, and each other."""
    rng = np.random.default_rng(0)
    leaves = [[rng.standard_normal((37, 5)).astype(np.float32),
               rng.standard_normal(11),
               rng.integers(0, 9, (4,)).astype(np.int32),
               rng.standard_normal((3, 3)).astype(np.float16)] for _ in range(2)]
    out: dict = {}

    def run(sid, mod):
        w = mod.SliceWorld(slice_id=sid, num_slices=2, dcn_dir=str(tmp_path))
        ex = mod.DcnExchange(w, resume_step=0, microbatches=1, buckets=3, peer_timeout_s=30)
        ex.begin_step(1)
        ex.submit(1, 0, leaves[sid])
        out[sid] = ex.collect(1)
        ex.step_done(1)
        ex.close()

    import tf_operator_tpu_torch.parallel.multislice as port

    threads = [threading.Thread(target=run, args=a) for a in ((0, jms), (1, port))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    for a, b, mine, theirs in zip(*leaves, out[0], out[1]):
        wire = [x if x.dtype.kind in "iub" or x.dtype in (np.float32, np.float64)
                else x.astype(np.float32) for x in (a, b)]
        want = wire[0].astype(np.float64 if wire[0].dtype == np.float64 else np.float32)
        want += wire[1]  # in place, in the accumulator's dtype, as the engine adds
        want = want * 0.5
        assert mine.dtype == theirs.dtype == want.dtype
        assert mine.tobytes() == theirs.tobytes() == want.tobytes()


def _exchanges(tmp_path, resume=(0, 0)):
    w0 = SliceWorld(slice_id=0, num_slices=2, dcn_dir=str(tmp_path))
    w1 = SliceWorld(slice_id=1, num_slices=2, dcn_dir=str(tmp_path))
    return (DcnExchange(w0, resume_step=resume[0], microbatches=1, buckets=1,
                        peer_timeout_s=30),
            DcnExchange(w1, resume_step=resume[1], microbatches=1, buckets=1,
                        peer_timeout_s=30), w1)


def _one_step(ex, step, v):
    ex.begin_step(step)
    ex.submit(step, 0, [np.full((4,), v, np.float32)])
    out = ex.collect(step)
    ex.step_done(step)
    return out


def test_rewind_protocol(tmp_path):
    ex0, ex1, w1 = _exchanges(tmp_path)
    done1 = []
    t = threading.Thread(target=lambda: done1.append(_one_step(ex1, 1, 1.0)))
    t.start()
    _one_step(ex0, 1, 0.0)
    t.join(30)
    assert done1 and float(done1[0][0][0]) == pytest.approx(0.5)
    # Slice 1 dies and restarts: a new generation resuming at step 0.
    ex1.close()
    ex1b = DcnExchange(w1, resume_step=0, microbatches=1, buckets=1, peer_timeout_s=30)
    ex0.begin_step(2)
    ex0.submit(2, 0, [np.full((4,), 2.0, np.float32)])
    with pytest.raises(SliceRewind) as exc:
        ex0.collect(2)
    assert exc.value.to_step == 0 and exc.value.peer == 1
    ex0.rewind_to(0)
    assert ex0.stats()["rewinds"] == 1
    done: dict = {}

    def replay(ex, sid, vals):
        for step, v in vals:
            done.setdefault(sid, []).append(_one_step(ex, step, v))

    ts_ = [threading.Thread(target=replay, args=(ex0, 0, [(1, 0.0), (2, 2.0)])),
           threading.Thread(target=replay, args=(ex1b, 1, [(1, 1.0), (2, 4.0)]))]
    for t in ts_:
        t.start()
    for t in ts_:
        t.join(30)
    assert float(done[0][1][0][0]) == pytest.approx(3.0)
    assert float(done[1][1][0][0]) == pytest.approx(3.0)
    ex0.close()
    ex1b.close()


def test_rewind_when_peer_resumes_at_pending_step(tmp_path):
    ex0, ex1, w1 = _exchanges(tmp_path)
    t = threading.Thread(target=lambda: _one_step(ex1, 1, 1.0))
    t.start()
    _one_step(ex0, 1, 0.0)
    t.join(30)
    ex1.close()
    ex0.begin_step(2)
    ex0.submit(2, 0, [np.full((2,), 2.0, np.float32)])
    ex1b = DcnExchange(w1, resume_step=2, microbatches=1, buckets=1, peer_timeout_s=30)
    with pytest.raises(SliceRewind) as exc:
        ex0.collect(2)
    assert exc.value.to_step == 2
    ex0.close()
    ex1b.close()


def test_collect_interrupted_by_guard(tmp_path):
    ex = DcnExchange(SliceWorld(slice_id=0, num_slices=2, dcn_dir=str(tmp_path)),
                     resume_step=0, microbatches=1, buckets=1, peer_timeout_s=30)
    ex.begin_step(1)
    ex.submit(1, 0, [np.zeros((2,), np.float32)])
    t0 = time.monotonic()
    with pytest.raises(DcnInterrupted):
        ex.collect(1, should_stop=lambda: True)
    assert time.monotonic() - t0 < 5.0
    ex.close()


def test_world_from_env():
    assert SliceWorld.from_env({"TPUJOB_NUM_SLICES": "1"}) is None
    w = SliceWorld.from_env({"TPUJOB_NUM_SLICES": "2", "TPUJOB_SLICE_ID": "1",
                             "TPUJOB_DCN_DIR": "/tmp/x", "TPUJOB_DCN_LATENCY_S": "0.5"})
    assert (w.slice_id, w.num_slices, w.latency_s) == (1, 2, 0.5)
    with pytest.raises(RuntimeError) as got:
        SliceWorld.from_env({"TPUJOB_NUM_SLICES": "2"})
    with pytest.raises(RuntimeError) as want:
        jms.SliceWorld.from_env({"TPUJOB_NUM_SLICES": "2"})
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------------- mesh


def test_hierarchical_mesh_data_axis_outermost():
    m = mesh_lib.hierarchical_mesh({"dp": 4}, 2, world=8)
    j = jmesh.hierarchical_mesh({"dp": 4}, 2, jax.devices()[:8])
    assert m.axis_names == tuple(j.axis_names) == ("data", "dp")
    assert m.shape == dict(j.shape) == {"data": 2, "dp": 4}
    assert mesh_lib.data_axes(m)[0] == "data"
    # The ranks group by slice: slice k holds ranks 4k .. 4k + 3.
    assert m.grid.tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert mesh_lib.hierarchical_mesh(None, 2, world=4).shape == {"data": 2, "dp": 2}


@pytest.mark.parametrize("axes,slices,world", [({"data": 2}, 2, 8), (None, 3, 8),
                                               (None, 0, 8)])
def test_hierarchical_mesh_refusals(axes, slices, world):
    with pytest.raises(ValueError) as got:
        mesh_lib.hierarchical_mesh(axes, slices, world=world)
    with pytest.raises(ValueError) as want:
        jmesh.hierarchical_mesh(axes, slices, jax.devices()[:world])
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ telemetry


def test_dcn_sync_is_a_phase():
    from tf_operator_tpu_torch.telemetry.phases import PHASES

    assert "dcn_sync" in PHASES


# ------------------------------------------------------- the step pair

ROWS, T = 2, 32


def test_backward_and_apply_match_the_jax_pair():
    """The port's backward (two row blocks of one batch) and apply (their
    mean, AdamW) against JAX make_multislice_step_fns on carried weights
    and the same rows, f32: the losses, every gradient, the norm and the
    updated parameters at rtol 1e-5."""
    jcfg = dataclasses.replace(jtfm.TINY_LM, dtype=jnp.float32, max_len=T)
    jmodel = jtfm.TransformerLM(jcfg)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, T), jnp.int32))["params"]

    def jloss(p, model_state, batch, rng):
        return jtfm.lm_loss(jmodel.apply({"params": p}, batch["tokens"]),
                            batch["tokens"]), model_state

    opt = {"learning_rate": 1e-2}
    jtx = joptim.make_optimizer(joptim.OptimizerConfig(**opt))
    mesh = jmesh.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    jstate = jts.create_train_state(params, jtx)
    _, jback, japply = jts.make_multislice_step_fns(
        jloss, jtx, mesh, lambda key: None, rows=ROWS)(jstate)

    model = tfm.TransformerLM(dataclasses.replace(tfm.TINY_LM, dtype=torch.float32, max_len=T))
    model.load_state_dict(tfm.params_from_flax(jax.tree.map(np.array, params)))
    ttx = optim.make_optimizer(optim.OptimizerConfig(**opt))
    state = ts.create_train_state(model, ttx)
    _, back, apply = ts.make_multislice_step_fns(
        lambda m, b: tfm.lm_loss(m(b["tokens"]), b["tokens"]), ttx, None, "cpu", ROWS)
    names = [n for n, _ in model.named_parameters()]

    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2 * ROWS, T))
    jgrads, tgrads = [], []
    for offset in (0, ROWS):
        jl, jg = jback(jstate, {"tokens": jnp.asarray(tokens, jnp.int32)}, 0, offset)
        tl, tg = back(state, {"tokens": torch.from_numpy(tokens)}, offset)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        want = tfm.params_from_flax(jax.tree.map(np.array, jg))
        for n, g in zip(names, tg):
            if n.endswith("attn.key.bias"):
                # Zero in exact arithmetic (softmax ignores a shift of the
                # scores): both sides hold f32 summation noise.
                assert np.abs(g.numpy() - want[n].numpy()).max() <= 1e-7, n
                continue
            np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=1e-5,
                                       atol=1e-5 * float(want[n].abs().max()), err_msg=n)
        jgrads.append(jg)
        tgrads.append([g.numpy() for g in tg])
    jmean = jax.tree.map(lambda a, b: (np.asarray(a) + np.asarray(b)) * 0.5, *jgrads)
    tmean = tfm.params_from_flax(jmean)
    jstate, jnorm = japply(jstate, jmean)
    state, tnorm = apply(state, [tmean[n].numpy() for n in names])
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-5)
    want = tfm.params_from_flax(jax.tree.map(np.array, jstate.params))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)
    assert state.step == 1 and int(jstate.step) == 1


# --------------------------------------------------------- the trainer

MNIST = ["--model", "mnist-mlp", "--device", "cpu", "--steps", "4", "--batch", "8",
         "--log-every", "1"]
LM = ["--model", "transformer-lm", "--device", "cpu", "--steps", "4", "--batch", "4",
      "--seq", "32", "--layers", "2", "--hidden", "32", "--heads", "2", "--log-every", "1"]


@pytest.mark.parametrize("argv", [MNIST, LM], ids=["mnist-mlp", "lm"])
def test_two_slices_train_as_one_process(tmp_path, argv):
    """A 2-slice job (one process a slice, 2 microbatches each) follows one
    process at the same global batch (rtol 1e-5, f32): first_step carries
    slices and slice_id, done its dcn block, and the phases (dcn_sync
    among them) telescope to the step wall."""
    slices = run_slices(tmp_path, argv + ["--dcn-buckets", "2"])
    one = run_world(tmp_path, argv, 1, tag="one")
    assert_ok(slices + one)
    want = progress_losses(one[0]["events"])
    for sid, r in enumerate(slices):
        got = progress_losses(r["events"])
        assert sorted(got) == sorted(want) == [2, 3, 4]
        np.testing.assert_allclose([got[s] for s in want], list(want.values()), rtol=1e-5)
        by = {e["event"]: e for e in r["events"]}
        assert (by["first_step"]["slices"], by["first_step"]["slice_id"]) == (2, sid)
        dcn, pb = by["done"]["dcn"], by["done"]["phase_breakdown"]
        assert (dcn["slices"], dcn["slice_id"], dcn["microbatches"]) == (2, sid, 2)
        assert dcn["transfers"] == 4 * 2 * dcn["buckets"] and dcn["bytes_out_mb"] > 0
        assert sum(v for k, v in pb.items() if k not in ("wall_s", "steps")) == \
            pytest.approx(pb["wall_s"], rel=1e-3)
        assert pb["dcn_sync"] == pytest.approx(dcn["dcn_sync_s"], rel=0.05, abs=1e-3)
        assert by["done"]["steps"] == 4


def test_two_slices_of_two_ranks_train_as_one_process(tmp_path):
    """Each slice a dp = 2 world of its own (4 processes in all): one
    exchange a rank pair, the same losses as one process."""
    slices = run_slices(tmp_path, MNIST, ranks=2, mesh={"dp": 2})
    one = run_world(tmp_path, MNIST, 1, tag="one")
    assert_ok(slices + one)
    want = progress_losses(one[0]["events"])
    for r in slices:
        got = progress_losses(r["events"])
        np.testing.assert_allclose([got[s] for s in want], list(want.values()), rtol=1e-5)
    assert sorted(os.listdir(tmp_path / "dcn")) == ["rank0", "rank1"]


@pytest.mark.parametrize("kill,resume", [(6, 4), (2, 0)])
def test_kill_of_slice1_rewinds_slice0_in_process(tmp_path, kill, resume):
    """kill:step=6,slice=1 (SIGKILL) two steps after worker 0's step-4
    save: slice 1 is relaunched and resumes from step 4; slice 0 never
    restarts, emits dcn_rewind (peer_resume 4), re-restores in process and
    ends loss-equal to an uninterrupted run at every step (rtol 1e-3). A
    kill at step 2, before any save: the relaunch starts at step 0 and
    slice 0 rewinds to its initial state."""
    argv = MNIST[:] + ["--checkpoint-dir", str(tmp_path / "ckpt"), "--checkpoint-every", "4"]
    argv[argv.index("--steps") + 1] = "8"
    s0 = start_slice(tmp_path, argv, 0, tag="k")
    (killed,) = finish([start_slice(
        tmp_path, argv + ["--chaos", f"kill:step={kill},slice=1,signal=KILL"], 1, tag="k1")])
    assert killed["rc"] == -9, killed["stderr"][-2000:]
    relaunched, first = finish([start_slice(tmp_path, argv, 1, tag="k2"), s0])
    ref_argv = MNIST[:]
    ref_argv[ref_argv.index("--steps") + 1] = "8"
    ref = run_world(tmp_path, ref_argv, 1, tag="ref")
    assert_ok([first, relaunched] + ref)
    resumed = [e["from_step"] for e in relaunched["events"] if e["event"] == "resumed"]
    assert resumed == ([resume] if resume else [])
    rewinds = [e for e in first["events"] if e["event"] == "dcn_rewind"]
    assert [r["peer_resume"] for r in rewinds] == [resume] and rewinds[0]["peer_slice"] == 1
    assert [e["event"] for e in first["events"]].count("start") == 1
    done = [e for e in first["events"] if e["event"] == "done"][-1]
    assert done["steps"] == 8 and done["dcn"]["rewinds"] == 1
    want, got = progress_losses(ref[0]["events"]), progress_losses(first["events"])
    assert 8 in want
    np.testing.assert_allclose([got[s] for s in want], list(want.values()), rtol=1e-3)


def test_a_lost_peer_exits_retryable(tmp_path):
    """A slice whose peer never comes: dcn_peer_timeout and exit 138."""
    (r,) = finish([start_slice(tmp_path, MNIST + ["--dcn-peer-timeout", "1"], 0)], 120)
    assert r["rc"] == 138, r["stderr"][-2000:]
    assert [e for e in r["events"] if e["event"] == "dcn_peer_timeout"]


@pytest.mark.parametrize("argv,env,says", [
    ([], {}, ["TPUJOB_NUM_SLICES=2 but TPUJOB_DCN_DIR is unset"]),
    (["--model", "resnet18"], {"TPUJOB_DCN_DIR": "d"},
     ["--model resnet18 carries mutable model state (batch stats)"]),
    (["--data-dir", "/nonexistent"], {"TPUJOB_DCN_DIR": "d"},
     ["--data-dir is not supported yet"]),
    (["--batch", "6"], {"TPUJOB_DCN_DIR": "d"},
     ["--batch 6 not divisible by slices x microbatches (2 x 2)"]),
    (["--dcn-microbatches", "0"], {"TPUJOB_DCN_DIR": "d"}, ["--dcn-microbatches must be >= 1"]),
])
def test_multislice_refusals(argv, env, says, capsys, monkeypatch):
    """What the JAX trainer refuses of a multi-slice job, with its
    messages: exit 2 before any event."""
    monkeypatch.setenv("TPUJOB_NUM_SLICES", "2")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit) as e:
        train.main(MNIST + argv)
    assert e.value.code == 2
    out = capsys.readouterr()
    assert all(s in out.err for s in says), out.err
    assert '"event"' not in out.out


# ------------------------------------------------------ e2e capstones

STEPS = 24


@pytest.mark.slow
def test_kill_slice1_rolls_only_slice1_through_the_operator(tmp_path, monkeypatch):
    """The JAX e2e on port pods: a LocalSession 2-slice TrainJob whose
    pods run the port trainer; kill:step=12,slice=1 SIGKILLs slice 1, the
    controller rolls only slice 1, slice 0 rewinds in process, and the job
    ends at STEPS loss-equal (rtol 1e-3) to a one-slice job."""
    from tf_operator_tpu.api import defaults
    from tf_operator_tpu.api.types import (
        ContainerSpec, JobConditionType, ObjectMeta, PodTemplateSpec, ReplicaSpec,
        ReplicaType, RestartPolicy, TPUSpec, TrainJob, TrainJobSpec, is_succeeded)
    from tf_operator_tpu.runtime.session import LocalSession

    def job(name, workers, slices, cmd):
        j = TrainJob(metadata=ObjectMeta(name=name), spec=TrainJobSpec(
            replica_specs={ReplicaType.WORKER: ReplicaSpec(
                replicas=workers, restart_policy=RestartPolicy.EXIT_CODE,
                template=PodTemplateSpec(containers=[
                    ContainerSpec(name="tensorflow", image="local", command=cmd)]))},
            tpu=TPUSpec(topology="v5e-1", slices=slices)))
        return defaults.set_defaults(j)

    def cmd(ckpt, *extra):
        return [PY, "-m", "tf_operator_tpu_torch.models.train", "--device", "cpu", "--model",
                "mnist-mlp", "--steps", str(STEPS), "--batch", "256", "--log-every", "4",
                "--checkpoint-dir", ckpt, "--checkpoint-every", "8", *extra]

    monkeypatch.setenv("TPUJOB_PRESPAWN", "0")
    session = LocalSession(env_overrides={"PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
                                          "TPUJOB_CHAOS_STATE": str(tmp_path / "chaos"),
                                          "TPUJOB_DCN_LATENCY_S": "0.005"},
                           log_dir=str(tmp_path / "logs"))
    try:
        session.submit(job("mskill", 2, 2, cmd(str(tmp_path / "ckpt"), "--dcn-microbatches",
                                               "2", "--dcn-buckets", "2", "--chaos",
                                               "kill:step=12,slice=1,signal=KILL")))
        ref_job = job("msref", 1, 1, cmd(str(tmp_path / "ref-ckpt")))
        ref_job.spec.tpu = None
        session.submit(ref_job)
        done = (JobConditionType.SUCCEEDED, JobConditionType.FAILED)
        got = session.wait_for_condition("default", "mskill", done, timeout=480)
        ref = session.wait_for_condition("default", "msref", done, timeout=480)
        assert is_succeeded(got.status) and is_succeeded(ref.status)
        assert got.status.slice_restarts == {"1": 1}
    finally:
        session.close()

    def events(pod):
        return read_events(tmp_path / "logs" / f"default_{pod}.metrics.jsonl")

    ev0, ev1 = events("mskill-worker-0"), events("mskill-worker-1")
    assert [e["event"] for e in ev0].count("start") == 1
    assert [e["event"] for e in ev1].count("start") == 2
    assert [e for e in ev1 if e["event"] == "resumed"][-1]["from_step"] == 8
    assert [e for e in ev0 if e["event"] == "dcn_rewind"][-1]["peer_resume"] == 8
    want, have = progress_losses(events("msref-worker-0")), progress_losses(ev0)
    common = sorted(set(want) & set(have))
    assert STEPS in common and len(common) >= 3
    np.testing.assert_allclose([have[s] for s in common], [want[s] for s in common], rtol=1e-3)


@pytest.mark.slow
def test_hidden_fraction_measured(tmp_path):
    """The JAX acceptance on port slices: an injected DCN latency that
    makes the exchange >= 30% of the step wall, hidden >= 0.5 by the
    microbatch streaming, the phases telescoping. The latency sits where
    the JAX test puts it relative to the backward: a real share of the
    step, yet under one microbatch's backward. The port's backward of a
    3072-row microbatch takes ~0.05 s on one CPU thread, ~4x under the JAX
    trainer's on the 2-core host its 0.16 s was tuned on: at 25 ms, hidden
    0.64-0.71 and busy / wall 0.40 were read, at 40 ms 0.33 / 0.50."""
    runs = run_slices(tmp_path, ["--model", "mnist-mlp", "--device", "cpu", "--steps", "8",
                                 "--batch", "36864", "--log-every", "4",
                                 "--dcn-microbatches", "6", "--dcn-buckets", "1"],
                      f32=False, env={"TPUJOB_DCN_LATENCY_S": "0.025"}, timeout=300)
    assert_ok(runs)
    (done,) = [e for e in runs[0]["events"] if e["event"] == "done"]
    d, pb = done["dcn"], done["phase_breakdown"]
    assert sum(v for k, v in pb.items() if k not in ("wall_s", "steps")) == \
        pytest.approx(pb["wall_s"], rel=1e-3)
    assert pb.get("dcn_sync", 0) == pytest.approx(d["dcn_sync_s"], rel=0.05)
    assert d["dcn_busy_s"] / pb["wall_s"] >= 0.30, (d, pb)
    assert d["hidden_fraction"] >= 0.5, d


def test_the_collector_reads_a_port_slices_dcn_block(tmp_path):
    """The operator's TelemetryCollector exposes a port slice's
    hidden_fraction from its done event, as it does the JAX trainer's."""
    from tf_operator_tpu.status import metrics as metrics_mod
    from tf_operator_tpu.telemetry.collector import TelemetryCollector

    runs = run_slices(tmp_path, MNIST)
    assert_ok(runs)
    (done,) = [e for e in runs[0]["events"] if e["event"] == "done"]
    reg = metrics_mod.Registry()
    col = TelemetryCollector(str(tmp_path), registry=reg)
    with open(tmp_path / "default_msjob-worker-0.metrics.jsonl", "w") as f:
        f.write(json.dumps({"event": "start", "t": 1.0}) + "\n")
        f.write(json.dumps(done) + "\n")

    class FakeCluster:
        def list_jobs(self):
            from test_multislice import make_ms_job

            return [make_ms_job("msjob", workers=2, slices=2)]

    col.refresh_gauges(FakeCluster())
    head = 'tpujob_trainer_dcn_hidden_fraction{job="msjob",namespace="default"} '
    (line,) = [ln for ln in reg.expose().splitlines() if ln.startswith(head)]
    assert float(line[len(head):]) == done["dcn"]["hidden_fraction"]


def test_example_manifest_gives_each_slice_a_trainer_it_accepts(monkeypatch):
    """examples/torch-multislice-lm.yaml: two Workers over two slices, each
    given its slice's world by the operator's env; the port trainer accepts
    their command under it (with the runtime's TPUJOB_DCN_DIR)."""
    from tf_operator_tpu.api import compat, validation
    from tf_operator_tpu.api.types import ReplicaType
    from tf_operator_tpu.cluster_spec import tpu_env

    job = compat.job_from_yaml((ROOT / "examples" / "torch-multislice-lm.yaml").read_text())
    assert not validation.validate_job(job)
    cmd = job.spec.replica_specs[ReplicaType.WORKER].template.containers[0].command
    argv = cmd[cmd.index("tf_operator_tpu_torch.models.train") + 1:]
    for index in range(2):
        env = tpu_env.gen_tpu_env(job, ReplicaType.WORKER, index)
        assert (env["TPUJOB_NUM_SLICES"], env["TPUJOB_SLICE_ID"]) == ("2", str(index))
        for k, v in {**env, "TPUJOB_DCN_DIR": "/shared/dcn"}.items():
            monkeypatch.setenv(k, v)
        ap = train.build_parser()
        args = ap.parse_args(argv)
        train.check_flags(ap, args)
        assert (args.model, args.batch, args.dcn_microbatches) == ("transformer-lm", 4, 2)
