"""The PyTorch port's on-disk input path (data/dataset.py, data/prefetch.py,
data/staging.py) and the trainer's --data-dir, on CPU.

What tests/test_data.py and tests/test_staging.py claim of the JAX
package, held for the port, and the two held against each other: the
port's ShardedDataset yields the JAX one's batches byte for byte on the
same directory; normalize_uint8 and the wire conversion equal the JAX
module's bit for bit on the host; the ring keeps order, values, errors,
bounded read-ahead and telescoping accounting, and its lane threads run no
compute (torch.cat and the normalisation are held to the consumer thread).
The trainer on CPU shards follows the JAX trainer's loss trajectory from
the same initial weights (the MNIST MLP computes in bf16: the first loss
equal, the trajectory at rtol 2e-3, as tests/test_torch_train.py holds
bf16 trajectories), staged ingest equals prefetch
ingest exactly, the uint8 wire is within rtol 1e-3 of the f32 wire (it is
in fact equal here: no FMA contraction on either side), a tuned run equals
an untuned one, a resumed run continues the uninterrupted batch sequence,
and the flag checks are the JAX trainer's, with its exit code 2.
"""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.data import dataset as jdataset
from tf_operator_tpu.data import staging as jstaging
from tf_operator_tpu_torch import chaos
from tf_operator_tpu_torch.data import dataset, prefetch, staging
from tf_operator_tpu_torch.models import mnist, train


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (tests/test_torch_flash_attention.py says why):
    the trainer comparisons here are bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dataset(tmp_path, n=64, shards=4):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, size=(n,)).astype(np.int32)
    d = str(tmp_path / "ds")
    dataset.write_array_shards(d, {"x": x, "y": y}, shards)
    return d, x, y


def _u8_dataset(tmp_path, n=64, side=28, label_dtype=np.int32):
    rng = np.random.default_rng(0)
    d = str(tmp_path / f"u8ds-{np.dtype(label_dtype).name}")
    dataset.write_array_shards(d, {
        "x": rng.integers(0, 256, size=(n, side, side), dtype=np.uint8),
        "y": rng.integers(0, 10, size=(n,)).astype(label_dtype)}, 2)
    return d


# --- the dataset ---------------------------------------------------------


class TestShardedDataset:
    def test_roundtrip_single_reader(self, tmp_path):
        d, x, y = _dataset(tmp_path)
        ds = dataset.ShardedDataset(d)
        assert ds.num_samples == 64
        got = next(ds.batches(64, seed=None, loop=False))
        np.testing.assert_array_equal(got["x"], x)
        np.testing.assert_array_equal(got["y"], y)

    def test_readers_cover_disjointly(self, tmp_path):
        d, _, y = _dataset(tmp_path, n=60, shards=6)
        seen = [b["y"] for r in range(3)
                for b in dataset.ShardedDataset(d, r, 3).batches(10, seed=None, loop=False)]
        all_y = np.concatenate(seen)
        assert len(all_y) == 60
        np.testing.assert_array_equal(np.sort(all_y), np.sort(y))

    def test_shuffle_is_epoch_deterministic(self, tmp_path):
        d, _, _ = _dataset(tmp_path)

        def take():
            return [b["y"].copy() for _, b in
                    zip(range(6), dataset.ShardedDataset(d).batches(16, seed=7))]

        a, b = take(), take()
        for xa, xb in zip(a, b):
            np.testing.assert_array_equal(xa, xb)
        # A new epoch reshuffles (4 batches an epoch here).
        assert not np.array_equal(np.concatenate(a[:4]), np.concatenate(a[4:] + a[:2]))

    def test_start_batch_fast_forward(self, tmp_path):
        d, _, _ = _dataset(tmp_path)
        full = [b["y"].copy() for _, b in zip(range(6), dataset.ShardedDataset(d).batches(
            16, seed=3))]
        ff = [b["y"].copy() for _, b in zip(range(3), dataset.ShardedDataset(d).batches(
            16, seed=3, start_batch=3))]
        for a, b in zip(full[3:], ff):
            np.testing.assert_array_equal(a, b)

    def test_remainder_dropped(self, tmp_path):
        d, _, _ = _dataset(tmp_path, n=50, shards=2)
        batches = list(dataset.ShardedDataset(d).batches(16, seed=None, loop=False))
        assert len(batches) == 3
        assert all(b["x"].shape == (16, 28, 28) for b in batches)

    def test_bad_configurations_refused(self, tmp_path):
        d, _, _ = _dataset(tmp_path, shards=2)
        with pytest.raises(ValueError):
            dataset.ShardedDataset(d, reader_index=2, num_readers=2)
        with pytest.raises(ValueError):
            dataset.ShardedDataset(d, reader_index=2, num_readers=3)
        with pytest.raises(ValueError, match="disagree"):
            dataset.write_array_shards(str(tmp_path / "bad"),
                                       {"x": np.zeros((4, 2)), "y": np.zeros((5,))}, 2)
        with pytest.raises(ValueError, match="> local samples"):
            next(dataset.ShardedDataset(d).batches(65))
        with pytest.raises(FileNotFoundError):
            dataset.ShardedDataset(str(tmp_path / "missing"))

    def test_misaligned_hand_written_shards_rejected(self, tmp_path):
        d = tmp_path / "misaligned"
        d.mkdir()
        np.save(d / "x_00000.npy", np.zeros((3, 2)))
        np.save(d / "x_00001.npy", np.zeros((1, 2)))
        np.save(d / "y_00000.npy", np.zeros((2,)))
        np.save(d / "y_00001.npy", np.zeros((2,)))
        (d / "dataset.json").write_text(json.dumps(
            {"num_shards": 2, "total_samples": 4,
             "keys": {"x": {"dtype": "float64", "shape": [2]},
                      "y": {"dtype": "float64", "shape": []}}}))
        with pytest.raises(ValueError, match="per-shard"):
            dataset.ShardedDataset(str(d))

    @pytest.mark.parametrize("readers,start", [(1, 0), (1, 5), (2, 3)])
    def test_batches_equal_the_jax_datasets_byte_for_byte(self, tmp_path, readers, start):
        """One directory, written by the JAX module's writer; both readers
        from the same seed and start_batch, across epoch boundaries."""
        rng = np.random.default_rng(1)
        d = str(tmp_path / "jds")
        jdataset.write_array_shards(d, {
            "x": rng.integers(0, 256, size=(70, 6, 6, 3), dtype=np.uint8),
            "y": rng.integers(0, 1000, size=(70,)).astype(np.int32),
            "tokens": rng.integers(0, 30522, size=(70, 9)).astype(np.int32)}, 4)
        for r in range(readers):
            ours = dataset.ShardedDataset(d, r, readers).batches(8, seed=0, start_batch=start)
            theirs = jdataset.ShardedDataset(d, r, readers).batches(8, seed=0,
                                                                    start_batch=start)
            for _ in range(9):
                a, b = next(ours), next(theirs)
                assert sorted(a) == sorted(b)
                for k in a:
                    assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()

    def test_written_files_equal_the_jax_writers(self, tmp_path):
        rng = np.random.default_rng(2)
        arrays = {"x": rng.integers(0, 256, size=(10, 4), dtype=np.uint8),
                  "y": rng.integers(0, 10, size=(10,)).astype(np.int32)}
        ours = dataset.write_array_shards(str(tmp_path / "a"), arrays, 3)
        theirs = jdataset.write_array_shards(str(tmp_path / "b"), arrays, 3)
        assert [p.split("/")[-1] for p in ours] == [p.split("/")[-1] for p in theirs]
        for a, b in zip(ours + [str(tmp_path / "a/dataset.json")],
                        theirs + [str(tmp_path / "b/dataset.json")]):
            assert open(a, "rb").read() == open(b, "rb").read()

    def test_shard_from_env(self, monkeypatch):
        monkeypatch.delenv("JAX_PROCESS_ID", raising=False)
        monkeypatch.delenv("JAX_NUM_PROCESSES", raising=False)
        assert dataset.shard_from_env() == (0, 1)
        monkeypatch.setenv("JAX_PROCESS_ID", "1")
        monkeypatch.setenv("JAX_NUM_PROCESSES", "3")
        assert dataset.shard_from_env() == jdataset.shard_from_env() == (1, 3)


# --- the prefetch thread -------------------------------------------------


class TestPrefetch:
    def test_order_values_and_tensors(self, tmp_path):
        d, x, _ = _dataset(tmp_path)
        batches = list(prefetch.prefetch_to_device(
            dataset.ShardedDataset(d).batches(16, seed=None, loop=False), depth=2))
        assert len(batches) == 4
        assert isinstance(batches[0]["x"], torch.Tensor)
        np.testing.assert_array_equal(batches[0]["x"].numpy(), x[:16])
        np.testing.assert_array_equal(batches[3]["x"].numpy(), x[48:])

    def test_error_propagates(self):
        def boom():
            yield {"x": np.zeros(2)}
            raise RuntimeError("reader died")

        it = prefetch.prefetch_to_device(boom(), depth=1)
        next(it)
        with pytest.raises(RuntimeError, match="reader died"):
            list(it)

    def test_stats_measure_overlap(self, tmp_path):
        d, _, _ = _dataset(tmp_path)

        def paced():  # a producer of known cost, 20 ms a batch
            for batch in dataset.ShardedDataset(d).batches(16, seed=None, loop=False):
                time.sleep(0.02)
                yield batch

        stats: dict = {}
        for _ in prefetch.prefetch_to_device(paced(), depth=2, stats=stats):
            time.sleep(0.05)  # "compute" dominates: the transfers hide
        assert stats["batches_consumed"] == 4 and stats["input_s"] > 0
        eff = prefetch.overlap_efficiency(stats)
        assert eff is not None and 0.5 < eff <= 1.0, (eff, stats)

    def test_stats_none_until_steady_state(self):
        assert prefetch.overlap_efficiency({}) is None
        assert prefetch.overlap_efficiency(
            {"batches_consumed": 1, "input_s": 1.0, "consumer_wait_s": 0.0}) is None

    def test_read_only_arrays_are_copied(self):
        x = np.arange(6, dtype=np.float32)
        x.flags.writeable = False
        (out,) = list(prefetch.prefetch_to_device(iter([{"x": x}])))
        np.testing.assert_array_equal(out["x"].numpy(), x)


# --- the wire format and codecs ------------------------------------------


class TestWireFormat:
    def test_auto_is_passthrough(self):
        b = {"x": np.zeros((4, 8, 8), np.uint8), "y": np.zeros(4, np.int32)}
        assert staging.to_wire(b, "auto") is b

    def test_constants_are_the_jax_modules(self):
        assert staging.U8_SCALE == jstaging.U8_SCALE
        assert staging.U8_SCALE.dtype == np.float32
        assert staging.U8_SHIFT == jstaging.U8_SHIFT
        assert staging.IMAGE_KEYS == jstaging.IMAGE_KEYS
        assert staging.WIRE_DTYPES == jstaging.WIRE_DTYPES
        assert staging.WIRE_CODECS == jstaging.WIRE_CODECS

    def test_normalize_equals_the_jax_one(self):
        """Host: bit for bit. The tensor path: bit for bit with the host
        (the same two f32 roundings), and with the JAX device path within
        the one rounding XLA may contract."""
        x = np.arange(256, dtype=np.uint8).reshape(16, 16)
        host = staging.normalize_uint8(x)
        assert host.dtype == np.float32
        assert host.tobytes() == jstaging.normalize_uint8(x).tobytes()
        dev = staging.normalize_uint8(torch.from_numpy(x))
        assert dev.dtype == torch.float32 and dev.numpy().tobytes() == host.tobytes()
        np.testing.assert_allclose(dev.numpy(), np.array(jstaging.normalize_uint8(
            jnp.asarray(x))), rtol=0, atol=2e-7)
        assert float(dev.min()) == -1.0 and float(dev.max()) == 1.0

    @pytest.mark.parametrize("wire", ["auto", "uint8", "f32"])
    def test_to_wire_equals_the_jax_one(self, wire):
        rng = np.random.default_rng(4)
        b = {"x": rng.integers(0, 256, (4, 8, 8), dtype=np.uint8),
             "y": rng.integers(0, 10, (4,), dtype=np.uint8),
             "mask": (rng.random((4, 8)) < 0.5).astype(np.uint8)}
        ours, theirs = staging.to_wire(b, wire), jstaging.to_wire(b, wire)
        assert sorted(ours) == sorted(theirs)
        for k in ours:
            assert ours[k].dtype == theirs[k].dtype
            assert ours[k].tobytes() == theirs[k].tobytes()
        # uint8 outside the image keys is data: never normalised.
        assert ours["y"].dtype == np.uint8 and ours["mask"].dtype == np.uint8

    def test_uint8_wire_rejects_float_images_and_bad_dtype(self):
        with pytest.raises(ValueError, match="uint8-stored"):
            staging.to_wire({"x": np.zeros((2, 2), np.float32)}, "uint8")
        out = staging.to_wire({"x": np.zeros((2, 2), np.int32)}, "uint8")
        assert out["x"].dtype == np.int32
        with pytest.raises(ValueError, match="wire_dtype"):
            staging.to_wire({}, "f16")

    def test_preprocess_normalises_only_uint8_images(self):
        pre = staging.make_preprocess_fn()
        b = {"x": torch.arange(4, dtype=torch.uint8), "y": torch.arange(4, dtype=torch.uint8),
             "tokens": torch.arange(4, dtype=torch.int32)}
        out = pre(b)
        assert out["x"].dtype == torch.float32 and out["y"] is b["y"]
        assert out["tokens"] is b["tokens"]
        f = {"x": torch.zeros(3)}
        assert pre(f)["x"] is f["x"]


class TestWireCodec:
    @pytest.mark.parametrize("dtype,shape", [
        (np.uint8, (8, 32, 32, 3)), (np.float32, (4, 512)), (np.int32, (4096,)),
        (np.float16, (2, 600))])
    def test_roundtrip_exact_any_dtype(self, dtype, shape):
        rng = np.random.default_rng(5)
        x = (rng.integers(0, 200, size=shape) if np.dtype(dtype).kind in "ui"
             else rng.standard_normal(shape)).astype(dtype)
        enc = staging.encode_batch({"x": x}, "zlib")
        assert isinstance(enc["x"], staging.Encoded)
        assert enc["x"].payload == jstaging.encode_batch({"x": x}, "zlib")["x"].payload
        back = staging.decode_batch(enc)["x"]
        assert back.dtype == x.dtype and back.shape == x.shape
        assert back.tobytes() == x.tobytes()

    def test_small_leaves_none_codec_and_bad_codec(self):
        b = {"y": np.arange(10, dtype=np.int32), "x": np.zeros((64, 64), np.uint8)}
        enc = staging.encode_batch(b, "zlib")
        assert enc["y"] is b["y"] and isinstance(enc["x"], staging.Encoded)
        assert staging.encoded_nbytes(enc) == enc["x"].nbytes + b["y"].nbytes
        assert staging.encode_batch(b, "none") is b
        with pytest.raises(ValueError, match="codec"):
            staging.encode_batch(b, "lz4")


# --- the staging ring ----------------------------------------------------


def _batches(n, rows=4, side=16, sleep_s=0.0):
    rng = np.random.default_rng(6)
    for _ in range(n):
        if sleep_s:
            time.sleep(sleep_s)
        yield {"x": rng.standard_normal((rows, side)).astype(np.float32),
               "y": rng.integers(0, 10, (rows,)).astype(np.int32)}


def _numbered(n, rows=4, side=16):
    """Batch i carries i in every element: order errors show in the values."""
    for i in range(n):
        yield {"x": np.full((rows, side), i, np.float32), "y": np.full((rows,), i, np.int32)}


def _check_accounting(stats, n, per_batch_bytes):
    assert stats["wall_s"] == pytest.approx(
        stats["consumer_wait_s"] + stats["consumer_busy_s"], abs=1e-3)
    assert stats["batches_consumed"] == stats["batches_staged"] == n
    assert stats["bytes_staged"] == n * per_batch_bytes
    assert staging.transfer_mb_per_s(stats) > 0
    assert stats["input_s"] == pytest.approx(
        stats["host_s"] + stats["encode_s"] + stats["decode_s"] + stats["transfer_s"],
        abs=1e-6)


class TestStagingRing:
    def test_order_and_values(self):
        src = list(_batches(5))
        out = list(staging.stage_to_device(iter(src), depth=2, chunks=2))
        assert len(out) == 5
        for a, b in zip(src, out):
            assert isinstance(b["x"], torch.Tensor)
            np.testing.assert_array_equal(a["x"], b["x"].numpy())
            np.testing.assert_array_equal(a["y"], b["y"].numpy())

    def test_chunked_values_roundtrip(self):
        """Over MIN_CHUNK_BYTES, so the arrays really go as chunks and are
        reassembled in order."""
        src = [{"x": np.arange(8 * 65536, dtype=np.float32).reshape(8, 65536) + i}
               for i in range(4)]
        stats: dict = {}
        out = list(staging.stage_to_device(iter(src), depth=2, chunks=4, stats=stats))
        assert stats["chunks_effective"] == 4
        for a, b in zip(src, out):
            np.testing.assert_array_equal(a["x"], b["x"].numpy())

    def test_effective_chunks_degrades(self):
        big = np.zeros((24, 65536), np.float32)
        assert staging.effective_chunks(big, 4) == 4
        assert staging.effective_chunks(big, 5) == 4  # largest divisor <= 5
        assert staging.effective_chunks(np.zeros((23, 65536), np.float32), 4) == 1
        assert staging.effective_chunks(np.zeros((24, 4), np.float32), 4) == 1
        assert staging.effective_chunks(torch.zeros(24, 65536), 3) == 3

    def test_error_propagates(self):
        def boom():
            yield {"x": np.zeros(2, np.float32)}
            raise RuntimeError("reader died")

        it = staging.stage_to_device(boom(), depth=1)
        next(it)
        with pytest.raises(RuntimeError, match="reader died"):
            list(it)

    @pytest.mark.parametrize("kw,match", [({"depth": 0}, "depth"), ({"chunks": 0}, "chunks"),
                                          ({"lanes": 0}, "lanes"), ({"codec": "lz4"}, "codec")])
    def test_bad_config(self, kw, match):
        with pytest.raises(ValueError, match=match):
            next(staging.stage_to_device(iter([]), **kw))

    @pytest.mark.parametrize("depth,lanes", [(2, 1), (3, 3)])
    def test_ring_bounds_readahead(self, depth, lanes):
        """With the consumer stalled after one take, the lanes finish at
        most consumed + depth batches however fast the source is."""
        stats: dict = {}
        it = staging.stage_to_device(_numbered(16), depth=depth, lanes=lanes, stats=stats)
        next(it)
        time.sleep(0.3)
        assert stats["batches_staged"] <= 1 + depth, stats
        it.close()

    def test_overlap_hidden_under_slow_consumer(self):
        stats: dict = {}
        for _ in staging.stage_to_device(_batches(6), depth=2, stats=stats):
            time.sleep(0.03)
        frac = staging.input_overlap_fraction(stats)
        assert frac is not None and frac > 0.5, (frac, stats)
        _check_accounting(stats, 6, 4 * 16 * 4 + 4 * 4)

    def test_slow_producer_shows_as_wait(self):
        stats: dict = {}
        for _ in staging.stage_to_device(_batches(6, sleep_s=0.04), depth=2, stats=stats):
            pass
        assert stats["consumer_wait_s"] > 0.1, stats
        frac = staging.input_overlap_fraction(stats)
        assert frac is not None and frac < 0.8, (frac, stats)
        _check_accounting(stats, 6, 4 * 16 * 4 + 4 * 4)

    def test_lanes_deliver_in_exact_order_and_are_capped(self):
        stats: dict = {}
        out = list(staging.stage_to_device(_numbered(12), depth=4, lanes=4, stats=stats))
        assert stats["lanes_effective"] == 4
        assert [int(b["y"][0]) for b in out] == list(range(12))
        stats = {}
        list(staging.stage_to_device(_numbered(3), depth=2, lanes=8, stats=stats))
        assert stats["lanes"] == 8 and stats["lanes_effective"] == 2

    def test_reassembly_order_under_random_lane_delays(self, monkeypatch):
        """Every transfer delayed at random, so lanes finish out of order
        all the time; chunked arrays too. The consumer still sees the exact
        order and values, and the accounting still telescopes."""
        rng = np.random.default_rng(7)
        lock = threading.Lock()

        def delay(index, stalls, lane=None):
            with lock:
                return float(rng.uniform(0, 0.008))

        monkeypatch.setattr(chaos, "staging_stalls_from_env", lambda env=None: [object()])
        monkeypatch.setattr(chaos, "staging_stall_delay", delay)
        src = [{"x": np.full((4, 65536), i, np.float32), "y": np.full((4,), i, np.int32)}
               for i in range(24)]
        stats: dict = {}
        out = list(staging.stage_to_device(iter(src), depth=3, lanes=3, chunks=2,
                                           stats=stats))
        assert stats["chunks_effective"] == 2
        assert [float(b["x"][0, 0]) for b in out] == [float(i) for i in range(24)]
        assert all(torch.all(b["x"] == i) for i, b in enumerate(out))
        _check_accounting(stats, 24, 4 * 65536 * 4 + 4 * 4)

    def test_stalled_lane_delays_only_its_slots(self, monkeypatch):
        monkeypatch.setenv("TPUJOB_CHAOS", "stall:lane=0,delay=0.05")
        stats: dict = {}
        out = list(staging.stage_to_device(_numbered(6), depth=2, lanes=2, stats=stats))
        assert [int(b["y"][0]) for b in out] == list(range(6))
        assert 0.04 <= stats["transfer_s"] < 0.3, stats

    def test_lane_threads_run_no_compute(self, monkeypatch):
        """The thread rule in torch terms: a lane only copies. torch.cat
        (chunk reassembly) and the normalisation of a tensor fail if a lane
        thread calls them; they run on the consumer thread."""
        calls = {"cat": set(), "normalize": set()}
        real_cat, real_norm = torch.cat, staging.normalize_uint8

        def on_consumer(kind, is_tensor=True):
            name = threading.current_thread().name
            if name.startswith("staging-") and is_tensor:
                raise AssertionError(f"{kind} ran on lane thread {name}")
            calls[kind].add(name)

        def spy_cat(*a, **kw):
            on_consumer("cat")
            return real_cat(*a, **kw)

        def spy_norm(x):
            on_consumer("normalize", isinstance(x, torch.Tensor))
            return real_norm(x)

        monkeypatch.setattr(torch, "cat", spy_cat)
        monkeypatch.setattr(staging, "normalize_uint8", spy_norm)
        pre = staging.make_preprocess_fn()
        src = [{"x": np.full((8, 65536 * 4), i, np.uint8), "y": np.full((8,), i, np.int32)}
               for i in range(6)]
        stats: dict = {}
        out = [pre(b) for b in staging.stage_to_device(iter(src), depth=2, lanes=2, chunks=4,
                                                       stats=stats)]
        assert stats["chunks_effective"] == 4 and stats["lanes_effective"] == 2
        for i, b in enumerate(out):
            assert b["x"].dtype == torch.float32
            assert float(b["x"][0, 0]) == float(staging.U8_SCALE * np.float32(i) - 1)
        assert calls["cat"] and calls["normalize"], calls
        assert not any(n.startswith("staging-") for n in calls["cat"] | calls["normalize"])

    def test_ring_with_codec_values_and_ledger(self):
        rng = np.random.default_rng(8)
        src = [{"x": rng.integers(0, 8, (16, 32, 32), dtype=np.uint8),
                "y": np.arange(16, dtype=np.int32)} for _ in range(4)]
        stats: dict = {}
        out = list(staging.stage_to_device(iter(src), depth=2, lanes=2, codec="zlib",
                                           stats=stats))
        for a, b in zip(src, out):
            assert a["x"].tobytes() == b["x"].numpy().tobytes()
        assert stats["codec"] == "zlib"
        assert 0 < stats["bytes_encoded"] < stats["bytes_staged"]
        assert stats["encode_s"] > 0 and stats["decode_s"] >= 0


class TestAutotune:
    def test_probe_table_and_pick(self):
        batch = {"x": np.random.default_rng(11).integers(0, 256, (16, 32, 32),
                                                         dtype=np.uint8)}
        tune = staging.autotune_staging(batch, lanes_grid=(1, 2), chunks_grid=(1, 2), reps=2)
        assert {(r["lanes"], r["chunks"]) for r in tune["table"]} == {(1, 1), (2, 1)}
        requested = sorted(tuple(rq) for r in tune["table"] for rq in r["requested"])
        assert requested == [(1, 1), (1, 2), (2, 1), (2, 2)]
        best = max(tune["table"], key=lambda r: r["mb_per_s"])
        assert (tune["lanes"], tune["chunks"]) == (best["lanes"], best["chunks"])
        assert tune["mb_per_s"] == best["mb_per_s"] > 0
        assert tune["reps"] == 2 and tune["probe_s"] >= 0

    def test_depth_caps_probes_and_big_batches_chunk(self):
        batch = {"x": np.zeros((16, 65536), np.float32)}
        tune = staging.autotune_staging(batch, lanes_grid=(1, 2, 4), chunks_grid=(1, 4),
                                        reps=2, depth=2)
        assert {(r["lanes"], r["chunks"]) for r in tune["table"]} == {
            (1, 1), (1, 4), (2, 1), (2, 4)}
        capped = [r for r in tune["table"] if (r["lanes"], r["chunks"]) == (2, 1)][0]
        assert [4, 1] in capped["requested"]
        assert (tune["lanes"], tune["chunks"]) in {(r["lanes"], r["chunks"])
                                                   for r in tune["table"]}

    def test_empty_grid_rejected_and_batch_untouched(self):
        with pytest.raises(ValueError, match="empty probe grid"):
            staging.autotune_staging({"x": np.zeros((2, 2), np.uint8)}, lanes_grid=())
        x = np.arange(4 * 64, dtype=np.uint8).reshape(4, 64)
        keep = x.copy()
        staging.autotune_staging({"x": x}, lanes_grid=(1,), chunks_grid=(1,), reps=2)
        np.testing.assert_array_equal(x, keep)


# --- the trainer on CPU shards -------------------------------------------


def _run(tmp_path, monkeypatch, d, tag, extra, steps=6, model="mnist-mlp"):
    metrics = tmp_path / f"ev-{tag}.jsonl"
    monkeypatch.setenv("TPUJOB_METRICS_FILE", str(metrics))
    rc = train.main(["--device", "cpu", "--model", model, "--steps", str(steps),
                     "--batch", "16", "--data-dir", d, "--log-every", "1", *extra])
    assert rc == 0
    ev = [json.loads(x) for x in metrics.read_text().splitlines()]
    losses = [e["loss"] for e in ev if e["event"] in ("first_step", "progress")]
    return losses, [e for e in ev if e["event"] == "done"][-1], ev


def test_mnist_data_dir_follows_the_jax_trainer(tmp_path, monkeypatch):
    """The same shards, the same initial weights (the JAX trainer's init,
    carried into the port's model): the port's --data-dir trajectory is the
    JAX trainer's, and the events carry the same data-path fields. The MLP
    computes in bf16, whose batch sums (the bias gradients) the two sides
    round in another order: 6.6e-4 relative was seen at step 5, so the
    steps are held at rtol 2e-3 and the first loss, before any update, at
    1e-6."""
    from tf_operator_tpu.models import mnist as jmnist
    from tf_operator_tpu.models import train as jtrain

    d, _, _ = _dataset(tmp_path, n=64, shards=2)
    params = jmnist.MLP().init(jax.random.key(0), jnp.zeros((1, 28, 28), jnp.float32))["params"]
    build = train._build_model

    def build_from_jax_init(args, device, mesh=None):
        model, loss_fn, make_batch = build(args, device, mesh)
        model.load_state_dict(mnist.params_from_flax(jax.tree.map(np.array, params)))
        return model, loss_fn, make_batch

    monkeypatch.setattr(train, "_build_model", build_from_jax_init)
    ours, done, ev = _run(tmp_path, monkeypatch, d, "port", [])
    jmetrics = tmp_path / "ev-jax.jsonl"
    monkeypatch.setenv("TPUJOB_METRICS_FILE", str(jmetrics))
    # One device, as the port's trainer runs (the tests' default is an
    # 8-device CPU mesh, which splits the batch sums another way).
    from tf_operator_tpu.parallel import mesh as mesh_lib

    monkeypatch.setattr(mesh_lib, "mesh_from_env",
                        lambda devices=None: mesh_lib.make_mesh({"dp": 1}, jax.devices()[:1]))
    assert jtrain.main(["--model", "mnist-mlp", "--steps", "6", "--batch", "16",
                        "--data-dir", d, "--log-every", "1"]) == 0
    jev = [json.loads(x) for x in jmetrics.read_text().splitlines()]
    theirs = [e["loss"] for e in jev if e["event"] in ("first_step", "progress")]
    assert len(ours) == len(theirs) == 6
    assert ours[0] == pytest.approx(theirs[0], rel=1e-6)
    np.testing.assert_allclose(ours, theirs, rtol=2e-3)
    first = {e["event"]: e for e in ev}["first_step"]
    jfirst = {e["event"]: e for e in jev}["first_step"]
    for key in ("data_dir", "local_samples", "steps_in_first_call"):
        assert first[key] == jfirst[key]
    jdone = [e for e in jev if e["event"] == "done"][-1]
    assert set(done["prefetch"]) == set(jdone["prefetch"])
    assert done["prefetch"]["batches"] == jdone["prefetch"]["batches"] == 6


def test_staged_equals_prefetch_exactly(tmp_path, monkeypatch):
    d = _u8_dataset(tmp_path)
    st, done, _ = _run(tmp_path, monkeypatch, d, "st",
                       ["--input-staging", "staged", "--wire-dtype", "uint8",
                        "--staging-chunks", "2", "--staging-lanes", "2"])
    pf, pdone, _ = _run(tmp_path, monkeypatch, d, "pf",
                        ["--input-staging", "prefetch", "--wire-dtype", "uint8"])
    assert st == pf
    assert done["staging"]["lanes"] == done["staging"]["lanes_effective"] == 2
    assert pdone["prefetch"]["batches"] == 6 and "staging" not in pdone


def test_uint8_wire_within_rtol_of_the_f32_wire(tmp_path, monkeypatch):
    d = _u8_dataset(tmp_path)
    u8, _, _ = _run(tmp_path, monkeypatch, d, "u8", ["--input-staging", "staged",
                                                     "--wire-dtype", "uint8"])
    f32, done, _ = _run(tmp_path, monkeypatch, d, "f32", ["--input-staging", "staged",
                                                          "--wire-dtype", "f32"])
    np.testing.assert_allclose(u8, f32, rtol=1e-3)
    assert abs(u8[0] - f32[0]) < 1e-4
    # The f32 wire moves four times the image bytes.
    assert done["staging"]["bytes_staged_mb"] > 3.5 * 6 * 16 * 28 * 28 / 1e6


def test_zlib_codec_and_tuned_runs_equal_the_plain_run(tmp_path, monkeypatch):
    d = _u8_dataset(tmp_path)
    plain, _, _ = _run(tmp_path, monkeypatch, d, "plain", ["--input-staging", "staged",
                                                           "--wire-dtype", "uint8"])
    zl, done, ev = _run(tmp_path, monkeypatch, d, "zl",
                        ["--input-staging", "staged", "--wire-dtype", "uint8",
                         "--wire-codec", "zlib", "--staging-lanes", "2", "--staging-tune"])
    assert zl == plain
    s = done["staging"]
    assert s["codec"] == "zlib" and s["bytes_encoded_mb"] > 0 and s["codec_ratio"] > 0
    tuned = [e for e in ev if e["event"] == "staging_tuned"]
    assert len(tuned) == 1
    tune = s["tune"]
    assert (tuned[0]["lanes"], tuned[0]["chunks"]) == (tune["lanes"], tune["chunks"]) == (
        s["lanes"], s["chunks"])
    assert len([rq for r in tune["table"] for rq in r["requested"]]) == 9


def test_staged_done_event_accounting(tmp_path, monkeypatch):
    d = _u8_dataset(tmp_path)
    _, done, _ = _run(tmp_path, monkeypatch, d, "acct",
                      ["--input-staging", "staged", "--wire-dtype", "uint8",
                       "--staging-depth", "3", "--staging-chunks", "2"])
    s = done["staging"]
    assert s["depth"] == 3 and s["chunks"] == 2 and s["chunks_effective"] == 1
    assert s["wire_dtype"] == "uint8" and s["batches"] == 6
    assert 6 <= s["batches_staged"] <= 6 + 3
    assert s["bytes_staged_mb"] == pytest.approx(
        s["batches_staged"] * (16 * 28 * 28 + 16 * 4) / 1e6, rel=1e-2)
    assert s["wall_s"] == pytest.approx(s["consumer_wait_s"] + s["consumer_busy_s"], abs=5e-3)
    assert s["input_overlap_fraction"] is None or 0 <= s["input_overlap_fraction"] <= 1
    assert done["phase_breakdown"]["data_wait"] >= 0


def test_uint8_labels_train_as_integers(tmp_path, monkeypatch):
    d = _u8_dataset(tmp_path, n=32, label_dtype=np.uint8)
    _, done, _ = _run(tmp_path, monkeypatch, d, "u8y", ["--input-staging", "staged",
                                                        "--wire-dtype", "uint8"])
    assert np.isfinite(done["final_loss"])


def test_resnet_loss_normalises_raw_uint8(tmp_path):
    """The JAX ResNet loss's uint8 branch: raw uint8 pixels handed to the
    loss train as their normalised f32 values."""
    args = train.build_parser().parse_args(["--model", "resnet18", "--image-size", "16",
                                            "--batch", "2", "--device", "cpu"])
    model, loss_fn, _ = train._build_model(args, torch.device("cpu"))
    x = torch.randint(0, 256, (2, 16, 16, 3), generator=torch.Generator().manual_seed(0),
                      dtype=torch.uint8)
    y = torch.tensor([1, 2])
    with torch.no_grad():
        raw = loss_fn(model, {"x": x, "y": y})
        normed = loss_fn(model, {"x": staging.normalize_uint8(x), "y": y})
    assert float(raw) == float(normed)


def test_resume_continues_the_uninterrupted_batch_sequence(tmp_path, monkeypatch):
    d = _u8_dataset(tmp_path)
    staged = ["--input-staging", "staged", "--wire-dtype", "uint8", "--staging-lanes", "2"]
    full, _, _ = _run(tmp_path, monkeypatch, d, "full", staged)
    ck = str(tmp_path / "ck")
    first, _, _ = _run(tmp_path, monkeypatch, d, "a", staged + ["--checkpoint-dir", ck],
                       steps=3)
    rest, done, ev = _run(tmp_path, monkeypatch, d, "b", staged + ["--checkpoint-dir", ck])
    resumed = [e for e in ev if e["event"] == "resumed"]
    assert resumed and resumed[-1]["from_step"] == 3
    assert first + rest == full
    assert done["steps"] == 6 and done["staging"]["batches"] == 3


def test_bert_trains_from_token_shards(tmp_path, monkeypatch):
    """Any model whose batch keys the shards carry: BERT's tokens,
    targets and mask."""
    rng = np.random.default_rng(9)
    targets = rng.integers(0, 1024, (32, 16)).astype(np.int32)
    mask = (rng.random((32, 16)) < 0.15).astype(np.float32)
    d = str(tmp_path / "mlm")
    dataset.write_array_shards(d, {"tokens": np.where(mask > 0, 103, targets).astype(np.int32),
                                   "targets": targets, "mask": mask}, 2)
    losses, done, _ = _run(tmp_path, monkeypatch, d, "bert", ["--seq", "16"], steps=3,
                           model="bert-tiny")
    assert len(losses) == 3 and np.isfinite(done["final_loss"])


@pytest.mark.parametrize("extra,match", [
    (["--staging-lanes", "0"], "--staging-lanes must be >= 1"),
    (["--staging-depth", "0"], "--staging-depth must be >= 1"),
    (["--staging-chunks", "0"], "--staging-chunks must be >= 1"),
    (["--input-staging", "prefetch", "--staging-lanes", "2"], "staging RING"),
    (["--input-staging", "prefetch", "--staging-tune"], "staging RING"),
    (["--input-staging", "prefetch", "--wire-codec", "zlib"], "staging RING"),
    (["--no-data-dir", "--input-staging", "staged", "--staging-tune"], "no wire to shape"),
    (["--no-data-dir", "--wire-dtype", "uint8"], "no wire to shape"),
])
def test_flag_errors_are_the_jax_trainers(tmp_path, capsys, extra, match):
    from tf_operator_tpu.models import train as jtrain

    argv = ["--model", "mnist-mlp", "--steps", "1", "--batch", "16"]
    if extra[0] == "--no-data-dir":
        extra = extra[1:]
    else:
        argv += ["--data-dir", _u8_dataset(tmp_path)]
    for main in (train.main, jtrain.main):
        with pytest.raises(SystemExit) as e:
            main([*argv, *extra])
        assert e.value.code == 2
        assert match in capsys.readouterr().err
