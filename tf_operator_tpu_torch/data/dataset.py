"""Sharded on-disk datasets: own copy of tf_operator_tpu/data/dataset.py.

The port may not import the JAX package, not even this numpy-only module,
so it keeps this copy; the layout, the batch order and the checks are the
JAX module's, byte for byte (tests/test_torch_data.py holds the two
against each other on one directory):

  - shards are plain .npy files per key (`{key}_{shard:05d}.npy`) beside a
    `dataset.json` manifest, loaded with mmap so a pod touches only the
    pages its batches read;
  - `shard_from_env()` picks this replica's shard list from the process
    env the operator injects (JAX_PROCESS_ID / JAX_NUM_PROCESSES), giving
    disjoint coverage with no coordination; a pod of several local ranks
    reads as one replica, each rank taking its block of the pod's rows
    (`local_part`: the port's addition, the JAX module has one process a
    pod);
  - batches are numpy dicts with a fixed shape (the remainder of an epoch
    is dropped), shuffled per epoch from (seed + epoch), and `start_batch`
    fast-forwards the stream so a resumed trainer continues it.
"""

from __future__ import annotations

import json
import os
from typing import Iterator

import numpy as np

MANIFEST = "dataset.json"


def write_array_shards(
    out_dir: str, arrays: dict[str, np.ndarray], num_shards: int
) -> list[str]:
    """Split `arrays` (all with equal leading dim) into `num_shards` shard
    files per key plus a manifest; returns the shard file paths."""
    n = {a.shape[0] for a in arrays.values()}
    if len(n) != 1:
        raise ValueError(f"arrays disagree on sample count: { {k: v.shape for k, v in arrays.items()} }")
    total = n.pop()
    if num_shards < 1 or num_shards > total:
        raise ValueError(f"num_shards {num_shards} not in [1, {total}]")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    bounds = np.linspace(0, total, num_shards + 1).astype(int)
    for key, arr in arrays.items():
        for s in range(num_shards):
            path = os.path.join(out_dir, f"{key}_{s:05d}.npy")
            np.save(path, arr[bounds[s]:bounds[s + 1]])
            paths.append(path)
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(
            {
                "num_shards": num_shards,
                "total_samples": int(total),
                "keys": {
                    k: {"dtype": str(a.dtype), "shape": list(a.shape[1:])}
                    for k, a in arrays.items()
                },
            },
            f,
        )
    return paths


def shard_from_env() -> tuple[int, int]:
    """(shard_index, num_readers) from the operator-injected process env;
    (0, 1) for standalone runs. The reader is the pod: a pod's local ranks
    (parallel/launch.py, which rewrites JAX_PROCESS_ID to the global rank
    and keeps the pod's own in TPUJOB_POD_PROCESS_ID) read its shards, as
    the JAX trainer's one process a pod does."""
    pid = int(os.environ.get("TPUJOB_POD_PROCESS_ID") or os.environ.get("JAX_PROCESS_ID", "0"))
    nprocs = int(os.environ.get("TPUJOB_POD_NUM_PROCESSES")
                 or os.environ.get("JAX_NUM_PROCESSES", "1"))
    return pid, max(nprocs, 1)


def local_part_from_env() -> tuple[int, int]:
    """(local rank, local ranks) of this process in its pod (parallel/
    launch.py's TPUJOB_LOCAL_RANK / TPUJOB_LOCAL_RANKS); (0, 1) in a pod of
    one process."""
    return (int(os.environ.get("TPUJOB_LOCAL_RANK", "0")),
            max(int(os.environ.get("TPUJOB_LOCAL_RANKS", "1")), 1))


def local_part(batches: Iterator[dict], index: int, parts: int) -> Iterator[dict]:
    """The `index`-th of `parts` equal row blocks of each of the pod's
    batches, in device order: the rows the JAX trainer's process places on
    its `index`-th local device (its batch sharded over the data axes)."""
    if parts == 1:
        yield from batches
        return
    for batch in batches:
        rows = next(iter(batch.values())).shape[0] // parts
        yield {k: v[index * rows:(index + 1) * rows] for k, v in batch.items()}


class ShardedDataset:
    """mmap-backed view over this reader's shards.

    reader_index/num_readers select a disjoint subset of shards round-robin
    (shard s belongs to reader s % num_readers), so N replicas jointly cover
    the dataset exactly once per epoch.
    """

    def __init__(self, data_dir: str, reader_index: int = 0, num_readers: int = 1):
        if not os.path.isdir(data_dir):
            raise FileNotFoundError(data_dir)
        if not 0 <= reader_index < num_readers:
            raise ValueError(f"reader {reader_index} not in [0, {num_readers})")
        with open(os.path.join(data_dir, MANIFEST)) as f:
            self.manifest = json.load(f)
        self.data_dir = data_dir
        self.num_shards = int(self.manifest["num_shards"])
        self.keys = sorted(self.manifest["keys"])
        my_shards = [
            s for s in range(self.num_shards) if s % num_readers == reader_index
        ]
        if not my_shards:
            raise ValueError(
                f"reader {reader_index}/{num_readers} has no shards "
                f"(dataset has {self.num_shards})"
            )
        self._arrays: dict[str, np.ndarray] = {}
        for key in self.keys:
            parts = [
                np.load(
                    os.path.join(self.data_dir, f"{key}_{s:05d}.npy"),
                    mmap_mode="r",
                )
                for s in my_shards
            ]
            # Concatenation of mmaps materializes; keep the shard list and a
            # flat index instead so reads stay lazy.
            self._arrays[key] = parts  # type: ignore[assignment]
        # Per-shard lengths must match across keys, not just totals: _gather
        # builds shard offsets from the first key only, so misaligned
        # hand-written shards would silently pair rows across keys wrong.
        first_lens = [p.shape[0] for p in self._arrays[self.keys[0]]]
        for k in self.keys[1:]:
            lens_k = [p.shape[0] for p in self._arrays[k]]
            if lens_k != first_lens:
                raise ValueError(
                    f"per-shard lengths differ between keys: "
                    f"{self.keys[0]}={first_lens} vs {k}={lens_k}"
                )
        self.num_samples = sum(first_lens)
        self._offsets = np.cumsum([0] + first_lens)

    def _gather(self, key: str, idx: np.ndarray) -> np.ndarray:
        """Gather rows by flat local index across the shard list."""
        parts = self._arrays[key]
        out = None
        shard_of = np.searchsorted(self._offsets, idx, side="right") - 1
        for s, part in enumerate(parts):
            mask = shard_of == s
            if not mask.any():
                continue
            rows = np.asarray(part[idx[mask] - self._offsets[s]])
            if out is None:
                out = np.empty((len(idx),) + rows.shape[1:], rows.dtype)
            out[mask] = rows
        return out

    def batches(
        self,
        batch_size: int,
        seed: int | None = 0,
        loop: bool = True,
        start_batch: int = 0,
    ) -> Iterator[dict[str, np.ndarray]]:
        """Dict batches of `batch_size` (remainder dropped — static shapes).
        seed=None iterates in order; otherwise shuffles per epoch.
        start_batch fast-forwards the stream (deterministic position, so a
        resumed trainer continues the exact batch sequence rather than
        replaying epoch 0)."""
        if batch_size > self.num_samples:
            raise ValueError(
                f"batch {batch_size} > local samples {self.num_samples}"
            )
        per_epoch = self.num_samples // batch_size
        epoch, skip = divmod(max(start_batch, 0), per_epoch)
        while True:
            idx = np.arange(self.num_samples)
            if seed is not None:
                np.random.default_rng(seed + epoch).shuffle(idx)
            for b in range(skip, per_epoch):
                take = idx[b * batch_size:(b + 1) * batch_size]
                yield {k: self._gather(k, take) for k in self.keys}
            skip = 0
            if not loop:
                return
            epoch += 1
