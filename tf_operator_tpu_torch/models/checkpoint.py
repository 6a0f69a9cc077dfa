"""Checkpoint save/restore and the trainer->evaluator handoff protocol.

Counterpart of tf_operator_tpu/models/checkpoint.py, with the same public
names, the same directory layout and the same publish discipline; the
tensors are written with safetensors where the JAX package writes orbax
trees.

Layout:  <dir>/step_<N>/tree.safetensors          the parameters
         <dir>/trainstate_<N>/tree.safetensors    the resume payload
         <dir>/<name>.manifest.json               size census of <name>
         <dir>/<name>.sharding.json               gang shape, leaves, digests
         <dir>/FINAL                              text: last step number

A tree is a nested dict whose leaves are tensors (torch or numpy) or
Python scalars. Its tensors go into one file in the safetensors format
(an 8-byte header length, a JSON header of dtype, shape and byte range per
tensor, then the bytes), under their path in `jax.tree_util.keystr` form
(`['mu']['w']`); scalars (a step, an optimizer count) and the nesting go
into the header's `__metadata__`. The module writes and reads the format
itself, straight from and into each tensor's memory, so it needs no
package beyond torch and numpy; the `safetensors` package reads its files
and writes files it reads.

Publish discipline: save_named writes the whole tree under a tmp name
carrying TMP_PUBLISH_MARKER (the marker string of the JAX package, so
sweep_tmp_dirs treats a directory written by either the same way), then
publishes it with one rename and writes the census after it. A kill at
any point before the rename strands only tmp entries, which the startup
sweep removes; readers never see a partly written final name.

Dtype contract (mixed-precision optimizer state, tf_operator_tpu_torch/
optim.py): leaves save at their in-memory dtypes (bf16 Adam moments as
bf16, the f32 master copy as f32), and restore with a template CASTS to
the template's dtypes, so an all-f32 trainstate loads under a bf16-moment
config and vice versa. A template whose leaf list differs from the saved
tree's raises ValueError; the trainer's resume then falls back to a
params-only resume.

Single process: the sharding manifest records one process, one device,
the `{"dp": 1}` mesh and no PartitionSpec per leaf.

Tracing: save_named and restore_named record the `checkpoint/save` and
`checkpoint/restore` spans of the JAX module (telemetry/tracer.py; free
when --trace is off). Chaos: `stall:ckpt=N,delay=S` holds the save of step
N for S seconds between its finished tmp write and the publishing rename.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import time
import zlib
from typing import Any

import numpy as np
import torch

from tf_operator_tpu_torch.telemetry import tracer

_STEP_RE = re.compile(r"^step_(\d+)$")

# Sibling census ({relative path: byte size}) of a finished checkpoint,
# written after the publishing rename: its presence means the save ran to
# completion, a size or membership mismatch means a torn write.
MANIFEST_SUFFIX = ".manifest.json"
# Second sibling: the gang shape the checkpoint was saved from, per-leaf
# shape and dtype, and (when the saver asked for them) crc32 digests of the
# host bytes, which the resumed event reports back.
SHARDING_SUFFIX = ".sharding.json"
# Every save lands under <name><marker>-publish, then renames to <name>.
TMP_PUBLISH_MARKER = ".orbax-checkpoint-tmp"
TREE_FILE = "tree.safetensors"
# safetensors dtype codes.
_DTYPES = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
           torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
           torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}
_CODES = {code: dtype for dtype, code in _DTYPES.items()}


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

def _key(k: Any) -> str:
    """One path entry in jax.tree_util.keystr's form: [repr(key)]."""
    return f"[{k!r}]"


def flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """[(keystr path, leaf)] of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        out = []
        for k, child in tree.items():
            out += flatten(child, prefix + _key(k))
        return out
    return [(prefix, tree)]


def _leaf_bytes(leaf: Any) -> memoryview | bytes:
    """The raw bytes of a leaf as numpy would hold it: a tensor's storage
    bytes (bf16 included, which numpy lacks), an array's, or a scalar's
    np.asarray bytes."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous()
        return _bytes_of(t) if t.numel() else b""
    return np.ascontiguousarray(np.asarray(leaf)).tobytes()


def tree_digest(tree: Any) -> str:
    """crc32 over every leaf's raw bytes in path-sorted order, each path in
    keystr form: on the same nested numpy dict, the digest of
    tf_operator_tpu.models.checkpoint.tree_digest. Computed on host
    tensors."""
    crc = 0
    for key, leaf in sorted(flatten(tree), key=lambda kv: kv[0]):
        crc = zlib.crc32(key.encode(), crc)
        crc = zlib.crc32(_leaf_bytes(leaf), crc)
    return f"{crc:08x}"


def _dtype_name(leaf: Any) -> str:
    dtype = getattr(leaf, "dtype", None)
    return "" if dtype is None else str(dtype).removeprefix("torch.")


def leaf_shardings(tree: Any, specs: dict | None = None) -> dict[str, dict]:
    """{leaf path: {"spec", "shape", "dtype"}}, the JAX manifest's per-leaf
    layout: `specs` maps a leaf path (keystr) to the spec the leaf is
    sharded by across the gang (a tuple of None or axis names); a leaf
    without one records null (fully replicated). Shapes are the leaves'
    own: the full tensors a checkpoint holds."""
    specs = specs or {}
    return {key: {"spec": list(specs[key]) if key in specs else None,
                  "shape": [int(d) for d in getattr(leaf, "shape", ())],
                  "dtype": _dtype_name(leaf)}
            for key, leaf in flatten(tree)}


def _structure(tree: Any, tensors: dict, prefix: str = ""):
    """The tree's JSON skeleton: dicts as {"dict": [[key, child], ...]},
    tensors as {"tensor": path} (collected into `tensors`), scalars as
    {"scalar": value}."""
    if isinstance(tree, dict):
        return {"dict": [[k, _structure(c, tensors, prefix + _key(k))]
                         for k, c in tree.items()]}
    if isinstance(tree, (np.ndarray, np.generic)):
        tree = torch.from_numpy(np.ascontiguousarray(tree))
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        tensors[prefix] = t.contiguous()
        return {"tensor": prefix}
    if isinstance(tree, (bool, int, float)) or tree is None:
        return {"scalar": tree}
    raise TypeError(f"checkpoint leaf {prefix} is a {type(tree).__name__}")


def _rebuild(node: dict, tensors: dict):
    if "dict" in node:
        return {k: _rebuild(c, tensors) for k, c in node["dict"]}
    if "tensor" in node:
        return tensors[node["tensor"]]
    return node["scalar"]


def cast_to_template(tree: Any, template: Any, path: str = "") -> Any:
    """tree with every tensor leaf at the template's dtype (the leaf's
    .dtype, or the leaf itself when it is a torch.dtype; a copy only where
    the dtype changes). ValueError when the two trees' keys differ."""
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(tree) != set(template):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"checkpoint tree at {path or 'the root'} does not match "
                             f"the template: saved {got}, expected {sorted(template)}")
        return {k: cast_to_template(tree[k], template[k], path + _key(k)) for k in template}
    if isinstance(tree, dict):
        raise ValueError(f"checkpoint tree at {path} is a dict, the template's a leaf")
    dtype = template if isinstance(template, torch.dtype) else getattr(template, "dtype", None)
    if isinstance(tree, torch.Tensor) and isinstance(dtype, torch.dtype):
        return tree.to(dtype)
    return tree


def _bytes_of(t: torch.Tensor) -> memoryview:
    """A contiguous CPU tensor's bytes, without a copy."""
    return t.reshape(-1).view(torch.uint8).numpy().data


def write_tensors(path: str, tensors: dict[str, torch.Tensor],
                  metadata: dict[str, str]) -> None:
    """tensors (contiguous, on the CPU) into one safetensors file, in the
    dict's order, each written from its own memory."""
    header: dict[str, Any] = {"__metadata__": metadata}
    offset = 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for t in tensors.values():
            if t.numel():
                f.write(_bytes_of(t))


def read_tensors(path: str) -> tuple[dict[str, torch.Tensor], dict[str, str]]:
    """(tensors, metadata) of a safetensors file; each tensor owns its
    memory and is read straight into it."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        start = 8 + n
        metadata = header.pop("__metadata__", None) or {}
        tensors = {}
        for name, info in sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0]):
            begin, end = info["data_offsets"]
            t = torch.empty(info["shape"], dtype=_CODES[info["dtype"]])
            if t.numel() * t.element_size() != end - begin:
                raise ValueError(f"{path}: tensor {name} has {end - begin} bytes for "
                                 f"shape {info['shape']} {info['dtype']}")
            if end > begin:
                f.seek(start + begin)
                if f.readinto(_bytes_of(t)) != end - begin:
                    raise ValueError(f"{path}: tensor {name} is truncated")
            tensors[name] = t
    return tensors, metadata


# ---------------------------------------------------------------------------
# Manifests
# ---------------------------------------------------------------------------

def _manifest_path(ckpt_dir: str, name: str) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), name + MANIFEST_SUFFIX)


def _sharding_path(ckpt_dir: str, name: str) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), name + SHARDING_SUFFIX)


def _file_census(root: str) -> dict[str, int]:
    out: dict[str, int] = {}
    for dirpath, _, filenames in os.walk(root):
        for f in filenames:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = os.path.getsize(p)
    return out


def _write_json(path: str, obj: dict) -> str:
    tmp = f"{path}.tmp{os.getpid()}"  # unique per writer: replace is atomic
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)
    return path


def write_manifest(ckpt_dir: str, name: str) -> str:
    """Census the finished checkpoint <dir>/<name> into its manifest
    (tmp+rename, so a half-written manifest never validates)."""
    census = _file_census(os.path.join(os.path.abspath(ckpt_dir), name))
    return _write_json(_manifest_path(ckpt_dir, name),
                       {"name": name, "files": census, "total_bytes": sum(census.values())})


def write_sharding_manifest(ckpt_dir: str, name: str, info: dict) -> str:
    """Persist the sharding manifest beside <dir>/<name> (tmp+rename)."""
    return _write_json(_sharding_path(ckpt_dir, name), info)


def read_sharding_manifest(ckpt_dir: str, name: str) -> dict | None:
    """The sharding manifest of <dir>/<name>, or None when absent or torn:
    a checkpoint whose shape cannot be verified restores under same-shape
    semantics, it never crashes the resume walk."""
    try:
        with open(_sharding_path(ckpt_dir, name)) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    return manifest if isinstance(manifest, dict) else None


def validate_named(ckpt_dir: str, name: str) -> bool:
    """Is <dir>/<name> a complete checkpoint? With a manifest every
    censused file must exist at its recorded size; without one (a
    checkpoint from before manifests, or written by hand) True: the resume
    walk's restore still catches an unreadable tree."""
    root = os.path.join(os.path.abspath(ckpt_dir), name)
    if not os.path.isdir(root):
        return False
    try:
        with open(_manifest_path(ckpt_dir, name)) as f:
            files = json.load(f)["files"]
    except FileNotFoundError:
        return True  # pre-manifest checkpoint: unverifiable, not invalid
    except (OSError, ValueError, KeyError, TypeError):
        return False  # torn manifest: the save did not finish cleanly
    for rel, size in files.items():
        try:
            if os.path.getsize(os.path.join(root, rel)) != int(size):
                return False
        except (OSError, ValueError, TypeError):
            return False
    return True


def validate_step(ckpt_dir: str, step: int) -> bool:
    return validate_named(ckpt_dir, f"step_{step}")


# ---------------------------------------------------------------------------
# Save and restore
# ---------------------------------------------------------------------------

def save_named(ckpt_dir: str, name: str, tree: Any) -> str:
    """Atomically persist `tree` under <dir>/<name>; returns the path.
    The tree is written under the tmp name, published with one rename
    (replacing an earlier save of the same name), then censused."""
    root = os.path.abspath(ckpt_dir)
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, name)
    tmp = os.path.join(root, f"{name}{TMP_PUBLISH_MARKER}-publish")
    tensors: dict[str, torch.Tensor] = {}
    skeleton = _structure(tree, tensors)
    with tracer.span("checkpoint/save", ckpt=name):
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)  # a killed generation's leftover
        os.makedirs(tmp)
        write_tensors(os.path.join(tmp, TREE_FILE), tensors, {"tree": json.dumps(skeleton)})
        _publish_stall(name)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        write_manifest(ckpt_dir, name)
    return path


def _publish_stall(name: str) -> None:
    """The chaos window between the finished tmp write and the rename:
    `stall:ckpt=N,delay=S` sleeps here while saving step N, so a kill that
    lands in it leaves exactly one tmp dir."""
    from tf_operator_tpu_torch import chaos

    stalls = chaos.ckpt_stalls_from_env()
    m = _STEP_RE.match(name)
    if stalls and m is not None:
        delay = chaos.ckpt_stall_delay(int(m.group(1)), stalls)
        if delay > 0:
            time.sleep(delay)


def restore_named(ckpt_dir: str, name: str, template: Any | None = None) -> Any:
    """Restore <dir>/<name> as CPU tensors. With a template, leaves come
    back at the template's dtypes; without one, at their saved dtypes.
    FileNotFoundError when absent, ValueError when the template's tree
    differs from the saved one."""
    path = os.path.join(os.path.abspath(ckpt_dir), name)
    if not os.path.isdir(path):
        raise FileNotFoundError(path)
    with tracer.span("checkpoint/restore", ckpt=name):
        tensors, metadata = read_tensors(os.path.join(path, TREE_FILE))
    try:
        skeleton = json.loads(metadata["tree"])
    except (KeyError, ValueError) as e:
        raise ValueError(f"{path}: no tree in the file's metadata") from e
    restored = _rebuild(skeleton, tensors)
    return restored if template is None else cast_to_template(restored, template)


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    """Atomically persist `tree` as step `step`; returns the checkpoint path."""
    return save_named(ckpt_dir, f"step_{step}", tree)


def restore(ckpt_dir: str, step: int, template: Any | None = None) -> Any:
    return restore_named(ckpt_dir, f"step_{step}", template)


# ---------------------------------------------------------------------------
# The directory: steps, FINAL, retention, the startup sweep, followers
# ---------------------------------------------------------------------------

def list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        # Only published checkpoints carry the final name.
        if m and os.path.isdir(os.path.join(ckpt_dir, name)):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def latest_valid_checkpoint(
    ckpt_dir: str, template_shapes: dict[str, list[int]] | None = None,
) -> int | None:
    """The newest step that passes the resume walk's validation: a step
    whose census fails validate_step is skipped and, with template_shapes
    ({leaf path: shape}), so is a step whose sharding manifest records other
    per-leaf shapes (a step without one is unverifiable, not invalid).
    Foreign gang shapes are not skipped. None when nothing validates."""
    for s in reversed(list_steps(ckpt_dir)):
        if not validate_step(ckpt_dir, s):
            continue
        if template_shapes is not None:
            sm = read_sharding_manifest(ckpt_dir, f"step_{s}")
            if sm is not None and sm.get("leaves"):
                saved = {k: v.get("shape") for k, v in sm["leaves"].items()}
                if saved != template_shapes:
                    continue
        return s
    return None


def mark_final(ckpt_dir: str, step: int) -> None:
    tmp = os.path.join(ckpt_dir, ".FINAL.tmp")
    with open(tmp, "w") as f:
        f.write(str(step))
    os.replace(tmp, os.path.join(ckpt_dir, "FINAL"))


def final_step(ckpt_dir: str) -> int | None:
    try:
        with open(os.path.join(ckpt_dir, "FINAL")) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def prune_checkpoints(ckpt_dir: str, keep: int) -> list[int]:
    """Retention: delete all but the newest `keep` step checkpoints (each
    step's params dir, its trainstate dir and both manifests of each).
    Returns the pruned steps; keep < 1 keeps everything."""
    if keep < 1:
        return []
    root = os.path.abspath(ckpt_dir)
    pruned: list[int] = []
    for s in list_steps(ckpt_dir)[:-keep]:
        for name in (f"step_{s}", f"trainstate_{s}"):
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
            for mpath in (_manifest_path(ckpt_dir, name), _sharding_path(ckpt_dir, name)):
                try:
                    os.unlink(mpath)
                except OSError:
                    pass
        pruned.append(s)
    return pruned


def sweep_tmp_dirs(ckpt_dir: str) -> list[str]:
    """Startup sweep of what a kill can strand: tmp publish dirs, manifest
    `.tmp*` files and `.FINAL.tmp`. Never touches a finished checkpoint.
    Returns the removed entry names."""
    if not os.path.isdir(ckpt_dir):
        return []
    removed: list[str] = []
    for name in os.listdir(ckpt_dir):
        is_tmp = (TMP_PUBLISH_MARKER in name or name == ".FINAL.tmp"
                  or (MANIFEST_SUFFIX + ".tmp") in name
                  or (SHARDING_SUFFIX + ".tmp") in name)
        if not is_tmp:
            continue
        path = os.path.join(ckpt_dir, name)
        try:
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.unlink(path)
            removed.append(name)
        except OSError:
            continue  # best-effort: a sweep must never fail a startup
    return removed


def wait_for_new_step(
    ckpt_dir: str, seen: set[int], timeout: float, poll: float = 0.2,
    should_stop=None,
) -> int | None:
    """Block until a checkpoint not in `seen` appears; None on timeout,
    when FINAL is set and every step has been consumed, or when
    `should_stop()` turns true."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if should_stop is not None and should_stop():
            return None
        for s in list_steps(ckpt_dir):
            if s not in seen:
                return s
        fs = final_step(ckpt_dir)
        if fs is not None and fs in seen:
            return None  # stream complete
        time.sleep(poll)
    return None
