"""A cell's data, found by name: `workloads/<cell>.json` names its
configuration (`configs/<config>.json`) and its traffic
(`traffic/<traffic>.json`); `BENCHMARK.json` at the root of the checkout
names its metrics, each read by `metrics/<metric>.py`."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _load(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} "
                                f"named {name!r}: {path} does not exist")
    return json.loads(path.read_text())


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load(name: str) -> dict:
    """The cell `name` as one dict: its file's fields, plus `cfg` (the
    configuration's file), `arch` (the sizes the reference and the yardstick
    read), `shape` (arch with the traffic's batch and seq), `argv` (the
    trainer's flags) and `optimizer`."""
    cell = dict(_load("workloads", name), name=name)
    cfg = cell["cfg"] = _load("configs", cell["config"])
    traffic = cell["traffic_data"] = _load("traffic", cell["traffic"])
    keys = cfg["arch_keys"]
    arch = {k: cfg[v] for k, v in keys.items() if k != "intermediate"}
    arch["mlp_ratio"] = cfg[keys["intermediate"]] // arch["hidden"]
    arch.update(family=cfg["family"], ln_eps=cfg["layer_norm_eps"],
                max_len=max(traffic["seq"], cfg.get("min_positions", 1)))
    arch.update(cfg.get("mlm", {}))
    cell["arch"] = arch
    cell["shape"] = dict(arch, batch=traffic["batch"], seq=traffic["seq"],
                         dtype=cfg["compute_dtype"], causal=cfg["causal"],
                         reference_rows=cell["reference_rows"])
    opt = cell["optimizer"]
    cell["argv"] = [*cfg["trainer_argv"], "--seq", str(traffic["seq"]), "--batch",
                    str(traffic["batch"]), "--optimizer", opt["name"], "--lr", repr(opt["lr"])]
    return cell


def metrics_of(name: str, bench: dict | None = None) -> tuple[list[dict], list[dict]]:
    """(end-to-end metrics, per-layer metrics) BENCHMARK.json gives the cell:
    those that list it, and those without a list whose end-to-end metric
    (for a per-layer one, the metric it moves) the cell reports."""
    bench = bench or benchmark()

    def listed(m):
        return "workloads" not in m or name in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", ()) or ("workloads" not in m
                                                  and m["moves"] in reported)]
    return e2e, layer


def reader(metric: str):
    """The read(record) function of `metrics/<metric>.py`."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader for the metric {metric!r}: {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_groups() -> dict[str, dict]:
    """{group: its file} of every `kernels/<group>.json`, by name."""
    return {p.stem: json.loads(p.read_text()) for p in sorted((HERE / "kernels").glob("*.json"))}
