"""BENCHMARK.json and the files it names: every cell's configuration and
traffic exist, every metric has its reader, every name and unit keeps to the
characters the contract allows, and each configuration's `reduced` is
exactly the keys that differ from its published source."""

import json
import re
from pathlib import Path

import pytest

from benchmarks import cells, compare

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
# Keys that name a width: a hidden, intermediate, latent, state or projection
# size, a head size, an expansion factor, experts per token.
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj\w*|head)_size$|_dim$|_rank$"
                   r"|^n_embd$|^n_head$|^d_(model|ff|head)$|ratio|factor|per_tok")


def test_the_contracts_keys_and_limits():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "benchmarks/run.py"]
    assert BENCH["paths"] == ["benchmarks"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # A full check of 24 cells fits in its 43200 seconds.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and LINE.match(m["layer"])


def test_names_and_units():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[section]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((section, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "source"):
                if key in entry and section in ("configs", "workloads"):
                    assert LINE.match(entry[key]), entry[key]
    assert len(set(names)) == len(names)
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_names_files_that_exist(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    loaded = cells.load(cell)
    assert loaded["config"] == entry["config"] and loaded["traffic"] == entry["traffic"]
    assert loaded["chips"] == entry["chips"] == 1
    assert NAME.match(entry["traffic"])
    assert (ROOT / "benchmarks" / "traffic" / f"{entry['traffic']}.json").is_file()
    config = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert (ROOT / config["file"]).is_file()
    assert set(loaded["limits"]) == set(compare.NUMBERS)
    # The configuration file states the position table the trainer holds.
    assert loaded["arch"]["max_len"] == loaded["cfg"]["max_position_embeddings"]
    e2e, layer = cells.metrics_of(cell, BENCH)
    assert {"setup_s", "tokens_per_s", "step_ms_p95"} <= {m["name"] for m in e2e}
    assert layer


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(cells.reader(m["name"])), m["name"]


def test_each_config_file_and_its_reduced_keys():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmarks/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["source"] == c["source"] and LINE.match(c["source"])
        changed = sorted(k for k, v in data["published"].items() if data[k] != v)
        assert sorted(c["reduced"]) == changed == sorted(data["reduced"])
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not WIDTH.search(key), key


def test_kernel_group_files():
    for name, spec in cells.kernel_groups().items():
        assert NAME.match(name)
        assert spec["patterns"] and all(p == p.lower() for p in spec["patterns"])
        assert spec["work"] in (None, "attention_fwd", "attention_bwd")
