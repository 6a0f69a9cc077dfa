"""tools/world_cells.py on the CPU: each cell's trainer arguments, mesh and
step count, and the device idle share it reads from a rank's Chrome trace
(the union of the device events against their span). Its runs need four
GPUs and run on the card only."""

import json
import sys

import pytest

import chip_smoke

sys.path.insert(0, str(chip_smoke.ROOT / "tools"))
import world_cells  # noqa: E402


@pytest.mark.parametrize("cell,model,mesh,tokens", [
    ("lm-dp4-pod", "transformer-lm", {"dp": 4}, 8192),
    ("lm-dp-tp", "transformer-lm", {"dp": 2, "tp": 2}, 8192),
    ("bert-dp4", "bert-base", {"dp": 4}, 512),
    ("bert-fsdp4", "bert-base", {"fsdp": 4}, 512),
    ("moe-ep4", "moe-lm", {"ep": 4}, 2048),
    ("lm64k-sp4", "transformer-lm", {"sp": 4}, 65536),
])
def test_cell_spec(cell, model, mesh, tokens):
    argv, got_tokens, got_mesh, env = world_cells.cell_spec(cell)

    def flag(name):
        return argv[argv.index(name) + 1]

    assert flag("--model") == model and got_mesh == mesh and got_tokens == tokens
    assert flag("--steps") == str(world_cells.STEPS) and flag("--log-every") == "2"
    assert flag("--device") == "cuda" and int(flag("--seq")) == tokens
    assert env == ({"TPUJOB_SP_MODE": "ring"} if cell == "lm64k-sp4" else {})
    assert cell in world_cells.CELLS


def test_idle_share_is_the_union_of_device_events(tmp_path):
    events = [{"ph": "X", "cat": "kernel", "ts": 0, "dur": 40},
              {"ph": "X", "cat": "kernel", "ts": 30, "dur": 20},     # overlaps the first
              {"ph": "X", "cat": "gpu_memcpy", "ts": 60, "dur": 10},
              {"ph": "X", "cat": "cpu_op", "ts": 0, "dur": 500},     # host: not counted
              {"ph": "X", "cat": "kernel", "ts": 90, "dur": 10}]
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"traceEvents": events}))
    got = world_cells.idle_share(trace)
    assert got == {"window_ms": 0.1, "busy_ms": 0.07, "idle_share": pytest.approx(0.3),
                   "events": 4}
    trace.write_text(json.dumps({"traceEvents": events[3:4]}))
    assert world_cells.idle_share(trace)["idle_share"] is None
