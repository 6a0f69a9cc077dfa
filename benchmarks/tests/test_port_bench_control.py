"""The control: the reference computed in float8, the precision below the
configurations' bfloat16, put in the program's place, must come out not
correct under each cell's limits; so must the faults planted in the
reference (half of each batch left out; a token altered where the batch is
made). On the CPU at a tiny size; on the card at the cell's own size."""

import pytest
import torch

from benchmarks import calibrate, cells, compare
from benchmarks.tests.tiny import tiny_cell

CELLS = tuple(w["name"] for w in cells.benchmark()["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail_at_a_tiny_size(name):
    cell = tiny_cell(name)
    for seed in (3, 2 ** 31 + 5):
        found = calibrate.variant_readings(cell, seed, torch.device("cpu"))
        for variant, values in found.items():
            ok, _ = compare.verdict(values, cell["limits"])
            assert not ok, (variant, seed, values)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail_at_the_cells_size(card, name):
    cell = cells.load(name)
    for seed in (11, 2 ** 31 + 13, 4_000_000_019):
        found = calibrate.variant_readings(cell, seed, card)
        for variant, values in found.items():
            ok, _ = compare.verdict(values, cell["limits"])
            assert not ok, (variant, seed, values)
