"""The PyTorch port's trainer in four processes (gloo, CPU) on two mesh axes.

tests/test_torch_dist_lm.py's gate at dp x tp, fsdp x tp and dp x fsdp =
2 x 2: the data group and the tp or fsdp group of each rank are different
process groups, and the batch rows, the gradient bucket, the fsdp shards
and the tp collectives must compose to the one-process model.
"""

import pytest
from test_torch_dist_lm import _one_thread, check_world, reference  # noqa: F401

MESHES = {"dp-tp": {"dp": 2, "tp": 2}, "fsdp-tp": {"fsdp": 2, "tp": 2},
          "dp-fsdp": {"dp": 2, "fsdp": 2}}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_four_processes_train_the_one_process_model(name, reference, tmp_path):
    check_world(MESHES[name], reference, tmp_path)
