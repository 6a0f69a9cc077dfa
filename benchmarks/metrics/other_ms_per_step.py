"""other_ms_per_step: device ms a step of the operations no kernels/*.json
group names: neither the port's hand kernels, nor GEMMs, nor NCCL."""

from benchmarks import trace


def read(rec):
    return trace.group_ms_per_step(rec, "other")
