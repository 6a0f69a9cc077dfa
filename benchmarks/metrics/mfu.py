"""mfu: the step's model FLOPs (the family reference's step_flops,
recomputation not counted) x the traced window's steps over its device
seconds, as a share of the H100's dense bf16 peak."""

from benchmarks import flops, reference


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    shape = rec["shape"]
    rate = reference.family(shape["family"]).step_flops(shape) * tr["steps"] / (
        tr["window_ns"] / 1e9)
    return 100.0 * rate / flops.PEAK_FLOPS["bfloat16"]
