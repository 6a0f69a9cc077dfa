"""attn_fwd_roofline: the flash forward's least time a step from the cell's
shapes (visible pairs only) over the device time of kernels/attn_fwd.json's
kernels, in %."""

from benchmarks import trace


def read(rec):
    return trace.roofline(rec, "attn_fwd")
