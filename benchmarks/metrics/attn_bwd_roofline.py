"""attn_bwd_roofline: the flash backward's least time a step (five products,
every byte once) over the device time of kernels/attn_bwd.json's kernels
(K2, K3, delta), in %."""

from benchmarks import trace


def read(rec):
    return trace.roofline(rec, "attn_bwd")
