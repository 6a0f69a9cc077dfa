"""step_ms_p95: the 95th percentile (nearest rank) of the window's step
times, each from one CUDA event to the next, recorded on the stream between
consecutive steps."""

import math


def read(rec):
    ms = sorted(rec["window"]["step_ms"])
    if not ms:
        return None
    return ms[max(0, math.ceil(0.95 * len(ms)) - 1)]
