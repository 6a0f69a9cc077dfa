"""idle_share: the share of the traced window of whole steps in which no
operation runs on the device, in %."""


def read(rec):
    tr = rec.get("trace")
    return None if not tr else 100.0 * (1.0 - tr["busy_ns"] / tr["window_ns"])
