"""host_launches_per_step: host runtime calls that put work on the device
(graph and kernel launches, copies, fills) a step of the traced window."""


def read(rec):
    tr = rec.get("trace")
    return None if not tr else tr["launches"] / tr["steps"]
