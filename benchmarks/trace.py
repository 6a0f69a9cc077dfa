"""From a torch.profiler run of whole steps to the record the per-layer
readers read.

The benchmark marks each step it drives with a host range (STEP_MARK). A
device operation belongs to the step whose range holds the host runtime
call that launched it (by correlation id), whatever launched it: a graph
replay, a kernel launch, a copy. The first marked step is left out (the
profiler's own start-up), and the last serves only as the end mark: the
window runs from the first device operation of the second step to the
first of the last, so it holds whole steps of device work and the gaps
between them. Nothing here depends on a kernel's name; names only sort the
window's device time into the groups of `kernels/*.json`.
"""

from __future__ import annotations

import bisect

STEP_MARK = "bench.step"
TOP = 10


def events(prof) -> dict:
    """The plain event lists of a finished torch.profiler run: device
    operations, host runtime calls (the CUDA API's, named cu...) and other
    host events as (name, start_ns, end_ns[, correlation id]), and the
    marked steps' host ranges. A host range also shows on the device's
    timeline under its own name: it is no work."""
    from torch.profiler import DeviceType

    device, runtime, host, steps = [], [], [], []
    for e in prof.profiler.kineto_results.events():
        name, start, end = e.name(), e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() != DeviceType.CPU:
            if name != STEP_MARK:
                device.append((name, start, end, e.correlation_id()))
        elif name == STEP_MARK:
            steps.append((start, end))
        elif name.startswith("cu"):
            runtime.append((name, start, end, e.correlation_id()))
        else:
            host.append((name, start, end))
    return {"device": device, "runtime": runtime, "host": host, "steps": sorted(steps)}


def is_launch(name: str) -> bool:
    """A host runtime call that puts work on the device: a kernel or graph
    launch, a copy, a fill."""
    return any(k in name for k in ("Launch", "Memcpy", "Memset"))


def group_of(name: str, groups: dict) -> str:
    """The first group (by file name) with a pattern in the lower-cased
    name, else "other"."""
    low = name.lower()
    return next((g for g, spec in groups.items() if any(p in low for p in spec["patterns"])),
                "other")


def _union_ns(spans) -> int:
    busy, end = 0, None
    for s, e in sorted(spans):
        if end is None or s >= end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def _host_at(t: int, host_sorted, starts) -> str:
    """The innermost host event running at time t (the latest to start)."""
    i = bisect.bisect_right(starts, t)
    for name, s, e in reversed(host_sorted[max(0, i - 400):i]):
        if s <= t < e:
            return name
    return "no host event"


def summarize(ev: dict, groups: dict) -> dict | None:
    """The window's summary: steps, window and busy ns, device ns by group
    and by operation, host launch calls a step, the longest idle gaps with
    the host event at each one's start. None when there is no window: fewer
    than three marked steps, or a step with no device work."""
    steps = ev["steps"]
    if len(steps) < 3:
        return None
    starts = [s for s, _ in steps]
    launched = {}
    for name, s, _, corr in ev["runtime"]:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s <= steps[i][1]:
            launched[corr] = i
    first: dict[int, int] = {}
    for _, s, _, corr in ev["device"]:
        i = launched.get(corr)
        if i is not None and (i not in first or s < first[i]):
            first[i] = s
    if any(i not in first for i in range(1, len(steps))):
        return None
    t0, t1 = first[1], first[len(steps) - 1]
    n = len(steps) - 2
    ops = [(name, s, min(e, t1)) for name, s, e, _ in ev["device"] if t0 <= s < t1]
    by_group: dict[str, int] = {}
    by_op: dict[str, int] = {}
    for name, s, e in ops:
        g = group_of(name, groups)
        by_group[g] = by_group.get(g, 0) + e - s
        by_op[name[:120]] = by_op.get(name[:120], 0) + e - s
    launches = sum(1 for name, s, _, _ in ev["runtime"]
                   if is_launch(name) and steps[1][0] <= s <= steps[-2][1])
    host = sorted(ev["host"] + [(r[0], r[1], r[2]) for r in ev["runtime"]], key=lambda h: h[1])
    host_starts = [h[1] for h in host]
    gaps, end = [], t0
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if s > end:
            gaps.append((s - end, _host_at(end, host, host_starts)))
        end = max(end, e)
    if t1 > end:
        gaps.append((t1 - end, _host_at(end, host, host_starts)))
    gaps.sort(reverse=True)
    return {
        "steps": n, "window_ns": t1 - t0, "busy_ns": _union_ns((s, e) for _, s, e in ops),
        "ops": len(ops), "gaps": len(gaps),
        "group_ns": by_group, "launches": launches,
        "top_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": [(label, ns) for ns, label in gaps[:TOP]],
    }


def group_ms_per_step(rec: dict, group: str) -> float | None:
    """Device ms a step of `group`; None when no operation of it ran."""
    tr = rec.get("trace")
    if not tr or not tr["group_ns"].get(group):
        return None
    return tr["group_ns"][group] / 1e6 / tr["steps"]


def roofline(rec: dict, group: str) -> float | None:
    """100 x the group's least time a step (its file's work function over the
    cell's shape) over its measured device time a step; None when the group
    ran nothing."""
    from benchmarks import flops

    ms = group_ms_per_step(rec, group)
    work = rec["groups"][group]["work"]
    if ms is None or work is None:
        return None
    bound_ms, _ = flops.WORK[work](rec["shape"])
    return 100.0 * bound_ms / ms
