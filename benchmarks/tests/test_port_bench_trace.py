"""The trace reduction on a synthetic event list: steps cut by the
benchmark's own host ranges, grouping by the kernels/*.json pattern files,
a planted idle gap, the per-layer readers."""

import pytest

from torch.profiler import DeviceType

from benchmarks import cells, flops, reference, trace

MS = 1_000_000  # ns


def synthetic(gap_ms=2.0):
    """Four marked steps of 10 ms on the host, one graph launch each; on the
    device each step runs a K1 kernel (1 ms), a K3 kernel (2 ms), a GEMM
    (3 ms) and an AdamW kernel (3 ms) back to back, and step 2 (the second
    of the window) waits `gap_ms` before its first kernel."""
    steps, runtime, device, host = [], [], [], []
    t = 0
    for i in range(4):
        start = i * 10 * MS
        steps.append((start, start + 1 * MS))
        runtime.append(("cudaGraphLaunch", start + 100, start + 200, 100 + i))
        runtime.append(("cudaLaunchKernel", start + 300, start + 400, 200 + i))
        runtime.append(("cudaEventSynchronize", start + 1000, start + 9 * MS, 300 + i))
        host.append(("aten::clone", start + 300, start + 500))
        t = max(t, start + MS) + (gap_ms * MS if i == 2 else 0)
        for name, dur in (("void fwd_wgmma_kernel<64, true>(FwdParams)", 1),
                          ("void bwd_dkv_wgmma_kernel<64, true>(BwdParams)", 2),
                          ("nvjet_hsh_128x256_64x4_1x2_h_bz_coopA_NNT", 3),
                          ("void at::native::vectorized_elementwise_kernel<4, AdamW>", 3)):
            device.append((name, int(t), int(t + dur * MS), 100 + i))
            t += dur * MS
        device.append(("void at::native::copy_kernel", int(t), int(t + 0.01 * MS), 200 + i))
        t += 0.01 * MS
    return {"device": device, "runtime": runtime, "host": host, "steps": steps}


def record(ev):
    groups = cells.kernel_groups()
    shape = cells.load("bert-base.seq512")["shape"]
    return {"trace": trace.summarize(ev, groups), "groups": groups, "shape": shape}


def test_groups_by_pattern_files():
    groups = cells.kernel_groups()
    assert trace.group_of("void fwd_wgmma_kernel<64, true>(FwdParams)", groups) == "attn_fwd"
    assert trace.group_of("fwd_wide_wgmma_kernel", groups) == "attn_fwd"
    for k in ("bwd_dq_wgmma_kernel", "bwd_dkv_kernel", "bwd_delta_kernel(float*)"):
        assert trace.group_of(k, groups) == "attn_bwd"
    for k in ("nvjet_hsh_128x256", "sm90_xmma_gemm_bf16bf16", "cutlass::Kernel2<...>"):
        assert trace.group_of(k, groups) == "gemm"
    assert trace.group_of("ncclDevKernel_AllReduce_Sum_f32_RING_LL", groups) == "nccl"
    assert trace.group_of("gmm_wgmma_kernel<true>", groups) == "grouped_matmul"
    assert trace.group_of("tgmm_wgmma_kernel", groups) == "grouped_matmul"
    assert trace.group_of("void at::native::vectorized_elementwise_kernel", groups) == "other"


def test_window_idle_share_and_other_with_a_planted_gap():
    rec = record(synthetic(gap_ms=2.0))
    tr = rec["trace"]
    # Window: steps 1 and 2 (step 0 is left out, step 3 is the end mark).
    assert tr["steps"] == 2
    busy = 2 * 9.01 * MS
    assert tr["busy_ns"] == pytest.approx(busy, abs=2)
    # From step 1's first kernel (11 ms) to step 3's (32.01 ms): step 2
    # starts 2.99 ms after step 1's work ends.
    assert tr["window_ns"] == pytest.approx(busy + 2.99 * MS, abs=2)
    idle = cells.reader("idle_share")(rec)
    assert idle == pytest.approx(100 * (1 - busy / tr["window_ns"]), rel=1e-9)
    assert cells.reader("other_ms_per_step")(rec) == pytest.approx(3.01, abs=1e-6)
    assert cells.reader("host_launches_per_step")(rec) == 2.0
    assert tr["idle_gaps"][0] == ("cudaEventSynchronize", pytest.approx(2.99 * MS, abs=2))


def test_rooflines_and_mfu():
    rec = record(synthetic(gap_ms=0.0))
    fwd_ms, _ = flops.attention_fwd(rec["shape"])
    bwd_ms, _ = flops.attention_bwd(rec["shape"])
    assert cells.reader("attn_fwd_roofline")(rec) == pytest.approx(100 * fwd_ms / 1.0)
    assert cells.reader("attn_bwd_roofline")(rec) == pytest.approx(100 * bwd_ms / 2.0)
    tr = rec["trace"]
    rate = reference.family("bert_mlm").step_flops(rec["shape"]) * 2 / (tr["window_ns"] / 1e9)
    assert cells.reader("mfu")(rec) == pytest.approx(100 * rate / 989e12)


def test_a_group_that_ran_nothing_reads_nothing():
    ev = synthetic()
    ev["device"] = [d for d in ev["device"] if "fwd_wgmma" not in d[0]]
    rec = record(ev)
    assert cells.reader("attn_fwd_roofline")(rec) is None
    assert cells.reader("attn_bwd_roofline")(rec) is not None


def test_no_window_without_device_work_or_steps():
    ev = synthetic()
    assert trace.summarize(dict(ev, steps=ev["steps"][:2]), cells.kernel_groups()) is None
    assert trace.summarize(dict(ev, device=[]), cells.kernel_groups()) is None
    rec = {"trace": None, "groups": cells.kernel_groups(), "shape": {}}
    for name in ("idle_share", "mfu", "host_launches_per_step", "other_ms_per_step",
                 "attn_fwd_roofline"):
        assert cells.reader(name)(rec) is None


class _Event:
    def __init__(self, name, on_device, start, dur, corr=0):
        self._v = (name, on_device, start, dur, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return DeviceType.CUDA if self._v[1] else DeviceType.CPU

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def test_events_sorts_kineto_kinds_and_drops_the_marks_device_shadow():
    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return [_Event("bench.step", False, 0, 100),
                            _Event("bench.step", True, 10, 500, 7),
                            _Event("cudaGraphLaunch", False, 5, 5, 7),
                            _Event("fwd_wgmma_kernel", True, 20, 30, 7),
                            _Event("Memcpy HtoD", True, 60, 5, 8),
                            _Event("aten::clone", False, 12, 3)]

    ev = trace.events(Prof)
    assert ev["steps"] == [(0, 100)]
    assert [d[0] for d in ev["device"]] == ["fwd_wgmma_kernel", "Memcpy HtoD"]
    assert ev["runtime"] == [("cudaGraphLaunch", 5, 10, 7)]
    assert ev["host"] == [("aten::clone", 12, 15)]
