"""chip_smoke.py's kernel checks, on CPU.

The check holds each kernel's output to its plain version elementwise. In
bf16 the flash limit scales with the rms of the reference's own row, so it
must reject an output whose late causal rows are wrong even though those
rows are small beside the first ones, and must accept one bf16 rounding
step. The fused bottleneck's check must accept y one bf16 step away and
reject each of chip_smoke.K4_MUTATIONS. Here the plain versions stand in
for the kernels' outputs. The build phase's readers of nvcc's and
cuobjdump's reports, and the profile's kernel groups, are held against
sample text and the kernels' own source.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from tf_operator_tpu_torch.ops import flash_attention as fa
from tf_operator_tpu_torch.ops import fused_bottleneck as fb
from tf_operator_tpu_torch.ops import grouped_matmul as gm

torch.set_num_threads(2)

BH, T, D = 2, 1024, 64


@pytest.fixture(scope="module")
def plain_outputs():
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((BH, T, D), dtype=np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_fwd_plain(q, k, v, True)
    dq, dk, dv = fa.flash_bwd_plain(q, k, v, o, lse, do, True)
    return {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}


@pytest.mark.parametrize("name", ["o", "lse", "dq", "dk", "dv"])
def test_check_accepts_agreement(plain_outputs, name):
    ref = plain_outputs[name]
    assert chip_smoke.excess(ref, ref, "bfloat16", chip_smoke._kind(name)) == 0.0


@pytest.mark.parametrize("name", ["o", "dq", "dk", "dv"])
def test_check_accepts_one_bf16_step(plain_outputs, name):
    ref = plain_outputs[name]
    # Every element moved one bf16 step away from zero.
    got = (ref.view(torch.int16) + 1).view(torch.bfloat16)
    assert (got != ref).all()
    assert chip_smoke.excess(got, ref, "bfloat16", chip_smoke._kind(name)) <= 1.0


def test_check_accepts_noise_on_a_row_that_cancels(plain_outputs):
    # Causal dq's row 0 is exactly zero (one visible key: P = 1, dP = delta);
    # the kernel leaves f32 rounding noise there.
    ref = plain_outputs["dq"]
    assert (ref[:, 0] == 0).all()
    got = ref.clone()
    got[:, 0] = 1e-7
    assert chip_smoke.excess(got, ref, "bfloat16", "grad") <= 1.0


@pytest.mark.parametrize("name,kind", [
    ("o", "o"), ("o(no lse)", "o"), ("lse", "lse"), ("delta", "delta"),
    ("delta+g_lse", "delta"), ("dq+g_lse", "grad"), ("FlashAttention.dk", "grad"),
])
def test_kind_reads_the_first_word(name, kind):
    """Each checked output is held to its own kind's limit: the lse-less o
    to o's, delta with the lse cotangent to delta's (not the looser grad's)."""
    assert chip_smoke._kind(name) == kind


@pytest.mark.parametrize("mutation", chip_smoke.MUTATIONS, ids=lambda m: f"{m[0]} {m[1]}")
def test_check_rejects_broken_output(plain_outputs, mutation):
    name, _, mutate = mutation
    assert chip_smoke.excess(mutate(plain_outputs[name]), plain_outputs[name],
                             "bfloat16", chip_smoke._kind(name)) > 1.0


def test_self_test_passes_on_true_outputs(plain_outputs):
    verdicts = chip_smoke.checker_self_test(plain_outputs, plain_outputs, "bfloat16")
    assert len(verdicts) == len(chip_smoke.MUTATIONS)
    assert min(verdicts.values()) > 1.0


def _k4_plain(b, h, w, cw, cn, tile_b, seed=0, offset=False):
    """The fused bottleneck's plain outputs and arguments on a post-relu
    bf16 x (moved per tile by chip_smoke.k4_tile_offset when `offset`),
    with BN scale/bias as chip_smoke draws them."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(shape).astype(np.float32))

    x = n(b, h, w, cw).relu()
    if offset:
        x = chip_smoke.k4_tile_offset(x, tile_b)
    x = x.to(torch.bfloat16)
    weights = [n(cw, cn, scale=cw ** -0.5), n(3, 3, cn, cn, scale=(9 * cn) ** -0.5),
               n(cn, cw, scale=cn ** -0.5)]
    bn = [n(cn).abs() + 0.5, n(cn, scale=0.1), n(cn).abs() + 0.5, n(cn, scale=0.1),
          n(cw).abs() + 0.5, n(cw, scale=0.1)]
    args = (x, *(t.to(torch.bfloat16) for t in weights), *bn)
    y, st = fb.fused_bottleneck(*args, tile_b=tile_b)
    return {"y": y, "st1": st[0], "st2": st[1], "st3": st[2]}, args


@pytest.fixture(scope="module")
def k4_outputs():
    """One image a tile, as the stage-1 case."""
    return _k4_plain(4, 14, 14, 64, 16, 1)


@pytest.fixture(scope="module")
def k4_ragged_outputs():
    """chip_smoke's ragged case: 98 rows a tile, tiles moved apart."""
    return _k4_plain(*chip_smoke.K4_RANDOM["ragged"], offset=True)


K4_FIXTURES = {"stage1": ("k4_outputs", 1),
               "ragged": ("k4_ragged_outputs", chip_smoke.K4_RANDOM["ragged"][-1])}


@pytest.mark.parametrize("name", ["y", "st1", "st2", "st3"])
def test_k4_check_accepts_agreement(k4_outputs, name):
    outs, _ = k4_outputs
    assert chip_smoke.k4_excess(outs[name], outs[name], "bfloat16", name) == 0.0


def test_k4_check_accepts_one_bf16_step_of_y(k4_outputs):
    y = k4_outputs[0]["y"]
    got = torch.where(y == 0, y, (y.view(torch.int16) + 1).view(torch.bfloat16))
    assert (got != y).any()
    assert chip_smoke.k4_excess(got, y, "bfloat16", "y") <= 1.0


@pytest.mark.parametrize("mutation", chip_smoke.K4_MUTATIONS, ids=lambda m: f"{m[0]} {m[1]}")
def test_k4_check_rejects_broken_output(request, mutation):
    name, _, mutate, case = mutation
    fixture, tile_b = K4_FIXTURES[case]
    outs, args = request.getfixturevalue(fixture)
    assert chip_smoke.k4_excess(mutate(outs, args, tile_b), outs[name], "bfloat16", name) > 1.0


def _self_test(request, case):
    fixture, tile_b = K4_FIXTURES[case]
    outs, args = request.getfixturevalue(fixture)
    verdicts = chip_smoke.k4_checker_self_test(outs, outs, args, tile_b, "bfloat16", case)
    assert len(verdicts) == sum(m[3] == case for m in chip_smoke.K4_MUTATIONS) > 0
    assert min(verdicts.values()) > 1.0


def test_k4_self_test_passes_on_true_outputs(request):
    _self_test(request, "stage1")


def test_k4_self_test_passes_on_true_ragged_outputs(request):
    _self_test(request, "ragged")


def test_k4_check_rejects_a_non_finite_output(k4_outputs):
    outs, _ = k4_outputs
    st = outs["st3"].clone()
    st[0, 0, 0] = float("nan")
    assert not chip_smoke.k4_excess(st, outs["st3"], "bfloat16", "st3") <= 1.0


def test_k4_leak_without_leaked_rows_gives_the_true_moments(k4_ragged_outputs):
    """The cross-tile mutation's moments are the plain version's when no
    row leaks, so what the check rejects is the leak alone."""
    outs, args = k4_ragged_outputs
    st = chip_smoke._leak_next_tile(outs["st1"], args, 0)
    assert chip_smoke.k4_excess(st, outs["st1"], "bfloat16", "st1") <= 1.0


def test_k4_tile_offset_moves_each_tile_apart():
    x = torch.ones(6, 2, 3, 4)
    got = chip_smoke.k4_tile_offset(x, 2)
    for i in range(3):
        assert (got[2 * i:2 * i + 2] == 1 + 2 * i).all()
    assert chip_smoke.k4_tile_offset(x.to(torch.bfloat16), 3).dtype == torch.bfloat16


def test_k4_cases_cover_every_stage_and_both_routes():
    """Every ResNet-50 stage's first identity block, a bf16 case that the
    wgmma route takes with tiles straddling 64- and 128-row blocks, and an
    f32 case on the FMA route."""
    cases = {label: (idx, dt) for label, idx, dt in chip_smoke.K4_CASES}
    assert [cases[f"stage{i}"][0] for i in range(1, 5)] == [1, 4, 8, 14]
    b, h, w, cw, cn, tb = chip_smoke.K4_RANDOM["ragged"]
    rows = tb * h * w
    assert cases["ragged"] == (None, "bfloat16") and b // tb > 1
    assert rows % 64 and rows % 128 and rows > 64
    assert fb.route(torch.bfloat16, cw, cn) == "wgmma"
    b, h, w, cw, cn, tb = chip_smoke.K4_RANDOM["small"]
    assert cases["small"] == (None, "float32") and fb.route(torch.float32, cw, cn) == "fma"
    assert set(chip_smoke.K4_SPLIT_CASES) <= set(cases)


CSRC = Path(chip_smoke.ROOT) / "tf_operator_tpu_torch" / "csrc"
FLASH_CU = CSRC / "flash_attention.cu"
KERNEL_RE = r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\("


def _flash_kernel_names():
    return re.findall(KERNEL_RE, FLASH_CU.read_text())


def test_every_k5_kernel_has_its_moe_profile_group():
    """Each __global__ kernel of grouped_matmul.cu, on every route, falls in
    its own MoE profile group (tgmm's names hold gmm's), and the flash
    kernels in the LM's groups there too."""
    src = (Path(chip_smoke.__file__).parent / chip_smoke.K5_SOURCE).read_text()
    names = re.findall(r"(\w+_kernel)\(", src)
    assert {"gmm_wgmma_kernel", "tgmm_wgmma_kernel", "gmm_mma_kernel", "tgmm_mma_kernel",
            "gmm_fma_kernel", "tgmm_fma_kernel"} <= set(names)
    assert set(re.findall(KERNEL_RE, src)) == {
        "gmm_wgmma_kernel", "tgmm_wgmma_kernel", "gmm_mma_kernel", "tgmm_mma_kernel",
        "gmm_fma_kernel", "tgmm_fma_kernel"}
    for name in set(names):
        group = chip_smoke.kernel_group(f"void (anonymous namespace)::{name}<true>(int)",
                                        chip_smoke.MOE_GROUPS)
        want = "grouped_matmul_tgmm" if name.startswith("tgmm") else "grouped_matmul_gmm"
        assert group == want, (name, group)
    assert chip_smoke.kernel_group("void fwd_wgmma_kernel<128>()", chip_smoke.MOE_GROUPS) \
        == "flash_fwd"


def test_every_flash_kernel_has_an_lm_profile_group():
    """Each __global__ kernel of flash_attention.cu falls in an LM profile
    group other than "other", as the profiler names it, and the kernels of
    each wrapper fall in that wrapper's group."""
    names = _flash_kernel_names()
    assert {"fwd_kernel", "bwd_dq_kernel", "bwd_dkv_kernel", "bwd_delta_kernel",
            "fwd_wgmma_kernel", "bwd_dq_wgmma_kernel", "bwd_dkv_wgmma_kernel",
            "fwd_wide_wgmma_kernel", "bwd_dq_wide_wgmma_kernel",
            "bwd_dkv_wide_wgmma_kernel"} <= set(names)
    want = {"fwd": "flash_fwd", "bwd_dq": "flash_bwd_dq", "bwd_dkv": "flash_bwd_dkv",
            "bwd_delta": "flash_bwd_delta"}
    for name in names:
        profiled = f"void (anonymous namespace)::{name}<__nv_bfloat16, 128>(__nv_bfloat16 const*)"
        group = chip_smoke.kernel_group(profiled, chip_smoke.LM_GROUPS)
        assert group != "other", name
        stem = re.sub(r"(_wide)?(_wgmma)?_kernel$", "", name)
        assert group == want[stem], (name, group)


@pytest.mark.parametrize("d", fa.SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_route_names_are_kernels_of_the_source(dtype, d):
    """The kernel that the wrapper reports for each built width and dtype
    is a __global__ kernel of flash_attention.cu, and chip_smoke names the
    same one (its wide LM phase holds the names against the profiler's)."""
    names = set(_flash_kernel_names())
    for key in ("fwd", "bwd_dq", "bwd_dkv"):
        assert fa.kernel_name(key, dtype, d) in names
        assert chip_smoke.kernel_function(key, dtype, d) == fa.kernel_name(key, dtype, d)
    assert chip_smoke.kernel_function("bwd_delta", dtype, d) in names


def test_bf16_d256_takes_the_wide_kernels():
    """bf16 K1, K2 and K3 at D 256 (and every width padded to it, 129-256)
    run the wide kernels; f32 at every width and bf16 at 384 and 512 keep
    the FMA kernels; bf16 at 64 and 128 the first wgmma kernels."""
    bf16, f32 = torch.bfloat16, torch.float32
    for key in ("fwd", "bwd_dq", "bwd_dkv"):
        assert fa.route(key, bf16, 256) == "wide"
    for d in range(129, 257):
        width = fa.kernel_head_dim(d)
        assert fa.kernel_name("fwd", bf16, width) == "fwd_wide_wgmma_kernel"
        assert fa.kernel_name("bwd_dq", bf16, width) == "bwd_dq_wide_wgmma_kernel"
        assert fa.kernel_name("bwd_dkv", bf16, width) == "bwd_dkv_wide_wgmma_kernel"
    for d in (64, 128):
        assert fa.kernel_name("fwd", bf16, d) == "fwd_wgmma_kernel"
    for d in (384, 512):
        assert fa.kernel_name("fwd", bf16, d) == "fwd_kernel"
    for d in fa.SUPPORTED_HEAD_DIMS:
        assert fa.kernel_name("fwd", f32, d) == "fwd_kernel"
    for key in ("fwd", "bwd_dq", "bwd_dkv"):
        for d in fa.SUPPORTED_HEAD_DIMS:
            assert fa.route(key, f32, d) == "fma"
        for d in (384, 512):
            assert fa.route(key, bf16, d) == "fma"
        for d in (64, 128):
            assert fa.route(key, bf16, d) == "wgmma"
    layers, hidden, heads, _ = chip_smoke.WIDE_LM
    assert hidden // heads == 256
    # The wide LM phase checks the timed shape and the trained one.
    assert (1, heads, chip_smoke.SEQ, 256) in chip_smoke.WIDE_LM_SHAPES
    assert (chip_smoke.BATCH, heads, chip_smoke.SEQ, 256) in chip_smoke.WIDE_LM_SHAPES
    assert ((2, 3, 2048, 256), "bfloat16", True) in chip_smoke.CHECK_CASES
    assert ((2, 3, 2048, 256), "bfloat16", False) in chip_smoke.CHECK_CASES


def test_profiled_kernel_count_tells_the_routes_apart():
    """The wide LM's count of each kernel in the profiler's demangled names:
    a route's name never counts another route's launches."""
    names = ["void (anonymous namespace)::bwd_dq_wide_wgmma_kernel(CUtensorMap_st, "
             "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*, float const*, "
             "__nv_bfloat16*, int, int, int, float)"] * 3 + [
        "void (anonymous namespace)::bwd_dq_kernel<__nv_bfloat16, 256, 32>(__nv_bfloat16 "
        "const*, __nv_bfloat16 const*)",
        "void (anonymous namespace)::bwd_dq_wgmma_kernel<128>(CUtensorMap_st)",
        "void (anonymous namespace)::bwd_dkv_wide_wgmma_kernel(CUtensorMap_st)"] + [
        "void (anonymous namespace)::fwd_wide_wgmma_kernel(CUtensorMap_st, CUtensorMap_st, "
        "CUtensorMap_st, __nv_bfloat16*, float*, int, int, int, float)"] * 2
    count = chip_smoke.profiled_kernel_count
    assert count(names, "bwd_dq_wide_wgmma_kernel") == 3
    assert count(names, "bwd_dq_kernel") == 1
    assert count(names, "bwd_dq_wgmma_kernel") == 1
    assert count(names, "bwd_dkv_wide_wgmma_kernel") == 1
    assert count(names, "bwd_dkv_kernel") == 0
    assert count(names, "fwd_wide_wgmma_kernel") == 2
    assert count(names, "fwd_kernel") == 0
    assert count(names, "fwd_wgmma_kernel") == 0


def test_k1_edge_cases_straddle_the_wide_forwards_tiles():
    """The check phase's K1 edge cases run the wide forward (bf16 at 256
    and 192) at lengths on either side of its 64-row k tiles and 128-row q
    blocks, for q rows and keys alike, and with fewer and more keys than
    q rows."""
    for d in chip_smoke.K1_EDGE_WIDTHS:
        assert fa.kernel_name("fwd", torch.bfloat16, fa.kernel_head_dim(d)) \
            == "fwd_wide_wgmma_kernel"
    lengths = chip_smoke.K1_EDGE_LENGTHS
    for side in (0, 1):
        seen = {pair[side] for pair in lengths}
        for edge in (64, 128):
            assert {edge - 1, edge, edge + 1} <= seen
        assert 1 in seen and any(t % 64 and t > 128 for t in seen)
    assert any(tq < tk for tq, tk in lengths) and any(tq > tk for tq, tk in lengths)


def _wide_lm_profile(layers=12, steps=4, fwd=None, extra=()):
    """Profiler names of `steps` steps of the D 256 LM as the wide route
    launches its kernels (fwd: K1's kernel, wide by default), plus
    `extra`; the wrappers' counts over 6 unprofiled steps; falling losses."""
    k = {key: chip_smoke.kernel_function(key, torch.bfloat16, 256)
         for key in chip_smoke.FLASH_LAUNCH_KEYS}
    fwd = k["fwd"] if fwd is None else fwd
    names = [f"void (anonymous namespace)::{n}(CUtensorMap_st)"
             for n in (fwd, k["bwd_delta"], k["bwd_dq"], k["bwd_dkv"])] * (layers * steps)
    names += [f"void (anonymous namespace)::{n}(int)" for n in extra]
    names += ["nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NNT"] * 5
    counted = {key: layers * 6 for key in chip_smoke.FLASH_LAUNCH_KEYS}
    losses = {s: 10.9 - 0.05 * s for s in range(1, steps + 1)}
    return names, counted, losses


def test_wide_lm_verdict_passes_the_wide_route():
    names, counted, losses = _wide_lm_profile()
    verdict = chip_smoke.wide_lm_verdict(names, counted, losses, 12, 4, 6)
    assert verdict["failures"] == []
    assert verdict["kernel_launches"]["fwd_wide_wgmma_kernel"] == 48
    assert verdict["fma_launches"] == {"fwd_kernel": 0, "bwd_dq_kernel": 0,
                                       "bwd_dkv_kernel": 0}


@pytest.mark.parametrize("fwd,extra,losses_fall,fault", [
    ("fwd_kernel", (), True, "fwd_kernel launched 48 times"),
    (None, ("fwd_kernel<__nv_bfloat16, 256, 32>",), True, "fwd_kernel launched 1 times"),
    ("fwd_wgmma_kernel<256>", (), True, "fwd_wide_wgmma_kernel: 0 launches, not 48"),
    (None, ("bwd_dq_kernel<__nv_bfloat16, 256, 32>",), True, "bwd_dq_kernel launched 1"),
    (None, ("bwd_dkv_wide_wgmma_kernel",), True, "bwd_dkv_wide_wgmma_kernel: 49 launches"),
    (None, (), False, "the loss does not fall"),
])
def test_wide_lm_verdict_fails_a_profile_off_the_wide_route(fwd, extra, losses_fall, fault):
    """The wide LM phase fails a run whose profile shows an FMA K1 (or
    K2/K3) launch, fewer than layers x steps of the wide K1, a count of
    the wide K2/K3 other than layers x steps, or a loss that does not fall."""
    names, counted, losses = _wide_lm_profile(fwd=fwd, extra=extra)
    if not losses_fall:
        losses[4] = losses[1] + 0.1
    failures = chip_smoke.wide_lm_verdict(names, counted, losses, 12, 4, 6)["failures"]
    assert any(fault in f for f in failures), failures


def test_wide_lm_verdict_fails_short_wide_forward_counts():
    """Fewer than layers x steps profiled launches of the wide K1 (one
    layer's forward missing in one step), or fewer counted by its wrapper
    in the unprofiled run, fail the phase."""
    names, counted, losses = _wide_lm_profile()
    names.remove(next(n for n in names if "fwd_wide_wgmma_kernel" in n))
    failures = chip_smoke.wide_lm_verdict(names, counted, losses, 12, 4, 6)["failures"]
    assert failures == ["fwd_wide_wgmma_kernel: 47 launches, not 48"]
    names, counted, losses = _wide_lm_profile()
    counted["fwd"] = 71
    failures = chip_smoke.wide_lm_verdict(names, counted, losses, 12, 4, 6)["failures"]
    assert failures == ["fwd counted 71 in 6 steps, not 72"]


def test_profile_step_marker_names_only_the_forward():
    """The LM profile cuts steps at kernels whose name holds every
    substring of LM_STEP_MARKER: of all the __global__ kernels of csrc/,
    exactly the forward kernels (f32 and bf16), as the profiler names them."""
    names = [n for src in sorted(CSRC.glob("*.cu")) for n in re.findall(KERNEL_RE, src.read_text())]
    assert "gemm_kernel" in names  # fused_bottleneck.cu's kernels are read too
    marked = {n for n in names
              if all(k in f"void (anonymous namespace)::{n}<128>(CUtensorMap_st)".lower()
                     for k in chip_smoke.LM_STEP_MARKER)}
    assert marked == {"fwd_kernel", "fwd_wgmma_kernel", "fwd_wide_wgmma_kernel"}


def _mangled(name, targs=""):
    ns = "_GLOBAL__N__e3b2a46e_18_flash_attention_cu_6df88d3d"
    return f"_ZN{len(ns)}{ns}{len(name)}{name}{targs}Ev14CUtensorMap_stPKfi"


@pytest.mark.parametrize("targs,label", [
    ("ILi128EE", "bwd_dq_wgmma_kernel<128>"),
    ("IfLi64EE", "bwd_dq_wgmma_kernel<float, 64>"),
    ("I13__nv_bfloat16Li128EE", "bwd_dq_wgmma_kernel<bf16, 128>"),
    ("", "bwd_dq_wgmma_kernel"),
    ("ILi128EE", "fwd_wgmma_kernel<128>"),
    ("ILb1EE", "gmm_mma_kernel<true>"),
    ("ILb0EE", "gmm_mma_kernel<false>"),
    ("ILb1EE", "gmm_wgmma_kernel<true>"),
    ("ILb0EE", "gmm_wgmma_kernel<false>"),
    ("", "tgmm_wgmma_kernel"),
])
def test_kernel_label(targs, label):
    name = label.split("<")[0]
    assert chip_smoke.kernel_label(_mangled(name, targs)) == label


def test_kernel_label_keeps_a_name_it_cannot_read():
    assert chip_smoke.kernel_label("_Z3foov") == "_Z3foov"


def test_parse_ptxas_reads_registers_and_spills_per_kernel():
    a, b = _mangled("bwd_dkv_wgmma_kernel", "ILi128EE"), _mangled("fwd_kernel", "IfLi64EE")
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{a}' for 'sm_90a'",
        f"ptxas info    : Function properties for {a}",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{b}' for 'sm_90a'",
        f"ptxas info    : Function properties for {b}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers",
    ])
    assert chip_smoke.parse_ptxas(log) == {
        "bwd_dkv_wgmma_kernel<128>": "168 registers, 4 bytes spill stores, 4 bytes spill loads",
        "fwd_kernel<float, 64>": "64 registers, 0 bytes spill stores, 0 bytes spill loads",
    }


def test_sass_counts_counts_an_opcode_per_kernel():
    a, b = _mangled("bwd_dq_wgmma_kernel", "ILi128EE"), _mangled("fwd_kernel", "IfLi64EE")
    sass = "\n".join([
        "\tcode for sm_90a",
        f"\t\tFunction : {a}",
        "        /*0af0*/   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT, gsb0 ;",
        "        /*0b00*/   HGMMA.64x128x16.F32.BF16 R24, R120, gdesc[UR8].tnspB, R24 ;",
        "        /*0b10*/   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;",
        f"\t\tFunction : {b}",
        "        /*0000*/   FFMA R1, R2, R3, R4 ;",
    ])
    assert chip_smoke.sass_counts(sass, "HGMMA") == {
        "bwd_dq_wgmma_kernel<128>": 2, "fwd_kernel<float, 64>": 0}


def test_width_cases_cover_every_padded_width():
    """Each of HEAD_WIDTHS in f32 and bf16, causal and full, at a T that no
    tile divides; the timing shapes keep H x D at the LM's hidden width
    where D divides it (H = 768 // D at 320 and 512)."""
    cases = {(shape[3], dt, causal) for shape, dt, causal in chip_smoke.WIDTH_CASES}
    assert cases == {(d, dt, c) for d in (32, 96, 192, 256, 320, 512)
                     for dt in ("float32", "bfloat16") for c in (True, False)}
    for shape, _, _ in chip_smoke.WIDTH_CASES:
        assert all(shape[2] % tile for tile in (16, 32, 64, 128))
    for d in chip_smoke.HEAD_WIDTHS:
        assert chip_smoke.HEAD_WIDTH_HIDDEN // d >= 1
        assert chip_smoke.HEAD_WIDTH_HIDDEN % d == 0 or d > 256
        assert fa.kernel_head_dim(d) in fa.SUPPORTED_HEAD_DIMS


@pytest.mark.parametrize("d,dtype_name", [(32, "bfloat16"), (96, "float32"),
                                          (192, "bfloat16"), (256, "float32"),
                                          (320, "float32"), (512, "bfloat16")])
def test_self_test_rejects_every_mutation_at_a_padded_width(d, dtype_name):
    """The check phase runs checker_self_test at every width case: the
    mutations stay rejected there, and the true outputs pass."""
    rng = np.random.default_rng(d)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 200, d), dtype=np.float32))
                   .to(getattr(torch, dtype_name)) for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v, True)
    dq, dk, dv = fa.flash_bwd(q, k, v, o, lse, do, True)
    outs = {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, True)
    refs = dict(zip(("dq", "dk", "dv"), fa.flash_bwd_plain(q, k, v, o_p, lse_p, do, True)),
                o=o_p, lse=lse_p)
    for name in outs:
        assert chip_smoke.excess(outs[name], refs[name], dtype_name,
                                 chip_smoke._kind(name)) <= 1.0, name
    verdicts = chip_smoke.checker_self_test(outs, refs, dtype_name)
    assert len(verdicts) == len(chip_smoke.MUTATIONS) and min(verdicts.values()) > 1.0


def test_k4_padded_case_takes_channels_off_the_wgmma_tiles():
    cases = {label: (idx, dt) for label, idx, dt in chip_smoke.K4_CASES}
    b, h, w, cw, cn, tb = chip_smoke.K4_RANDOM["padded"]
    assert cases["padded"] == (None, "bfloat16") and (cn, cw) == (40, 96)
    assert cn % fb.WGMMA_CHANNELS and cw % fb.WGMMA_CHANNELS and b % tb == 0


@pytest.mark.parametrize("r0", [0, 96, 448])
def test_longctx_tile_checks_equal_the_full_plain_version(r0):
    """longctx_kernel_check's references: a row tile against every key up to
    it (with q_offset) and a key tile against every row from it on give the
    full plain version's rows and key columns exactly."""
    t, tile = 512, 64
    rng = np.random.default_rng(r0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, t, 32), dtype=np.float32))
                   for _ in range(4))
    o, lse = fa.flash_fwd_plain(q, k, v, True)
    delta = fa._bwd_delta_plain(o, do)
    dq, dk, dv = fa.flash_bwd_plain(q, k, v, o, lse, do, True)
    rows, keys, after = slice(r0, r0 + tile), slice(0, r0 + tile), slice(r0, t)
    o_p, lse_p = fa.flash_fwd_plain(q[:, rows], k[:, keys], v[:, keys], True, q_offset=r0)
    torch.testing.assert_close(o_p, o[:, rows], rtol=0, atol=1e-6)
    torch.testing.assert_close(lse_p, lse[:, rows], rtol=0, atol=1e-6)
    dq_p = fa._bwd_dq_plain(q[:, rows], k[:, keys], v[:, keys], o[:, rows], lse[:, rows],
                            do[:, rows], True, delta=delta[:, rows], q_offset=r0)
    torch.testing.assert_close(dq_p, dq[:, rows], rtol=0, atol=1e-5)
    dk_p, dv_p = fa._bwd_dkv_plain(q[:, after], k[:, rows], v[:, rows], o[:, after],
                                   lse[:, after], do[:, after], True, delta=delta[:, after])
    torch.testing.assert_close(dk_p, dk[:, rows], rtol=0, atol=1e-5)
    torch.testing.assert_close(dv_p, dv[:, rows], rtol=0, atol=1e-5)


def test_longctx_runs_expect_the_save_policys_launches():
    """K1 a step: the forward's 12, the loss replay's 12, and one more for
    each block whose residuals are not kept."""
    for label, seq, steps, extra, k1, may_not_fit in chip_smoke.LONGCTX_RUNS:
        layers = chip_smoke.LAYERS
        # Only the run without remat may be recorded as not fitting.
        assert may_not_fit == ("--remat" not in extra), label
        if "--remat" not in extra:
            assert k1 == layers
            continue
        saved = (layers if "--remat-save-flash" in extra else
                 int(extra[extra.index("--remat-save-flash-layers") + 1])
                 if "--remat-save-flash-layers" in extra else 0)
        assert k1 == 2 * layers + (layers - saved), label
        argv = chip_smoke.longctx_argv(seq, steps, extra)
        assert argv[argv.index("--seq") + 1] == str(seq) and "--batch" in argv


def test_child_runs_the_trainer_and_reports_its_launches(tmp_path, monkeypatch):
    """run_child: the trainer's entry point in a subprocess, its events, and
    the kernels' launch counts it wrote at exit (all zero on the CPU, where
    the plain versions run), through a real SIGTERM from --chaos."""
    monkeypatch.setattr(chip_smoke, "OUT_DIR", tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc, events, counts = chip_smoke.run_child(
        ["--device", "cpu", "--model", "transformer-lm", "--batch", "1", "--seq", "32",
         "--layers", "1", "--hidden", "32", "--heads", "1", "--steps", "3", "--log-every",
         "1", "--chaos", "kill:step=2,signal=TERM", "--checkpoint-dir",
         str(tmp_path / "ckpt")], "_t", timeout=120)
    assert rc == 143 and counts == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0, "bwd_delta": 0}
    assert [e["event"] for e in events][-1] == "preempted"


@pytest.mark.parametrize("oom_run", [run[0] for run in chip_smoke.LONGCTX_RUNS])
def test_longctx_fails_when_a_run_that_must_fit_runs_out_of_memory(monkeypatch, oom_run):
    """longctx_phase with the trainer stood in for: the run named oom_run
    runs out of memory, every other run launches what its policy gives.
    Only a run marked as one that may not fit is recorded (fits: false);
    for any other the phase fails."""
    monkeypatch.setattr(chip_smoke, "longctx_kernel_check", lambda records: None)
    for name in ("empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    runs = {run[0]: run for run in chip_smoke.LONGCTX_RUNS}

    def run_trainer(argv, tag=""):
        label = next(lb for lb in runs if tag == "_long_" + re.sub(r"\W+", "_", lb))
        if label == oom_run:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        _, _, steps, _, k1, _ = runs[label]
        layers = chip_smoke.LAYERS
        fa.LAUNCHES.update(fwd=k1 * steps, bwd_dq=layers * steps, bwd_dkv=layers * steps,
                           bwd_delta=layers * steps)
        return {"done": {"examples_per_sec": 1.0, "final_loss": 1.0}}

    monkeypatch.setattr(chip_smoke, "run_trainer", run_trainer)
    if not runs[oom_run][5]:
        with pytest.raises(chip_smoke.SmokeFailure, match="does not fit"):
            chip_smoke.longctx_phase({}, "card")
        return
    results = chip_smoke.longctx_phase({}, "card")
    assert [r["run"] for r in results] == list(runs)
    assert [r["fits"] for r in results] == [r != oom_run for r in runs]


@pytest.mark.parametrize("counts", [
    {}, {"fwd": 1, "bwd_dq": 1, "bwd_dkv": 1}, {"fwd": 1, "bwd_dq": 1, "bwd_dkv": 1,
                                                 "bwd_delta": 0},
], ids=["no-counts-file", "a-key-missing", "a-kernel-not-launched"])
def test_preempt_phase_requires_every_flash_kernel_in_both_runs(tmp_path, monkeypatch,
                                                                 counts):
    """preempt_phase with its children stood in for: both runs behave, but
    one reports launch counts without every flash kernel in them."""
    monkeypatch.setattr(chip_smoke, "PREEMPT_DIR", tmp_path / "preempt")
    full = dict.fromkeys(chip_smoke.FLASH_LAUNCH_KEYS, 1)
    trace = {"traceEvents": [{"ph": "X", "name": n} for n in chip_smoke.PREEMPT_SPANS]}

    def run_child(argv, tag, timeout=600):
        trace_dir = Path(argv[argv.index("--trace-dir") + 1])
        trace_dir.mkdir(parents=True, exist_ok=True)
        (trace_dir / "local-0.trace.json").write_text(json.dumps(trace))
        if tag == "_preempt_a":
            return 143, [{"event": "preempted", "step": chip_smoke.PREEMPT_STEP,
                          "emergency_checkpoint": True}], full
        prof = Path(argv[argv.index("--profile-dir") + 1])
        prof.mkdir(parents=True, exist_ok=True)
        (prof / "t.json").write_text("{}")
        return 0, [{"event": "resumed", "from_step": chip_smoke.PREEMPT_STEP},
                   {"event": "profile_done", "dir": str(prof)},
                   {"event": "done", "final_loss": 1.0}], counts

    monkeypatch.setattr(chip_smoke, "run_child", run_child)
    args = chip_smoke.argparse.Namespace(steps=6)
    with pytest.raises(chip_smoke.SmokeFailure, match="was not launched"):
        chip_smoke.preempt_phase(args, "card", {"final_loss": 1.0})


def test_bert_flops_per_step_is_the_count():
    """6 x 108,965,376 dense weights per token plus 12 L T h of full
    attention: 7.104e8 FLOP a token at T = 512, 1.164e13 a step at batch
    32."""
    dense = 12 * 7_077_888 + 589_824 + 768 * 30522
    assert dense == 108_965_376
    per_token = 6 * dense + 12 * 12 * 512 * 768
    assert chip_smoke.bert_flops_per_step(1, 1, vocab=30522) == pytest.approx(
        6 * dense + 12 * 12 * 768)
    assert chip_smoke.bert_flops_per_step(32, 512) == pytest.approx(32 * 512 * per_token)
    assert per_token == pytest.approx(7.104e8, rel=1e-3)
    assert chip_smoke.bert_flops_per_step(32, 512) == pytest.approx(1.164e13, rel=1e-3)


def test_bert_shapes_are_the_runs_attention():
    """The kernels are checked at the attention shapes of the BERT-base
    runs ([batch, 12 heads, seq, 64]), and the runs are full width."""
    from tf_operator_tpu_torch.models import transformer as tfm

    base = tfm.BERT_BASE
    runs = [(b, base.num_heads, t, base.hidden // base.num_heads)
            for model, t, b, layers in chip_smoke.BERT_RUNS if model == "bert-base"]
    assert sorted(runs) == sorted(chip_smoke.BERT_SHAPES)
    assert all(layers == (12 if model == "bert-base" else 2)
               for model, _, _, layers in chip_smoke.BERT_RUNS)


@pytest.mark.parametrize("t", [512, 128])
def test_self_test_rejects_every_mutation_full_attention(t):
    """Each MUTATIONS entry is rejected on BERT's full attention at its
    sequence lengths (two (b, h) rows stand in for the whole tensor)."""
    rng = np.random.default_rng(t)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, t, 64), dtype=np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_fwd_plain(q, k, v, False)
    dq, dk, dv = fa.flash_bwd_plain(q, k, v, o, lse, do, False)
    outs = {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
    verdicts = chip_smoke.checker_self_test(outs, outs, "bfloat16")
    assert len(verdicts) == len(chip_smoke.MUTATIONS)
    assert all(e > 1.0 for e in verdicts.values())


def test_data_runs_are_the_four_ways_and_the_lane_runs():
    labels = [label for label, _ in chip_smoke.DATA_RUNS]
    assert [label[0] for label in labels[:4]] == ["a", "b", "c", "d"]
    flags = dict(chip_smoke.DATA_RUNS)
    assert chip_smoke.DATA_DIR.is_relative_to(chip_smoke.OUT_DIR)
    assert "--staging-tune" in flags["d staged uint8 zlib tuned"]
    assert flags["c staged f32"][-1] == "f32"
    lanes = {label: f[f.index("--staging-lanes") + 1] for label, f in chip_smoke.DATA_RUNS
             if "--staging-lanes" in f}
    depth = {label: int(f[f.index("--staging-depth") + 1]) for label, f in chip_smoke.DATA_RUNS
             if "--staging-depth" in f}
    assert {lanes["b at 1 lane"], lanes["b staged uint8"], lanes["b at 4 lanes"]} == {
        "1", "2", "4"}
    assert all(int(lanes[k]) <= depth[k] for k in lanes)  # no lane capped away


def test_data_phase_runs_on_cpu_at_a_tiny_size(tmp_path, monkeypatch):
    """The data phase's own logic end to end, with the MNIST MLP on 28x28
    uint8 images on the CPU in place of ResNet-50 at 224x224 on the card:
    the shards, the seven runs, the bit-equality and rtol checks and the
    record."""
    monkeypatch.setattr(chip_smoke, "OUT_DIR", tmp_path)
    monkeypatch.setattr(chip_smoke, "DATA_DIR", tmp_path / "u8")
    monkeypatch.setattr(chip_smoke, "DATA_SAMPLES", 48)
    monkeypatch.setattr(chip_smoke, "DATA_SHARDS", 3)
    monkeypatch.setattr(chip_smoke, "DATA_STEPS", 4)
    monkeypatch.setattr(chip_smoke, "DATA_IMAGE", (28, 28))
    monkeypatch.setattr(chip_smoke, "DATA_CLASSES", 10)
    monkeypatch.setattr(chip_smoke, "resnet_argv", lambda steps: [
        "--model", "mnist-mlp", "--batch", "8", "--steps", str(steps), "--log-every", "2",
        "--device", "cpu"])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rec = chip_smoke.data_phase("cpu", None)
    finally:
        torch.set_num_threads(n)
    runs = {r["run"]: r for r in rec["runs"]}
    assert len(runs) == len(chip_smoke.DATA_RUNS)
    assert runs["b staged uint8"]["losses"] == runs["a prefetch uint8"]["losses"]
    assert len(runs["a prefetch uint8"]["losses"]) == 4
    assert runs["d staged uint8 zlib tuned"]["ingest"]["tune"]["table"]
    assert runs["b at 4 lanes"]["ingest"]["lanes_effective"] == 4
    assert runs["a prefetch uint8"]["ingest"]["batches"] == 4
    assert not (tmp_path / "u8").exists()


def test_bert_eval_run_follows_the_chief_on_cpu(tmp_path, monkeypatch):
    """The BERT chief and its Evaluator subprocess, as the bert phase runs
    them, with bert-tiny at seq 16 on the CPU."""
    monkeypatch.setattr(chip_smoke, "OUT_DIR", tmp_path)
    monkeypatch.setattr(chip_smoke, "BERT_CKPT_DIR", tmp_path / "ck")
    monkeypatch.setattr(chip_smoke, "BERT_CKPT", ("bert-tiny", 16, 2))
    monkeypatch.setattr(chip_smoke, "BERT_STEPS", 4)
    argv = chip_smoke.bert_argv
    monkeypatch.setattr(chip_smoke, "bert_argv", lambda *a: [
        *argv(*a)[:-2], "--device", "cpu"])
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rec = chip_smoke.bert_eval_run("cpu")
    assert rec["evals"][-1]["checkpoint_step"] == 4
    assert rec["evals"][-1]["eval_loss"] == round(rec["in_process_loss"], 6)


def test_sp_runs_launch_and_shape_as_the_issue_of_each_scheme():
    """The sp phase's expectations: the ring launches each flash kernel sp
    times a layer a forward pass at [1, 6, T/sp, 128], Ulysses once at
    [1, 6/sp, T, 128]; K1 runs two passes a step under --remat
    --remat-save-flash (the forward and the loss's replay)."""
    job = chip_smoke.sp_lm_job(chip_smoke.SP_SEQ, 1, "ref.pt")
    layers, steps = chip_smoke.LAYERS, chip_smoke.SP_STEPS
    assert job.argv[job.argv.index("--seq") + 1] == "16384" and "--remat-save-flash" in job.argv
    want = {"ring": ((1, 6, 8192, 128), 2), "ulysses": ((1, 3, 16384, 128), 1)}
    for name, mesh, mode in chip_smoke.SP_RUNS:
        shape, blocks = want[mode]
        assert job.local_shape(mesh, mode) == shape
        n = layers * steps * blocks
        assert job.launches(mesh, mode) == {"fwd": 2 * n, "bwd_dq": n, "bwd_dkv": n,
                                            "bwd_delta": n}
    shapes = {(tuple(sh), c) for sh, c in chip_smoke.SP_SHAPES}
    assert shapes == {((1, 6, 8192, 128), True), ((1, 6, 8192, 128), False),
                      ((1, 3, 16384, 128), True)}
    # BERT keeps one launch a layer a step at every dist mesh.
    assert chip_smoke.BERT_DIST.launches({"fsdp": 2}, None) == {
        k: 12 * chip_smoke.DIST_STEPS for k in chip_smoke.FLASH_LAUNCH_KEYS}
    assert chip_smoke.BERT_DIST.local_shape({"tp": 2}, None) == (32, 6, 512, 64)
    assert chip_smoke.BERT_DIST.local_shape({"dp": 2, "tp": 2}, None) == (16, 6, 512, 64)


@pytest.mark.parametrize("r0", [0, 96, 448])
def test_full_attention_tile_checks_equal_the_full_plain_version(r0):
    """tile_kernel_check's references without the causal mask: a row tile
    against every key and a key tile against every row give the full plain
    version's rows and key columns, the lse cotangent in delta included."""
    t, tile = 512, 64
    rng = np.random.default_rng(r0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, t, 32), dtype=np.float32))
                   for _ in range(4))
    g_lse = torch.from_numpy(rng.standard_normal((1, t), dtype=np.float32))
    o, lse = fa.flash_fwd_plain(q, k, v, False)
    delta = fa._bwd_delta_plain(o, do, g_lse)
    dq, dk, dv = fa.flash_bwd_plain(q, k, v, o, lse, do, False, g_lse)
    rows = slice(r0, r0 + tile)
    o_p, lse_p = fa.flash_fwd_plain(q[:, rows], k, v, False, q_offset=r0)
    torch.testing.assert_close(o_p, o[:, rows], rtol=0, atol=1e-6)
    torch.testing.assert_close(lse_p, lse[:, rows], rtol=0, atol=1e-6)
    torch.testing.assert_close(fa._bwd_delta_plain(o[:, rows], do[:, rows], g_lse[:, rows]),
                               delta[:, rows], rtol=0, atol=0)
    dq_p = fa._bwd_dq_plain(q[:, rows], k, v, o[:, rows], lse[:, rows], do[:, rows], False,
                            delta=delta[:, rows], q_offset=r0)
    torch.testing.assert_close(dq_p, dq[:, rows], rtol=0, atol=1e-5)
    dk_p, dv_p = fa._bwd_dkv_plain(q, k[:, rows], v[:, rows], o, lse, do, False, delta=delta)
    torch.testing.assert_close(dk_p, dk[:, rows], rtol=0, atol=1e-5)
    torch.testing.assert_close(dv_p, dv[:, rows], rtol=0, atol=1e-5)


def test_sp_phase_holds_runs_and_rejects_its_faults_on_cpu(tmp_path, monkeypatch):
    """The sp phase's machinery at a tiny LM on the CPU (where no kernel
    launches): one process, then sp = 2 through the ring and through
    Ulysses as two trainer processes started as pods (dist_child), each
    held against one process at the dist limits; and both planted faults
    (no gradient sum over sp, no visibility mask in the ring) rejected on
    what a wrong update moves."""
    monkeypatch.setattr(chip_smoke, "OUT_DIR", tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(chip_smoke.DistJob, "launches",
                        lambda self, mesh, mode: dict.fromkeys(chip_smoke.FLASH_LAUNCH_KEYS, 0))
    argv = ("--model", "transformer-lm", "--steps", "3", "--batch", "2", "--seq", "64",
            "--layers", "2", "--hidden", "64", "--heads", "4", "--log-every", "1",
            "--device", "cpu", "--remat", "--remat-save-flash")
    job = chip_smoke.DistJob("tiny", argv, 64, 2, 3, 2, 4, 2, tmp_path / "ref.pt", 64)
    ref, _ = chip_smoke.one_process("cpu", job)
    runs = chip_smoke.held_against(ref, chip_smoke.SP_RUNS, "gloo", False, "cpu", job)
    assert [r["kernel_shape"] for r in runs] == [[2, 4, 32, 16], [2, 2, 64, 16]]
    for fault in chip_smoke.SP_FAULTS:
        res = chip_smoke.fault_control(ref, fault, job)
        assert res["rejected_on"], res


def test_fault_controls_run_the_faults_at_once_on_cpu(tmp_path, monkeypatch):
    """The sp phase's faults as fault_controls runs them, both worlds at
    once: each rejected, each by its own record."""
    monkeypatch.setattr(chip_smoke, "OUT_DIR", tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(chip_smoke.DistJob, "launches",
                        lambda self, mesh, mode: dict.fromkeys(chip_smoke.FLASH_LAUNCH_KEYS, 0))
    argv = ("--model", "transformer-lm", "--steps", "3", "--batch", "2", "--seq", "64",
            "--layers", "2", "--hidden", "64", "--heads", "4", "--log-every", "1",
            "--device", "cpu", "--remat", "--remat-save-flash")
    job = chip_smoke.DistJob("tiny", argv, 64, 2, 3, 2, 4, 2, tmp_path / "ref.pt", 64)
    ref, _ = chip_smoke.one_process("cpu", job)
    res = chip_smoke.fault_controls(ref, chip_smoke.SP_FAULTS, job)
    assert [r["run"] for r in res] == [f[0] for f in chip_smoke.SP_FAULTS]
    assert all(r["rejected_on"] for r in res), res


def _k5_operands(dtype, rows=300, k=24, n=40, sizes=(0, 1, 130, 169)):
    rng = np.random.default_rng(11)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)

    return t(rows, k), t(len(sizes), k, n), t(len(sizes), n, k), t(rows, k), torch.tensor(sizes)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k5_check_holds_the_plain_version_and_rejects_every_mutation(dtype):
    """k5_check_case with the plain version standing in for the kernels
    (CPU tensors): it accepts them (excess 0) and rejects each
    K5_MUTATIONS entry on every kernel, at groups that are empty, one row
    and off the tile."""
    x, w_in, w_out, dy, sizes = _k5_operands(dtype)
    out = chip_smoke.k5_check_case("cpu", x, w_in, w_out, dy, sizes, 0, mutate=True)
    assert sorted(out) == sorted([name for name, _ in chip_smoke.K5]
                                 + ["grouped_matmul_tgmm_bf16"])
    assert all(e == (0.0, 0.0) for e in out.values())


def test_k5_check_accepts_one_bf16_step_of_gmm():
    x, w_in, _, _, sizes = _k5_operands(torch.bfloat16)
    ref = gm.gmm_reference(x, w_in, sizes)
    got = (ref.view(torch.int16) + 1).view(torch.bfloat16)
    assert chip_smoke.k5_excess(got, ref, "bfloat16", "gmm") <= 1.0
    got[7, 3] = float("nan")
    assert chip_smoke.k5_excess(got, ref, "bfloat16", "gmm") == float("inf")


def test_k5_bound_at_the_cell_is_operations():
    """Each K5 launch at the cell: 2 x 32768 x 768 x 3072 = 154.6 GFLOP, so
    0.1563 ms at 989 TF/s, against 0.086 ms of bytes."""
    ms, by = chip_smoke.k5_bound(32768, 768, 3072, 8)
    assert by == "operations" and abs(ms - 2 * 32768 * 768 * 3072 / 989e9) < 1e-9
    assert round(ms, 4) == 0.1563


def test_moe_flops_per_step_is_the_count():
    """moe_flops_per_step at a hand-sized model: 6 x the active weights a
    token (attention projections, the dense MLP, two experts' FFNs and the
    router, the head) plus causal attention's 3 x 4 x B T(T+1)/2 x h."""
    b, t, h, v = 2, 4, 8, 10
    active = 2 * 4 * h * h + 2 * h * 4 * h + (2 * 2 * h * 4 * h + h * 8) + h * v
    want = 6.0 * active * b * t + 2 * 3 * 4.0 * b * (t * (t + 1) / 2) * h
    assert chip_smoke.moe_flops_per_step(b, t, layers=2, hidden=h, vocab=v) == want


def test_moe_runs_launch_k5_twice_a_moe_layer_a_step():
    """The ep job's K5 launches: two of each kernel per MoE layer (every
    2nd) a step under sparse, none under dense; the phase's kernels line
    names K5's three kernels and the JAX function they replace."""
    assert chip_smoke.moe_ep_job("sparse").k5_per_step == chip_smoke.MOE_EP_LAYERS
    assert chip_smoke.moe_ep_job("dense").k5_per_step == 0
    assert chip_smoke.moe_ep_job("sparse", 12).k5_per_step == 12
    assert [k for _, k in chip_smoke.K5] == ["gmm_nn", "gmm_nt", "tgmm"]
    assert chip_smoke.K5_REPLACES == "tf_operator_tpu/models/moe.py:193"
    assert chip_smoke.MOE_SHAPE == (8, 6, 2048, 128)


def test_moe_phase_holds_ep_runs_and_rejects_its_fault_on_cpu(tmp_path, monkeypatch):
    """The moe phase's ep machinery at a tiny MoE LM on the CPU (where no
    kernel launches): one process, then ep = 2 as two trainer processes
    started as pods (dist_child), held against one process at the dist
    limits for both dispatches; and ep = 2 without the sum over ep
    rejected on what a wrong update moves."""
    monkeypatch.setattr(chip_smoke, "OUT_DIR", tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(chip_smoke.DistJob, "launches",
                        lambda self, mesh, mode: dict.fromkeys(chip_smoke.FLASH_LAUNCH_KEYS, 0))
    for dispatch in ("sparse", "dense"):
        argv = ("--model", "moe-lm", "--moe-dispatch", dispatch, "--steps", "3", "--batch",
                "4", "--seq", "32", "--layers", "2", "--hidden", "64", "--heads", "4",
                "--log-every", "1", "--device", "cpu")
        job = chip_smoke.DistJob("tiny", argv, 32, 4, 3, 2, 4, 1, tmp_path / "ref.pt", 64)
        ref, _ = chip_smoke.one_process("cpu", job)
        runs = chip_smoke.held_against(ref, chip_smoke.MOE_EP_RUNS, "gloo", False, "cpu", job)
        assert [r["mesh"] for r in runs] == [{"ep": 2}]
        if dispatch == "sparse":
            res = chip_smoke.fault_control(ref, chip_smoke.MOE_EP_FAULT, job)
            assert res["rejected_on"], res


def _sass_listing(kernels):
    """A cuobjdump --dump-sass listing: one Function per (name, template
    arguments, opcodes) of grouped_matmul.cu."""
    ns = "_GLOBAL__N__e3b2a46e_17_grouped_matmul_cu_6df88d3d"
    lines = ["\tcode for sm_90a"]
    for name, targs, opcodes in kernels:
        lines.append(f"\t\tFunction : _ZN{len(ns)}{ns}{len(name)}{name}{targs}EvPKtS2_PKiPii")
        lines += [f"        /*0{i:03x}0*/   {op} ;" for i, op in enumerate(opcodes)]
    return "\n".join(lines)


HGMMA = "HGMMA.64x256x16.F32.BF16 R24, gdesc[UR4], R24, gsb0"
HMMA = "HMMA.16816.F32.BF16 R4, R8, R12, R4"


@pytest.mark.parametrize("kernels,failing", [
    # every kernel with its own tensor-core instructions: accepted
    ([("gmm_wgmma_kernel", "ILb0E", [HGMMA]), ("tgmm_wgmma_kernel", "", [HGMMA]),
      ("gmm_mma_kernel", "ILb1E", [HMMA]), ("gmm_fma_kernel", "ILb1E", ["FFMA R1, R2, R3, R4"])],
     []),
    # a wgmma kernel that compiled to mma.sync (HMMA) is refused
    ([("gmm_wgmma_kernel", "ILb1E", [HMMA]), ("gmm_mma_kernel", "ILb1E", [HMMA])],
     ["gmm_wgmma_kernel<true> without HGMMA instructions"]),
    # an mma.sync kernel without HMMA is refused, HGMMA does not stand in
    ([("tgmm_wgmma_kernel", "", [HGMMA]), ("gmm_mma_kernel", "ILb0E", [HGMMA, "FFMA R1"])],
     ["gmm_mma_kernel<false> without HMMA instructions"]),
    ([("tgmm_mma_kernel", "", ["FFMA R1, R2, R3, R4"])],
     ["tgmm_mma_kernel without HMMA instructions"]),
])
def test_sass_rule_asks_each_route_for_its_tensor_core_instructions(kernels, failing):
    """build_phase's rule (sass_failures): HGMMA in every *wgmma_kernel, HMMA
    in every other *mma_kernel; FMA kernels are asked for neither."""
    assert chip_smoke.sass_failures(_sass_listing(kernels)) == failing


def test_k5_small_cases_reach_both_bf16_routes():
    """K5_SMALL in bf16 takes the wgmma route (K and N multiples of 8 but
    not of 64) and the mma.sync route (K or N off 8), the ep case on each,
    and the tgmm edge-mask case's groups of 1-63 rows start and end inside
    64-row k-steps on the wgmma route."""
    routes = {label: gm.route(torch.bfloat16, rows, k, n, held, 0, 16)
              for label, rows, k, n, gs, first, held in chip_smoke.K5_SMALL}
    assert set(routes.values()) == {"wgmma", "mma"}
    ep = {routes[label] for label, *_, first, held in chip_smoke.K5_SMALL if first > 0}
    assert ep == {"wgmma", "mma"}
    for label, rows, k, n, gs, first, held in chip_smoke.K5_SMALL:
        assert sum(gs) == rows and len(gs) >= first + held
        if routes[label] == "wgmma":
            assert k % 64 and n % 64
    label, rows, k, n, gs, _, _ = chip_smoke.K5_SMALL[1]
    assert routes[label] == "wgmma" and "edge masks" in label
    starts = np.cumsum((0,) + gs[:-1])
    assert sum(1 <= g <= 63 for g in gs) >= 4 and any(s % 64 for s in starts[1:])
    assert {gm.route(torch.float32, rows, k, n, held)
            for _, rows, k, n, _, _, held in chip_smoke.K5_SMALL} == {"fma"}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", range(len(chip_smoke.K5_SMALL)))
def test_k5_small_cases_hold_the_plain_version(dtype, case):
    """Each K5_SMALL case through k5_check_case, the plain version standing
    in for the kernels, with the phase's operands: excess 0 on every
    product."""
    label, rows, k, n, gs, first, held = chip_smoke.K5_SMALL[case]
    rng = np.random.default_rng(rows)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)

    out = chip_smoke.k5_check_case(label, t(rows, k), t(held, k, n, scale=k ** -0.5),
                                   t(held, n, k, scale=k ** -0.5), t(rows, k),
                                   torch.tensor(gs), first, mutate=False)
    assert all(e == (0.0, 0.0) for e in out.values())


def test_stale_outputs_fills_what_torch_empty_makes_and_restores_it():
    empty = torch.empty
    with chip_smoke.stale_outputs():
        assert torch.empty((3, 4), dtype=torch.bfloat16).isnan().all()
        assert torch.empty(5, dtype=torch.int32).dtype == torch.int32
    assert torch.empty is empty


def test_k5_functions_are_the_kernels_of_each_route():
    """The kernels line's kernel_functions: for each K5 record its wgmma,
    mma.sync and FMA kernels, named as kernel_label names them."""
    src = (Path(chip_smoke.__file__).parent / chip_smoke.K5_SOURCE).read_text()
    kernels = set(re.findall(KERNEL_RE, src))
    assert set(chip_smoke.K5_FUNCTIONS) == {name for name, _ in chip_smoke.K5}
    for name, funcs in chip_smoke.K5_FUNCTIONS.items():
        assert [f.split("<")[0].split("_")[-2] for f in funcs] == ["wgmma", "mma", "fma"]
        assert {f.split("<")[0] for f in funcs} <= kernels
        assert chip_smoke.kernel_group(f"void {funcs[0]}(CUtensorMap_st)",
                                       chip_smoke.MOE_GROUPS) == (
            "grouped_matmul_tgmm" if name.endswith("tgmm") else "grouped_matmul_gmm")


# ------------------------------------------------------------ the serve phase

# The serve phase at a CPU size: 2 layers x 128 (2 heads of 64), window 256.
SERVE_TINY = chip_smoke.ServeCell(
    layers=2, hidden=128, heads=2, seq=256, slots=4, max_new=32, batch_max=4,
    a_lengths=(5, 17, 40, 200), a_new=16, b_requests=8, b_new=(4, 32, 8),
    b_length_range=(3, 60), forward_lengths=(9, 100, 200), check_lengths=(1, 3, 11, 150),
    chain_lengths=(5, 20), chain_tokens=8, train_batch=2, device="cpu")


@pytest.fixture(scope="module")
def serve_host(tmp_path_factory):
    """A tiny LM's state dict as the port trainer saves it."""
    from tf_operator_tpu_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig(vocab_size=32000, num_layers=2, hidden=128, num_heads=2,
                                max_len=256, causal=True)
    model = tfm.TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    return {k: v.detach() for k, v in model.state_dict().items()}


def test_serve_cell_requests_fit_its_window():
    """Request a: 8 rows over at least four seq buckets, each with its 64
    new tokens inside the 2048 window; b: 24 single rows, maxNewTokens 8 to
    128; the checks' rows shorter than the window."""
    from tf_operator_tpu_torch.serve.server import select_bucket, seq_bucket_sizes

    cell = chip_smoke.SERVE
    a, b = chip_smoke.serve_requests(cell)
    assert [len(r) for r in a] == list(cell.a_lengths) and len(a) == cell.batch_max == 8
    assert min(cell.a_lengths) == 17 and max(cell.a_lengths) == 1984
    assert all(n + cell.a_new <= cell.seq for n in cell.a_lengths)
    buckets = {select_bucket(n, seq_bucket_sizes(cell.seq)) for n in cell.a_lengths}
    assert len(buckets) >= 4
    assert len(b) == 24 and {n for _, n in b} >= {8, 128}
    assert all(len(r) + n <= cell.seq and 0 < n <= cell.max_new for r, n in b)
    assert max(cell.forward_lengths + cell.check_lengths) < cell.seq
    assert (cell.layers, cell.hidden, cell.heads, cell.vocab) == (12, 768, 6, 32000)


def test_serve_env_is_the_controllers():
    from tf_operator_tpu.serve import controller

    env = chip_smoke.serve_env(chip_smoke.SERVE, "/ck", 1234, {
        k: f"/f/{k}" for k in ("stats", "heartbeat", "events")})
    assert env[controller.ENV_MAX_SEQ_LEN] == "2048"
    assert env[controller.ENV_MAX_CONCURRENT] == "8"
    assert env[controller.ENV_MAX_NEW_TOKENS] == "128"
    assert env[controller.ENV_BATCH_MAX] == "8"
    assert env[controller.ENV_MODEL] == "transformer-lm"
    assert env[controller.ENV_CKPT_DIR] == "/ck"
    assert env["TPUJOB_SERVE_NUM_HEADS"] == "6"


def test_serve_checks_pass_sound_and_reject_each_planted_fault(serve_host):
    """decode_readings in bf16 on the CPU: the sound path within
    SERVE_LIMITS, every SERVE_FAULTS entry over one of them (serve_verdict
    passes), and planted() restores the helper it broke."""
    from tf_operator_tpu_torch.models import decode

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        readings = {"sound": chip_smoke.decode_readings(serve_host, SERVE_TINY)}
        for what, helper in chip_smoke.SERVE_FAULTS:
            orig = getattr(decode, helper)
            with chip_smoke.planted(helper):
                assert getattr(decode, helper) is not orig
                readings[what] = chip_smoke.decode_readings(serve_host, SERVE_TINY)
            assert getattr(decode, helper) is orig
    finally:
        torch.set_num_threads(n)
    assert chip_smoke.serve_verdict(readings) == []
    for what, _ in chip_smoke.SERVE_FAULTS:
        assert max(readings[what][k] / chip_smoke.SERVE_LIMITS[k]
                   for k in chip_smoke.SERVE_LIMITS) > 3, (what, readings[what])


@pytest.mark.parametrize("broken", ["sound over", "fault under"])
def test_serve_verdict_fails_a_bad_reading(broken):
    sound = {"prefill_vs_forward": 0.03, "tick_vs_prefill": 0.03}
    fault = {"prefill_vs_forward": 0.03, "tick_vs_prefill": 0.5}
    readings = {"sound": dict(sound), **{w: dict(fault) for w, _ in chip_smoke.SERVE_FAULTS}}
    assert chip_smoke.serve_verdict(readings) == []
    if broken == "sound over":
        readings["sound"]["tick_vs_prefill"] = 0.2
    else:
        readings[chip_smoke.SERVE_FAULTS[1][0]] = dict(sound)
    assert len(chip_smoke.serve_verdict(readings)) == 1


def test_f32_chains_equal_a_naive_reforward_on_cpu(serve_host):
    out = chip_smoke.f32_chains(serve_host, SERVE_TINY)
    assert out["equal"] and len(out["chains"]) == 2 and len(out["chains"][0]) == 8


def test_held_answers_stop_at_the_first_near_tie():
    want = [[1, 2, 3, 4], [5, 6, 7, 8]]
    margins = [[1.0, 1.0, 0.001, 1.0], [1.0] * 4]
    assert chip_smoke.held_answers([[1, 2, 9, 9], [5, 6, 7, 8]], want, margins) == {
        "compared": 6, "of": 8, "mismatch": None, "identical": False}
    bad = chip_smoke.held_answers([[1, 2, 3, 4], [5, 0, 7, 8]], want, margins)
    assert bad["mismatch"] == (1, 1, 0, 6)
    assert chip_smoke.held_answers([[1, 2]], [[1, 2, 3]], [[1.0] * 3])["mismatch"] == (
        0, "length", 2, 3)


def test_tick_bound_counts_weights_cache_and_logits():
    """The full-width cell's tick: bf16 dense weights and biases, f32
    LayerNorm parameters, 9 rows of both f32 embedding tables, the 679 MB
    cache of 9 slots x 2048, the tick's K/V writes and f32 logits."""
    from tf_operator_tpu_torch.models import decode
    from tf_operator_tpu_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig(vocab_size=32000, num_layers=12, hidden=768, num_heads=6,
                                max_len=2048, causal=True)
    model = tfm.TransformerLM(cfg, device="meta")
    params = decode.prepare_params(dict(model.state_dict()), cfg)
    h, layers, slots = 768, 12, 9
    dense = layers * (4 * (h * h + h) + (h * 4 * h + 4 * h) + (4 * h * h + h)) + h * 32000
    norms = (2 * layers + 1) * 2 * h
    cache = 2 * layers * slots * 6 * 2048 * 128 * 2
    want = dense * 2 + norms * 4 + 2 * slots * h * 4 + cache + 2 * layers * slots * h * 2 \
        + slots * 32000 * 4
    got = chip_smoke.tick_bound_bytes(params, cfg, slots, 2048)
    assert got == want == 900357120
    assert cache == 679477248


def test_serve_phase_runs_on_cpu_at_a_tiny_size(tmp_path, monkeypatch):
    """The serve phase end to end at SERVE_TINY on the CPU: the trainer's
    checkpoint, the server subprocess with requests a and b and its
    SIGTERM drain, the in-process chains, readings, faults and f32 chains."""
    monkeypatch.setattr(chip_smoke, "OUT_DIR", tmp_path)
    monkeypatch.setattr(chip_smoke, "SERVE_DIR", tmp_path / "serve")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rec = chip_smoke.serve_phase("cpu", SERVE_TINY)
    finally:
        torch.set_num_threads(n)
    assert rec["answers_held"]["identical"] and rec["answers_held"]["of"] == 4 * 16
    assert rec["server_stats"]["served_total"] == 1 + 8
    assert rec["f32_chains"]["equal"] and rec["tick_ms"]["n"] == 15
    assert rec["kv_bytes"] == 2 * 2 * 5 * 2 * 256 * 64 * 2
    assert set(rec["readings"]) == {"sound"} | {w for w, _ in chip_smoke.SERVE_FAULTS}


def test_multislice_runs_are_the_cells():
    """The multislice phase's argv: the train phase's full-width LM (every
    step logged) with 2 microbatches, each slice launching K1-K3 and the
    delta pass once a layer a microbatch a step; each slice's env is the
    operator's (worker `sid`, its slice, the shared directory)."""
    job = chip_smoke.ms_job(chip_smoke.LAYERS, "ref.pt")
    argv = chip_smoke.ms_argv(job)
    for flag, value in (("--layers", "12"), ("--hidden", "768"), ("--heads", "6"),
                        ("--seq", "8192"), ("--batch", "4"), ("--steps", "6"),
                        ("--log-every", "1"), ("--dcn-microbatches", "2"),
                        ("--device", "cuda")):
        assert argv[argv.index(flag) + 1] == value, flag
    assert chip_smoke.slice_launches(job) == dict.fromkeys(chip_smoke.FLASH_LAUNCH_KEYS, 144)
    assert chip_smoke.ms_job(chip_smoke.MS_REWIND_LAYERS, "r.pt").layers == 4
    assert chip_smoke.MS_KILL - chip_smoke.MS_CKPT_EVERY == 2
    env = chip_smoke.slice_env(1, Path("/d"), job)
    assert {k: env[k] for k in ("TPUJOB_NUM_SLICES", "TPUJOB_SLICE_ID", "TPUJOB_DCN_DIR",
                                "TPUJOB_REPLICA_TYPE", "TPUJOB_REPLICA_INDEX")} == \
        {"TPUJOB_NUM_SLICES": "2", "TPUJOB_SLICE_ID": "1", "TPUJOB_DCN_DIR": "/d",
         "TPUJOB_REPLICA_TYPE": "worker", "TPUJOB_REPLICA_INDEX": "1"}


def test_dcn_dir_falls_back_when_dev_shm_lacks_room(tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "OUT_DIR", tmp_path)
    monkeypatch.setattr(chip_smoke, "MS_SHM_BYTES", float("inf"))
    path = chip_smoke.dcn_dir("x")
    assert path.parent == tmp_path and path.is_dir() and not any(path.iterdir())


def test_multislice_phase_holds_slices_and_rejects_its_fault_on_cpu(tmp_path, monkeypatch):
    """The multislice phase's machinery at a tiny LM on the CPU (where no
    kernel launches): one process, then 2 slices (dist_child, the
    operator's env) held against it at the dist limits with the dcn block
    recorded; each slice applying its own mean rejected on what a wrong
    update moves; the same 2 slices again (sent eager by
    CHIP_SMOKE_STEP_ROUTE) within 1e-5 of the first run (world_gap: the
    exchange sums in the order its files arrive, so no closer); the kill
    of slice 1, its relaunch and slice 0's rewind ending on the
    uninterrupted losses."""
    monkeypatch.setattr(chip_smoke, "OUT_DIR", tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    zeros = dict.fromkeys(chip_smoke.FLASH_LAUNCH_KEYS, 0)
    monkeypatch.setattr(chip_smoke.DistJob, "launches", lambda self, mesh, mode: zeros)
    monkeypatch.setattr(chip_smoke, "slice_launches", lambda job: zeros)
    argv = ("--model", "transformer-lm", "--steps", "6", "--batch", "4", "--seq", "32",
            "--layers", "2", "--hidden", "32", "--heads", "2", "--log-every", "1",
            "--device", "cpu")
    job = chip_smoke.DistJob("tiny", argv, 32, 4, 6, 2, 2, 1, tmp_path / "ref.pt", 32)
    ref, _ = chip_smoke.one_process("cpu", job)
    sound = chip_smoke.slice_world("full", job)
    res = chip_smoke.ms_summary("2 slices", job, sound, ref, "cpu")
    assert not chip_smoke.dist_verdict(res["gaps"]), res["gaps"]
    assert [d["slice_id"] for d in res["dcn"]] == [0, 1]
    assert all(d["transfers"] == 6 * 2 * d["buckets"] for d in res["dcn"])
    again = chip_smoke.slice_world("eager", job, route="eager")
    assert not chip_smoke.dist_verdict(chip_smoke.dist_gaps(ref, again))
    gap = chip_smoke.world_gap(sound, again)
    assert gap["loss"] <= 1e-5 and gap["grad_norm"] <= 1e-5, gap
    assert all(len(r["param_digest"]) == 64 for r in sound["ranks"])
    gaps = chip_smoke.dist_gaps(ref, chip_smoke.slice_world("fault", job, "no-dcn-sum"))
    assert [f for f in chip_smoke.dist_verdict(gaps) if not f.startswith("loss")], gaps
    rewind = chip_smoke.ms_rewind(job, ref, "cpu", sound)
    assert rewind["resumed_from"] == 3 and rewind["rewind"]["peer_resume"] == 3
    assert rewind["slice0_starts"] == 1 and rewind["dcn"]["rewinds"] == 1
    assert max(rewind["gaps_to_the_sound_run"].values()) <= 1e-5, rewind


PIPE_TINY = chip_smoke.PipeCell(layers=2, hidden=32, heads=2, vocab=64, seq=16, batch=4,
                                stages=2, micro=2, device="cpu", dtype="bfloat16")


def test_pipeline_launches_are_a_stages_layers_a_microbatch():
    assert chip_smoke.pipeline_launches(chip_smoke.PIPE) == \
        dict.fromkeys(chip_smoke.FLASH_LAUNCH_KEYS, 6 * 4)
    assert (chip_smoke.PIPE.layers, chip_smoke.PIPE.seq, chip_smoke.PIPE.batch) == \
        (chip_smoke.LAYERS, chip_smoke.SEQ, chip_smoke.BATCH)


@pytest.mark.parametrize("broken", [None, "sound", "fault"])
def test_pipeline_phase_runs_on_cpu_at_a_tiny_size(tmp_path, monkeypatch, broken):
    """The pipeline phase end to end on the CPU (two gloo ranks, bf16):
    the sound readings under PP_LIMIT, the zero hop over it, the record's
    fields; a limit the sound readings miss, or one the zero hop meets,
    fails the phase."""
    monkeypatch.setattr(chip_smoke, "OUT_DIR", tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(chip_smoke, "pipeline_launches",
                        lambda cell: dict.fromkeys(chip_smoke.FLASH_LAUNCH_KEYS, 0))
    if broken:
        monkeypatch.setattr(chip_smoke, "PP_LIMIT", 0.0 if broken == "sound" else 1e12)
        with pytest.raises(chip_smoke.SmokeFailure, match="sound grads|zero hop"):
            chip_smoke.pipeline_phase({}, "cpu", PIPE_TINY)
        return
    records: dict = {}
    res = chip_smoke.pipeline_phase(records, "cpu", PIPE_TINY)
    assert res["backend"] == "gloo" and res["bubble"] == pytest.approx(1 / 3)
    assert res["sound"]["logits"] <= chip_smoke.PP_LIMIT >= res["sound"]["grads"]
    assert res["zero_hop"]["logits"] > chip_smoke.PP_LIMIT
    assert len(res["step_s"]) == 2 and len(res["one_process_step_s"]) == 3
    assert records["flash_fwd"]["pipeline_launches_per_step_per_rank"] == 0


@pytest.mark.parametrize("make", [
    lambda layers: chip_smoke.sp_lm_job(chip_smoke.SP_SEQ, 1, "ref.pt", layers),
    lambda layers: chip_smoke.pod_job(layers)], ids=["sp", "pod"])
def test_planted_faults_run_at_their_own_depth(make):
    """The sp and pod phases hold their planted faults at FAULT_LAYERS
    against a one-process run of that depth: the fault job differs from
    the sound runs' only in its layers (argv and launches) and label."""
    full, fault = make(chip_smoke.LAYERS), make(chip_smoke.FAULT_LAYERS)
    assert chip_smoke.FAULT_LAYERS < chip_smoke.LAYERS
    at = full.argv.index("--layers") + 1
    assert fault.argv[at] == str(chip_smoke.FAULT_LAYERS)
    assert fault.argv[:at] + fault.argv[at + 1:] == full.argv[:at] + full.argv[at + 1:]
    mesh = {"sp": 2}
    assert {k: n * chip_smoke.LAYERS for k, n in fault.launches(mesh, "ring").items()} == \
        {k: n * chip_smoke.FAULT_LAYERS for k, n in full.launches(mesh, "ring").items()}
    assert fault.label != full.label and fault.layers == chip_smoke.FAULT_LAYERS


def test_pod_runs_are_the_cells():
    """The pod phase's argv is the train phase's full-width LM (every step
    logged); each rank of 2 pods x 2 at dp x tp = 2 x 2 launches K1-K3 and
    delta once a layer a step at [2, 3, 8192, 128]; the pod4 runs span four
    GPUs, as one pod and as two."""
    job = chip_smoke.pod_job()
    for flag, value in (("--layers", "12"), ("--hidden", "768"), ("--heads", "6"),
                        ("--seq", "8192"), ("--batch", "4"), ("--steps", "6"),
                        ("--log-every", "1"), ("--device", "cuda")):
        assert job.argv[job.argv.index(flag) + 1] == value, flag
    assert chip_smoke.POD_PODS * chip_smoke.POD_LOCAL == \
        int(np.prod(list(chip_smoke.POD_MESH.values()))) == 4
    assert job.launches(chip_smoke.POD_MESH, None) == \
        dict.fromkeys(chip_smoke.FLASH_LAUNCH_KEYS, 12 * 6)
    assert job.local_shape(chip_smoke.POD_MESH, None) == (2, 3, 8192, 128)
    for _, mesh, pods, visible in chip_smoke.POD4_RUNS:
        assert len(visible) == pods and int(np.prod(list(mesh.values()))) == 4
        assert sorted(",".join(visible).split(",")) == ["0", "1", "2", "3"]


def test_children_see_one_card_unless_given_their_own(tmp_path, monkeypatch):
    """start_child pins a trainer child to this process's first GPU (a pod
    given one card), unless its env names the GPUs it sees."""
    monkeypatch.setattr(chip_smoke, "OUT_DIR", tmp_path)
    code = "import os, sys; open(sys.argv[1], 'w').write(os.environ['CUDA_VISIBLE_DEVICES'])\n"
    for parent, given, want in (("2,3", None, "2"), (None, None, "0"), ("0,1", "1", "1")):
        if parent is None:
            monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        else:
            monkeypatch.setenv("CUDA_VISIBLE_DEVICES", parent)
        env = None if given is None else {"CUDA_VISIBLE_DEVICES": given}
        child = chip_smoke.start_child([], "_cards", env, code)
        assert chip_smoke.finish_child(child, 60)[0] == 0
        assert child[2].read_text() == want


def test_pod_phase_holds_pods_and_rejects_its_fault_on_cpu(tmp_path, monkeypatch):
    """The pod phase's machinery at a tiny LM on the CPU (where no kernel
    launches): one process, then 2 pods x 2 local ranks at dp x tp = 2 x 2
    (pod_child: each supervisor given 2 ranks, each rank dist_child) held
    against it at the dist limits, with one event stream a pod and every
    rank's K1 at its [rows * local heads, T, D]; dp without the gradient
    reduction rejected on what a wrong update moves."""
    monkeypatch.setattr(chip_smoke, "OUT_DIR", tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(chip_smoke.DistJob, "launches",
                        lambda self, mesh, mode: dict.fromkeys(chip_smoke.FLASH_LAUNCH_KEYS, 0))
    argv = ("--model", "transformer-lm", "--steps", "3", "--batch", "4", "--seq", "32",
            "--layers", "2", "--hidden", "128", "--heads", "2", "--log-every", "1",
            "--device", "cpu")
    job = chip_smoke.DistJob("tiny", argv, 32, 4, 3, 2, 2, 1, tmp_path / "ref.pt", 128)
    ref, _ = chip_smoke.one_process("cpu", job)
    mesh = chip_smoke.POD_MESH
    world = chip_smoke.pod_world("pods", job, mesh, ("0", "0"), 2, "gloo")
    assert [(r["pod"], r["local_rank"]) for r in world["ranks"]] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r["flash_fwd_shapes"] == [[2, 32, 64]] for r in world["ranks"])
    res = chip_smoke.pod_summary("pods", job, mesh, world, ref, "cpu")
    assert not chip_smoke.dist_verdict(res["gaps"]), res["gaps"]
    assert (res["pods"], res["ranks_per_pod"], len(res["peak_gb"])) == (2, 2, 4)
    gaps = chip_smoke.dist_gaps(ref, chip_smoke.pod_world("fault", job, mesh, ("0", "0"), 2,
                                                          "gloo", "no-grad-reduce"))
    assert [f for f in chip_smoke.dist_verdict(gaps) if not f.startswith("loss")], gaps


def _graph_record(losses, norms, state, launches_per_step=12, steps=6):
    return {"loss": list(losses), "grad_norm": list(norms), "state": state,
            "count": steps, "launches": {k: launches_per_step * steps
                                         for k in chip_smoke.FLASH_LAUNCH_KEYS}}


@pytest.fixture
def graph_records():
    """Stand-ins of graph_run's records: an eager run, a graphed run equal
    to it bit for bit, and what each planted fault gives."""
    rng = np.random.default_rng(0)
    steps = chip_smoke.GRAPH_STEPS
    names = ("trunk.embed.weight", "lm_head.weight")
    state = {f"{g}/{n}": torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
             for g in chip_smoke.GRAPH_STATE_GROUPS for n in names}
    losses = [10.88 - 0.05 * i for i in range(steps)]
    norms = [0.86 / (i + 1) for i in range(steps)]
    eager = _graph_record(losses, norms, state)
    same = _graph_record(losses, norms, {k: v.clone() for k, v in state.items()})
    # skip-reseed: the replays (steps 2 on) train on other batches.
    other = [x + 1e-3 for x in losses[1:]]
    reseed = _graph_record(losses[:1] + other, norms[:1] + [x * 1.01 for x in norms[1:]],
                           {k: v + 1e-3 for k, v in state.items()})
    # frozen-bias: the corrections of the captured step reused from step 3
    # on: the losses move a step later, the parameters and masters too.
    frozen_state = {k: (v + 1e-4 if k.startswith(("params/", "master/")) else v.clone())
                    for k, v in state.items()}
    frozen = _graph_record(losses[:3] + [x + 1e-4 for x in losses[3:]], norms, frozen_state)
    return eager, same, {"skip-reseed": reseed, "frozen-bias": frozen}


def test_graph_verdict_accepts_the_bit_equal_run(graph_records):
    eager, same, _ = graph_records
    assert chip_smoke.graph_verdict(eager, same, chip_smoke.LAYERS,
                                    chip_smoke.GRAPH_STEPS) == []


@pytest.mark.parametrize("label,fault,must", chip_smoke.GRAPH_FAULTS)
def test_graph_verdict_rejects_each_planted_fault_by_name(graph_records, label, fault, must):
    eager, _, faults = graph_records
    fails = chip_smoke.graph_verdict(eager, faults[fault], chip_smoke.LAYERS,
                                     chip_smoke.GRAPH_STEPS)
    assert any(f.startswith(must) for f in fails), (label, fails)


def test_graph_verdict_rejects_one_ulp_and_missing_launches(graph_records):
    eager, same, _ = graph_records
    k = "mu/lm_head.weight"
    same["state"][k] = torch.nextafter(same["state"][k], torch.full_like(same["state"][k], 9))
    same["launches"]["bwd_dkv"] -= 12  # a step whose K3 did not replay
    same["grad_norm"][4] = float(np.nextafter(same["grad_norm"][4], 1.0))
    fails = chip_smoke.graph_verdict(eager, same, chip_smoke.LAYERS, chip_smoke.GRAPH_STEPS)
    assert [f.split()[0] for f in fails] == ["grad_norm", "mu", "launches"], fails


def _census_events(graphed: bool, steps: int = 6, layers: int = 12):
    """A synthetic profile of `steps` LM steps: each step's device kernels
    (12 K1, 12 K2, 12 K3, 12 delta, a GEMM, a copy) and the host call
    behind each: one cudaGraphLaunch a step when graphed, else one
    cudaLaunchKernel (cudaMemcpyAsync for the copy) a kernel."""
    kernels, runtime, t, corr = [], {}, 0, 0
    for _ in range(steps):
        names = [n for n in ("fwd_wgmma_kernel<128>", "bwd_dq_wgmma_kernel<128>",
                             "bwd_dkv_wgmma_kernel<128>", "bwd_delta_kernel<bf16, 128>")
                 for _ in range(layers)] + ["nvjet_tst_128x256", "Memcpy DtoD"]
        names = names[:1] + names[-2:] + names[1:-2]  # the step opens with K1
        if graphed:
            corr += 1
            runtime[corr] = "cudaGraphLaunch"
        for name in names:
            if not graphed:
                corr += 1
                runtime[corr] = "cudaMemcpyAsync" if "Memcpy" in name else "cudaLaunchKernel"
            kernels.append((name, t, corr))
            t += 10
    return kernels, runtime


def test_launch_census_counts_one_graph_launch_a_step():
    kernels, runtime = _census_events(graphed=True)
    census = chip_smoke.launch_census(kernels, runtime, chip_smoke.LM_STEP_MARKER, 12, 6)
    assert census["steps"] == 3 and census["graph_launches"] == 3
    assert census["graph_launches_per_step"] == 1.0
    assert census["k123_by_launch_api"] == {"cudaGraphLaunch": 3 * 36}
    assert census["kernels_by_launch_api"] == {"cudaGraphLaunch": 3 * 50}
    assert chip_smoke.census_failures(census) == []


def test_launch_census_rejects_kernels_launched_one_by_one():
    kernels, runtime = _census_events(graphed=False)
    census = chip_smoke.launch_census(kernels, runtime, chip_smoke.LM_STEP_MARKER, 12, 6)
    assert census["graph_launches"] == 0
    assert census["k123_by_launch_api"] == {"cudaLaunchKernel": 3 * 36}
    assert census["kernels_by_launch_api"] == {"cudaLaunchKernel": 3 * 49,
                                               "cudaMemcpyAsync": 3}
    fails = chip_smoke.census_failures(census)
    assert len(fails) == 2 and "cudaGraphLaunch" in fails[0] and "outside a graph" in fails[1]


def test_launch_census_needs_every_step_marker():
    kernels, runtime = _census_events(graphed=True)
    with pytest.raises(chip_smoke.SmokeFailure, match="census saw"):
        chip_smoke.launch_census(kernels[1:], runtime, chip_smoke.LM_STEP_MARKER, 12, 6)


def test_is_k123_leaves_out_the_delta_pass_and_k5():
    assert chip_smoke.is_k123("void fwd_wide_wgmma_kernel(...)")
    assert chip_smoke.is_k123("bwd_dkv_kernel<float, 64, 64>")
    assert not chip_smoke.is_k123("bwd_delta_kernel<bf16, 128>")
    assert not chip_smoke.is_k123("gmm_wgmma_kernel<false>")


def test_census_holds_a_world_ranks_nccl_kernels_under_the_graph():
    """A rank of a world: its step's NCCL kernels must replay under the
    graph launch, and no NCCL kernel may come from another host call (the
    world watch's empty all-reduce launches none)."""
    kernels, runtime = _census_events(graphed=True)
    corr = {c for _, _, c in kernels}
    under = [("ncclDevKernel_AllReduce_Sum_f32_RING_LL", t + 1, c)
             for n, t, c in kernels if n.startswith("nvjet")]
    census = chip_smoke.launch_census(kernels + under, runtime, chip_smoke.LM_STEP_MARKER,
                                      12, 6)
    assert census["nccl_by_launch_api"] == {"cudaGraphLaunch": 3}
    assert chip_smoke.census_failures(census, world=True) == []
    assert chip_smoke.census_failures(chip_smoke.launch_census(
        kernels, runtime, chip_smoke.LM_STEP_MARKER, 12, 6), world=True) == \
        ["no NCCL kernel under the graph launches"]
    outside = max(corr) + 1
    runtime[outside] = "cudaLaunchKernelExC"
    stray = [("ncclDevKernel_AllReduce_Sum_f32_RING_LL", t + 2, outside)
             for n, t, _ in kernels if n.startswith("nvjet")]
    fails = chip_smoke.census_failures(chip_smoke.launch_census(
        kernels + under + stray, runtime, chip_smoke.LM_STEP_MARKER, 12, 6), world=True)
    assert fails == ["NCCL kernels launched outside a graph: {'cudaLaunchKernelExC': 3}"]
    assert chip_smoke.is_nccl("ncclKernel_AllGather_RING_LL_Sum_int8_t")
    assert not chip_smoke.is_nccl("bwd_delta_kernel<bf16, 128>")


def test_nccl_graph_probe_record_is_pinned():
    """The one-rank NCCL capture probe's expected record: the port's five
    collectives in one graph, 3 replays each bit-equal to the eager calls,
    and the world watch's empty all-reduce ordered after the stream's work
    without a device event of its own."""
    assert chip_smoke.NCCL_GRAPH_PROBE == {
        "collectives": ["all_reduce", "all_gather", "reduce_scatter", "all_to_all", "rotate"],
        "replays": 3, "bit_equal": [True, True, True], "watch_waits_for_the_stream": True,
        "watch_device_events": 0}
    good = dict(chip_smoke.NCCL_GRAPH_PROBE, watch_device_event_names=[])
    assert chip_smoke.nccl_graph_failures(good) == []
    for key, bad in (("bit_equal", [True, False, True]), ("watch_device_events", 1),
                     ("watch_waits_for_the_stream", False), ("replays", 2)):
        fails = chip_smoke.nccl_graph_failures(dict(good, **{key: bad}))
        assert len(fails) == 1 and fails[0].startswith(key), fails


def test_world_graph_fault_is_rejected_by_name(graph_records):
    """WORLD_GRAPH_FAULTS: a graph that left its gradient all-reduce out
    steps every replay on the rank's own gradients, so graph_verdict's
    grad_norm (from step 2 on) names it; world_graph_failures demands that
    of every rank and passes bit-equal ranks."""
    (label, fault, must), = chip_smoke.WORLD_GRAPH_FAULTS
    assert (fault, must) == ("skip-grad-reduce", "grad_norm") and "all-reduce" in label
    eager, same, _ = graph_records
    local = dict(same, grad_norm=same["grad_norm"][:1] + [x * 1.4 for x in same["grad_norm"][1:]],
                 loss=same["loss"][:2] + [x + 1e-3 for x in same["loss"][2:]])
    fails = chip_smoke.graph_verdict(eager, local, chip_smoke.LAYERS, chip_smoke.GRAPH_STEPS)
    assert [f.split()[0] for f in fails] == ["loss", "grad_norm"], fails
    good = {"fails": [], "census_fails": [], "faults": {fault: fails}}
    assert chip_smoke.world_graph_failures("w", [good] * 4, True) == []
    missed = dict(good, faults={fault: []})
    assert "was not rejected" in chip_smoke.world_graph_failures("w", [good, missed], True)[0]
    off = dict(good, fails=["loss differs at steps [3]"])
    assert chip_smoke.world_graph_failures("w", [good, off], False) == \
        ["w rank 1: loss differs at steps [3]"]


def test_skip_grad_reduce_leaves_the_reduction_out_of_the_capture_only(monkeypatch):
    from tf_operator_tpu_torch.parallel import collectives

    calls = []
    monkeypatch.setattr(collectives, "all_reduce_flat",
                        lambda tensors, group: calls.append(group) or ["reduced"])
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    g = [torch.ones(2)]
    with chip_smoke.planted_graph_fault("skip-grad-reduce"):
        assert collectives.all_reduce_flat(g, "dp") == ["reduced"]
        capturing[0] = True
        assert collectives.all_reduce_flat(g, "dp") == g
    assert calls == ["dp"] and collectives.all_reduce_flat(g, "tp") == ["reduced"]


def test_world_route_is_the_backend_rule():
    from tf_operator_tpu_torch.parallel import graphed_step

    for backend in ("nccl", "gloo"):
        want = graphed_step.step_route("cuda", 4, backend, False)[0]
        assert chip_smoke.world_route(backend) == want


def _kill_world(ends):
    return {"killed": True, "survivors": [
        {"rank": r, "exit_code": rc, "peer_lost": lost, "seconds_after_kill": t}
        for r, (rc, lost, t) in enumerate(ends)]}


def test_kill_failures_hold_the_graph_world_to_no_worse_than_the_eager_one():
    # Both NCCL worlds, graphed and eager, are held to the trainer's own
    # watchdog: every survivor exits 138 with peer_lost within KILL_LIMIT_S.
    limit = chip_smoke.KILL_LIMIT_S
    ok = _kill_world([(138, True, 61.0)] * 3)
    assert chip_smoke.kill_failures({"graph": ok, "eager": ok}) == []
    sigabrt = chip_smoke.kill_failures({"graph": _kill_world([(-6, False, 131.1)] * 3),
                                        "eager": ok})
    assert len(sigabrt) == 3 and all(f.startswith("graph: rank") for f in sigabrt), sigabrt
    hung = chip_smoke.kill_failures({"graph": ok,
                                     "eager": _kill_world([(None, False, None)] * 3)})
    assert len(hung) == 3 and "never after the kill" in hung[0], hung
    late = chip_smoke.kill_failures({"graph": _kill_world([(138, True, limit + 0.5)] * 3),
                                     "eager": ok})
    assert len(late) == 3 and f"within {limit} s" in late[0]
    silent = chip_smoke.kill_failures({"graph": ok,
                                       "eager": _kill_world([(138, False, 10.0)] * 3)})
    assert len(silent) == 3 and "peer_lost False" in silent[0]
    unseen = dict(_kill_world([]), killed=False)
    assert "never seen" in chip_smoke.kill_failures({"graph": unseen, "eager": ok})[0]
    assert "eager: its last rank" in chip_smoke.kill_failures({"graph": ok})[0]
    # A world recorded beside them (the parent's) is not held.
    assert chip_smoke.kill_failures({"graph": ok, "eager": ok,
                                     "parent eager": _kill_world([(None, False, None)])}) == []


def test_kill_check_on_cpu(tmp_path, monkeypatch):
    """The kill check's machinery on the CPU: a tiny LM at dp = 2 over gloo
    in two worlds of this checkout (through chip_smoke._TREE_CHILD, one on
    the trainer's own route, one sent eager by CHIP_SMOKE_STEP_ROUTE), the
    last rank killed once it reports step 3; gloo reports the lost peer at
    once, so each survivor exits 138 with a peer_lost event, as
    kill_failures demands."""
    monkeypatch.setattr(chip_smoke, "OUT_DIR", tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = ["--model", "transformer-lm", "--steps", "400", "--batch", "4", "--seq", "32",
            "--layers", "2", "--hidden", "64", "--heads", "4", "--log-every", "1",
            "--device", "cpu"]
    res = chip_smoke.kill_check("cpu", {"graph": (chip_smoke.ROOT, {}),
                                        "eager": (chip_smoke.ROOT, chip_smoke.KILL_EAGER)},
                                argv, {"dp": 2})
    for label in ("graph", "eager"):
        assert res[label]["killed"], res
        (end,) = res[label]["survivors"]
        assert (end["exit_code"], end["peer_lost"]) == (138, True), res
        assert end["seconds_after_kill"] < 60, res
    assert chip_smoke.kill_failures(res) == []
