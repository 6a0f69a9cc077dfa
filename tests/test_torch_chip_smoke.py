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

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from tf_operator_tpu_torch.ops import flash_attention as fa
from tf_operator_tpu_torch.ops import fused_bottleneck as fb

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


def test_every_flash_kernel_has_an_lm_profile_group():
    """Each __global__ kernel of flash_attention.cu falls in an LM profile
    group other than "other", as the profiler names it, and the kernels of
    each wrapper fall in that wrapper's group."""
    names = _flash_kernel_names()
    assert {"fwd_kernel", "bwd_dq_kernel", "bwd_dkv_kernel", "bwd_delta_kernel",
            "fwd_wgmma_kernel", "bwd_dq_wgmma_kernel", "bwd_dkv_wgmma_kernel"} <= set(names)
    want = {"fwd": "flash_fwd", "bwd_dq": "flash_bwd_dq", "bwd_dkv": "flash_bwd_dkv",
            "bwd_delta": "flash_bwd_delta"}
    for name in names:
        profiled = f"void (anonymous namespace)::{name}<__nv_bfloat16, 128>(__nv_bfloat16 const*)"
        group = chip_smoke.kernel_group(profiled, chip_smoke.LM_GROUPS)
        assert group != "other", name
        stem = re.sub(r"(_wgmma)?_kernel$", "", name)
        assert group == want[stem], (name, group)


def test_profile_step_marker_names_only_the_forward():
    """The LM profile cuts steps at kernels whose name holds every
    substring of LM_STEP_MARKER: of all the __global__ kernels of csrc/,
    exactly the forward kernels (f32 and bf16), as the profiler names them."""
    names = [n for src in sorted(CSRC.glob("*.cu")) for n in re.findall(KERNEL_RE, src.read_text())]
    assert "gemm_kernel" in names  # fused_bottleneck.cu's kernels are read too
    marked = {n for n in names
              if all(k in f"void (anonymous namespace)::{n}<128>(CUtensorMap_st)".lower()
                     for k in chip_smoke.LM_STEP_MARKER)}
    assert marked == {"fwd_kernel", "fwd_wgmma_kernel"}


def _mangled(name, targs=""):
    ns = "_GLOBAL__N__e3b2a46e_18_flash_attention_cu_6df88d3d"
    return f"_ZN{len(ns)}{ns}{len(name)}{name}{targs}Ev14CUtensorMap_stPKfi"


@pytest.mark.parametrize("targs,label", [
    ("ILi128EE", "bwd_dq_wgmma_kernel<128>"),
    ("IfLi64EE", "bwd_dq_wgmma_kernel<float, 64>"),
    ("I13__nv_bfloat16Li128EE", "bwd_dq_wgmma_kernel<bf16, 128>"),
    ("", "bwd_dq_wgmma_kernel"),
    ("ILi128EE", "fwd_wgmma_kernel<128>"),
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
    tile divides; the timing shapes keep H x D at the LM's hidden width."""
    cases = {(shape[3], dt, causal) for shape, dt, causal in chip_smoke.WIDTH_CASES}
    assert cases == {(d, dt, c) for d in (32, 96, 192, 256)
                     for dt in ("float32", "bfloat16") for c in (True, False)}
    for shape, _, _ in chip_smoke.WIDTH_CASES:
        assert all(shape[2] % tile for tile in (32, 64, 128))
    for d in chip_smoke.HEAD_WIDTHS:
        assert chip_smoke.HEAD_WIDTH_HIDDEN % d == 0
        assert fa.kernel_head_dim(d) in fa.SUPPORTED_HEAD_DIMS


@pytest.mark.parametrize("d,dtype_name", [(32, "bfloat16"), (96, "float32"),
                                          (192, "bfloat16"), (256, "float32")])
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
