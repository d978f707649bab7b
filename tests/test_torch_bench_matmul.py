"""The port's matmul-shape probes against scripts/bench_matmul_shapes.py
(interpret-mode `pallas_call`) on the CPU, at shapes that are not
multiples of the card's tiles: bit-exact (exact f32 products summed in
f32, rounded once; at K <= 80 both orders round alike); the library line
1e-2 of max|ref| against XLA's dot.
"""
import functools
import importlib.util
import math
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vggt_slam_tpu_torch.scripts import bench_matmul_shapes as MM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location(
        "_reference_bench_matmul_shapes",
        os.path.join(REPO, "scripts", "bench_matmul_shapes.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(
        BlockSpec=pl.BlockSpec,
        pallas_call=functools.partial(pl.pallas_call, interpret=True))
    return mod


def _inputs(B, M, K, N, seed=0):
    """bf16 a (B, M, K) and b (B, K, N) from a seeded numpy normal."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 .to(torch.bfloat16) for s in ((B, M, K), (B, K, N)))


def _jax(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# (B, M, K, N): partial tiles in M and N at both tilings, K under one K
# step; a PV-like case (K < N); B = 1; K = 80 spanning two K steps.
SHAPES = [(4, 40, 64, 24), (2, 24, 48, 64), (1, 72, 80, 40), (3, 136, 16, 8)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_batched_mm_matches_reference(ref, shape):
    a, b = _inputs(*shape)
    want = ref.pallas_batched_mm(*shape)(_jax(a), _jax(b))
    np.testing.assert_array_equal(_f32(MM.batched_mm_ref(a, b)), _f32(want))
    before = dict(MM.LAUNCHES)
    for tile in MM.TILINGS:
        np.testing.assert_array_equal(_f32(MM.batched_mm(a, b, tile)),
                                      _f32(want))
    assert MM.LAUNCHES == before


@pytest.mark.parametrize("B,G", [(4, 2), (4, 4), (8, 4)])
def test_grouped_mm_matches_reference(ref, B, G):
    M, K, N = 40, 64, 24
    a, b = _inputs(B, M, K, N, seed=1)
    want = ref.pallas_grouped_mm(B, G, M, K, N)(_jax(a), _jax(b))
    for tile in MM.TILINGS:
        np.testing.assert_array_equal(_f32(MM.grouped_mm(a, b, G, tile)),
                                      _f32(want))


def test_plain_version_chunks_without_changing_the_result():
    a, b = _inputs(5, 24, 32, 16, seed=2)
    np.testing.assert_array_equal(_f32(MM.batched_mm_ref(a, b, chunk=2)),
                                  _f32(MM.batched_mm_ref(a, b)))


@pytest.mark.parametrize("B", [1, 3])
def test_library_line_matches_xla_batched_dot(ref, B):
    a, b = _inputs(B, 40, 64, 24, seed=3)
    want = _f32(ref.xla_batched_mm(_jax(a), _jax(b)))
    got = _f32(MM.library_mm(a, b))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-2 * np.abs(want).max())


def _refused(a, b, G=1, tile=MM.DEFAULT_TILING):
    return lambda: (MM.batched_mm(a, b, tile) if G == 1 else
                    MM.grouped_mm(a, b, G, tile))


@pytest.mark.parametrize("case", [
    "dtype", "non_contiguous", "misaligned", "g_not_dividing_b", "k_not_8",
    "n_not_8", "tiling", "shapes", "device", "out_shape", "out_dtype"])
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    """Refused on CPU tensors too, before the plain version is chosen."""
    a, b = _inputs(4, 40, 64, 24)
    call, err = {
        "dtype": (_refused(a.float(), b), TypeError),
        "non_contiguous": (_refused(a.transpose(1, 2).contiguous()
                                    .transpose(1, 2), b), ValueError),
        "misaligned": (_refused(torch.empty(a.numel() + 8, dtype=a.dtype)
                                [4:4 + a.numel()].view_as(a), b),
                       ValueError),
        "g_not_dividing_b": (_refused(a, b, G=3), ValueError),
        "k_not_8": (_refused(*_inputs(2, 16, 12, 24)), ValueError),
        "n_not_8": (_refused(*_inputs(2, 16, 16, 20)), ValueError),
        "tiling": (_refused(a, b, tile=(128, 64)), ValueError),
        "shapes": (_refused(a, b[:2]), ValueError),
        "device": (_refused(a.to("meta"), b.to("meta")), ValueError),
        "out_shape": (lambda: MM.run_variant(
            "batched_mm", a, b, 1, MM.DEFAULT_TILING,
            torch.empty(4, 40, 8, dtype=torch.bfloat16)), ValueError),
        "out_dtype": (lambda: MM.run_variant(
            "batched_mm", a, b, 1, MM.DEFAULT_TILING,
            torch.empty(4, 40, 24)), TypeError),
    }[case]
    with pytest.raises(err):
        call()


def test_bounds_at_the_reference_shapes():
    """B = 528 QKᵀ and PV: 1.32 GB at 3.35 TB/s, 0.394 ms, against 75.4
    GFLOP's 0.076 ms; (2048)³: 17.4 µs of operations; (4096, 64, 4096):
    34.6 MB, 10.3 µs; (1056, 64, 1056): 0.75 µs of bytes."""
    for shape in ((528, 1056, 64, 1056), (528, 1056, 1056, 64)):
        ms, by = MM.bound_ms(*shape)
        assert by == "bytes"
        assert MM.problem_bytes(*shape) == pytest.approx(1.3203e9, rel=1e-4)
        assert ms == pytest.approx(0.394, abs=5e-4)
        assert 2 * math.prod(shape) / 989e12 * 1e3 == pytest.approx(
            0.0762, abs=1e-4)
    ms, by = MM.bound_ms(1, 2048, 2048, 2048)
    assert by == "operations" and ms * 1e3 == pytest.approx(17.37, abs=0.01)
    ms, by = MM.bound_ms(1, 4096, 64, 4096)
    assert by == "bytes" and ms * 1e3 == pytest.approx(10.33, abs=0.01)
    assert MM.problem_bytes(1, 4096, 64, 4096) == pytest.approx(34.6e6,
                                                                rel=1e-3)
    ms, by = MM.bound_ms(1, 1056, 64, 1056)
    assert by == "bytes" and ms * 1e3 == pytest.approx(0.746, abs=1e-3)


def test_tolerance_is_one_ulp_of_the_largest_output():
    ref = torch.tensor([[[3.0, -5.5]]], dtype=torch.bfloat16)
    err, tol = MM.mm_error(ref, ref)
    assert err == 0.0 and tol == 2.0 ** (2 - 7)
    out = ref.clone()
    out[0, 0, 1] = -5.5 - tol
    assert MM.mm_error(out, ref) == (tol, tol)


# ragged at the tiles: M 136 and 200 leave 8 and 72 rows past 128, so the
# `edge` control's NaN band starts at row 128, where the last row tile
# begins; N 264 leaves 8 columns past 256
@pytest.mark.parametrize("shape", [(4, 72, 64, 24), (3, 72, 80, 16),
                                   (2, 136, 64, 24), (3, 200, 80, 264)],
                         ids=["qk_like", "pv_like", "qk_ragged_128",
                              "ragged_128x256"])
def test_check_and_controls_on_cpu_tensors(shape, capsys):
    """`check` and its three controls on CPU tensors (no launch)."""
    a, b = _inputs(*shape, seed=4)
    before = dict(MM.LAUNCHES)
    names = MM.variants(shape[0])
    assert [n for n, *_ in names] == ["batched 128x128", "batched 128x256"]
    errors, ctrl = MM.check(a, b, MM.batched_mm_ref(a, b), names, True)
    assert all(e["max_abs_err"] == 0.0 for e in errors.values())
    assert set(ctrl) == {"batch", "edge", "k_tile", "tol"}
    assert ctrl["batch"] > ctrl["tol"] and ctrl["k_tile"] > ctrl["tol"]
    assert math.isnan(ctrl["edge"])
    assert capsys.readouterr().out.count("  check ") == 2
    assert MM.LAUNCHES == before


def test_controls_raise_when_the_check_would_pass_one():
    """Two equal problems make a batch control the check passes."""
    a, b = _inputs(2, 72, 64, 24, seed=5)
    a[1], b[1] = a[0], b[0]
    ref = MM.batched_mm_ref(a, b)
    with pytest.raises(AssertionError, match="passes a control"):
        MM.controls(a, b, ref, ref)


def test_run_variant_writes_into_the_given_output():
    a, b = _inputs(3, 40, 64, 24, seed=6)
    out = torch.full((3, 40, 24), math.nan, dtype=torch.bfloat16)
    assert MM.run_variant("grouped_mm", a, b, 3, (128, 128), out) is out
    np.testing.assert_array_equal(_f32(out), _f32(MM.batched_mm_ref(a, b)))


def test_a_nan_in_a_later_chunk_fails_the_check():
    """An element a kernel never wrote stays NaN in check's output, in any
    chunk of the error's reduction, and `not err <= tol` rejects it."""
    ref = torch.ones(130, 2, 8, dtype=torch.bfloat16)
    out = ref.clone()
    out[-1, 1, 7] = math.nan
    err, tol = MM.mm_error(out, ref)
    assert math.isnan(err) and not err <= tol
    assert math.isnan(MM.max_abs_diff(ref, out))


def test_timed_copies_span_twice_the_l2():
    """B = 1 lines cycle through copies past the 50 MB L2; B = 528 needs
    one."""
    assert [MM.copies(*s) for s in ((1, 1056, 64, 1056), (1, 2048, 2048, 2048),
                                    (1, 4096, 64, 4096), (528, 1056, 64, 1056),
                                    (528, 1056, 1056, 64))] == [40, 4, 3, 1, 1]


def test_variants_follow_the_reference_sections():
    secs = MM.sections()
    assert [s[2] for s in secs[:9]] == MM.SINGLE_SHAPES
    assert all(s[1] == 1 for s in secs[:9])
    assert secs[9][1:] == (528, (1056, 64, 1056))
    assert secs[10][1:] == (528, (1056, 1056, 64))
    names = [n for n, *_ in MM.variants(528)]
    assert len(names) == 2 + 2 * len(MM.GROUPS)
    assert "grouped G=16 128x128" in names


@pytest.mark.parametrize("B", [MM.BATCH, 1])
def test_variants_list_every_tiling(B):
    """Every built tiling has its batched line at both batch sizes, and at
    B = 528 its grouped line at every G; names are unique."""
    lines = MM.variants(B)
    assert len({n for n, *_ in lines}) == len(lines)
    for tile in MM.TILINGS:
        assert (f"batched {MM.tile_name(tile)}", "batched_mm", 1,
                tile) in lines
        for G in MM.GROUPS:
            grouped = (f"grouped G={G} {MM.tile_name(tile)}", "grouped_mm",
                       G, tile)
            assert (grouped in lines) == (B == MM.BATCH)
    assert MM.TILINGS == ((128, 128), (128, 256))
    assert MM.DEFAULT_TILING in MM.TILINGS


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MM.main(["--check"])


# ptxas's -v report of the two mm_sm90 instances, as nvcc prints it.
_PTXAS = "\n".join(
    f"ptxas info    : Compiling entry function "
    f"'_ZN12_GLOBAL__N_17mm_sm90ILi{bn}EEEvNS_8MmParamsE' for 'sm_90a'\n"
    f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
    f"ptxas info    : Used {regs} registers, 384 bytes cmem[0]"
    for bn, regs in ((128, 90), (256, 154)))


def test_ptxas_report_survives_a_cached_build(tmp_path, monkeypatch):
    """Phase G's register lookup finds mm_sm90<128> and <256> whether the
    library was just built or was already up to date: the report is kept
    beside the library and read back on a cache hit."""
    import chip_smoke
    from vggt_slam_tpu_torch.ops import cuda_build

    nvcc = tmp_path / "nvcc"
    (tmp_path / "report.txt").write_text(_PTXAS + "\n")
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = -o ] && '
                    'out="$2"; shift; done\n: > "$out"\n'
                    f'cat "{tmp_path / "report.txt"}" >&2\n')
    nvcc.chmod(0o755)
    src = tmp_path / "csrc" / "probe.cu"
    src.parent.mkdir()
    src.write_text("// a probe\n")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: str(nvcc))
    for run in ("built", "cached"):
        monkeypatch.setattr(cuda_build, "build_log", {})
        monkeypatch.setattr(cuda_build, "build_seconds", {})
        lib = cuda_build.build("probe", str(src))
        assert os.path.exists(lib)
        assert (cuda_build.build_seconds["probe"] == 0.0) == (run == "cached")
        report = chip_smoke.ptxas_report(cuda_build.build_log)
        assert chip_smoke.mm_ptxas(report, 128) == (90, 0), run
        assert chip_smoke.mm_ptxas(report, 256) == (154, 0), run
        assert chip_smoke.mm_ptxas(report, 64) == (None, None), run
        if run == "built":      # a cache hit must not call nvcc
            monkeypatch.setattr(cuda_build, "nvcc_path", _no_nvcc)


def _no_nvcc():
    raise AssertionError("nvcc called on an up-to-date library")


@pytest.mark.parametrize("carries_script", [True, False])
def test_ab_leg_takes_each_builds_tilings(tmp_path, carries_script):
    """The A/B leg reads a folder's tilings from the port script beside its
    .cu (this tree's where there is none) and refuses, before any launch,
    a tiling that build does not take."""
    import chip_smoke

    parent = ((64, 64), (128, 128))
    if carries_script:
        (tmp_path / "bench_matmul_shapes.py").write_text(
            f"import math\n\nTILINGS = {parent!r}   # (block_m, block_n)\n"
            f"DEFAULT_TILING = (64, 64)\n")
    tilings = chip_smoke.ab_mm_tilings(str(tmp_path))
    assert tilings == (parent if carries_script else MM.TILINGS)
    a, b = _inputs(2, 40, 64, 24)
    out = torch.empty(2, 40, 24, dtype=torch.bfloat16)
    refused = next(t for t in ((64, 64), (128, 256)) if t not in tilings)
    with pytest.raises(ValueError, match="not built"):
        chip_smoke.ab_mm_call(None, tilings)("batched_mm", a, b, 1, refused,
                                             out)
