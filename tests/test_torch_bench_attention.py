"""The port's frame-attention probes against the reference script's Pallas
kernels in interpret mode on the CPU, on the same seeded bf16 inputs at BH
4, N 100 (padded to 128), D 64: softmax-only bit-exact; matmul-only 1e-2
of max|ref|; grouped, interleaved, pipelined 2e-3 abs, G = 8 at S 2; the
plain version at the kernels' key tiles (`block_k` 16 to 128)
`tiled_tolerance`: 2e-3, or one bf16 step of the reference where larger.
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

from vggt_slam_tpu_torch.scripts import bench_attention as BA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, H, N, D = 1, 4, 100, 64
BH, NP = S * H, 128


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location(
        "_reference_bench_attention",
        os.path.join(REPO, "scripts", "bench_attention.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(
        BlockSpec=pl.BlockSpec,
        pallas_call=functools.partial(pl.pallas_call, interpret=True))
    return mod


@pytest.fixture(scope="module")
def inputs():
    """Seeded (S, H, N, D) bf16 q, k, v: torch tensors and jax arrays of the
    same values."""
    rng = np.random.default_rng(0)
    ts = [torch.from_numpy(rng.normal(size=(S, H, N, D)).astype(np.float32))
          .bfloat16() for _ in range(3)]
    return ts, [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in ts]


@pytest.fixture(scope="module")
def inputs8():
    """As `inputs` at S 2, H 4: BH 8, so G = 8 divides it."""
    rng = np.random.default_rng(0)
    ts = [torch.from_numpy(rng.normal(size=(2, H, N, D)).astype(np.float32))
          .bfloat16() for _ in range(3)]
    return ts, [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in ts]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ref_scaled(q):
    """The reference's `scaled` pre-scale (a closure inside its main)."""
    c_scale = math.log2(math.e) / math.sqrt(D)
    return (q.astype(jnp.float32) * c_scale).astype(q.dtype)


def test_matmul_only_matches_reference(ref, inputs):
    ts, js = inputs
    want = _f32(ref.make_flat_call(ref._matmul_only_kernel, N, D, BH)(*js))
    got = _f32(BA.make_flat_call(BA.matmul_only, N, D, BH)(*ts))
    assert got.shape == want.shape == (S, H, N, D)
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def test_softmax_only_is_exactly_one_over_np(ref, inputs):
    ts, js = inputs
    want = _f32(ref.make_flat_call(ref._softmax_only_kernel, N, D, BH)(*js))
    got = _f32(BA.make_flat_call(BA.softmax_only, N, D, BH)(*ts))
    np.testing.assert_array_equal(got, want)
    one_over_np = torch.tensor(1.0 / NP).bfloat16().float().item()
    assert (got == one_over_np).all()


def _calls(ref, schedule, G, bh):
    """The reference's call and the port's of `schedule` at G on bh
    problems."""
    if schedule == "pipelined":
        return (ref.make_grouped_call(ref._pipelined_kernel, G, N, D, bh,
                                      extra=(("G", G),)),
                BA.make_grouped_call(BA.pipelined_attention, G, N, D, bh))
    il = schedule == "interleaved"
    return (ref.make_grouped_call(ref._grouped_kernel, G, N, D, bh,
                                  extra=(("G", G), ("interleave", il))),
            BA.make_grouped_call(BA.grouped_attention, G, N, D, bh,
                                 extra=(("interleave", il),)))


@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("schedule", ["straight", "interleaved", "pipelined"])
def test_attention_probes_match_reference(ref, inputs, schedule, G):
    ts, js = inputs
    ref_call, port = _calls(ref, schedule, G, BH)
    want = _f32(ref_call(_ref_scaled(js[0]), js[1], js[2]))
    got = _f32(BA.scaled(port, D)(*ts))
    assert got.shape == (S, H, N, D)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


@pytest.mark.parametrize("schedule", ["straight", "interleaved", "pipelined"])
def test_attention_probes_match_reference_at_g8(ref, inputs8, schedule):
    ts, js = inputs8
    ref_call, port = _calls(ref, schedule, 8, 2 * H)
    want = _f32(ref_call(_ref_scaled(js[0]), js[1], js[2]))
    got = _f32(BA.scaled(port, D)(*ts))
    assert got.shape == (2, H, N, D)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


@pytest.mark.parametrize("G", [2, 4, 8])
@pytest.mark.parametrize("schedule", ["straight", "interleaved", "pipelined"])
def test_tiled_plain_version_matches_reference(ref, inputs8, schedule, G):
    """The plain version at every key tile the kernels take (running max
    per tile) against the reference's kernel (row max over all keys)."""
    ts, js = inputs8
    ref_call, port = _calls(ref, schedule, G, 2 * H)
    want = torch.tensor(_f32(ref_call(_ref_scaled(js[0]), js[1], js[2])))
    call = BA.scaled(port, D)
    args = call.prep(*ts)
    tol = BA.tiled_tolerance(want)
    for bk in (16, 32, 64, 128):
        got = call.unprep(BA.exp2_attention_ref(*args, block_k=bk),
                          ts[0].shape).float()
        assert ((got - want).abs() <= tol).all(), bk


def test_tiled_plain_version_at_one_tile_is_untiled(inputs8):
    ts, _ = inputs8
    args = BA.scaled(BA.make_grouped_call(BA.grouped_attention, 8, N, D,
                                          2 * H), D).prep(*ts)
    torch.testing.assert_close(BA.exp2_attention_ref(*args, block_k=NP),
                               BA.exp2_attention_ref(*args), rtol=0, atol=0)


@pytest.mark.parametrize("n", [100, 1041])
def test_tiled_control_fails_the_tiled_tolerance(n):
    """The card's tiled check tells a kernel that drops the padded keys from
    l: the tiled plain version with l over the first n keys is further from
    the real one than `tiled_tolerance`, at every key tile."""
    q, k, v = BA.make_inputs(1, 2, n, D, seed=1)
    args = BA.scaled(BA.make_grouped_call(BA.grouped_attention, 2, n, D, 2),
                     D).prep(q, k, v)
    for bk in (16, 32, 64, 128):
        real = BA.exp2_attention_ref(*args, block_k=bk)
        dropped = BA.exp2_attention_ref(*args, l_keys=n, block_k=bk)
        share = ((dropped.float() - real.float()).abs()
                 / BA.tiled_tolerance(real)).max()
        assert share > 2, bk


def test_prescale_and_padding_match_reference(inputs):
    """`scaled` rounds q·log2(e)/sqrt(D) as the reference does, and the
    grouped call pads with zero rows to Np and groups problems in order."""
    ts, js = inputs
    G = 2
    args = BA.scaled(BA.make_grouped_call(BA.grouped_attention, G, N, D, BH),
                     D).prep(*ts)
    assert BA.roundup(N, 128) == NP and BA.roundup(1041, 128) == 1152
    for i, (a, j) in enumerate(zip(args, js)):
        assert a.shape == (BH // G, G, NP, D) and a.is_contiguous()
        j = _ref_scaled(j) if i == 0 else j
        want = jnp.pad(j.reshape(BH, N, D), ((0, 0), (0, NP - N), (0, 0)))
        np.testing.assert_array_equal(_f32(a).reshape(BH, NP, D), _f32(want))


def test_slicing_back_and_wrappers_on_cpu(inputs):
    """Outputs are sliced back to (S, H, N, D); on CPU tensors the wrappers
    are their plain versions and launch nothing; another device raises."""
    ts, _ = inputs
    call = BA.make_flat_call(BA.matmul_only, N, D, BH)
    args = call.prep(*ts)
    assert args[0].shape == (BH, NP, D)
    assert (args[1][:, N:] == 0).all()
    before = dict(BA.LAUNCHES)
    out = call.run(*args)
    torch.testing.assert_close(out, BA.matmul_only_ref(*args), rtol=0,
                               atol=0)
    torch.testing.assert_close(call.unprep(out, ts[0].shape),
                               out[:, :N].reshape(S, H, N, D))
    assert BA.LAUNCHES == before
    meta = torch.empty(BH, NP, D, dtype=torch.bfloat16, device="meta")
    for fn in (BA.matmul_only, BA.softmax_only):
        with pytest.raises(ValueError, match="no probe kernel"):
            fn(meta, meta, meta)
    grouped = meta.view(BH // 2, 2, NP, D)
    for fn in (BA.grouped_attention, BA.pipelined_attention):
        with pytest.raises(ValueError, match="no probe kernel"):
            fn(grouped, grouped, grouped)


@pytest.mark.parametrize("n", [100, 1041])
def test_dropping_padded_keys_from_l_fails_the_tolerance(n):
    """The card check's control: l without the padded keys lies further than
    1e-2 of max|ref| from the real function, at the small shape and the frame
    shape's padding."""
    q, k, v = BA.make_inputs(1, 2, n, D, seed=1)
    call = BA.scaled(BA.make_grouped_call(BA.grouped_attention, 2, n, D, 2),
                     D)
    args = call.prep(q, k, v)
    real = BA.exp2_attention_ref(*args)
    dropped = BA.exp2_attention_ref(*args, l_keys=n)
    err, tol = BA.probe_error("attention", dropped, real)
    assert err > 2 * tol


def test_sdpa_at_ln2_computes_the_exp2_function(inputs):
    ts, _ = inputs
    call = BA.scaled(BA.make_grouped_call(BA.sdpa, H, N, D, BH), D)
    args = call.prep(*(t.float() for t in ts))
    err, tol = BA.probe_error("library", call.run(*args),
                              BA.exp2_attention_ref(*args))
    assert err <= 1e-3 * tol


def test_check_on_cpu_and_main_needs_a_card(monkeypatch, capsys):
    """`check` holds every variant's call against its plain version and the
    attention calls against naive attention, here on CPU tensors (the
    wrappers' plain versions, no launch); `main` times on the card only."""
    before = dict(BA.LAUNCHES)
    variants = BA.make_variants(1, 4, 1000, D)
    errors = BA.check(variants, *BA.make_inputs(1, 4, 1000, D))
    assert list(errors) == list(variants)
    assert len(errors) == 10               # 3 + 3 schedules x G 2, 4 + SDPA
    assert capsys.readouterr().out.count("against naive attention") == 8
    assert all(err <= tol for err, tol in errors.values())
    assert BA.LAUNCHES == before
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BA.main([])


def test_bounds_at_the_frame_shape():
    """The bound arithmetic at BH = 288, Np = 1152, D = 64 with a 4e12/s
    exp2 rate: matmul-only 97.8 GFLOP at 989 TFLOP/s; softmax-only 382 M
    exp2; attention the larger; all above their bytes."""
    mm, by = BA.bound_ms("matmul", 288, 1152, 64, 4e12)
    assert by == "operations" and mm == pytest.approx(
        4 * 288 * 1152 ** 2 * 64 / 989e12 * 1e3)
    sm, by = BA.bound_ms("softmax", 288, 1152, 64, 4e12)
    assert by == "operations" and sm == pytest.approx(
        288 * 1152 ** 2 / 4e12 * 1e3)
    att, _ = BA.bound_ms("attention", 288, 1152, 64, 4e12)
    assert att == max(mm, sm)
    _, by = BA.bound_ms("matmul", 288, 128, 64, 4e12)
    assert by == "bytes"


# chip_smoke.py --ab: the frame probes' leg

def test_ab_probe_leg_builds_each_folders_matmul_only(tmp_path, monkeypatch):
    """The leg builds each folder's bench_attention.cu (named after the
    folder) with the entries every build has, bench_matmul_only among
    them, and without the ones an older build lacks; then this tree's."""
    import chip_smoke
    from vggt_slam_tpu_torch.ops import cuda_build

    folder = tmp_path / "parent"
    folder.mkdir()
    (folder / "bench_attention.cu").write_text("// a build\n")
    loaded = []

    def load(name, sigs, src=None):
        loaded.append((name, src, set(sigs)))
        return name
    monkeypatch.setattr(cuda_build, "load", load)
    monkeypatch.setattr(BA, "kernel_library", lambda: "this BA")
    libs = chip_smoke.ab_probe_libs([str(folder), str(tmp_path / "none")])
    assert libs == {"parent": "bench_attention_ab_parent",
                    "this_tree": "this BA"}
    (name, src, sigs), = loaded
    assert src == str(folder / "bench_attention.cu")
    assert {"bench_matmul_only", "bench_grouped", "bench_pipelined"} <= sigs
    assert not sigs & {"bench_grouped_block_k",
                       "bench_attention_design_launches"}


def test_ab_probe_leg_without_nvcc_raises_before_any_launch(tmp_path,
                                                            monkeypatch):
    """Without a CUDA toolkit the leg's first build raises nvcc's error
    before it writes or times anything."""
    import chip_smoke
    from vggt_slam_tpu_torch.ops import cuda_build

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "first use and need the CUDA toolkit")
    monkeypatch.setattr(cuda_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "_loaded", {})
    (tmp_path / "bench_attention.cu").write_text("// a build\n")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        chip_smoke.ab_probes(torch.device("cpu"), [str(tmp_path)])
    assert not (tmp_path / "build").exists()
