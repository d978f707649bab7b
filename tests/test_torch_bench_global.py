"""The port's global-shape probes against the reference scripts' Pallas
kernels in interpret mode on the CPU, same seeded bf16 inputs at BH 2, N
256, D 64: quantizations and scales bit-exact; every softmax mode 2e-3
abs (bf16 p against the same running max); matmul 1e-2 of max|ref|.
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
from jax.experimental.pallas import tpu as pltpu

from vggt_slam_tpu_torch.scripts import bench_attention as BA
from vggt_slam_tpu_torch.scripts import bench_global_attention as GA
from vggt_slam_tpu_torch.scripts import bench_int8_inkernel as IK
from vggt_slam_tpu_torch.scripts import bench_softmax_variants as SV

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BH, N, D = 2, 256, 64
SCRIPTS = ("bench_global_attention", "bench_softmax_variants",
           "bench_int8_inkernel")


def _load(name, interpret=True):
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(
        BlockSpec=pl.BlockSpec, when=pl.when, program_id=pl.program_id,
        ds=pl.ds,
        pallas_call=functools.partial(pl.pallas_call, interpret=interpret))
    return mod


@pytest.fixture(scope="module")
def ref():
    return {name: _load(name) for name in SCRIPTS}


def _jax(t):
    """A torch tensor as a jax array of the same values and dtype."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(scale=1.0):
    return GA.make_inputs(BH, N, D, seed=0, scale=scale)


def _close(got, want, mode):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape and got.shape[-1] == D
    tol = 1e-2 * np.abs(want).max() if mode == "matmul" else 2e-3
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


# bench_global_attention

# Every tiling of the port's TILINGS, the first two as before.
@pytest.mark.parametrize("tiling", [(64, 64), (128, 128)] + [
    t for t in GA.TILINGS if t not in ((64, 64), (128, 128))])
@pytest.mark.parametrize("mode", GA.MODES)
def test_global_attention_matches_reference(ref, mode, tiling):
    q, k, v = _inputs()
    scale = 1.0 / math.sqrt(D)
    if mode == "int8":
        q, k, scale = GA.int8_operands(q, k, scale)
    want = ref["bench_global_attention"].run_kernel(
        _jax(q), _jax(k), _jax(v), *tiling, mode, scale)
    _close(GA.run_kernel(q, k, v, *tiling, mode, scale), want, mode)


def test_global_attention_slab_attends_the_first_nq_keys(ref):
    """The reference's grid takes its key count from q: 64 q rows against
    256 keys attend to the first 64 keys only. The port's run_kernel
    computes the same function, and n_keys widens it to all keys."""
    q, k, v = _inputs()
    q64 = q[:, :64].contiguous()
    scale = 1.0 / math.sqrt(D)
    R = ref["bench_global_attention"]
    full = R.run_kernel(_jax(q64), _jax(k), _jax(v), 64, 64, "bf16", scale)
    first = R.run_kernel(_jax(q64), _jax(k[:, :64]), _jax(v[:, :64]), 64,
                         64, "bf16", scale)
    np.testing.assert_array_equal(_f32(full), _f32(first))
    got = GA.run_kernel(q64, k, v, 64, 64, "bf16", scale)
    np.testing.assert_array_equal(
        _f32(got), _f32(GA.run_kernel(q64, k[:, :64], v[:, :64], 64, 64,
                                      "bf16", scale)))
    _close(got, full, "bf16")
    wide = GA.run_kernel(q64, k, v, 64, 64, "bf16", scale, n_keys=N)
    assert np.abs(_f32(wide) - _f32(got)).max() > 1e-2


def test_global_attention_int8_operands_match_reference():
    """Script 1's quantization (:178-184) in numpy, as the reference writes
    it, against the port's: int8 values and int8_scale bit-exact."""
    q, k, _ = _inputs()
    scale = 1.0 / math.sqrt(D)
    qn, kn = q.float().numpy(), k.float().numpy()
    qa, ka = np.abs(qn).max(), np.abs(kn).max()
    q8 = np.clip(np.rint(qn / qa * 127), -127, 127).astype(np.int8)
    k8 = np.clip(np.rint(kn / ka * 127), -127, 127).astype(np.int8)
    want_scale = float(qa * ka / (127 * 127) * scale)
    got_q8, got_k8, got_scale = GA.int8_operands(q, k, scale)
    np.testing.assert_array_equal(got_q8.numpy(), q8)
    np.testing.assert_array_equal(got_k8.numpy(), k8)
    assert got_scale == want_scale


# bench_softmax_variants

def _reference_staticint8(q, k):
    """Script 2's quantization (:193-198), in jnp as the reference writes
    it."""
    q, k = _jax(q), _jax(k)
    qs = float(jnp.max(jnp.abs(q.astype(jnp.float32))))
    ks = float(jnp.max(jnp.abs(k.astype(jnp.float32))))
    qi = jnp.clip(jnp.round(q.astype(jnp.float32) * (127.0 / qs)),
                  -127, 127).astype(jnp.int8)
    ki = jnp.clip(jnp.round(k.astype(jnp.float32) * (127.0 / ks)),
                  -127, 127).astype(jnp.int8)
    return qi, ki, (12.0, (qs / 127.0) * (ks / 127.0))


@pytest.mark.parametrize("mode", SV.MODES)
def test_softmax_variants_match_reference(ref, mode):
    """staticint8: the reference's `_init` zeroes l for online and static only,
    so with interpret mode's NaN-filled scratch its output is NaN, and with
    zeroed scratch l carries from one q block to the next. The port resets l
    per q tile: it is held to the reference's first q block, and the later
    blocks are shown off by their carried l."""
    q, k, v = _inputs(scale=0.3)
    smax = 12.0
    R = ref["bench_softmax_variants"]
    if mode == "staticint8":
        q, k, smax = SV.int8_operands(q, k)
        R = _load("bench_softmax_variants", pltpu.InterpretParams(
            uninitialized_memory="zero"))
    want = R.run_kernel(_jax(q), _jax(k), _jax(v), 64, 128, mode, smax)
    got = SV.run_kernel(q, k, v, 64, 128, mode, smax)
    if mode == "staticint8":
        _close(got[:1, :64], want[:1, :64], mode)
        ratio = _f32(got[:, 64:]) / _f32(want[:, 64:])
        assert np.median(ratio) > 1.5       # l grown by the earlier blocks
    else:
        _close(got, want, mode)


@pytest.mark.parametrize("tiling", [t for t in SV.TILINGS if t != (64, 128)])
@pytest.mark.parametrize("mode", SV.MODES)
def test_softmax_variants_match_reference_at_other_tilings(ref, mode,
                                                            tiling):
    """As test_softmax_variants_match_reference, at the port's other two
    tilings; staticint8 held to the reference's first q block (zeroed
    scratch), its later blocks shown off by their carried l."""
    q, k, v = _inputs(scale=0.3)
    smax = 12.0
    R = ref["bench_softmax_variants"]
    if mode == "staticint8":
        q, k, smax = SV.int8_operands(q, k)
        R = _load("bench_softmax_variants", pltpu.InterpretParams(
            uninitialized_memory="zero"))
    want = R.run_kernel(_jax(q), _jax(k), _jax(v), *tiling, mode, smax)
    got = SV.run_kernel(q, k, v, *tiling, mode, smax)
    if mode == "staticint8":
        bq = tiling[0]
        _close(got[:1, :bq], want[:1, :bq], mode)
        ratio = _f32(got[:, bq:]) / _f32(want[:, bq:])
        assert np.median(ratio) > 1.5       # l grown by the earlier blocks
    else:
        _close(got, want, mode)


def test_softmax_variants_int8_operands_match_reference():
    q, k, _ = _inputs(scale=0.3)
    qi, ki, smax = _reference_staticint8(q, k)
    q8, k8, got = SV.int8_operands(q, k)
    np.testing.assert_array_equal(q8.numpy(), np.asarray(qi))
    np.testing.assert_array_equal(k8.numpy(), np.asarray(ki))
    assert got == smax


def test_staticfused_sums_the_rounded_weights():
    """staticfused's l is the sum of bf16(p), static's the sum of p: the two
    differ, as the reference's |staticfused - online| line measures."""
    q, k, v = _inputs(scale=0.3)
    st = SV.run_kernel_ref(q, k, v, 64, 64, "static")
    sf = SV.run_kernel_ref(q, k, v, 64, 64, "staticfused")
    on = SV.run_kernel_ref(q, k, v, 64, 64, "online")
    assert 0 < np.abs(_f32(sf) - _f32(st)).max() < 2e-3
    assert np.abs(_f32(st) - _f32(on)).max() < 2e-3


# bench_int8_inkernel

@pytest.mark.parametrize("mode", IK.MODES)
def test_int8_inkernel_matches_reference(ref, mode):
    q, k, v = _inputs()
    want = ref["bench_int8_inkernel"].run(_jax(q), _jax(k), _jax(v), 64, 64,
                                          mode)
    _close(IK.run(q, k, v, 64, 64, mode), want, mode)


@pytest.mark.parametrize("tiling", [t for t in IK.TILINGS
                                    if t != IK.DEFAULT_TILING])
@pytest.mark.parametrize("mode", IK.MODES)
def test_int8_inkernel_matches_reference_at_other_tilings(ref, mode, tiling):
    q, k, v = _inputs()
    want = ref["bench_int8_inkernel"].run(_jax(q), _jax(k), _jax(v), *tiling,
                                          mode)
    _close(IK.run(q, k, v, *tiling, mode), want, mode)


@pytest.mark.parametrize("mode", ["bf16", "qk8"])
def test_int8_inkernel_scales_and_quantization_match_reference(ref, mode):
    """The (5, BH) scales in the reference's jnp order (:105-114) and its
    `_quant`, against the port's: bit-exact."""
    q, k, v = _inputs()
    qj, kj, vj = _jax(q), _jax(k), _jax(v)
    c = math.log2(math.e) / math.sqrt(D)
    qa, ka, va = (jnp.max(jnp.abs(t.astype(jnp.float32)), axis=(1, 2))
                  for t in (qj, kj, vj))
    dq = jnp.full((BH,), c, jnp.float32) if mode == "bf16" else \
        qa * ka / (127.0 * 127.0) * c
    want = jnp.stack([127.0 / qa, 127.0 / ka, 127.0 / va, dq,
                      va / (127.0 * 127.0)])
    sc = IK.scales(q, k, v, mode)
    np.testing.assert_array_equal(sc.numpy(), np.asarray(want))
    R = ref["bench_int8_inkernel"]
    for i, (t, tj) in enumerate(((q, qj), (k, kj), (v, vj))):
        got = IK.quant(t, sc[i]).to(torch.int8).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(_jax_quant_rows(R, tj, want[i])))


def _jax_quant_rows(R, x, inv):
    """The reference's `_quant` applied per (b, h) row block."""
    return jnp.stack([R._quant(x[b].astype(jnp.float32), inv[b])
                      for b in range(x.shape[0])])


def test_f32_attention_is_softmax_attention():
    q, k, v = (t.float() for t in _inputs())
    want = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(D), -1) @ v
    torch.testing.assert_close(IK.f32_attention(q, k, v, heads_per_chunk=1),
                               want)


# The scripts: check on CPU tensors, no main without a card, bounds, SDPA

def _check_on_cpu(name):
    if name == "bench_global_attention":
        q, k, v = _inputs()
        s = 1.0 / math.sqrt(D)
        q8, k8, s8 = GA.int8_operands(q, k, s)
        return GA.check({"bf16": (q, k, v, s), "matmul": (q, k, v, s),
                         "int8": (q8, k8, v, s8)}, N), len(GA.TILINGS) * 3
    if name == "bench_softmax_variants":
        q, k, v = _inputs(scale=0.3)
        q8, k8, s8 = SV.int8_operands(q, k)
        ops = {m: (q, k, v, SV.SMAX) for m in SV.MODES}
        ops["staticint8"] = (q8, k8, v, s8)
        return SV.check(ops, (64, 64), N)[0], len(SV.TILINGS) * 5
    return IK.check(*_inputs(), N), len(IK.TILINGS) * 3


@pytest.mark.parametrize("name", SCRIPTS)
def test_check_on_cpu_and_main_needs_a_card(name, monkeypatch, capsys):
    """`check` holds every mode and tiling against its plain version, here
    on CPU tensors (the wrappers' plain versions, no launch), with the int8
    control; `main` runs on the card only."""
    module = {"bench_global_attention": GA, "bench_softmax_variants": SV,
              "bench_int8_inkernel": IK}[name]
    before = dict(module.LAUNCHES)
    errors, n_variants = _check_on_cpu(name)
    assert len(errors) == n_variants
    assert all(e["max_abs_err"] <= e["tol"] for e in errors.values())
    controls = [e for e in errors.values() if "mean_dist_own_plain" in e]
    assert len(controls) == (2 if name == "bench_int8_inkernel" else 1)
    assert all(c["mean_dist_bf16_plain"] > c["mean_dist_own_plain"]
               for c in controls)
    assert capsys.readouterr().out.count("  check ") == n_variants
    assert module.LAUNCHES == before
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])


def test_bounds_at_the_global_shape():
    """BH 16, N 34816, D 64 at 4.19e12 exp2/s: bf16 products 4.97 TFLOP (5.02
    ms) against 4.63 ms of exp; int8 QKᵀ (1.25 + 2.51 ms) and both products in
    int8 (2.51) leave the exp units the floor; matmul-only is the tensor cores
    alone."""
    args = (16, 34816, 34816, 64, 4.19e12)
    ms, by, unit = GA.bound_ms(*args)
    assert (by, unit) == ("operations", "tensor cores")
    assert ms == pytest.approx(4 * 16 * 34816 ** 2 * 64 / 989e12 * 1e3)
    assert ms == pytest.approx(5.02, abs=0.01)
    exp_ms = 16 * 34816 ** 2 / 4.19e12 * 1e3
    for kw in (dict(qk8=True, qk_bytes=1), dict(qk8=True, pv8=True)):
        ms, by, unit = GA.bound_ms(*args, **kw)
        assert (ms, by, unit) == (pytest.approx(exp_ms), "operations",
                                  "exp units")
    ms, _, unit = GA.bound_ms(*args, exp=False)
    assert unit == "tensor cores" and ms == pytest.approx(5.02, abs=0.01)
    ms, by, unit = GA.bound_ms(16, 64, 64, 64, 4.19e12)
    assert (by, unit) == ("bytes", "HBM")


@pytest.mark.parametrize("case", ["natural exp", "exp2"])
def test_sdpa_yardstick_computes_the_plain_function(case):
    """SDPA at scale 1/√D computes the bf16 mode's function (natural exp);
    at scale ln 2, the exp2 of raw logits (online, static). The plain
    versions round p to bf16, SDPA on f32 inputs does not: 1e-2 of max."""
    if case == "natural exp":
        q, k, v = _inputs()
        s = 1.0 / math.sqrt(D)
        want = GA.run_kernel_ref(q, k, v, 64, 64, "bf16", s)
    else:
        q, k, v = _inputs(scale=0.3)
        s = math.log(2.0)
        want = SV.run_kernel_ref(q, k, v, 64, 64, "online")
    got = GA.sdpa(q.float(), k.float(), v.float(), s)
    err, tol = BA.probe_error("attention", got, want)
    assert err <= tol


def test_wrappers_launch_nothing_on_cpu_and_refuse_other_devices():
    q, k, v = _inputs()
    before = (dict(GA.LAUNCHES), dict(SV.LAUNCHES), dict(IK.LAUNCHES))
    GA.run_kernel(q, k, v, 64, 64, "matmul", 0.125)
    SV.run_kernel(q, k, v, 64, 64, "static")
    IK.run(q, k, v, 64, 64, "qk8")
    assert (GA.LAUNCHES, SV.LAUNCHES, IK.LAUNCHES) == before
    meta = torch.empty(BH, N, D, dtype=torch.bfloat16, device="meta")
    sc = torch.empty(5, BH, device="meta")
    for call in (lambda: GA.run_kernel(meta, meta, meta, 64, 64, "bf16", 1.0),
                 lambda: SV.run_kernel(meta, meta, meta, 64, 64, "online"),
                 lambda: IK.attention(sc, meta, meta, meta, 64, 64, "bf16")):
        with pytest.raises(ValueError, match="no probe kernel"):
            call()


# chip_smoke.py --ab: the global probes' leg

@pytest.mark.parametrize("holds", [("bench_global_attention",),
                                   ("bench_int8_inkernel",),
                                   ("bench_global_attention",
                                    "bench_int8_inkernel"), (),
                                   ("bench_softmax_variants",),
                                   ("bench_global_attention",
                                    "bench_softmax_variants",
                                    "bench_int8_inkernel")])
def test_ab_global_leg_builds_what_each_folder_holds(tmp_path, monkeypatch,
                                                     holds):
    """The leg builds, for each script, the .cu of each folder that holds
    one (named after the folder, without the design-count entry an older
    build lacks), then this tree's; a script no folder holds is left out."""
    import chip_smoke
    from vggt_slam_tpu_torch.ops import cuda_build

    folder = tmp_path / "parent"
    folder.mkdir()
    for script in holds:
        (folder / f"{script}.cu").write_text("// a build\n")
    loaded = []

    def load(name, sigs, src=None):
        loaded.append((name, src, set(sigs)))
        return name
    monkeypatch.setattr(cuda_build, "load", load)
    monkeypatch.setattr(GA, "kernel_library", lambda: "this GA")
    monkeypatch.setattr(SV, "kernel_library", lambda: "this SV")
    monkeypatch.setattr(IK, "kernel_library", lambda: "this IK")
    libs = chip_smoke.ab_global_libs([str(folder), str(tmp_path / "none")])
    assert list(libs) == list(holds)
    this = {"bench_global_attention": "this GA",
            "bench_softmax_variants": "this SV",
            "bench_int8_inkernel": "this IK"}
    for script in holds:
        assert libs[script] == {"parent": f"{script}_ab_parent",
                                "this_tree": this[script]}
    assert [(n, src) for n, src, _ in loaded] == [
        (f"{s}_ab_parent", str(folder / f"{s}.cu")) for s in holds]
    for _, _, sigs in loaded:
        assert sigs and not any(n.endswith("_design_launches") for n in sigs)


@pytest.mark.parametrize("script", ["bench_int8_inkernel",
                                    "bench_softmax_variants"])
def test_ab_global_leg_without_nvcc_raises_before_any_launch(tmp_path,
                                                             monkeypatch,
                                                             script):
    """Where there is no CUDA toolkit the leg's first build raises nvcc's
    error before it writes anything: no build is skipped and nothing is
    timed."""
    import chip_smoke
    from vggt_slam_tpu_torch.ops import cuda_build

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "first use and need the CUDA toolkit")
    monkeypatch.setattr(cuda_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "_loaded", {})
    (tmp_path / f"{script}.cu").write_text("// a build\n")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        chip_smoke.ab_global_libs([str(tmp_path)])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        chip_smoke.ab_global(torch.device("cpu"), [str(tmp_path)])
    assert not (tmp_path / "build").exists()
