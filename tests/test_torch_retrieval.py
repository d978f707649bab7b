"""The port's retrieval against the reference's on the same inputs and
weights: Sinkhorn 1e-5, the SALAD descriptor 1e-4 (f32 ViT forwards), the
tiny-image descriptor 1e-6, the converters bit-equal.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggt_slam_tpu.models import retrieval as JR
from vggt_slam_tpu.models.vggt import convert as JC
from vggt_slam_tpu_torch.models import retrieval as TR
from vggt_slam_tpu_torch.models.vggt import convert as TC
from vggt_slam_tpu_torch.slam.loop_closure import ImageRetrieval

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


@pytest.mark.parametrize("K,n,iters", [(8, 50, 3), (64, 256, 3), (8, 8, 2),
                                       (8, 4, 3), (4, 1, 5)])
def test_matching_probs_match_reference(K, n, iters):
    """Including n <= K, where the dustbin's mass clamps to log(1)."""
    rng = np.random.default_rng(K * 1000 + n)
    S = rng.normal(size=(2, K, n)).astype(np.float32) * 2
    ref = jax.jit(jax.vmap(JR.get_matching_probs, (0, None, None)),
                  static_argnums=2)
    want = np.asarray(ref(jnp.asarray(S), jnp.float32(0.7), iters))
    got = TR.get_matching_probs(torch.from_numpy(S), torch.tensor(0.7),
                                iters).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    log_a = np.log(rng.dirichlet(np.ones(K + 1))).astype(np.float32)
    log_b = np.full(n, -np.log(n), np.float32)
    M = rng.normal(size=(K + 1, n)).astype(np.float32)
    want = jax.jit(JR.log_otp_solver, static_argnums=3)(
        jnp.asarray(log_a), jnp.asarray(log_b), jnp.asarray(M), iters)
    got = TR.log_otp_solver(torch.from_numpy(log_a), torch.from_numpy(log_b),
                            torch.from_numpy(M), iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.fixture(scope="module")
def tiny_salad():
    cfg = JR.SALADConfig.tiny()
    jmodel = JR.SALAD(cfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 3, 56, 56), jnp.float32))
    tmodel = TR.SALAD(TR.SALADConfig.tiny())
    tmodel.load_state_dict(TC.load_flax_params(JC._flatten(params)),
                           strict=True)
    return jmodel, params, tmodel.eval()


@pytest.mark.parametrize("hw", [(56, 56), (392, 518)])
def test_salad_tiny_forward_matches_reference(tiny_salad, hw):
    jmodel, params, tmodel = tiny_salad
    x = np.random.default_rng(hw[1]).uniform(
        0, 1, (3, 3) + hw).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 16 + 8 * 16)     # token_dim + K * cluster_dim
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_padding_frames_do_not_reach_real_descriptors(tiny_salad):
    """ImageRetrieval pads a submap to its bucket with zero frames; each
    frame is encoded on its own, so the real frames' descriptors are those
    of the unpadded batch."""
    _, _, tmodel = tiny_salad

    def fn(frames):
        with torch.no_grad():
            return tmodel(torch.from_numpy(frames)).numpy()

    class _Submap:
        def get_all_frames(self):
            return np.random.default_rng(5).uniform(
                0, 1, (3, 3, 56, 70)).astype(np.float32)

    plain = ImageRetrieval(descriptor_fn=fn).get_all_submap_embeddings(
        _Submap())
    padded = ImageRetrieval(descriptor_fn=fn, batch_bucket=6
                            ).get_all_submap_embeddings(_Submap())
    assert padded.shape == plain.shape == (3, 8 * 16 + 16)
    np.testing.assert_allclose(padded, plain, atol=1e-6)


def _dino_salad_state_dict(cfg, params, seed=3):
    """A dino_salad-layout state dict (DINOv2 pos_embed with a CLS slot,
    1x1-conv aggregator, (out, in) linears), as
    tests/test_images_retrieval.py builds it."""
    rng = np.random.default_rng(seed)
    g = cfg.input_size // cfg.patch_size
    sd = {}
    for path, arr in JC._flatten(params).items():
        name = JR._salad_name_candidates(path)[0]
        val = rng.normal(size=arr.shape).astype(np.float32)
        if name.endswith("pos_embed"):
            cls_slot = np.full((1, 1, arr.shape[-1]), 0.25, np.float32)
            sd[name] = np.concatenate(
                [cls_slot, val.reshape(1, g * g, arr.shape[-1])], axis=1)
        elif name.endswith("cls_token"):
            sd[name] = val - 0.25
        elif name.endswith(".weight") and val.ndim == 4:
            sd[name] = val.transpose(3, 2, 0, 1)
        elif name.endswith(".weight") and val.ndim == 2 and \
                ("cluster_features" in name or ".score." in name):
            sd[name] = val.T[:, :, None, None]
        elif name.endswith(".weight") and val.ndim == 2:
            sd[name] = val.T
        else:
            sd[name] = val
    sd["backbone.model.mask_token"] = rng.normal(size=(1, 32)).astype(
        np.float32)
    return sd


def test_salad_converter_bit_equal_to_reference(tiny_salad):
    _, params, _ = tiny_salad
    cfg = JR.SALADConfig.tiny()
    sd = _dino_salad_state_dict(cfg, params)
    jparams, jreport = JR.convert_torch_state_dict(dict(sd), params)
    tsd, treport = TR.convert_torch_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()},
        TC.meta_template(TR.SALAD, TR.SALADConfig.tiny()))
    assert treport == jreport
    assert treport["unmatched_flax"] == []
    assert treport["unused_torch"] == ["backbone.model.mask_token"]
    want = JC._flatten(jparams)
    assert sorted(TC.torch_key_to_flax(k) for k in tsd) == sorted(want)
    for name, t in tsd.items():
        np.testing.assert_array_equal(
            t.numpy(), want[TC.torch_key_to_flax(name)], err_msg=name)
    assert tsd["dust_bin"].shape == ()


def test_salad_manifest_coverage_on_meta_template():
    with open(os.path.join(DATA_DIR, "manifest_salad.json")) as f:
        manifest = json.load(f)
    sd = {k: torch.zeros(()).expand(s) for k, s in manifest.items()}
    template = TC.meta_template(TR.SALAD, TR.SALADConfig())
    out, report = TR.convert_torch_state_dict(sd, template)
    assert report["unmatched_flax"] == []
    assert report["unused_torch"] == ["backbone.model.mask_token"]
    assert all(TR.allowed_unused_salad(k) for k in report["unused_torch"])
    assert all(out[k].shape == p.shape for k, p in template.items())


def test_reference_converted_npz_loads_into_port(tiny_salad, tmp_path):
    """dino_salad.ckpt -> the reference's npz -> the port's SALAD: the same
    descriptors as the reference's model on its own load; the 0-d dust bin
    survives the npz."""
    jmodel, params, _ = tiny_salad
    cfg = JR.SALADConfig.tiny()
    sd = _dino_salad_state_dict(cfg, params, seed=8)
    ckpt = str(tmp_path / "dino_salad.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in sd.items()}}, ckpt)
    npz = str(tmp_path / "salad.npz")
    JR.convert_torch_checkpoint(ckpt, npz, cfg)
    port_npz = str(tmp_path / "salad_port.npz")
    assert TR.convert_torch_checkpoint(ckpt, port_npz, TR.SALADConfig.tiny()
                                       )["unmatched_flax"] == []
    with np.load(npz) as a, np.load(port_npz) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    model = TR.SALAD(TR.SALADConfig.tiny())
    model.load_state_dict(TC.load_checkpoint(npz), strict=True)
    jparams = JC.load_checkpoint(npz, params)
    x = np.random.default_rng(2).uniform(0, 1, (2, 3, 56, 56)).astype(
        np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax.jit(jmodel.apply)(jparams, jnp.asarray(x))),
        atol=1e-4)


@pytest.mark.parametrize("hw", [(392, 518), (480, 640)])
def test_tiny_descriptor_matches_reference(hw):
    """On textured frames; the thumbnail is also held to OpenCV's on i.i.d.
    noise frames to 5e-7 (there its contrast is ~0.09, and normalization would
    magnify OpenCV's f32 sums ~11x past 1e-6)."""
    import cv2

    rng = np.random.default_rng(hw[0])
    coarse = torch.from_numpy(rng.uniform(0, 1, (3, 3, 9, 12)))
    x = (torch.nn.functional.interpolate(coarse, size=hw, mode="bicubic",
                                         align_corners=False).numpy()
         + rng.normal(0, 0.05, (3, 3) + hw)).clip(0, 1).astype(np.float32)
    got = TR.tiny_image_descriptor_fn()(x)
    want = JR.tiny_image_descriptor_fn()(x)
    assert got.shape == want.shape == (3, 256)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert TR.tiny_image_descriptor_fn().trusted is True
    noise = rng.uniform(0, 1, hw).astype(np.float32)
    np.testing.assert_allclose(
        TR.resize_area(noise[..., None], 16, 16)[..., 0],
        cv2.resize(noise, (16, 16), interpolation=cv2.INTER_AREA), atol=5e-7)


def test_default_salad_descriptor_builds_once_and_is_untrusted(
        monkeypatch):
    """The default descriptor callable: seeded random SALAD weights (the
    tiny widths here), built on the first call on the CPU and reused,
    unit-norm descriptors; untrusted without a checkpoint."""
    tiny = TR.SALADConfig.tiny(input_size=56)
    monkeypatch.setattr(TR, "SALADConfig", lambda input_size: tiny)
    TR.build_salad.cache_clear()
    try:
        fn = TR.default_descriptor_fn(input_size=56, device="cpu")
        assert fn.trusted is False
        x = np.random.default_rng(0).uniform(0, 1, (2, 3, 56, 70)).astype(
            np.float32)
        d = fn(x)
        assert d.shape == (2, 16 + 8 * 16) and np.isfinite(d).all()
        np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0,
                                   atol=1e-5)
        assert TR.build_salad(56, None, "cpu") is TR.build_salad(
            56, None, "cpu")
        np.testing.assert_array_equal(fn(x), d)
    finally:
        TR.build_salad.cache_clear()
    assert TR.default_descriptor_fn(checkpoint="w.npz").trusted is True


class TestTrust:
    """As tests/test_images_retrieval.py: no checkpoint, no loops."""

    def test_untrusted_retrieval_inserts_zero_loops(self):
        class _Submap:
            def get_all_frames(self):
                return np.zeros((3, 3, 8, 8), np.float32)

            def get_id(self):
                return 5

        class _Map:
            def retrieve_best_score_frame(self, *a, **k):
                raise AssertionError("search must not run when untrusted")

        r = ImageRetrieval()
        assert r.trusted is False
        emb = r.get_all_submap_embeddings(_Submap())
        assert emb.shape == (3, 1) and not emb.any()
        sub = _Submap()
        sub.get_all_retrieval_vectors = lambda: emb
        assert r.find_loop_closures(_Map(), sub, max_loop_closures=3) == []

    def test_explicit_descriptor_fn_stays_trusted(self):
        r = ImageRetrieval(descriptor_fn=lambda f: np.zeros((len(f), 4)))
        assert r.trusted is True

    def test_checkpoint_makes_salad_trusted(self):
        assert ImageRetrieval(checkpoint="salad.npz").trusted is True

    def test_cli_backends(self):
        from vggt_slam_tpu_torch import main

        args = main.parser.parse_args([])
        assert (args.retrieval_backend, args.retrieval_checkpoint) == (
            "salad", None)
        assert main.parser.parse_args(
            ["--retrieval_backend", "tiny"]).retrieval_backend == "tiny"
