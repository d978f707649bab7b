"""The port's SAM2 and its automatic mask generator against the JAX
package's on the CPU at tiny_test, on the reference's parameters carried by
`load_flax_params` (pos_embed random: the port resizes it by
jax.image.resize's bicubic); the converter against the reference's on its
torch mirror; the helpers (remove_small_regions against cv2); the
generator, the embedder and `--masker sam2`. Features, masks and scores
within 1e-4 of each output's largest entry, the bicubic resize 1e-6; the
converter, point grid, crop boxes, NMS and components exact. The uint8
crop resizes lie within one step of OpenCV's, so masks match by IoU (>=
0.98, the same count) and painted maps on >= 99% of pixels.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_sam2 import TSAM2Image, _randomize
from vggt_slam_tpu.models import sam2 as R
from vggt_slam_tpu.semantic import sam2_amg as RA
from vggt_slam_tpu_torch.models import sam2 as P
from vggt_slam_tpu_torch.semantic import sam2_amg as PA

REL = 1e-4


def close(a, b, rel=REL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * np.abs(b).max())


def flax_tree(sd):
    tree = {}
    for k, v in sd.items():
        *path, leaf = k.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v.numpy())
    return {"params": tree}


@pytest.fixture(scope="module")
def pair():
    """(reference model, its params, the port's model on them, features of
    one seeded image on both sides)."""
    cfg = P.SAM2Config.tiny_test()
    sd = P.init_state_dict(cfg, seed=3)
    sd["trunk.pos_embed"] = torch.randn(sd["trunk.pos_embed"].shape,
                                        generator=torch.Generator()
                                        .manual_seed(4))
    params = flax_tree(sd)
    rm = R.SAM2ImageModel(R.SAM2Config.tiny_test())
    pm = P.load_flax_params(P.SAM2ImageModel(cfg), params).eval()
    img = np.random.default_rng(0).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    rf = jax.jit(lambda p, x: rm.apply(p, x, method=R.SAM2ImageModel
                                       .embed_image))(params, img)
    with torch.no_grad():
        pf = pm.embed_image(torch.from_numpy(img))
    return rm, params, pm, rf, pf


def test_embed_image_matches_reference(pair):
    _, _, _, rf, pf = pair
    for k in ("image_embed", "feat_s0", "feat_s1"):
        close(pf[k], rf[k])


def test_decode_points_and_chunk_stats_match_reference(pair):
    rm, params, pm, rf, pf = pair
    pts = np.random.default_rng(1).uniform(0, 64, (5, 2)).astype(np.float32)
    ref = jax.jit(lambda p, f, q: rm.apply(
        p, f, q, method=R.SAM2ImageModel.decode_points))(params, rf, pts)
    with torch.no_grad():
        got = pm.decode_points(pf, torch.from_numpy(pts))
        stats = PA.decode_chunk(pm, pf, torch.from_numpy(pts))
    for a, b in zip(got, ref):      # masks, iou, obj
        close(a, b)
    ref_stats = RA._decode_chunk(rm, params, rf, jnp.asarray(pts))
    close(stats[0], ref_stats[0])
    # stability, boxes and areas of the port's own logits against the
    # reference's rule on them
    m = stats[0].numpy()
    np.testing.assert_allclose(
        stats[2], (m > 1).sum((1, 2)) / np.maximum((m > -1).sum((1, 2)), 1),
        rtol=1e-6)
    np.testing.assert_array_equal(stats[4], (m > 0).sum((1, 2)))
    for i, box in enumerate(stats[3].numpy()):
        ys, xs = np.nonzero(m[i] > 0)
        want = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1] if len(ys) \
            else [0, 0, 0, 0]
        np.testing.assert_array_equal(box, want)
    assert (stats[4] > 0).any() and (stats[4] < 16 * 16).any()


def test_box_and_mask_prompts_match_reference(pair):
    _, params, pm, _, _ = pair
    rng = np.random.default_rng(6)
    boxes = rng.uniform(0, 64, (3, 4)).astype(np.float32)
    masks = rng.normal(size=(2, 16, 16, 1)).astype(np.float32)
    pe = R.PromptEncoder(R.SAM2Config.tiny_test())
    p = {"params": params["params"]["prompt_encoder"]}
    with torch.no_grad():
        close(pm.prompt_encoder.embed_boxes(torch.from_numpy(boxes)),
              pe.apply(p, boxes, method="embed_boxes"))
        close(pm.prompt_encoder.embed_masks(torch.from_numpy(masks)),
              pe.apply(p, masks, method="embed_masks"))


@pytest.mark.parametrize("n_in,n_out", [(2, 16), (14, 256), (14, 9)])
def test_pos_embed_resize_matches_jax(n_in, n_out):
    """tiny_test's and base_plus's grids, and a shrink."""
    x = np.random.default_rng(n_out).normal(size=(1, n_in, n_in, 5)).astype(
        np.float32)
    ref = jax.image.resize(x, (1, n_out, n_out, 5), "bicubic")
    close(P.resize_bicubic(torch.from_numpy(x), n_out, n_out), ref, 1e-6)


def test_converter_matches_reference():
    """On the mirror's state dict with video-memory keys: the same tensors
    as the reference's converter, and back to the same checkpoint."""
    cfg = P.SAM2Config.tiny_test()
    sd = _randomize(TSAM2Image(R.SAM2Config.tiny_test(),
                               with_video_dummies=True), 5).state_dict()
    got = P.convert_torch_state_dict(sd, cfg)
    ref = jax.tree_util.tree_flatten_with_path(
        R.convert_torch_state_dict(sd, R.SAM2Config.tiny_test()))[0]
    ref = {".".join(k.key for k in path[1:]): v for path, v in ref}
    assert sorted(got) == sorted(ref) == sorted(P.param_shapes(cfg))
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    back = P.to_torch_state_dict(got, cfg)
    assert sorted(back) == sorted(k for k in sd if not any(
        k.startswith(p) or p in k for p in P.VIDEO_ONLY))
    for k in back:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)


@pytest.mark.parametrize("fault,error,match", [
    ("missing", KeyError, "missing checkpoint key .*iou_token"),
    ("drift", KeyError, "unconsumed.*mystery"),
    ("shape", ValueError, "mask_tokens.*shape")])
def test_converter_names_the_faulty_key(fault, error, match):
    cfg = P.SAM2Config.tiny_test()
    sd = TSAM2Image(R.SAM2Config.tiny_test()).state_dict()
    if fault == "missing":
        del sd["sam_mask_decoder.iou_token.weight"]
    elif fault == "drift":
        sd["sam_mask_decoder.new_mystery_head.weight"] = np.zeros(3)
    else:
        sd["sam_mask_decoder.mask_tokens.weight"] = torch.zeros(3, 16)
    with pytest.raises(error, match=match):
        P.convert_torch_state_dict(sd, cfg)


def test_base_plus_keys_covered_on_meta():
    """sam2.1_hiera_base_plus's mirror on the meta device: every key
    consumed, every port parameter filled at its shape."""
    cfg = P.SAM2Config.base_plus()
    with torch.device("meta"):
        tm = TSAM2Image(R.SAM2Config.base_plus(), with_video_dummies=True)
    sd = {k: torch.zeros(()).expand(v.shape)
          for k, v in tm.state_dict().items()}
    got = P.convert_torch_state_dict(sd, cfg)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        P.param_shapes(cfg)
    assert sum(v.numel() for v in got.values()) == 73_328_657


def test_load_params_pt_and_npz(tmp_path):
    cfg = P.SAM2Config.tiny_test()
    sd = P.init_state_dict(cfg, seed=1)
    torch.save({"model": P.to_torch_state_dict(sd, cfg)}, tmp_path / "m.pt")
    np.savez(tmp_path / "m.npz", **{"params/" + k.replace(".", "/"):
                                    v.numpy() for k, v in sd.items()})
    for name in ("m.pt", "m.npz"):
        got = PA.load_params(str(tmp_path / name), cfg)
        assert sorted(got) == sorted(sd)
        for k in sd:
            torch.testing.assert_close(got[k], sd[k], rtol=0, atol=0)
    gen = PA.make_sam2_mask_generator(str(tmp_path / "m.pt"), cfg,
                                      device="cpu")
    torch.testing.assert_close(gen.model.state_dict(), sd, rtol=0, atol=0)


def test_helpers_match_reference():
    rng = np.random.default_rng(2)
    for n in (1, 4, 24):
        np.testing.assert_array_equal(PA.build_point_grid(n),
                                      RA.build_point_grid(n))
    for hw in ((480, 640), (518, 518), (48, 72)):
        for layers in (0, 1, 2):
            assert PA.generate_crop_boxes(hw, layers, 512 / 1500) == \
                RA.generate_crop_boxes(hw, layers, 512 / 1500)
    xy = rng.uniform(0, 50, (200, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 20, (200, 2))], 1)
    scores = rng.uniform(0, 1, 200)
    for t in (0.3, 0.7):
        np.testing.assert_array_equal(PA.nms(boxes, scores, t),
                                      RA.nms(boxes, scores, t))


@pytest.mark.parametrize("mode", ["holes", "islands"])
def test_remove_small_regions_matches_cv2(mode):
    """Random masks at odd and even sizes, and a tie of the largest small
    islands whose first pixels and first 2x2 blocks come in other orders
    (the reference keeps cv2's first)."""
    rng = np.random.default_rng(3)
    cases = [(rng.random(s) > p, a) for s in ((37, 53), (64, 64))
             for p in (0.5, 0.8) for a in (3, 9, 40)]
    tie = np.zeros((8, 12), bool)
    tie[1, 0:2] = tie[0, 6:8] = True
    cases += [(tie, 5), (tie[::-1].copy(), 5), (tie[:, ::-1].copy(), 5)]
    for mask, area in cases:
        got, changed = PA.remove_small_regions(mask, area, mode)
        ref, ref_changed = RA.remove_small_regions(mask, area, mode)
        assert changed == ref_changed
        np.testing.assert_array_equal(got, ref)


def tiny_generators(pair, **kw):
    rm, params, pm, _, _ = pair
    ref = RA.SAM2MaskGenerator(params, R.SAM2Config.tiny_test(), **kw)
    return PA.SAM2MaskGenerator(pm, **kw), ref


def match_masks(got, ref):
    assert len(got) == len(ref) > 0
    segs = np.stack([m["segmentation"] for m in got])
    for m in ref:
        inter = (segs & m["segmentation"]).sum((1, 2))
        union = (segs | m["segmentation"]).sum((1, 2))
        assert (inter / np.maximum(union, 1)).max() >= 0.98


def test_generator_matches_reference(pair):
    kw = dict(points_per_side=4, points_per_batch=8, pred_iou_thresh=0.0,
              stability_score_thresh=0.0, min_mask_region_area=4)
    gen, ref = tiny_generators(pair, **kw)
    img = np.random.default_rng(0).uniform(0, 255, (48, 72, 3)).astype(
        np.uint8)
    got = gen(img)
    match_masks(got, ref(img))
    areas = [m["area"] for m in got]
    assert areas == sorted(areas, reverse=True)
    for m in got:
        assert m["segmentation"].shape == (48, 72)
        assert m["area"] == int(m["segmentation"].sum())
        x, y, w, h = m["bbox"]
        assert 0 <= x <= x + w <= 72 and 0 <= y <= y + h <= 48
    assert gen.chunks == 2 + 4 and set(gen.seconds) == {"embed", "decode",
                                                         "host"}


def test_embedder_with_sam2_matches_reference(pair):
    """As the reference's TestAMG::test_embedder_integration, both sides."""
    from vggt_slam_tpu.semantic.embedder import SemanticEmbedder as RE
    from vggt_slam_tpu_torch.semantic.embedder import SemanticEmbedder

    kw = dict(points_per_side=2, points_per_batch=4, pred_iou_thresh=0.0,
              stability_score_thresh=0.0, min_mask_region_area=0)
    gen, ref = tiny_generators(pair, **kw)
    img = np.random.default_rng(1).uniform(0, 1, (64, 80, 3)).astype(
        np.float32)
    got = SemanticEmbedder(mask_generator=gen, target_hw=(32, 40)) \
        .embed_image(img)
    want = RE(mask_generator=ref, target_hw=(32, 40)).embed_image(img)
    assert got.shape == want.shape and got.shape[:2] == (32, 40)
    assert np.abs(got).sum() > 0
    same = np.isclose(got, want, rtol=0, atol=1e-5).all(-1)
    assert same.mean() >= 0.99


def test_embedder_cli_masker_sam2(tmp_path, monkeypatch, pair):
    """--masker sam2 builds the generator with --sam2_checkpoint and
    --device (here patched to the tiny model on the CPU: the CLI's own
    base_plus at 1024 is the card's)."""
    from vggt_slam_tpu_torch.data.images import write_png
    from vggt_slam_tpu_torch.semantic import embedder

    seen = []

    def fake(checkpoint=None, device="cuda", **kw):
        seen.append((checkpoint, device))
        return PA.SAM2MaskGenerator(pair[2], points_per_side=2,
                                    pred_iou_thresh=0.0,
                                    stability_score_thresh=0.0)

    monkeypatch.setattr(PA, "make_sam2_mask_generator", fake)
    rng = np.random.default_rng(5)
    (tmp_path / "rgb").mkdir()
    for i in range(2):
        write_png(str(tmp_path / "rgb" / f"{i:03d}.png"),
                  rng.integers(0, 256, (40, 56, 3), dtype=np.uint8))
    n = embedder.main(["--image_dir", str(tmp_path / "rgb"), "--out_dir",
                       str(tmp_path / "emb"), "--masker", "sam2",
                       "--sam2_checkpoint", "ckpt.pt", "--device", "cpu",
                       "--target_size", "32"])
    assert n == 2 and seen == [("ckpt.pt", "cpu")]
    for i in range(2):
        with np.load(tmp_path / "emb" / f"{i:03d}.npz") as z:
            assert z["embedding"].shape[:2] == (32, 32)
