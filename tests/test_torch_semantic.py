"""The port's semantic voxel map against the reference's on the CPU:
voxelize_np (bit-exact), voxelize_device (centres, counts exact, means
1e-6); the map and its files across packages; the map's semantic hooks
(order, contributors exact, features 1e-5); Felzenszwalb labels
(bit-equal); the embedder (1e-6, against cv2 without IPP); the hash text
embeddings; the embedder CLI and query tool with a tiny CLIP (1e-5);
show_voxels on the viser stub; the CLI end to end at the tiny model.
"""
import contextlib
import io
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import viser_stub

jax.config.update("jax_enable_x64", True)


@contextlib.contextmanager
def _portable_cv2():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(was)


def _cloud(rng, n=400, d=5):
    pts = rng.normal(scale=0.6, size=(n, 3)).astype(np.float32)
    return pts, rng.normal(size=(n, d)).astype(np.float32)


def test_voxelize_np_is_the_reference():
    from vggt_slam_tpu.ops.voxel import voxelize_np as ref
    from vggt_slam_tpu_torch.ops.voxel import voxelize_np

    pts, feats = _cloud(np.random.default_rng(0))
    for a, b in zip(voxelize_np(pts, feats, 0.25), ref(pts, feats, 0.25)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["masked", "all_masked", "overflow",
                                  "negative"])
def test_voxelize_device_matches_reference(case):
    from vggt_slam_tpu.ops.voxel import voxelize_device as ref
    from vggt_slam_tpu_torch.ops.voxel import voxelize_device

    rng = np.random.default_rng(1)
    pts, feats = _cloud(rng)
    mask = rng.random(len(pts)) > 0.3
    capacity = 512
    if case == "all_masked":
        mask[:] = False
    elif case == "overflow":
        capacity = 40                  # fewer than the occupied voxels
    elif case == "negative":
        pts = pts - 3.0                # every coordinate below zero
    got = voxelize_device(torch.from_numpy(pts), torch.from_numpy(feats),
                          torch.from_numpy(mask), 0.25, capacity)
    want = ref(jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(mask), 0.25,
               capacity)
    c, m, n, num = (x.numpy() for x in got)
    rc, rm, rn, rnum = (np.asarray(x) for x in want)
    assert int(num) == int(rnum)
    assert (case == "all_masked") == (num == 0)
    assert (case == "overflow") == (num == capacity)
    np.testing.assert_array_equal(c, rc)
    np.testing.assert_array_equal(n, rn)
    np.testing.assert_allclose(m, rm, rtol=0, atol=1e-6)


def _voxel_maps(d=6):
    from vggt_slam_tpu.semantic import voxel_map as R
    from vggt_slam_tpu_torch.semantic import voxel_map as P

    rng = np.random.default_rng(2)
    coords = np.unique(rng.integers(-6, 6, (60, 3)), axis=0)
    centers = ((coords + 0.5) * 0.1).astype(np.float32)
    feats = rng.normal(size=(len(coords), d)).astype(np.float32)
    contributors = [[(int(s), f"{float(f)}") for s, f in
                     rng.integers(0, 3, (int(rng.integers(1, 4)), 2))]
                    for _ in range(len(coords))]
    names = {str(s): {f"{float(f)}": f"{s}_{f:06d}.png" for f in range(3)}
             for s in range(3)}
    return [M.SemanticVoxelMap(M.SemanticVoxel(0.1, centers, feats,
                                               contributors), names)
            for M in (R, P)], rng


def test_voxel_map_queries_and_lookups():
    (ref, port), rng = _voxel_maps()
    qe = rng.normal(size=6).astype(np.float32)
    for k in (1, 5, 500):
        got, want = port.query_with_embedding(qe, k), \
            ref.query_with_embedding(qe, k)
        assert got[0] == want[0] and got[2] == want[2]
        np.testing.assert_array_equal(got[1], want[1])
    probes = np.concatenate([ref.get_centers_world()[::7] + 0.03,
                             rng.uniform(-1, 1, (20, 3))]).astype(np.float32)
    for p in probes:
        assert port.get_index_at_position(p) == ref.get_index_at_position(p)
        assert port.get_contributors_at_position(p) == \
            ref.get_contributors_at_position(p)
        a, b = port.get_features_at_position(p), \
            ref.get_features_at_position(p)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    for i in range(len(ref.get_centers_world())):
        assert port.get_latest_frame_at_voxel(i) == \
            ref.get_latest_frame_at_voxel(i)
        np.testing.assert_array_equal(port.get_voxel_coord_at_index(i),
                                      ref.get_voxel_coord_at_index(i))
    feats = ref.get_features()
    for x, cap in ((feats, 20000), (feats, 9), (feats[:, :3], 20000),
                   (feats[:, :2], 20000), (feats[:, :1], 20000),
                   (feats[:0], 20000)):
        np.random.seed(3)
        want = ref.features_to_rgb(x, cap)
        np.random.seed(3)
        np.testing.assert_array_equal(port.features_to_rgb(x, cap), want)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_saved_map_loads_across_packages(tmp_path, writer):
    from vggt_slam_tpu.semantic.voxel_map import SemanticVoxelMap as Ref
    from vggt_slam_tpu_torch.semantic.voxel_map import SemanticVoxelMap

    (ref, port), _ = _voxel_maps()
    (port if writer == "port" else ref).save_to_directory(str(tmp_path))
    loaded = (Ref if writer == "port" else SemanticVoxelMap) \
        .load_from_directory(str(tmp_path))
    for got in (loaded, SemanticVoxelMap.load_from_directory(str(tmp_path))):
        assert got.get_voxel_size() == pytest.approx(0.1)
        np.testing.assert_array_equal(got.get_centers_world(),
                                      ref.get_centers_world())
        np.testing.assert_array_equal(got.get_features(), ref.get_features())
        assert [[tuple(t) for t in c] for c in got.get_contributors()] == \
            ref.get_contributors()
        assert got.frame_name_maps == ref.frame_name_maps
        assert got.get_latest_frame_at_voxel(3) == \
            ref.get_latest_frame_at_voxel(3)


_SUBMAPS = ((0, 5, None), (1, 5, 3), (2, 4, None))   # id, frames, loop idx


def _submap_arrays(rng, S, H=12, W=16, d=4):
    """A tilted plane patch per frame plus noise, a far outlier, NaNs."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32) / 20.0
    pts = np.stack([np.broadcast_to(xx, (S, H, W)) + rng.normal(
        scale=0.01, size=(S, H, W)), np.broadcast_to(yy, (S, H, W)) + 0.05
        * np.arange(S)[:, None, None], 0.3 * xx + 0.2 * yy + rng.normal(
        scale=0.01, size=(S, H, W))], -1).astype(np.float32)
    pts[0, 0, 0] = (40.0, -40.0, 40.0)
    pts[1, 2, 3] = np.nan
    sem = rng.normal(size=(S, H, W, d)).astype(np.float32)
    sem[0, 1, 1, 2] = np.inf
    conf = rng.uniform(1, 3, size=(S, H, W)).astype(np.float32)
    Hw = np.eye(4)
    Hw[:3, :3] = 1.3 * np.array([[0.96, -0.28, 0], [0.28, 0.96, 0],
                                 [0, 0, 1]])
    Hw[:3, 3] = rng.normal(size=3)
    Hw[3, :3] = (0.01, -0.02, 0.005)
    return pts, sem, conf, Hw


def _graph_maps():
    from vggt_slam_tpu.slam.map import GraphMap as RefMap
    from vggt_slam_tpu.slam.submap import Submap as RefSubmap
    from vggt_slam_tpu_torch.slam.map import GraphMap
    from vggt_slam_tpu_torch.slam.submap import Submap

    rng = np.random.default_rng(4)
    maps = (RefMap(), GraphMap())
    for sid, S, loop in _SUBMAPS:
        pts, sem, conf, Hw = _submap_arrays(rng, S)
        # ids 8..12, 18..22, 28..31: "10.0" sorts before "8.0"
        names = [f"frame_{10 * sid + 8 + i:04d}.png" for i in range(S)]
        for m, cls in zip(maps, (RefSubmap, Submap)):
            s = cls(sid)
            s.add_all_points(pts, np.zeros(pts.shape, np.uint8), conf, 25.0,
                             np.tile(np.eye(3), (S, 1, 1)))
            s.add_all_semantic_embeddings(sem)
            s.set_frame_ids(names)
            s.set_reference_homography(Hw)
            s.set_last_non_loop_frame_index(S - 1 if loop is None else loop)
            m.add_submap(s)
    return maps


@pytest.mark.parametrize("dedup", [True, False])
def test_build_semantic_voxel_map_matches_reference(dedup):
    ref_map, port_map = _graph_maps()
    want = ref_map.build_semantic_voxel_map(0.1,
                                            deduplicate_contributors=dedup)
    got = port_map.build_semantic_voxel_map(0.1,
                                            deduplicate_contributors=dedup,
                                            device="cpu")
    assert 20 < len(want.get_centers_world()) < 1000
    np.testing.assert_array_equal(got.get_centers_world(),
                                  want.get_centers_world())
    assert got.get_features().dtype == want.get_features().dtype
    np.testing.assert_allclose(got.get_features(), want.get_features(),
                               rtol=0, atol=1e-5)
    assert got.get_contributors() == want.get_contributors()
    assert got.frame_name_maps == want.frame_name_maps
    # the loop frame (submap 1, index 4) contributes nothing
    assert ("1", "22.0") not in {(str(s), f) for c in got.get_contributors()
                                 for s, f in c}


def test_submap_semantic_hooks_match_reference():
    ref_map, port_map = _graph_maps()
    for ignore in (False, True):
        want = ref_map.get_submap(1).get_semantic_voxel_in_world_frame(
            0.1, ignore_loop_closure_frames=ignore)
        got = port_map.get_submap(1).get_semantic_voxel_in_world_frame(
            0.1, ignore_loop_closure_frames=ignore)
        np.testing.assert_array_equal(got.centers_world, want.centers_world)
        np.testing.assert_array_equal(got.features, want.features)
        assert got.contributors == want.contributors
    for s in (ref_map.get_submap(0), port_map.get_submap(0)):
        with pytest.raises(ValueError, match=r"\(S,H,W,d\)"):
            s.add_all_semantic_embeddings(np.zeros((5, 12, 16)))
        with pytest.raises(ValueError, match="spatial dims"):
            s.add_all_semantic_embeddings(np.zeros((5, 12, 15, 2)))
        s.add_all_semantic_embeddings(None)
        assert s.semantic_embeddings is None


def _image(seed, h=48, w=64):
    """Smooth colour blobs quantised to uint8 steps, as a decoded frame."""
    r = np.random.default_rng(seed)
    coarse = torch.from_numpy(r.uniform(0, 1, (3, 5, 7)).astype(np.float32))
    img = torch.nn.functional.interpolate(coarse[None], size=(h, w),
                                          mode="bicubic",
                                          align_corners=False)[0]
    return (np.round(img.clamp(0, 1).permute(1, 2, 0).numpy() * 255)
            .astype(np.uint8))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_felzenszwalb_labels_bit_equal_reference(seed):
    from vggt_slam_tpu.native import felzenszwalb as ref
    from vggt_slam_tpu_torch.native import felzenszwalb
    from vggt_slam_tpu_torch.ops.cuda_build import BUILD_DIR

    img = _image(seed, 60, 80).astype(np.float32)
    for k, min_size in ((300.0, 20), (100.0, 5)):
        labels, n = felzenszwalb.segment(img, k, min_size)
        want, n_ref = ref.segment(img, k, min_size)
        assert n == n_ref > 1
        np.testing.assert_array_equal(labels, want)
    assert os.path.dirname(felzenszwalb._LIB) == BUILD_DIR
    assert os.path.exists(felzenszwalb._LIB)


@pytest.mark.parametrize("masker", ["felzenszwalb", "grid"])
def test_embedder_matches_reference(tmp_path, masker):
    from vggt_slam_tpu.semantic import embedder as ref
    from vggt_slam_tpu_torch.data.images import write_png
    from vggt_slam_tpu_torch.semantic import embedder

    folder = tmp_path / "rgb"
    folder.mkdir()
    for i in range(3):
        write_png(str(folder / f"{i:03d}.png"), _image(10 + i)[..., ::-1])
    outs = {}
    for name, mod in (("ref", ref), ("port", embedder)):
        gen = getattr(mod, f"{masker}_mask_generator")
        emb = mod.SemanticEmbedder(mask_generator=gen, target_hw=(40, 52),
                                   bbox_expand_pct=0.2)
        with _portable_cv2():
            img = _image(5).astype(np.float32) / 255.0
            outs[name] = (emb.embed_image(img),
                          emb.best_match_from_text(img, "a chair") if
                          masker == "grid" else None)
            n = emb.embed_folder_to_npz(str(folder), str(tmp_path / name),
                                        mask_vis_dir=str(tmp_path / name))
        assert n == 3
    (e_ref, m_ref), (e, m) = outs["ref"], outs["port"]
    assert e.shape == e_ref.shape and e.shape[:2] == (40, 52)
    np.testing.assert_allclose(e, e_ref, rtol=0, atol=1e-6)
    if m is not None:
        assert m[0] == m_ref[0] and m[2] == pytest.approx(m_ref[2], abs=1e-6)
        np.testing.assert_array_equal(m[1], m_ref[1])
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "ref"))
    for f in sorted(os.listdir(tmp_path / "ref")):
        a, b = tmp_path / "port" / f, tmp_path / "ref" / f
        if f.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert za.files == zb.files == ["embedding"]
                np.testing.assert_allclose(za["embedding"], zb["embedding"],
                                           rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(cv2.imread(str(a)),
                                          cv2.imread(str(b)))


def test_embedder_shards_and_worker_processes_match_one_process(tmp_path):
    """The CLI's --num_procs 2 (spawned workers) and two --shard_index
    runs write the files one process writes, bit for bit."""
    from vggt_slam_tpu_torch.data.images import write_png
    from vggt_slam_tpu_torch.semantic import embedder

    folder = tmp_path / "rgb"
    folder.mkdir()
    for i in range(4):
        write_png(str(folder / f"{i:03d}.png"), _image(20 + i, 30, 40))
    base = ["--image_dir", str(folder), "--target_size", "24"]
    with contextlib.redirect_stdout(io.StringIO()):
        embedder.main(base + ["--out_dir", str(tmp_path / "one")])
        embedder.main(base + ["--out_dir", str(tmp_path / "procs"),
                              "--num_procs", "2"])
        for i in range(2):
            assert embedder.main(base + ["--out_dir", str(tmp_path / "shards"),
                                         "--num_shards", "2", "--shard_index",
                                         str(i)]) == 2
    files = sorted(os.listdir(tmp_path / "one"))
    assert len(files) == 4
    for other in ("procs", "shards"):
        assert sorted(os.listdir(tmp_path / other)) == files
        for f in files:
            with np.load(tmp_path / "one" / f) as a, \
                    np.load(tmp_path / other / f) as b:
                np.testing.assert_array_equal(a["embedding"], b["embedding"])


def test_text_embeddings_equal_reference():
    from vggt_slam_tpu.semantic import embedder as ref
    from vggt_slam_tpu.tools import query_voxelmap as ref_query
    from vggt_slam_tpu_torch.semantic import embedder
    from vggt_slam_tpu_torch.tools import query_voxelmap

    texts = ["a chair", "", "kitchen table ü"]
    np.testing.assert_array_equal(embedder.hash_text_encoder(texts, 32),
                                  ref.hash_text_encoder(texts, 32))
    crops = np.random.default_rng(6).uniform(0, 1, (4, 3, 9, 11)).astype(
        np.float32)
    np.testing.assert_array_equal(embedder.color_hash_encoder(crops),
                                  ref.color_hash_encoder(crops))
    for t in texts:      # hash() is salted per process: same process here
        np.testing.assert_array_equal(
            query_voxelmap.text_embedding(t, 16, None),
            ref_query.text_embedding(t, 16, None))


def test_missing_models_raise_naming_the_module(tmp_path, monkeypatch):
    """The hf backend, which `auto` takes without a CLIP or SigLIP config.json,
    is not ported; a SigLIP config.json without weights raises naming them;
    `--masker sam2` runs (seeded, on an empty folder) and raises on --device
    cuda without a card."""
    from vggt_slam_tpu_torch.models.siglip import SigLIPConfig
    from vggt_slam_tpu_torch.semantic import embedder
    from vggt_slam_tpu_torch.tools import query_voxelmap

    (tmp_path / "config.json").write_text(json.dumps(
        SigLIPConfig.tiny_test().to_hf_dict()))
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        query_voxelmap.text_embedding("x", 8, str(tmp_path), device="cpu")
    with pytest.raises(ModuleNotFoundError, match="hf backend"):
        embedder.resolve_clip_encoders(str(tmp_path / "none"))
    with pytest.raises(ModuleNotFoundError, match="hf backend"):
        embedder.resolve_clip_encoders(str(tmp_path), "hf", "cpu")
    (tmp_path / "empty").mkdir()
    argv = ["--image_dir", str(tmp_path / "empty"), "--out_dir",
            str(tmp_path / "o"), "--masker", "sam2"]
    assert embedder.main(argv + ["--device", "cpu"]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        embedder.main(argv)


def _clip_dir(path):
    """A tiny CLIP checkpoint directory (tests/test_torch_clip.py)."""
    from tests.test_torch_clip import write_checkpoint
    from vggt_slam_tpu_torch.models.clip import CLIPConfig

    path.mkdir()
    cfg = CLIPConfig.tiny_test(vocab_size=524, context_length=16)
    write_checkpoint(str(path), cfg, "bin")
    return str(path), cfg


def test_embedder_cli_with_clip_matches_reference(tmp_path, monkeypatch):
    """The embedder CLI with --clip_model_dir --device cpu against the
    reference's CLI (its flax CLIP): the same npz files and keys, the
    embeddings within 1e-5, d the projection width, each painted pixel
    unit-norm."""
    import sys

    from vggt_slam_tpu.semantic import embedder as ref
    from vggt_slam_tpu_torch.data.images import write_png
    from vggt_slam_tpu_torch.semantic import embedder

    ckpt, cfg = _clip_dir(tmp_path / "clip")
    folder = tmp_path / "rgb"
    folder.mkdir()
    for i in range(2):
        write_png(str(folder / f"{i:03d}.png"), _image(30 + i)[..., ::-1])
    args = ["--image_dir", str(folder), "--target_size", "40",
            "--clip_model_dir", ckpt]
    with contextlib.redirect_stdout(io.StringIO()):
        assert embedder.main(args + ["--out_dir", str(tmp_path / "port"),
                                     "--device", "cpu"]) == 2
        monkeypatch.setattr(sys, "argv", ["embedder"] + args + [
            "--out_dir", str(tmp_path / "ref")])
        with _portable_cv2():
            ref.main()
    files = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "port")) == files and len(files) == 2
    for f in files:
        with np.load(tmp_path / "port" / f) as a, \
                np.load(tmp_path / "ref" / f) as b:
            assert a.files == b.files == ["embedding"]
            e = a["embedding"]
            assert e.shape == (40, 40, cfg.projection_dim)
            np.testing.assert_allclose(e, b["embedding"], rtol=0, atol=1e-5)
        norms = np.linalg.norm(e, axis=-1)
        painted = norms > 0
        assert painted.mean() > 0.5
        np.testing.assert_allclose(norms[painted], 1.0, atol=1e-5)


def test_query_text_embedding_with_clip_matches_reference(tmp_path):
    from vggt_slam_tpu.tools import query_voxelmap as ref_query
    from vggt_slam_tpu_torch.tools import query_voxelmap

    ckpt, cfg = _clip_dir(tmp_path / "clip")
    for q in ("a chair", "the cat and the dog", ""):
        got = query_voxelmap.text_embedding(q, 64, ckpt, device="cpu")
        want = np.asarray(ref_query.text_embedding(q, 64, ckpt))
        assert got.shape == (cfg.projection_dim,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("render_mode,color_mode,max_voxels", [
    ("points", "pca", None), ("points", "query", 30), ("cubes", "query", None),
    ("points", "first3", 30)])
def test_show_voxels_matches_reference(monkeypatch, render_mode, color_mode,
                                       max_voxels):
    calls = viser_stub.install_with(monkeypatch)
    from vggt_slam_tpu.viz.viser_viewer import show_voxels as ref_show
    from vggt_slam_tpu_torch.viz.viser_viewer import show_voxels

    (ref, port), _ = _voxel_maps()
    query = [0, 3, 17]
    recorded = []
    for fn, vm in ((ref_show, ref), (show_voxels, port)):
        np.random.seed(7)
        calls.clear()
        fn(vm, render_mode=render_mode, color_mode=color_mode,
           max_voxels=max_voxels, query_voxel_indices=query, keep_alive=False,
           x_offset=0.5)
        recorded.append(list(calls))
    want, got = recorded
    assert [c[0] for c in got] == [c[0] for c in want]
    for (_, _, kw), (_, _, rkw) in zip(got, want):
        assert sorted(kw) == sorted(rkw)
        for k in kw:
            np.testing.assert_array_equal(np.asarray(kw[k]),
                                          np.asarray(rkw[k]))
    n = max_voxels or len(port.get_centers_world())
    if render_mode == "cubes":
        assert len(got) == 1 + n
        colors = np.array([kw["color"] for _, _, kw in got[1:]])
    else:
        assert len(got) == 2
        colors = got[1][2]["colors"]
        assert got[1][2]["points"].shape == (n, 3)
    assert colors.shape == (n, 3) and 0 <= colors.min() <= colors.max() <= 1
    if color_mode == "query" and max_voxels is None:
        red = np.flatnonzero((colors == (1.0, 0.0, 0.0)).all(1))
        assert red.tolist() == query


def test_cli_semantic_voxel_map_and_query(tmp_path, monkeypatch):
    """The embedder CLI on 6 PNG frames, the tiny-model SLAM CLI with
    --semantic_emb_dir --get_voxel --voxel_save_dir on the CPU, the saved
    map read by the reference's loader, then query_voxelmap on it (its
    --visualize on the viser stub)."""
    from vggt_slam_tpu.semantic.voxel_map import SemanticVoxelMap as Ref
    from vggt_slam_tpu_torch import main
    from vggt_slam_tpu_torch.data.images import write_png
    from vggt_slam_tpu_torch.semantic import embedder
    from vggt_slam_tpu_torch.tools import query_voxelmap

    rng = np.random.default_rng(0)
    coarse = rng.uniform(0, 255, (8, 60)).astype(np.float32)
    tex = torch.nn.functional.interpolate(
        torch.from_numpy(coarse)[None, None], size=(96, 900),
        mode="bicubic", align_corners=False)[0, 0].clamp(0, 255).numpy()
    tex = np.repeat(tex.astype(np.uint8)[..., None], 3, axis=2)
    tex[..., 1] = 255 - tex[..., 1]
    rgb = tmp_path / "rgb"
    rgb.mkdir()
    for i in range(6):
        write_png(str(rgb / f"{i:06d}.png"),
                  np.ascontiguousarray(tex[20:76, 20 + 40 * i:538 + 40 * i]))
    emb_dir, vox_dir = tmp_path / "emb", tmp_path / "vox"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert embedder.main(["--image_dir", str(rgb), "--out_dir",
                              str(emb_dir), "--target_size", "32",
                              "--masker", "felzenszwalb"]) == 6
    assert "felzenszwalb_mask_generator" in out.getvalue()
    args = main.parser.parse_args(
        ["--image_folder", str(rgb), "--model_size", "tiny", "--submap_size",
         "3", "--max_loops", "0", "--min_disparity", "20",
         "--keyframe_backend", "torch", "--semantic_emb_dir", str(emb_dir),
         "--get_voxel", "--voxel_size", "0.02", "--voxel_save_dir",
         str(vox_dir), "--timing"])
    res = main.run_slam(args, device="cpu")
    vm = res["voxel_map"]
    assert "semantic_voxel_map" in res["timer"].summary()
    for s in res["solver"].map.ordered_submaps_by_key():
        assert s.semantic_embeddings.shape[:3] == s.pointclouds.shape[:3]
    loaded = Ref.load_from_directory(str(vox_dir))
    V = len(loaded.get_centers_world())
    assert V == len(vm.get_centers_world()) > 0
    assert loaded.get_features().shape == (V, 64)
    assert np.isfinite(loaded.get_features()).all()
    for i in range(V):
        name, _, _ = loaded.get_latest_frame_at_voxel(i)
        assert (rgb / name).exists()

    calls = viser_stub.install_with(monkeypatch)
    monkeypatch.setattr("sys.stdin", io.StringIO(""))
    with contextlib.redirect_stdout(io.StringIO()):
        results = query_voxelmap.main(
            ["--voxel_dir", str(vox_dir), "--query", "a chair", "--top_k",
             "5", "--image_dir", str(rgb), "--out_dir", str(tmp_path / "q"),
             "--visualize"])
    assert [r[0] for r in results] == list(range(min(5, V)))
    sims = [r[2] for r in results]
    assert sims == sorted(sims, reverse=True)
    assert len(os.listdir(tmp_path / "q")) == len(results)
    cloud = [kw for name, _, kw in calls if name == "scene.add_point_cloud"]
    assert len(cloud) == 1 and len(cloud[0]["points"]) == min(V, 20000)
    # show_voxels draws its voxels at random (numpy's global generator, as
    # the reference): exactly the drawn ranked voxels are red
    pts = cloud[0]["points"]
    red = pts[(cloud[0]["colors"] == (1.0, 0.0, 0.0)).all(1)]
    ranked = {tuple(loaded.get_centers_world()[r[1]]) for r in results}
    assert len({tuple(p) for p in red}) == len(red)
    assert {tuple(p) for p in red} == ranked & {tuple(p) for p in pts}
