"""The port's Solver on the reference's deterministic fake VGGT
(tests/fake_vggt.py): tests/test_slam_e2e.py's scenarios and outcome
bounds (aligned ATE, loop factors).
"""
import numpy as np
import pytest

from tests.fake_vggt import FakeVGGT, circular_trajectory, default_K
from vggt_slam_tpu_torch.slam.loop_closure import ImageRetrieval
from vggt_slam_tpu_torch.slam.solver import Solver

IMAGE_HW = (28, 42)


def cheap_descriptor(frames):
    """Content-hash descriptor: distinct images -> distant descriptors."""
    f = np.asarray(frames).reshape(len(frames), -1)
    d = f @ np.random.default_rng(123).normal(size=(f.shape[1], 16))
    return d / (np.linalg.norm(d, axis=1, keepdims=True) + 1e-9)


def _run(model, frames, solver, submap_size=3, max_loops=0):
    subset, loops = [], 0
    for i in range(len(frames)):
        subset.append(i)
        if len(subset) == submap_size + 1 or i == len(frames) - 1:
            preds = solver.run_predictions(
                np.stack([frames[j] for j in subset]), model, max_loops,
                names=[f"{j}.png" for j in subset])
            loops += len(preds["detected_loops"])
            solver.add_points(preds)
            solver.graph.optimize()
            solver.map.update_submap_homographies(solver.graph)
            subset = subset[-1:]
    return loops


def _ate(solver, w2c, submap_size=3):
    from vggt_slam_tpu.slam.alignment import rmse, umeyama_sim3_np

    pred = np.stack([p[:3, 3] for s in solver.map.ordered_submaps_by_key()
                     for p in s.get_all_poses_world(
                         ignore_loop_closure_frames=True)])
    gt, subset = [], []
    for i in range(len(w2c)):
        subset.append(i)
        if len(subset) == submap_size + 1 or i == len(w2c) - 1:
            gt.extend(np.linalg.inv(w2c[j])[:3, 3] for j in subset)
            subset = subset[-1:]
    gt = np.stack(gt[:len(pred)])
    s, R, t = umeyama_sim3_np(pred, gt)
    return rmse((s * (R @ pred.T)).T + t, gt)


@pytest.mark.parametrize("use_sim3,scales,bound", [
    (False, [1.0, 1.7, 0.6], 0.02),   # SL(4) absorbs per-submap scale
    (True, [1.0, 2.0, 0.5], 0.02),    # Sim(3) scale propagation
])
def test_trajectory_recovery(use_sim3, scales, bound):
    w2c = circular_trajectory(7)
    model = FakeVGGT(w2c, default_K(IMAGE_HW), image_hw=IMAGE_HW,
                     scale_schedule=scales)
    solver = Solver(use_sim3=use_sim3, loop_inlier_thresh=0.0,
                    retrieval=ImageRetrieval(descriptor_fn=cheap_descriptor))
    _run(model, [model.make_image(i) for i in range(7)], solver)
    assert solver.map.get_num_submaps() == 2
    assert _ate(solver, w2c) < bound


def test_loop_factor_inserted():
    n = 10
    w2c = circular_trajectory(n)
    w2c[-1] = w2c[0]                      # a true revisit of frame 0
    model = FakeVGGT(w2c, default_K(IMAGE_HW), image_hw=IMAGE_HW)
    frames = [model.make_image(i) for i in range(n)]
    frames[-1][1:, 5:, 5:] = frames[0][1:, 5:, 5:]
    solver = Solver(loop_inlier_thresh=0.9,
                    retrieval=ImageRetrieval(descriptor_fn=cheap_descriptor))
    assert _run(model, frames, solver, max_loops=1) >= 1
    assert solver.graph.get_num_loops() >= 1
    assert solver.rejected_loop_count == 0


def test_semantic_embeddings_resized_like_reference():
    """Per-pixel embeddings at another resolution are resized to the image
    grid as the reference's jax.image.resize does, padded for loop frames.
    Tolerance 2e-5: the reference may compute its weights in f64."""
    import jax
    import jax.numpy as jnp

    sem = np.random.default_rng(0).normal(size=(2, 9, 13, 4)).astype(
        np.float32)
    images = np.zeros((3, 3, 28, 42), np.float32)
    got = Solver._fit_semantics(sem, images)
    want = np.asarray(jax.image.resize(jnp.asarray(sem), (2, 28, 42, 4),
                                       method="bilinear"))
    assert got.shape == (3, 28, 42, 4)
    np.testing.assert_allclose(got[:2], want, atol=2e-5)
    assert not got[2].any()
