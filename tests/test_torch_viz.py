"""The port's viewer and export against the reference's on the CPU: GLB
files byte-equal; the viser viewer on tests/viser_stub.py (calls exact,
poses 1e-6, frustum images one uint8 step: cv2's INTER_AREA against
resize_area); the Solver's viewer hooks (1e-9 relative in float64).
"""
import jax
import numpy as np
import pytest

from tests import viser_stub

jax.config.update("jax_enable_x64", True)


def _rotation(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else -q


def _poses(rng, n):
    T = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        T[i, :3, :3] = _rotation(rng)
        T[i, :3, 3] = rng.normal(size=3)
    return T


@pytest.mark.parametrize("colors", ["float", "uint8", "none", "lines_only"])
def test_glb_bytes_equal_reference(tmp_path, colors):
    from vggt_slam_tpu.viz.glb import GLBExporter as Ref
    from vggt_slam_tpu_torch.viz.glb import GLBExporter, TrimeshViewer

    rng = np.random.default_rng(0)
    out = []
    for cls in (Ref, GLBExporter, TrimeshViewer):
        ex = cls()
        if colors != "lines_only":
            for n in (37, 5):
                pts = rng.normal(size=(n, 3))
                col = {"float": rng.uniform(size=(n, 3)),
                       "uint8": rng.integers(0, 256, (n, 3), dtype=np.uint8),
                       "none": None}[colors]
                ex.add_point_cloud(pts, col)
        for pose in _poses(rng, 3):
            ex.add_camera_pose(pose, axis_length=0.2)
        path = tmp_path / f"{cls.__module__}.{cls.__name__}.glb"
        assert ex.export(str(path)) == str(path)
        out.append(path.read_bytes())
        rng = np.random.default_rng(0)
    assert out[0][:4] == b"glTF"
    assert out[1] == out[0] and out[2] == out[0]


def _compare_calls(ref, port, image_steps=1):
    assert [c[0] for c in port] == [c[0] for c in ref]
    for (name, ra, rk), (_, pa, pk) in zip(ref, port):
        assert pa == ra and sorted(pk) == sorted(rk), name
        for key, rv in rk.items():
            pv = pk[key]
            if key == "image":
                assert pv.dtype == rv.dtype == np.uint8
                assert pv.shape == rv.shape
                assert np.abs(pv.astype(int) - rv.astype(int)).max() \
                    <= image_steps
            elif key in ("wxyz", "position"):
                np.testing.assert_allclose(pv, rv, rtol=0, atol=1e-6)
            elif isinstance(rv, np.ndarray):
                assert pv.dtype == rv.dtype, (name, key)
                np.testing.assert_allclose(pv, rv, rtol=1e-9, atol=1e-12)
            else:
                assert pv == rv, (name, key)


def test_viser_viewer_matches_reference(monkeypatch):
    calls = viser_stub.install_with(monkeypatch)
    from vggt_slam_tpu.viz.viser_viewer import ViserViewer as Ref
    from vggt_slam_tpu_torch.viz.viser_viewer import ViserViewer

    rng = np.random.default_rng(1)
    poses = _poses(rng, 3)
    images = rng.uniform(size=(3, 3, 27, 41))       # odd sizes, scale 0.5
    pts = rng.normal(size=(50, 3))
    cols = rng.uniform(size=(50, 3))
    recorded = []
    viewers = []
    for make in (lambda: (np.random.seed(7), Ref())[1],
                 lambda: ViserViewer(rng=np.random.RandomState(7))):
        calls.clear()
        v = make()
        v.add_point_cloud(pts, cols, name="0", point_size=0.003)
        v.add_point_cloud(pts, (cols * 255).astype(np.uint8), name="1",
                          point_size=0.01)
        v.add_frames(poses, images, submap_id=0)
        v.add_frames(poses[:2], images[:2], submap_id=251)
        v.gui_show_frames.value = False
        v._on_update_show_frames(None)
        recorded.append(list(calls))
        viewers.append(v)
    ref, port = recorded
    _compare_calls(ref, port)
    assert sum(c[0] == "scene.add_frame" for c in port) == 5
    assert sum(c[0] == "scene.add_camera_frustum" for c in port) == 5
    np.testing.assert_array_equal(viewers[1].random_colors,
                                  viewers[0].random_colors)
    for v in viewers:
        assert not any(h.visible for hs in v.submap_frames.values()
                       for h in hs)
        assert not any(h.visible for hs in v.submap_frustums.values()
                       for h in hs)
        with pytest.raises(NotImplementedError):
            v.export("x.glb")


class _RecordingViewer:
    def __init__(self):
        self.calls = []

    def add_point_cloud(self, points, colors, name, point_size):
        self.calls.append(("add_point_cloud", (),
                           dict(points=points, colors=colors, name=name,
                                point_size=point_size)))

    def add_frames(self, extrinsics, images, submap_id):
        self.calls.append(("add_frames", (),
                           dict(extrinsics=extrinsics, images=images,
                                submap_id=submap_id)))


def synthetic_submaps(submap_cls, n=3, frames=4, hw=(9, 11), seed=0,
                      loop_frames=1):
    """`n` submaps of `frames` named frames (plus `loop_frames` appended
    loop frames) with seeded poses, point maps, colours, confidences,
    intrinsics and SL(4) homographies; the same data for either
    package's Submap class."""
    rng = np.random.default_rng(seed)
    out = []
    S = frames + loop_frames
    for k in range(n):
        sub = submap_cls(k)
        K = np.tile(np.array([[20.0, 0, hw[1] / 2], [0, 21.0, hw[0] / 2],
                              [0, 0, 1]]), (S, 1, 1))
        sub.add_all_frames(rng.uniform(size=(S, 3) + hw).astype(np.float32))
        sub.add_all_points(rng.normal(size=(S,) + hw + (3,)) + [0, 0, 4],
                           rng.integers(0, 256, (S,) + hw + (3,),
                                        dtype=np.uint8),
                           rng.uniform(1, 10, (S,) + hw), 25.0, K)
        sub.add_all_poses(_poses(rng, S))
        H = np.eye(4)
        H[:3, :3] = _rotation(rng) * rng.uniform(0.5, 2.0)
        H[:3, 3] = rng.normal(size=3)
        H[3, :3] = rng.normal(scale=1e-3, size=3)
        sub.set_reference_homography(H)
        sub.set_frame_ids([f"rgb/{1000 + (k * frames + i) / 30:.6f}.png"
                           for i in range(frames)])
        sub.set_last_non_loop_frame_index(frames - 1)
        out.append(sub)
    return out


@pytest.mark.parametrize("stride", [1, 3])
def test_solver_viewer_hooks_match_reference(stride):
    from vggt_slam_tpu.slam.solver import Solver as RefSolver
    from vggt_slam_tpu.slam.submap import Submap as RefSubmap
    from vggt_slam_tpu_torch.slam.solver import Solver
    from vggt_slam_tpu_torch.slam.submap import Submap

    recorded = []
    for solver_cls, submap_cls, kw in (
            (RefSolver, RefSubmap, {}), (Solver, Submap, {"device": "cpu"})):
        viewer = _RecordingViewer()
        solver = solver_cls(viewer=viewer, vis_stride=stride,
                            vis_point_size=0.004, **kw)
        for sub in synthetic_submaps(submap_cls):
            solver.map.add_submap(sub)
        solver.update_all_submap_vis()
        solver.update_latest_submap_vis()
        recorded.append(viewer.calls)
        quiet = solver_cls(**kw)
        quiet.map.add_submap(sub)
        quiet.update_all_submap_vis()
        quiet.update_latest_submap_vis()
        with pytest.raises(RuntimeError, match="no viewer"):
            quiet.export_3d_scene()
    ref, port = recorded
    assert [c[0] for c in port] == ["add_point_cloud", "add_frames"] * 4
    assert port[0][2]["points"].shape[0] == port[0][2]["colors"].shape[0] > 0
    _compare_calls(ref, port)
