"""The demo app and synth_sequence against the JAX package on the CPU:
textures within one grey level of the reference's OpenCV ones, both apps'
GLBs over one zip with the same weights and RANSAC samples (1e-4), the UI
on a gradio stub.
"""
import importlib.util
import json
import os
import struct
import sys
import tempfile
import types
import zipfile

import cv2
import numpy as np
import pytest
import torch

from vggt_slam_tpu.tools import synth_sequence as jseq
from vggt_slam_tpu_torch.tools import synth_sequence as tseq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("loop", [True, False])
def test_camera_path_exact(loop):
    np.testing.assert_array_equal(tseq.camera_path(17, 300.0, 45.0, loop),
                                  jseq.camera_path(17, 300.0, 45.0, loop))


@pytest.mark.parametrize("hw,seed,sigma", [((300, 460), 0, 3.0),
                                           ((97, 131), 5, 1.0)])
def test_make_texture_within_one_grey_level(hw, seed, sigma):
    a = jseq.make_texture(*hw, seed=seed, blur_sigma=sigma).astype(int)
    b = tseq.make_texture(*hw, seed=seed, blur_sigma=sigma)
    assert b.dtype == np.uint8 and b.shape == (*hw, 3)
    assert np.abs(a - b).max() <= 1


@pytest.mark.parametrize("tum", [False, True])
def test_generate_sequence_matches_reference(tmp_path, tum):
    kw = dict(n_frames=9, size=(160, 120), step_px=30.0, tum_layout=tum)
    ja = jseq.generate_sequence(str(tmp_path / "j"), **kw)
    tb = tseq.generate_sequence(str(tmp_path / "t"), **kw)
    assert [os.path.relpath(n, tmp_path / "t") for n in tb] == \
        [os.path.relpath(n, tmp_path / "j") for n in ja]
    for a, b in zip(ja, tb):
        assert np.abs(cv2.imread(a).astype(int) - cv2.imread(b)).max() <= 1
    if tum:
        gt = [(tmp_path / d / "groundtruth.txt").read_bytes() for d in "jt"]
        assert gt[0] == gt[1]


# The app


def _reference_app():
    spec = importlib.util.spec_from_file_location(
        "reference_app", os.path.join(REPO, "app.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def glb_accessors(path):
    """[(accessor, its values)] of a GLB's meshes."""
    data = open(path, "rb").read()
    js_len = struct.unpack_from("<I", data, 12)[0]
    gltf = json.loads(data[20:20 + js_len])
    binary = data[28 + js_len:]
    out = []
    for acc in gltf["accessors"]:
        view = gltf["bufferViews"][acc["bufferView"]]
        dt = np.float32 if acc["componentType"] == 5126 else np.uint8
        out.append((acc, np.frombuffer(binary, dt, acc["count"] * 3,
                                       view["byteOffset"]).reshape(-1, 3)))
    return out


def _zip(tmp_path, n=7):
    """n panned 56x518 PNG frames (and a text file) in a zip."""
    tex = tseq.make_texture(56, 518 + (n - 1) * 60, seed=1)
    path = str(tmp_path / "frames.zip")
    with zipfile.ZipFile(path, "w") as zf:
        for i in range(n):
            ok, png = cv2.imencode(".png", tex[:, 60 * i:60 * i + 518])
            zf.writestr(f"seq/{i:03d}.png", png.tobytes())
        zf.writestr("seq/notes.txt", "ignored")
    return path


def test_run_slam_on_the_cpu_writes_a_glb(tmp_path, monkeypatch):
    """Seeded tiny weights, two submaps: finite points, one camera's axes a
    pose (frames and the overlap), the plain kernels only; the card is
    the default and raises without one."""
    from vggt_slam_tpu_torch import app
    from vggt_slam_tpu_torch.ops import attention

    zip_path = _zip(tmp_path)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    before = dict(attention.LAUNCHES)
    acc = glb_accessors(app.run_slam(zip_path, 4, 0, 20.0, device="cpu"))
    assert [a["count"] for a, _ in acc[2:]] == [6 * 8, 6 * 8]
    assert acc[0][0]["count"] > 0 and np.isfinite(acc[0][1]).all()
    assert attention.LAUNCHES == before
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.run_slam(zip_path)


@pytest.mark.slow   # ~70 s: the reference compiles its forward and LM
def test_run_slam_matches_reference_app(tmp_path, monkeypatch):
    """Both apps over one 7-frame zip, the tiny model's weights from one
    reference npz, the reference's model at the CLI's K/V stride, the same
    RANSAC samples: the same accessor counts, points and camera axes 1e-4."""
    import jax
    import jax.numpy as jnp

    from vggt_slam_tpu import main as jmain
    from vggt_slam_tpu.models.vggt.config import VGGTConfig
    from vggt_slam_tpu.models.vggt.convert import save_checkpoint
    from vggt_slam_tpu.models.vggt.model import VGGT
    from vggt_slam_tpu.ops import homography as jhom
    from vggt_slam_tpu.ops import lie as jlie
    from vggt_slam_tpu.slam import solver as jsolver
    from vggt_slam_tpu_torch import app
    from vggt_slam_tpu_torch.ops import homography as thom
    from vggt_slam_tpu_torch.slam import solver as tsolver

    ckpt = str(tmp_path / "tiny.npz")
    model = VGGT(VGGTConfig.tiny(img_size=518, enable_point_head=False))
    save_checkpoint(jax.jit(model.init)(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 3, 56, 518))), ckpt)
    zip_path = _zip(tmp_path)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    build = jmain.build_model_fn

    def at_cli_stride(args):
        args.global_kv_stride = None        # the reference CLI's default
        return build(args)

    monkeypatch.setattr(jmain, "build_model_fn", at_cli_stride)
    samples = {}

    def indices(side, n):
        k = samples.setdefault(side, 0)
        samples[side] = k + 1
        return np.random.default_rng(100 + k).integers(0, n, (300, 5))

    def jax_ransac(X1, X2, weights=None, *, key, threshold=0.01, **_):
        idx = indices("jax", X1.shape[0])
        X1, X2 = X1.astype(jnp.float32), X2.astype(jnp.float32)
        H = jhom.estimate_3d_homography(X1[idx], X2[idx])
        err = jnp.linalg.norm(jlie.apply_homography(H, X1[None]) - X2[None],
                              axis=-1)
        w = jnp.ones(X1.shape[0]) if weights is None else weights
        inl = ((jnp.where(jnp.isfinite(err), err, jnp.inf) < threshold)
               * w[None]).sum(-1)
        return H[jnp.argmax(inl)], inl[jnp.argmax(inl)]

    def torch_ransac(X1, X2, weights=None, **kw):
        kw.pop("generator", None)
        return thom.ransac_projective(X1, X2, weights, indices=torch.from_numpy(
            indices("torch", X1.shape[0])), **kw)

    monkeypatch.setattr(jsolver, "ransac_projective", jax_ransac)
    monkeypatch.setattr(tsolver, "ransac_projective", torch_ransac)
    args = (zip_path, 4, 0, 20.0, 25.0, "tiny", ckpt)
    want = glb_accessors(_reference_app().run_slam(*args))
    got = glb_accessors(app.run_slam(*args, device="cpu"))
    assert samples["torch"] == samples["jax"] >= 1
    assert [a["count"] for a, _ in got] == [a["count"] for a, _ in want]
    assert len(got) == 4 and want[2][0]["count"] == 6 * 8
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4)


def test_build_demo_on_a_gradio_stub(monkeypatch):
    from vggt_slam_tpu_torch import app

    made = []

    class Widget:
        def __init__(self, *a, **kw):
            self.a, self.kw = a, kw
            made.append(self)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def click(self, fn, inputs, outputs):
            self.wiring = (fn, inputs, outputs)

    gr = types.SimpleNamespace(**{k: type(k, (Widget,), {}) for k in (
        "Blocks", "Markdown", "Row", "File", "Model3D", "Slider", "Button")})
    monkeypatch.setitem(sys.modules, "gradio", gr)
    calls = []
    monkeypatch.setattr(app, "run_slam", lambda *a: calls.append(a) or "x")
    demo = app.build_demo()
    sliders = [(w.a, w.kw["value"], w.kw.get("step"), w.kw["label"])
               for w in made if type(w).__name__ == "Slider"]
    assert sliders == [((4, 32), 16, 1, "submap size"),
                       ((0, 5), 1, 1, "max loops"),
                       ((0, 150), 50, None, "min disparity (px)"),
                       ((0, 90), 25, None, "conf percentile")]
    fn, inputs, outputs = next(w for w in made if hasattr(w, "wiring")).wiring
    by_kind = {type(w).__name__: w for w in made}
    assert inputs[0] is by_kind["File"] and outputs == [by_kind["Model3D"]]
    assert [w.kw["label"] for w in inputs[1:]] == [s[3] for s in sliders]
    assert fn("z.zip", 8.0, 2.0, 30.5, 40.0) == "x"
    assert calls == [("z.zip", 8, 2, 30.5, 40.0)]
    assert type(calls[0][1]) is int and isinstance(demo, gr.Blocks)


def test_app_main_without_gradio_exits_as_reference():
    import subprocess

    code = ("import sys, runpy; sys.modules['gradio'] = None; "
            "runpy.run_path({!r}, run_name='__main__')")
    outs = [subprocess.run([sys.executable, "-c", code.format(p)], cwd=REPO,
                           capture_output=True, text=True, timeout=120)
            for p in ("app.py", "vggt_slam_tpu_torch/app.py")]
    assert [o.returncode for o in outs] == [1, 1]
    want = outs[0].stderr.strip().replace("vggt_slam_tpu.main",
                                          "vggt_slam_tpu_torch.main")
    assert outs[1].stderr.strip() == want and "gradio is not" in want
