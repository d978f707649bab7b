"""Synthetic 3D scenes with exact multi-view ground truth (the port's copy
of vggt_slam_tpu/tools/synth3d.py): `training_batch`, tools/train_tiny.py's
data, and `write_tum_sequence`, evals/smoke_loop.py's TUM-layout
sequences.

    python -m vggt_slam_tpu_torch.tools.synth3d --out_dir DIR [--kind loop]

A textured smooth heightfield is raycast from a moving perspective camera:
frames with real parallax, exact depth and camera ground truth in the
model's conventions (world->cam extrinsics relative to frame 0, pose
encoding [t, quat wxyz, fov_h, fov_w]). The five OpenCV operations the
reference uses are numpy here: filled circles and rectangles to the pixel;
cubic resize, the Gaussian blur and bilinear remap to float32 rounding
(OpenCV sums in another order). The camera path and pose encodings are the
reference's numpy code; PNGs are data/images.write_png's.
"""
from __future__ import annotations

import argparse
import os
from dataclasses import dataclass

import numpy as np


# ---------------------------------------------------------------------------
# Image operations (OpenCV semantics, float32)
# ---------------------------------------------------------------------------


def _cubic_taps(n_src: int, n_dst: int):
    """Source indices (n_dst, 4) and float32 weights of OpenCV's
    INTER_CUBIC along one axis."""
    f = ((np.arange(n_dst) + 0.5) * (n_src / n_dst) - 0.5).astype(np.float32)
    s = np.floor(f)
    x = (f - s).astype(np.float32)
    a = np.float32(-0.75)
    one = np.float32(1.0)
    w0 = ((a * (x + one) - 5 * a) * (x + one) + 8 * a) * (x + one) - 4 * a
    w1 = ((a + 2) * x - (a + 3)) * x * x + one
    w2 = ((a + 2) * (one - x) - (a + 3)) * (one - x) * (one - x) + one
    w3 = one - w0 - w1 - w2
    idx = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3)[None],
                  0, n_src - 1)
    return idx, np.stack([w0, w1, w2, w3], -1).astype(np.float32)


def resize_cubic(src: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """cv2.resize(src, (out_w, out_h), interpolation=INTER_CUBIC) for an
    (h, w) or (h, w, c) float32 image: horizontal pass, then vertical."""
    src = np.asarray(src, np.float32)
    xi, xw = _cubic_taps(src.shape[1], out_w)
    yi, yw = _cubic_taps(src.shape[0], out_h)
    extra = (None,) * (src.ndim - 2)
    rows = sum(src[:, xi[:, k]] * xw[(None, slice(None), k) + extra]
               for k in range(4))
    return sum(rows[yi[:, k]] * yw[(slice(None), k, None) + extra]
               for k in range(4)).astype(np.float32)


def fill_circle(img: np.ndarray, center, radius: int, color) -> None:
    """cv2.circle(img, center, radius, color, -1) in place: OpenCV's
    midpoint rasterisation into horizontal spans, clipped to the image."""
    H, W = img.shape[:2]
    cx, cy = center
    color = np.asarray(color, img.dtype)

    def span(y, x0, x1):
        x0, x1 = max(x0, 0), min(x1, W - 1)
        if 0 <= y < H and x0 <= x1:
            img[y, x0:x1 + 1] = color

    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        if cx - dx < W and cx + dx >= 0 and cy - dx < H and cy + dx >= 0:
            span(cy - dy, cx - dx, cx + dx)
            span(cy + dy, cx - dx, cx + dx)
            span(cy - dx, cx - dy, cx + dy)
            span(cy + dx, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        mask = (1 if err <= 0 else 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def fill_rect(img: np.ndarray, p0, p1, color) -> None:
    """cv2.rectangle(img, p0, p1, color, -1) in place: corners inclusive,
    clipped to the image."""
    H, W = img.shape[:2]
    x0, x1 = max(p0[0], 0), min(p1[0], W - 1)
    y0, y1 = max(p0[1], 0), min(p1[1], H - 1)
    if x0 <= x1 and y0 <= y1:
        img[y0:y1 + 1, x0:x1 + 1] = np.asarray(color, img.dtype)


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(img, (0, 0), sigma) for a 2-D float32 image: kernel
    size round(8 sigma + 1) | 1, weights normalised in float64 and stored
    as float32, reflect-101 border, rows then columns."""
    from scipy.ndimage import correlate1d

    n = int(np.floor(sigma * 8 + 1 + 0.5)) | 1
    x = np.arange(n) - (n - 1) * 0.5
    k = np.exp(-0.5 / (sigma * sigma) * x * x)
    k = (k / k.sum()).astype(np.float32)
    out = correlate1d(np.asarray(img, np.float32), k, axis=1, mode="mirror")
    return correlate1d(out, k, axis=0, mode="mirror")


def _reflect(i: np.ndarray, n: int) -> np.ndarray:
    """OpenCV's BORDER_REFLECT index (fedcba|abcdef|fedcba)."""
    i = np.mod(i, 2 * n)
    return np.where(i >= n, 2 * n - 1 - i, i)


def remap_linear(src: np.ndarray, gx: np.ndarray, gy: np.ndarray):
    """cv2.remap(src, gx, gy, INTER_LINEAR, borderMode=BORDER_REFLECT) for
    an (h, w) or (h, w, c) float32 image and float32 coordinate maps."""
    h, w = src.shape[:2]
    fx, fy = np.floor(gx), np.floor(gy)
    ax = (gx - fx).astype(np.float32)
    ay = (gy - fy).astype(np.float32)
    if src.ndim == 3:
        ax, ay = ax[..., None], ay[..., None]
    x0, y0 = fx.astype(np.int64), fy.astype(np.int64)
    x1, y1 = _reflect(x0 + 1, w), _reflect(y0 + 1, h)
    x0, y0 = _reflect(x0, w), _reflect(y0, h)
    top = src[y0, x0] + (src[y0, x1] - src[y0, x0]) * ax
    bot = src[y1, x0] + (src[y1, x1] - src[y1, x0]) * ax
    return (top + (bot - top) * ay).astype(np.float32)


# ---------------------------------------------------------------------------
# Scene
# ---------------------------------------------------------------------------


@dataclass
class Scene:
    texture: np.ndarray   # (Ng, Ng, 3) float32 in [0, 1]
    elev: np.ndarray      # (Ng, Ng) float32 world-z elevation (>= 0)
    extent: float         # world half-size: X, Y in [-extent, extent]
    zbase: float          # surface plane depth at elevation 0


def make_scene(seed: int = 0, ng: int = 1536, extent: float = 2.2,
               zbase: float = 2.0, elev_amp: float = 0.25) -> Scene:
    """Procedural scene: a low-frequency colour field (distinctive
    neighbourhoods for LK), sparse high-contrast shapes (corners) and light
    noise, as the reference's make_texture, with brightness modulated by a
    smooth elevation."""
    rng = np.random.default_rng(seed)

    coarse = rng.uniform(60, 220, (10, 10, 3)).astype(np.float32)
    tex = resize_cubic(coarse, ng, ng)
    n_shapes = max(60, ng * ng // 30000)
    for _ in range(n_shapes):
        c = tuple(int(v) for v in rng.uniform(0, ng, 2))
        color = tuple(float(v) for v in rng.uniform(0, 255, 3))
        r = int(rng.uniform(ng // 90, ng // 22))
        if rng.uniform() < 0.5:
            fill_circle(tex, c, r, color)
        else:
            fill_rect(tex, (c[0] - r, c[1] - r), (c[0] + r, c[1] + r),
                      color)
    tex += rng.normal(0, 10, tex.shape).astype(np.float32)

    # Smooth elevation: coarse random field, cubic upsample, Gaussian blur.
    # Slope stays O(elev_amp / feature_size) ~ 0.5, which with |ray_xy| <~
    # 0.65 keeps the raycast fixed-point contraction factor < ~0.35.
    ecoarse = rng.uniform(0, 1, (6, 6)).astype(np.float32)
    elev = resize_cubic(ecoarse, ng, ng)
    elev = gaussian_blur(elev, ng / 48.0)
    elev -= elev.min()
    elev *= elev_amp / max(elev.max(), 1e-6)

    # Elevation shading: nearer (higher) surface slightly brighter.
    shade = 0.78 + 0.22 * (elev / max(elev.max(), 1e-6))
    tex = np.clip(tex * shade[..., None], 0, 255) / 255.0
    return Scene(texture=tex.astype(np.float32), elev=elev.astype(np.float32),
                 extent=float(extent), zbase=float(zbase))


def _world_maps(scene: Scene, X: np.ndarray, Y: np.ndarray):
    """World XY -> field pixel coords (x=col, y=row) for remap_linear."""
    ng = scene.elev.shape[0]
    sc = (ng - 1) / (2.0 * scene.extent)
    gx = (X + scene.extent) * sc
    gy = (Y + scene.extent) * sc
    return gx.astype(np.float32), gy.astype(np.float32)


def camera_intrinsics(H: int, W: int, fov_w_deg: float = 55.0) -> np.ndarray:
    """Pinhole K with square pixels, principal point at the image center."""
    f = (W / 2.0) / np.tan(np.radians(fov_w_deg) / 2.0)
    return np.array([[f, 0.0, W / 2.0],
                     [0.0, f, H / 2.0],
                     [0.0, 0.0, 1.0]], dtype=np.float64)


def rotation_rpy(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """World->cam rotation from small roll/pitch/yaw (radians) about the
    camera axes; identity = looking straight down +Z."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1.0]])
    Rx = np.array([[1.0, 0, 0], [0, cp, -sp], [0, sp, cp]])
    Ry = np.array([[cy, 0, sy], [0, 1.0, 0], [-sy, 0, cy]])
    return (Rz @ Rx @ Ry).astype(np.float64)


def render(scene: Scene, cam_center: np.ndarray, R_wc: np.ndarray,
           K: np.ndarray, image_hw: tuple[int, int], iters: int = 8):
    """Raycast one frame from camera centre `cam_center` (3,), world->cam
    `R_wc` (X_cam = R (X_w - C)), intrinsics `K`, `image_hw`. Returns rgb (H,
    W, 3) f32 [0, 1], depth (H, W) f32 (camera z) and the last iteration's max
    |s_k - s_{k-1}| (< 1e-4 in the supported regime)."""
    H, W = image_hw
    C = np.asarray(cam_center, dtype=np.float64)
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    pix = np.stack([u, v, np.ones_like(u)], axis=0).reshape(3, -1)
    rays = (R_wc.T @ np.linalg.inv(K) @ pix)  # (3, H*W); depth = s exactly
    wx = rays[0].reshape(H, W)
    wy = rays[1].reshape(H, W)
    wz = rays[2].reshape(H, W)

    s = np.full((H, W), scene.zbase - C[2], dtype=np.float64) / wz
    prev = s
    for _ in range(iters):
        prev = s
        X = C[0] + s * wx
        Y = C[1] + s * wy
        gx, gy = _world_maps(scene, X, Y)
        e = remap_linear(scene.elev, gx, gy).astype(np.float64)
        s = (scene.zbase - e - C[2]) / wz
    residual = float(np.abs(s - prev).max())

    X = C[0] + s * wx
    Y = C[1] + s * wy
    gx, gy = _world_maps(scene, X, Y)
    rgb = remap_linear(scene.texture, gx, gy)
    return rgb.astype(np.float32), s.astype(np.float32), residual


# ---------------------------------------------------------------------------
# Camera paths & ground-truth encodings
# ---------------------------------------------------------------------------


def camera_path(n: int, seed: int = 0, kind: str = "loop",
                span: float = 0.8, z_amp: float = 0.12,
                rot_deg: float = 4.0):
    """(centers (n, 3), world->cam rotations (n, 3, 3)) of a smooth random
    walk: `loop` closes near the start, `pan` sweeps across; small smooth
    roll/pitch/yaw wobbles."""
    rng = np.random.default_rng(seed + 7)
    if kind == "loop":
        # True revisit: every path term is periodic in t with period 1
        # (integer wobble frequencies) and the endpoint is excluded, so the
        # last frame sits 1/n before closure - a near-identical (but not
        # bit-identical) viewpoint to frame 0. This is what makes the
        # sequence exercise loop-closure retrieval the way the reference's
        # office_loop sample does (reference README.md:132-143).
        t = np.linspace(0.0, 1.0, n, endpoint=False)
        ang = 2 * np.pi * t
        xs = span * 0.5 * (1 - np.cos(ang)) - span * 0.25
        ys = span * 0.45 * np.sin(ang)
        z_freq = float(rng.integers(1, 3))
        rot_freqs = rng.integers(1, 3, 3).astype(np.float64)
    else:
        t = np.linspace(0.0, 1.0, n)
        xs = span * (t - 0.5)
        ys = span * 0.3 * np.sin(2 * np.pi * t)
        z_freq = rng.uniform(0.5, 1.5)
        rot_freqs = rng.uniform(0.5, 2.0, 3)
    zs = z_amp * np.sin(2 * np.pi * t * z_freq + rng.uniform(0, np.pi))
    centers = np.stack([xs, ys, zs], axis=1)

    rmax = np.radians(rot_deg)
    phases = rng.uniform(0, 2 * np.pi, 3)
    freqs = rot_freqs
    rots = []
    for ti in t:
        ang3 = rmax * np.sin(2 * np.pi * freqs * ti + phases)
        rots.append(rotation_rpy(*ang3))
    return centers, np.stack(rots, axis=0)


def extrinsics_from_path(centers: np.ndarray, rots: np.ndarray) -> np.ndarray:
    """(n, 3, 4) world->cam [R | -R C]."""
    n = centers.shape[0]
    out = np.zeros((n, 3, 4), dtype=np.float64)
    out[:, :, :3] = rots
    out[:, :, 3] = -np.einsum("nij,nj->ni", rots, centers)
    return out


def relative_to_frame0(extr: np.ndarray) -> np.ndarray:
    """Re-express world->cam extrinsics in frame 0's camera frame (the
    "VGGT world": the model predicts all cameras relative to the first
    view - reference solver.py:473-475 consumes them that way)."""
    R0 = extr[0, :, :3]
    t0 = extr[0, :, 3]
    out = np.zeros_like(extr)
    for i in range(extr.shape[0]):
        Ri = extr[i, :, :3]
        ti = extr[i, :, 3]
        Rrel = Ri @ R0.T
        out[i, :, :3] = Rrel
        out[i, :, 3] = ti - Rrel @ t0
    return out


def rotmat_to_quat_np(R: np.ndarray) -> np.ndarray:
    """(n, 3, 3) -> (n, 4) (w, x, y, z), w >= 0, in numpy."""
    R = np.asarray(R, dtype=np.float64)
    n = R.shape[0]
    q = np.zeros((n, 4))
    for i in range(n):
        m = R[i]
        tr = np.trace(m)
        cands = np.array([1 + tr, 1 + 2 * m[0, 0] - tr, 1 + 2 * m[1, 1] - tr,
                          1 + 2 * m[2, 2] - tr])
        k = int(np.argmax(cands))
        if k == 0:
            q[i] = [1 + tr, m[2, 1] - m[1, 2], m[0, 2] - m[2, 0],
                    m[1, 0] - m[0, 1]]
        elif k == 1:
            q[i] = [m[2, 1] - m[1, 2], cands[1], m[0, 1] + m[1, 0],
                    m[0, 2] + m[2, 0]]
        elif k == 2:
            q[i] = [m[0, 2] - m[2, 0], m[0, 1] + m[1, 0], cands[2],
                    m[1, 2] + m[2, 1]]
        else:
            q[i] = [m[1, 0] - m[0, 1], m[0, 2] + m[2, 0], m[1, 2] + m[2, 1],
                    cands[3]]
        q[i] /= np.linalg.norm(q[i]) + 1e-12
        if q[i, 0] < 0:
            q[i] = -q[i]
    return q


def pose_encodings(extr_rel: np.ndarray, K: np.ndarray,
                   image_hw: tuple[int, int]) -> np.ndarray:
    """(n, 9) ground-truth pose encodings [t, quat wxyz, fov_h, fov_w]
    (ops/geometry.py convention), computed host-side in numpy."""
    H, W = image_hw
    t = extr_rel[:, :, 3]
    q = rotmat_to_quat_np(extr_rel[:, :, :3])
    fy = K[1, 1]
    fx = K[0, 0]
    fov_h = 2.0 * np.arctan((H / 2.0) / fy)
    fov_w = 2.0 * np.arctan((W / 2.0) / fx)
    n = extr_rel.shape[0]
    fovs = np.broadcast_to(np.array([fov_h, fov_w]), (n, 2))
    return np.concatenate([t, q, fovs], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Consumers: training batches & TUM-layout eval sequences
# ---------------------------------------------------------------------------


def training_batch(seed: int, n_frames: int = 8,
                   image_hw: tuple[int, int] = (392, 518),
                   fov_w_deg: float = 55.0, ng: int = 1024):
    """One scene -> dict(images (S,3,H,W) f32 [0,1], pose_enc_gt (S,9),
    depth_gt (S,H,W)), parallel.train.vggt_loss's contract, on a random smooth
    path."""
    H, W = image_hw
    scene = make_scene(seed=seed, ng=ng)
    kind = "loop" if (seed % 2) else "pan"
    rng = np.random.default_rng(seed ^ 0x9E3779B9)
    centers, rots = camera_path(
        max(n_frames, 2), seed=seed, kind=kind,
        span=float(rng.uniform(0.45, 0.9)),
        z_amp=float(rng.uniform(0.0, 0.18)),
        rot_deg=float(rng.uniform(1.0, 6.0)))
    K = camera_intrinsics(H, W, fov_w_deg)

    imgs = np.zeros((n_frames, 3, H, W), np.float32)
    depths = np.zeros((n_frames, H, W), np.float32)
    for i in range(n_frames):
        rgb, depth, _ = render(scene, centers[i], rots[i], K, (H, W))
        imgs[i] = rgb.transpose(2, 0, 1)
        depths[i] = depth
    extr = extrinsics_from_path(centers[:n_frames], rots[:n_frames])
    enc = pose_encodings(relative_to_frame0(extr), K, (H, W))
    return {"images": imgs, "pose_enc_gt": enc.astype(np.float32),
            "depth_gt": depths}


def write_tum_sequence(out_dir: str, n_frames: int = 120, seed: int = 0,
                       image_hw: tuple[int, int] = (392, 518),
                       kind: str = "loop", span: float = 0.9,
                       fov_w_deg: float = 55.0, fps: float = 30.0,
                       ng: int = 1536) -> list[str]:
    """TUM-RGBD-layout sequence: rgb/<stamp>.png + groundtruth.txt, whose
    rows "t x y z qx qy qz qw" hold the cam->world pose (TUM convention;
    evals/ate.py associates and Sim3-aligns against it)."""
    from vggt_slam_tpu_torch.data.images import write_png

    H, W = image_hw
    scene = make_scene(seed=seed, ng=ng)
    centers, rots = camera_path(n_frames, seed=seed, kind=kind, span=span)
    K = camera_intrinsics(H, W, fov_w_deg)

    img_dir = os.path.join(out_dir, "rgb")
    os.makedirs(img_dir, exist_ok=True)
    names = []
    gt_rows = []
    t0 = 1000.0
    for i in range(n_frames):
        rgb, _, _ = render(scene, centers[i], rots[i], K, (H, W))
        stamp = t0 + i / fps
        name = os.path.join(img_dir, f"{stamp:.6f}.png")
        write_png(name, (rgb * 255).astype(np.uint8)[..., ::-1])
        names.append(name)
        q = rotmat_to_quat_np(rots[i].T[None])[0]  # cam->world (w, x, y, z)
        c = centers[i]
        gt_rows.append(
            f"{stamp:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
            f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}")
    with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        f.write("\n".join(gt_rows) + "\n")
    return names


def main():
    p = argparse.ArgumentParser(
        description="Generate a synthetic 3D (heightfield) TUM-layout "
                    "sequence with exact groundtruth")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--n_frames", type=int, default=120)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--kind", choices=["loop", "pan"], default="loop")
    p.add_argument("--span", type=float, default=0.9)
    p.add_argument("--size", type=int, nargs=2, default=(518, 392),
                   metavar=("W", "H"))
    args = p.parse_args()
    W, H = args.size
    names = write_tum_sequence(args.out_dir, n_frames=args.n_frames,
                               seed=args.seed, image_hw=(H, W),
                               kind=args.kind, span=args.span)
    print(f"wrote {len(names)} frames to {args.out_dir}")


if __name__ == "__main__":
    main()
