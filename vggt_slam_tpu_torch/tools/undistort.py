"""Image undistortion without OpenCV (counterpart of
vggt_slam_tpu/tools/undistort.py): MetaCam's fisheye to a pinhole, EuRoC
cam0's radtan in place. Maps on the card in float64, kept as OpenCV's
CV_16SC2 (a pixel and a 1/32 fraction); the remap is cv2.remap
(INTER_LINEAR)'s fixed point, taps outside the source 0. Images through
data/images (JPEG through PIL or torchvision).

    python -m vggt_slam_tpu_torch.tools.undistort metacam --input_dir I \
        --output_dir O [--camera left] [--device cpu]
    python -m vggt_slam_tpu_torch.tools.undistort euroc --input_dir I \
        --output_dir O
"""
from __future__ import annotations

import argparse
import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from vggt_slam_tpu_torch.data.images import load_image, write_image
from vggt_slam_tpu_torch.utils.device import resolve_device


def _maps(K_new, size, device, project):
    """OpenCV's maps: each output pixel's ray (x, y) = K_new^-1 (j, i, 1),
    project(x, y) -> source (u, v); (integer (x, y) (H, W, 2), fraction
    index y * 32 + x (H, W)), int64."""
    dev = resolve_device(device)
    iR = torch.as_tensor(np.linalg.inv(K_new), device=dev)
    j = torch.arange(size[0], dtype=torch.float64, device=dev)[None]
    i = torch.arange(size[1], dtype=torch.float64, device=dev)[:, None]
    x, y, w = (j * iR[r, 0] + (i * iR[r, 1] + iR[r, 2]) for r in range(3))
    iu, iv = (torch.round(a * 32).clamp(-2**31, 2**31 - 1).long()
              for a in project(x / w, y / w))
    m1 = (torch.stack([iu >> 5, iv >> 5], -1) + 32768) % 65536 - 32768
    return m1, (iv & 31) * 32 + (iu & 31)


def fisheye_maps(K, D, K_new, size, device="cuda"):
    """cv2.fisheye.initUndistortRectifyMap(K, D, I, K_new, size, CV_16SC2)."""
    k1, k2, k3, k4, fx, fy, cx, cy = map(float, (*np.ravel(D), K[0, 0],
                                                 K[1, 1], K[0, 2], K[1, 2]))

    def project(x, y):
        r = torch.sqrt(x * x + y * y)
        th = torch.atan(r)
        t2 = th * th
        t4 = t2 * t2
        d = th * (1 + k1 * t2 + k2 * t4 + k3 * (t4 * t2) + k4 * (t4 * t4))
        s = torch.where(r == 0, 1.0, d / r)
        return fx * x * s + cx, fy * y * s + cy
    return _maps(K_new, size, device, project)


def radtan_maps(K, D, size, device="cuda"):
    """cv2.undistort's maps (the camera matrix as the new one; D = k1, k2,
    p1, p2)."""
    k1, k2, p1, p2, fx, fy, cx, cy = map(float, (*np.ravel(D)[:4], K[0, 0],
                                                 K[1, 1], K[0, 2], K[1, 2]))

    def project(x, y):
        x2, y2 = x * x, y * y
        r2, xy2 = x2 + y2, 2 * x * y
        kr = 1 + ((0 * r2 + k2) * r2 + k1) * r2
        return (fx * (x * kr + p1 * xy2 + p2 * (r2 + 2 * x2)) + cx,
                fy * (y * kr + p1 * (r2 + 2 * y2) + p2 * xy2) + cy)
    return _maps(K, size, device, project)


def remap_linear(img, m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """cv2.remap(img, m1, m2, INTER_LINEAR) on m1's device, (h, w) or (h, w,
    c) uint8: (the 2x2 taps times (32 - a or a) products times 32, summed,
    + 2^14) >> 15; taps outside the image 0."""
    src = torch.as_tensor(img, device=m1.device)
    h, w = src.shape[:2]
    pad = torch.zeros((h + 2, w + 2) + src.shape[2:], dtype=torch.int32,
                      device=m1.device)
    pad[1:-1, 1:-1] = src
    pad = pad.reshape((h + 2) * (w + 2), -1)
    ax, ay = (m2 & 31)[..., None], (m2 >> 5)[..., None]
    acc = 0
    for dy, wy in ((0, 32 - ay), (1, ay)):
        yy = (m1[..., 1] + dy).clamp(-1, h) + 1
        for dx, wx in ((0, 32 - ax), (1, ax)):
            xx = (m1[..., 0] + dx).clamp(-1, w) + 1
            acc = acc + pad[yy * (w + 2) + xx] * (wy * wx * 32)
    return ((acc + (1 << 14)) >> 15).to(torch.uint8).reshape(
        m2.shape + src.shape[2:])


@dataclass
class FisheyeModel:
    """Equidistant (Kannala-Brandt k1..k4) fisheye camera."""
    K: np.ndarray
    D: np.ndarray  # (4,)
    image_size: tuple[int, int]  # (w, h)

    def undistort_maps(self, out_size: int = 1600, fov_deg: float = 90.0,
                       device="cuda"):
        f = (out_size / 2.0) / np.tan(np.radians(fov_deg) / 2.0)
        K_new = np.array([[f, 0, out_size / 2.0], [0, f, out_size / 2.0],
                          [0, 0, 1.0]])
        return (*fisheye_maps(self.K, self.D, K_new, (out_size, out_size),
                              device), K_new)

    def undistort(self, img: np.ndarray, out_size: int = 1600,
                  fov_deg: float = 90.0, device="cuda"):
        m1, m2, K_new = self.undistort_maps(out_size, fov_deg, device)
        return remap_linear(img, m1, m2).cpu().numpy(), K_new


# MetaCam's fisheye pair and EuRoC MAV cam0, as the reference's
METACAM_LEFT = FisheyeModel(
    np.array([[1430.2, 0.0, 1500.0], [0.0, 1430.1, 1500.4], [0, 0, 1.0]]),
    np.array([-0.0043, 0.0392, -0.0378, 0.0069]), (3000, 3000))
METACAM_RIGHT = FisheyeModel(
    np.array([[1429.8, 0.0, 1500.9], [0.0, 1429.7, 1501.2], [0, 0, 1.0]]),
    np.array([-0.0041, 0.0384, -0.0370, 0.0066]), (3000, 3000))
EUROC_CAM0_K = np.array([[458.654, 0.0, 367.215], [0.0, 457.296, 248.375],
                         [0.0, 0.0, 1.0]])
EUROC_CAM0_D = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05])


def _undistort_folder(input_dir, output_dir, maps, device) -> int:
    """Each readable image of `input_dir` remapped by maps((w, h), device),
    built once a size, into `output_dir` under its own name."""
    device = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    built, n = {}, 0
    for name in sorted(os.listdir(input_dir)):
        try:
            img = load_image(os.path.join(input_dir, name))
        except (OSError, RuntimeError, ValueError):
            continue
        size = img.shape[1::-1]
        if size not in built:
            built[size] = maps(size, device)
        write_image(os.path.join(output_dir, name),
                    remap_linear(img, *built[size]).cpu().numpy())
        n += 1
    return n


def undistort_folder_fisheye(input_dir: str, output_dir: str,
                             model: FisheyeModel, out_size: int = 1600,
                             fov_deg: float = 90.0, device="cuda") -> int:
    return _undistort_folder(input_dir, output_dir, lambda size, dev: model
                             .undistort_maps(out_size, fov_deg, dev)[:2],
                             device)


def undistort_folder_radtan(input_dir: str, output_dir: str,
                            K=EUROC_CAM0_K, D=EUROC_CAM0_D,
                            device="cuda") -> int:
    return _undistort_folder(input_dir, output_dir, functools.partial(
        radtan_maps, K, D), device)


def main(argv=None):
    p = argparse.ArgumentParser(description="Image undistortion")
    sub = p.add_subparsers(dest="mode", required=True)
    pm, pe = sub.add_parser("metacam"), sub.add_parser("euroc")
    for q in (pm, pe):
        q.add_argument("--input_dir", required=True)
        q.add_argument("--output_dir", required=True)
        q.add_argument("--device", default="cuda")
    pm.add_argument("--camera", choices=["left", "right"], default="left")
    pm.add_argument("--out_size", type=int, default=1600)
    pm.add_argument("--fov_deg", type=float, default=90.0)
    a = p.parse_args(argv)
    if a.mode == "metacam":
        n = undistort_folder_fisheye(
            a.input_dir, a.output_dir,
            METACAM_LEFT if a.camera == "left" else METACAM_RIGHT,
            a.out_size, a.fov_deg, a.device)
    else:
        n = undistort_folder_radtan(a.input_dir, a.output_dir,
                                    device=a.device)
    print(f"undistorted {n} images -> {a.output_dir}")
    return n


if __name__ == "__main__":
    main()
