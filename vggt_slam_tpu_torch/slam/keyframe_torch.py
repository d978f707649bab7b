"""Shi-Tomasi corners and pyramidal Lucas-Kanade in torch (counterpart of
vggt_slam_tpu/slam/keyframe_jax.py), the reference gate's parameters (at
most 1000 corners, quality 0.01, one per 8x8 cell, 21x21 window, 3
levels, 30 iterations): corners a fixed-capacity (K, 2) array with a
mask, all tracked at once, window gathers one `grid_sample` a step.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _filter(img: torch.Tensor, k: torch.Tensor, axis: int) -> torch.Tensor:
    """1D convolution (kernel flipped, as np.convolve) of an (H, W) image
    along `axis`, with edge padding."""
    n = k.shape[0]
    pad = n // 2
    x = img[None, None]
    w = torch.flip(k, (0,)).to(img.dtype)
    if axis == 0:
        x = F.pad(x, (0, 0, pad, pad), mode="replicate")
        w = w.view(1, 1, n, 1)
    else:
        x = F.pad(x, (pad, pad, 0, 0), mode="replicate")
        w = w.view(1, 1, 1, n)
    return F.conv2d(x, w)[0, 0]


def _sep_filter(img, k):
    return _filter(_filter(img, k, 0), k, 1)


def _gauss_kernel(sigma: float, n: int, device) -> torch.Tensor:
    r = torch.arange(n, dtype=torch.float32, device=device) - (n - 1) / 2
    k = torch.exp(-0.5 * (r / sigma) ** 2)
    return k / k.sum()


def _sobel(img):
    """Central differences (I[x+1] - I[x-1]) / 2 along x and y."""
    d = torch.tensor([0.5, 0.0, -0.5], device=img.device)
    return _filter(img, d, 1), _filter(img, d, 0)


def _pyramid(img, levels: int):
    pyr = [img]
    k = _gauss_kernel(1.0, 5, img.device)
    for _ in range(levels - 1):
        pyr.append(_sep_filter(pyr[-1], k)[::2, ::2])
    return pyr


def shi_tomasi(gray: torch.Tensor, max_corners: int = 1000,
               quality: float = 0.01, cell: int = 8):
    """Corners of an (H, W) image -> (pts (K, 2) f32 (x, y), valid (K,))."""
    g = gray.float()
    gx, gy = _sobel(g)
    k = torch.full((7,), 1.0 / 7.0, device=g.device)
    Ixx = _sep_filter(gx * gx, k)
    Iyy = _sep_filter(gy * gy, k)
    Ixy = _sep_filter(gx * gy, k)
    tr = Ixx + Iyy
    det = Ixx * Iyy - Ixy * Ixy
    score = 0.5 * (tr - torch.sqrt((tr * tr - 4 * det).clamp_min(0.0)))

    H, W = g.shape
    Hc, Wc = H // cell, W // cell
    sc = score[:Hc * cell, :Wc * cell].reshape(Hc, cell, Wc, cell)
    sc = sc.permute(0, 2, 1, 3).reshape(Hc, Wc, cell * cell)
    cell_score, cell_best = sc.max(-1)
    flat = cell_score.reshape(-1)
    k_top = min(max_corners, flat.shape[0])
    top_scores, top_idx = torch.topk(flat, k_top)
    sub = cell_best.reshape(-1)[top_idx]
    py = (top_idx // Wc) * cell + sub // cell
    px = (top_idx % Wc) * cell + sub % cell
    valid = top_scores > quality * top_scores.max()
    m = 11
    valid &= (px >= m) & (px < W - m) & (py >= m) & (py < H - m)
    pts = torch.stack([px, py], dim=-1).float()
    if k_top < max_corners:
        pts = F.pad(pts, (0, 0, 0, max_corners - k_top))
        valid = F.pad(valid, (0, max_corners - k_top))
    return pts, valid


def _window(win: int, device) -> torch.Tensor:
    r = (win - 1) / 2.0
    o = torch.arange(win, dtype=torch.float32, device=device) - r
    dy, dx = torch.meshgrid(o, o, indexing="ij")
    return torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=-1)   # (w*w, 2)


def _sample(img: torch.Tensor, centers: torch.Tensor, offs: torch.Tensor):
    """Bilinear samples of (H, W) `img` at centers (K, 2) + offs (M, 2),
    coordinates clamped to the image -> (K, M)."""
    H, W = img.shape
    xy = centers[:, None, :] + offs[None]                          # (K, M, 2)
    grid = torch.stack([xy[..., 0] * (2.0 / (W - 1)) - 1.0,
                        xy[..., 1] * (2.0 / (H - 1)) - 1.0], dim=-1)
    return F.grid_sample(img[None, None], grid[None], mode="bilinear",
                         padding_mode="border", align_corners=True)[0, 0]


def lk_track(prev_gray, curr_gray, pts, valid, levels: int = 3,
             win: int = 21, iters: int = 30):
    """Pyramidal LK of pts (K, 2) from prev to curr -> (next (K, 2),
    status (K,) bool)."""
    prev = prev_gray.float()
    curr = curr_gray.float()
    pyr_p = _pyramid(prev, levels)
    pyr_c = _pyramid(curr, levels)
    H, W = prev.shape
    offs = _window(win, prev.device)
    eye = 1e-6 * torch.eye(2, device=prev.device)
    d = torch.zeros_like(pts)
    for lv in range(levels - 1, -1, -1):
        scale = 2.0 ** lv
        p_lv = pts / scale
        gx, gy = _sobel(pyr_p[lv])
        T = _sample(pyr_p[lv], p_lv, offs)
        Gx = _sample(gx, p_lv, offs)
        Gy = _sample(gy, p_lv, offs)
        gxy = (Gx * Gy).sum(-1)
        G = torch.stack([torch.stack([(Gx * Gx).sum(-1), gxy], -1),
                         torch.stack([gxy, (Gy * Gy).sum(-1)], -1)], -2)
        Ginv = torch.linalg.inv(G + eye)
        dd = d / scale
        for _ in range(iters):
            err = _sample(pyr_c[lv], p_lv + dd, offs) - T
            b = torch.stack([(err * Gx).sum(-1), (err * Gy).sum(-1)], -1)
            dd = dd - torch.einsum("kij,kj->ki", Ginv, b)
        d = dd * scale
    nxt = pts + d
    inb = (nxt[:, 0] >= 0) & (nxt[:, 0] < W) & (nxt[:, 1] >= 0) \
        & (nxt[:, 1] < H)
    return nxt, valid & inb


class LKTracker:
    """Host-facing wrapper of the FrameTracker backend protocol; the work
    runs on `device`."""

    def __init__(self, max_corners: int = 1000, device="cpu"):
        self.max_corners = max_corners
        self.device = torch.device(device)

    def _t(self, gray):
        return torch.as_tensor(np.asarray(gray)).to(self.device)

    def detect(self, gray: np.ndarray) -> np.ndarray:
        pts, valid = shi_tomasi(self._t(gray), max_corners=self.max_corners)
        pts = pts[valid].cpu().numpy()
        return pts.reshape(-1, 1, 2).astype(np.float32)

    def track(self, prev_gray, curr_gray, kf_pts):
        pts = np.asarray(kf_pts, dtype=np.float32).reshape(-1, 2)
        K = self.max_corners
        n = min(pts.shape[0], K)
        padded = np.zeros((K, 2), np.float32)
        padded[:n] = pts[:n]
        valid = np.arange(K) < n
        nxt, status = lk_track(self._t(prev_gray), self._t(curr_gray),
                               self._t(padded), self._t(valid))
        status = status[:n].cpu().numpy()
        nxt = nxt[:n].cpu().numpy()
        return pts[:n][status], nxt[status]
