"""SAM2's automatic mask generator in PyTorch (counterpart of
vggt_slam_tpu/semantic/sam2_amg.py) at the reference's settings: a point
grid per crop, batched multimask decodes, IoU and stability filters, box
NMS within and across overlapping crops, small-region cleanup. Statistics
and filters run on the model's device; NMS, the resizes and the connected
components (scipy.ndimage in OpenCV's label order) on the host. As the
reference, crops go to `embed_image` in 0-255.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from vggt_slam_tpu_torch.data.images import resize_linear
from vggt_slam_tpu_torch.models.sam2 import (SAM2Config, build_model,
                                             convert_torch_state_dict,
                                             init_state_dict)


def build_point_grid(n_per_side: int) -> np.ndarray:
    """n x n points in [0, 1]^2 (xy), offset half a cell."""
    offset = 1.0 / (2 * n_per_side)
    side = np.linspace(offset, 1.0 - offset, n_per_side)
    xx, yy = np.meshgrid(side, side)
    return np.stack([xx.reshape(-1), yy.reshape(-1)], axis=-1)


def generate_crop_boxes(im_hw, n_layers: int, overlap_ratio: float):
    """The full image and n_layers of overlapping 2^i x 2^i crop grids:
    (xyxy boxes, layer of each)."""
    im_h, im_w = im_hw
    boxes, layers = [[0, 0, im_w, im_h]], [0]
    for layer in range(n_layers):
        n_side = 2 ** (layer + 1)
        overlap = int(overlap_ratio * min(im_h, im_w) * (2 / n_side))
        cw, ch = (int(np.ceil((overlap * (n_side - 1) + n) / n_side))
                  for n in (im_w, im_h))
        for y0 in (int((ch - overlap) * i) for i in range(n_side)):
            for x0 in (int((cw - overlap) * i) for i in range(n_side)):
                boxes.append([x0, y0, min(x0 + cw, im_w), min(y0 + ch, im_h)])
                layers.append(layer + 1)
    return boxes, layers


def _box_iou(box, boxes):
    lo = np.maximum(box[:2], boxes[:, :2])
    hi = np.minimum(box[2:], boxes[:, 2:])
    inter = np.prod(np.clip(hi - lo, 0, None), axis=1)
    a = (box[2] - box[0]) * (box[3] - box[1])
    b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(a + b - inter, 1e-9)


def nms(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float):
    """Greedy box NMS: the kept indices, by descending score."""
    keep, alive = [], np.ones(len(boxes), bool)
    for i in np.argsort(-scores):
        if alive[i]:
            keep.append(i)
            alive &= _box_iou(boxes[i], boxes) <= iou_thresh
    return np.asarray(keep, dtype=np.int64)


def remove_small_regions(mask: np.ndarray, area_thresh: int, mode: str):
    """Drop "islands" (components) or fill "holes" below area_thresh, as
    cv2.connectedComponentsWithStats(., 8) does it for the reference: where
    every island is small, the largest stays, the first in OpenCV's order
    (by each component's first 2x2 block in raster order) on a tie."""
    from scipy import ndimage

    holes = mode == "holes"
    regions, n = ndimage.label(holes ^ mask, np.ones((3, 3), int))
    sizes = np.bincount(regions.ravel(), minlength=n + 1)[1:]
    small = np.nonzero(sizes < area_thresh)[0] + 1
    if not len(small):
        return mask, False
    if holes:
        fill = np.r_[0, small]
    else:
        fill = np.nonzero(sizes >= area_thresh)[0] + 1
        if not len(fill):
            ties = np.nonzero(sizes == sizes.max())[0] + 1
            h, w = mask.shape
            block = (np.arange(h)[:, None] // 2) * w + np.arange(w) // 2
            fill = ties[[np.argmin(ndimage.minimum(block, regions, ties))]]
    return np.isin(regions, fill), True


def decode_chunk(model, feats, points, offset: float = 1.0):
    """One chunk of points -> (masks (3C, h, w) logits, iou, stability,
    boxes (3C, 4) xyxy at mask resolution (0 where empty), areas), on the
    model's device."""
    masks, iou, _ = model.decode_points(feats, points)
    masks = masks.flatten(0, 1).float()
    stability = (masks > offset).sum((1, 2)).float() / \
        (masks > -offset).sum((1, 2)).clamp(min=1).float()
    binm = masks > 0
    area = binm.sum((1, 2))

    def span(hit):   # first and one past the last hit (0, 0 where none)
        idx = torch.arange(hit.shape[1], device=hit.device)
        lo = torch.where(hit, idx, hit.shape[1]).amin(1)
        return torch.where(area > 0, lo, 0), torch.where(hit, idx + 1,
                                                         0).amax(1)

    (y0, y1), (x0, x1) = span(binm.any(2)), span(binm.any(1))
    return (masks, iou.flatten().float(), stability,
            torch.stack([x0, y0, x1, y1], dim=-1), area)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


class SAM2MaskGenerator:
    """image (H, W, 3) uint8 or float RGB -> list of dicts (segmentation,
    area, bbox XYWH, predicted_iou, stability_score, crop_box), largest
    first. `seconds` accumulates the wall time of the embeds, of the
    decodes with their filters, and of the host's resizes, NMS and cleanup;
    `chunks` counts the decodes."""

    def __init__(self, model, points_per_side: int = 24,
                 points_per_batch: int = 192, pred_iou_thresh: float = 0.9,
                 stability_score_thresh: float = 0.92,
                 stability_score_offset: float = 1.0,
                 box_nms_thresh: float = 0.7, crop_n_layers: int = 1,
                 crop_nms_thresh: float = 0.7,
                 crop_overlap_ratio: float = 512 / 1500,
                 crop_n_points_downscale_factor: int = 2,
                 min_mask_region_area: int = 100):
        self.model, self.cfg = model, model.cfg
        self.device = model.no_mem_embed.device
        self.point_grids = [build_point_grid(max(
            1, points_per_side // crop_n_points_downscale_factor ** i))
            for i in range(crop_n_layers + 1)]
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.box_nms_thresh = box_nms_thresh
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio
        self.min_mask_region_area = min_mask_region_area
        self.seconds = {"embed": 0.0, "decode": 0.0, "host": 0.0}
        self.chunks = 0

    @torch.no_grad()
    def _process_crop(self, image, crop_box, layer_idx):
        x0, y0, x1, y1 = crop_box
        ch, cw = y1 - y0, x1 - x0
        S, dev = self.cfg.img_size, self.device
        t0 = time.perf_counter()
        crop = resize_linear(image[y0:y1, x0:x1], S, S)
        t1 = _sync(dev)
        feats = self.model.embed_image(
            torch.from_numpy(crop[None]).to(dev, torch.float32))
        t2 = _sync(dev)
        pts = torch.from_numpy((self.point_grids[layer_idx] * S).astype(
            np.float32)).to(dev)
        kept = []
        for s in range(0, len(pts), self.points_per_batch):
            m, i, st, bx, ar = decode_chunk(
                self.model, feats, pts[s:s + self.points_per_batch],
                self.stability_score_offset)
            keep = (i > self.pred_iou_thresh) & \
                (st >= self.stability_score_thresh) & (ar > 0)
            kept.append([t[keep].cpu().numpy() for t in (m, i, st, bx)])
            self.chunks += 1
        t3 = time.perf_counter()
        self.seconds["host"] += t1 - t0
        self.seconds["embed"] += t2 - t1
        self.seconds["decode"] += t3 - t2
        masks, ious, stabs, boxes = (np.concatenate(c) for c in zip(*kept))
        boxes = boxes.astype(np.float64)
        out, hm = [], masks.shape[1]
        for k in nms(boxes, ious, self.box_nms_thresh):
            logit = resize_linear(masks[k][..., None], cw, ch)[..., 0]
            seg = np.zeros(image.shape[:2], dtype=bool)
            seg[y0:y1, x0:x1] = logit > 0.0
            area = int(seg.sum())
            if area == 0:
                continue
            bx = boxes[k].copy()
            bx[0::2] = bx[0::2] * (cw / hm) + x0
            bx[1::2] = bx[1::2] * (ch / hm) + y0
            out.append({"segmentation": seg, "area": area,
                        "bbox": [float(bx[0]), float(bx[1]),
                                 float(bx[2] - bx[0]), float(bx[3] - bx[1])],
                        "predicted_iou": float(ious[k]),
                        "stability_score": float(stabs[k]),
                        "crop_box": list(crop_box)})
        self.seconds["host"] += time.perf_counter() - t3
        return out

    def __call__(self, image_rgb: np.ndarray):
        img = image_rgb
        if img.dtype != np.uint8:
            arr = np.asarray(img, np.float32)
            if arr.max() <= 1.5:
                arr = arr * 255.0
            img = np.clip(arr, 0, 255).astype(np.uint8)
        crop_boxes, layer_idxs = generate_crop_boxes(
            img.shape[:2], self.crop_n_layers, self.crop_overlap_ratio)
        data = []
        for cb, li in zip(crop_boxes, layer_idxs):
            data.extend(self._process_crop(img, cb, li))
        t0 = time.perf_counter()
        if len(crop_boxes) > 1 and data:
            # masks of smaller crops first: score 1 / crop area
            scores = np.asarray([1.0 / max((c[2] - c[0]) * (c[3] - c[1]), 1)
                                 for c in (d["crop_box"] for d in data)])
            data = [data[k] for k in nms(_xyxy(data), scores,
                                         self.crop_nms_thresh)]
        if self.min_mask_region_area > 0:
            data = self._postprocess_small(data)
        data.sort(key=lambda d: -d["area"])
        self.seconds["host"] += time.perf_counter() - t0
        return data

    def _postprocess_small(self, data):
        out, scores = [], []
        for d in data:
            seg, ch1 = remove_small_regions(
                d["segmentation"], self.min_mask_region_area, "holes")
            seg, ch2 = remove_small_regions(
                seg, self.min_mask_region_area, "islands")
            area = int(seg.sum())
            if area == 0:
                continue
            ys, xs = np.nonzero(seg)
            out.append(dict(d, segmentation=seg, area=area, bbox=[
                float(xs.min()), float(ys.min()),
                float(xs.max() - xs.min() + 1),
                float(ys.max() - ys.min() + 1)]))
            # changed masks score 0, so NMS drops them for unchanged ones
            scores.append(0.0 if (ch1 or ch2) else 1.0)
        if not out:
            return out
        keep = nms(_xyxy(out), np.asarray(scores), self.box_nms_thresh)
        return [out[k] for k in sorted(keep)]


def _xyxy(data):
    return np.asarray([[x, y, x + w, y + h]
                       for x, y, w, h in (d["bbox"] for d in data)])


def load_params(checkpoint_path: str, cfg: Optional[SAM2Config] = None):
    """The port's state dict of a public torch checkpoint (.pt / .pth,
    sam2.1_hiera_*.pt) or of the reference's converted .npz (flax paths)."""
    cfg = cfg or SAM2Config.base_plus()
    if checkpoint_path.endswith((".pt", ".pth")):
        sd = torch.load(checkpoint_path, map_location="cpu",
                        weights_only=True)
        return convert_torch_state_dict(sd.get("model", sd), cfg)
    with np.load(checkpoint_path) as z:
        return {k.removeprefix("params/").replace("/", "."):
                torch.from_numpy(z[k].astype(np.float32)) for k in z.files}


def make_sam2_mask_generator(checkpoint: Optional[str] = None,
                             cfg: Optional[SAM2Config] = None, seed: int = 0,
                             device="cuda", **amg_kwargs):
    """The embedder's mask generator on `device` (the card unless the CPU
    is asked for): SAM2 with the checkpoint's weights, or seeded random
    ones (`init_state_dict`), which exercise the pipeline only."""
    from vggt_slam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg = cfg or SAM2Config.base_plus()
    sd = load_params(checkpoint, cfg) if checkpoint else \
        init_state_dict(cfg, seed, dev)
    return SAM2MaskGenerator(build_model(cfg, sd, dev), **amg_kwargs)
