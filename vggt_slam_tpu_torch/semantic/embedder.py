"""Offline dense semantic embedding (counterpart of
vggt_slam_tpu/semantic/embedder.py): each image becomes an (H, W, d)
feature map saved as `{stem}.npz` under "embedding", which the SLAM CLI
reads with --semantic_emb_dir.

A mask generator, image -> [dict(segmentation=(H, W) bool, area=int)]
(Felzenszwalb segments, a grid where g++ is missing, or with `--masker
sam2` SAM2's automatic mask generator on --device), proposes masks; each
mask's black-background box crop, (N, 3, h, w) float [0, 1], is embedded
by CLIP's or SigLIP's image tower (--clip_model_dir, on --device) or else
colour statistics under a seeded projection, and the masks are painted
largest first. Resizes are data/images.resize_linear. The transformers
(hf) backend is not ported and raises.

    python -m vggt_slam_tpu_torch.semantic.embedder --image_dir DIR \
        --out_dir DIR [--masker felzenszwalb|grid|sam2 [--sam2_checkpoint
        PT]] [--target_size N] [--clip_model_dir DIR] [--device cuda|cpu]
"""
from __future__ import annotations

import os
import warnings
from typing import Callable, Optional

import numpy as np

from vggt_slam_tpu_torch.data.images import resize_linear


def grid_mask_generator(image_rgb: np.ndarray, grid: int = 8):
    """A regular grid of square segments."""
    H, W = image_rgb.shape[:2]
    masks = []
    hs, ws = H // grid, W // grid
    for i in range(grid):
        for j in range(grid):
            seg = np.zeros((H, W), dtype=bool)
            seg[i * hs:(i + 1) * hs or H, j * ws:(j + 1) * ws or W] = True
            masks.append({"segmentation": seg, "area": int(seg.sum())})
    return masks


def felzenszwalb_mask_generator(image_rgb: np.ndarray, k: float = 300.0,
                                min_size: int = 100, sigma: float = 0.8,
                                max_masks: int = 64):
    """Graph-based segments (native C++), the largest `max_masks` of at
    least `min_size` pixels; [0, 1] images are scaled to [0, 255]."""
    from vggt_slam_tpu_torch.native import felzenszwalb as _fz

    img = image_rgb
    if img.dtype != np.float32:
        img = img.astype(np.float32)
    if img.max() <= 1.5:
        img = img * 255.0
    labels, n = _fz.segment(img, k=k, min_size=min_size, sigma=sigma)
    areas = np.bincount(labels.reshape(-1), minlength=n)
    keep = np.argsort(-areas)[:max_masks]
    return [{"segmentation": labels == lab, "area": int(areas[lab])}
            for lab in keep if areas[lab] >= min_size]


def color_hash_encoder(crops: np.ndarray, dim: int = 64) -> np.ndarray:
    """Colour mean, std and a 10-bin histogram of each crop under a seeded
    random projection, L2-normed. Not semantic."""
    stats = []
    for c in crops:
        hist = np.histogram(c, bins=10, range=(0, 1))[0] / c.size
        stats.append(np.concatenate([c.mean(axis=(1, 2)), c.std(axis=(1, 2)),
                                     hist]))
    stats = np.asarray(stats, dtype=np.float32)
    proj = np.random.default_rng(0).normal(
        size=(stats.shape[1], dim)).astype(np.float32)
    emb = stats @ proj
    return emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-8)


def hash_text_encoder(texts: list[str], dim: int = 64) -> np.ndarray:
    """Byte histograms under a seeded random projection, L2-normed: a valid
    text vector for the query machinery, in a space unrelated to
    color_hash_encoder's. Not semantic."""
    proj = np.random.default_rng(1).normal(size=(256, dim)).astype(
        np.float32)
    out = []
    for t in texts:
        hist = np.bincount(np.frombuffer(t.encode(), np.uint8),
                           minlength=256).astype(np.float32)
        out.append(hist / (np.linalg.norm(hist) + 1e-8))
    emb = np.asarray(out) @ proj
    return emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-8)


def render_masks_overlay(image_rgb: np.ndarray, masks: list,
                         alpha: float = 0.5, seed: int = 0) -> np.ndarray:
    """Each mask alpha-blended over the image in a seeded random colour:
    (H, W, 3) float [0, 1] or uint8 -> uint8 RGB."""
    img = image_rgb
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    rng = np.random.default_rng(seed)
    overlay = img.astype(np.float32).copy()
    base = img.astype(np.float32)
    for m in masks:
        seg = m["segmentation"]
        color = rng.integers(0, 256, size=3).astype(np.float32)
        overlay[seg] = (1.0 - alpha) * base[seg] + alpha * color
    return np.clip(overlay, 0, 255).astype(np.uint8)


def resolve_clip_encoders(model_dir: str, backend: str = "auto",
                          device="cuda"):
    """(encode_crops, encode_text) of a local checkpoint directory by the
    reference's rule: `native`, or `auto` on a config.json of model_type "clip"
    or "siglip", is models.clip's or models.siglip's make_encoders on `device`;
    `hf`, which `auto` takes otherwise, is not ported and raises."""
    if backend not in ("auto", "native", "hf"):
        raise ValueError(f"unknown clip backend {backend!r}")
    model_type = None
    if backend in ("auto", "native"):
        import json
        try:
            with open(os.path.join(model_dir, "config.json")) as f:
                model_type = json.load(f).get("model_type")
        except OSError:
            model_type = None
        if backend == "auto":
            backend = "native" if model_type in ("clip", "siglip") else "hf"
    if backend == "hf":
        raise ModuleNotFoundError(
            f"{model_dir} (model_type {model_type!r}) needs the hf backend, "
            f"transformers on the host, which the port does not carry",
            name="transformers")
    if model_type == "siglip":
        from vggt_slam_tpu_torch.models.siglip import make_encoders
    else:
        from vggt_slam_tpu_torch.models.clip import make_encoders
    return make_encoders(model_dir, device=device)


def default_mask_generator():
    """Felzenszwalb segments; the grid, with a warning, where the native
    segmenter does not build."""
    from vggt_slam_tpu_torch.native import felzenszwalb as _fz
    if _fz.available():
        return felzenszwalb_mask_generator
    warnings.warn("the Felzenszwalb segmenter did not build (no g++?): "
                  "proposing grid masks", RuntimeWarning, stacklevel=2)
    return grid_mask_generator


class SemanticEmbedder:
    """Dense per-pixel semantic embedding painter."""

    def __init__(self, mask_generator: Optional[Callable] = None,
                 crop_encoder: Optional[Callable] = None,
                 text_encoder: Optional[Callable] = None,
                 target_hw: tuple[int, int] = (518, 518),
                 crop_size: int = 224, bbox_expand_pct: float = 0.0):
        if bbox_expand_pct < 0:
            raise ValueError("bbox_expand_pct must be >= 0")
        self.mask_generator = mask_generator or default_mask_generator()
        # the hash fallbacks embed crops and text into unrelated spaces
        self.semantic_encoders = (crop_encoder is not None
                                  and text_encoder is not None)
        self.crop_encoder = crop_encoder or color_hash_encoder
        self.text_encoder = text_encoder or hash_text_encoder
        self.target_hw = target_hw
        self.crop_size = crop_size
        self.bbox_expand_pct = float(bbox_expand_pct)

    def _crop(self, image: np.ndarray, seg: np.ndarray) -> np.ndarray:
        """The mask's box (grown by bbox_expand_pct of its size, clamped to
        the image), pixels outside the mask black, resized to crop_size:
        (3, crop_size, crop_size) float32."""
        H, W = image.shape[:2]
        ys, xs = np.where(seg)
        y0, y1 = ys.min(), ys.max() + 1
        x0, x1 = xs.min(), xs.max() + 1
        if self.bbox_expand_pct > 0:
            ey = int(np.ceil((y1 - y0) * self.bbox_expand_pct / 2))
            ex = int(np.ceil((x1 - x0) * self.bbox_expand_pct / 2))
            y0, y1 = max(0, y0 - ey), min(H, y1 + ey)
            x0, x1 = max(0, x0 - ex), min(W, x1 + ex)
        patch = image[y0:y1, x0:x1].copy()
        patch[~seg[y0:y1, x0:x1]] = 0
        patch = resize_linear(patch, self.crop_size, self.crop_size)
        return np.transpose(patch.astype(np.float32), (2, 0, 1))

    def propose(self, image_rgb: np.ndarray):
        """(the image resized to target_hw, its masks largest first)."""
        th, tw = self.target_hw
        img = resize_linear(image_rgb, tw, th)
        return img, sorted(self.mask_generator(img), key=lambda m: -m["area"])

    def propose_and_embed(self, image_rgb: np.ndarray):
        """(resized image, masks largest first, (N, d) embeddings)."""
        img, masks = self.propose(image_rgb)
        if not masks:
            return img, [], np.zeros((0, 1), np.float32)
        crops = np.stack([self._crop(img, m["segmentation"]) for m in masks])
        return img, masks, np.asarray(self.crop_encoder(crops), np.float32)

    def best_match_from_text(self, image_rgb: np.ndarray, text_query: str):
        """(index, (H, W) segmentation at target_hw, cosine score) of the
        mask closest to the query; (-1, None, -1.0) with no masks. On the
        hash fallback encoders the score is not semantic (a warning)."""
        if not self.semantic_encoders:
            warnings.warn(
                "best_match_from_text is running on the non-semantic hash "
                "fallback encoders: the returned mask is arbitrary and the "
                "score is not a CLIP-style similarity.", RuntimeWarning,
                stacklevel=2)
        _, masks, embs = self.propose_and_embed(image_rgb)
        if not masks:
            return -1, None, -1.0
        te = np.asarray(self.text_encoder([text_query]),
                        dtype=np.float32).reshape(-1)
        te = te / (np.linalg.norm(te) + 1e-8)
        en = embs / (np.linalg.norm(embs, axis=1, keepdims=True) + 1e-8)
        sims = en @ te
        best = int(np.argmax(sims))
        return best, masks[best]["segmentation"], float(sims[best])

    def save_masks_visualization(self, image_rgb: np.ndarray,
                                 output_path: str, alpha: float = 0.5):
        """Write the masks' overlay on the resized image as a PNG."""
        from vggt_slam_tpu_torch.data.images import write_png

        img, masks = self.propose(image_rgb)
        vis = render_masks_overlay(img, masks, alpha=alpha)
        if os.path.dirname(output_path):
            os.makedirs(os.path.dirname(output_path), exist_ok=True)
        write_png(output_path, np.ascontiguousarray(vis[..., ::-1]))

    def embed_image(self, image_rgb: np.ndarray) -> np.ndarray:
        """(H, W, 3) float [0, 1] RGB -> (target_h, target_w, d); smaller
        masks, painted later, overwrite larger ones."""
        th, tw = self.target_hw
        _, masks, embs = self.propose_and_embed(image_rgb)
        if not masks:
            return np.zeros((th, tw, 1), dtype=np.float32)
        out = np.zeros((th, tw, embs.shape[-1]), dtype=np.float32)
        for m, e in zip(masks, embs):
            out[m["segmentation"]] = e
        return out

    def embed_folder_to_npz(self, image_dir: str, out_dir: str,
                            limit: int | None = None, shard_index: int = 0,
                            num_shards: int = 1,
                            mask_vis_dir: str | None = None) -> int:
        """Embed the folder's images (those with index % num_shards ==
        shard_index, skipping existing outputs) to {out_dir}/{stem}.npz,
        and with `mask_vis_dir` their {stem}.masks.png overlays. Returns
        how many were embedded."""
        from vggt_slam_tpu_torch.data.images import list_image_folder, \
            load_image

        os.makedirs(out_dir, exist_ok=True)
        names = list_image_folder(image_dir)
        if limit:
            names = names[:limit]
        done = 0
        for i, path in enumerate(names):
            if i % num_shards != shard_index:
                continue
            stem = os.path.splitext(os.path.basename(path))[0]
            out_path = os.path.join(out_dir, f"{stem}.npz")
            if os.path.exists(out_path):
                continue
            img = load_image(path)[..., ::-1].astype(np.float32) / 255.0
            np.savez_compressed(out_path, embedding=self.embed_image(img))
            if mask_vis_dir:
                self.save_masks_visualization(
                    img, os.path.join(mask_vis_dir, f"{stem}.masks.png"))
            done += 1
        return done


def _mp_worker(shard_index: int, num_shards: int, image_dir: str,
               out_dir: str, limit, clip_model_dir, target_size: int,
               clip_backend: str = "auto", device="cuda"):
    """One spawned worker: its own embedder over its shard of the folder."""
    crop_encoder = None
    if clip_model_dir:
        crop_encoder, _ = resolve_clip_encoders(clip_model_dir, clip_backend,
                                                device)
    emb = SemanticEmbedder(crop_encoder=crop_encoder,
                           target_hw=(target_size, target_size))
    n = emb.embed_folder_to_npz(image_dir, out_dir, limit=limit,
                                shard_index=shard_index,
                                num_shards=num_shards)
    print(f"[shard {shard_index}/{num_shards}] embedded {n} images")


def embed_folder_multiproc(image_dir: str, out_dir: str, num_procs: int,
                           limit=None, clip_model_dir=None,
                           target_size: int = 518,
                           clip_backend: str = "auto",
                           device="cuda") -> None:
    """The folder over `num_procs` spawned workers, round-robin."""
    import multiprocessing as mp

    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_mp_worker,
                         args=(i, num_procs, image_dir, out_dir, limit,
                               clip_model_dir, target_size, clip_backend,
                               device))
             for i in range(num_procs)]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"embedder worker(s) failed: exit codes {bad}")


def main(argv=None) -> int:
    """The CLI; returns the number of images embedded (in this process)."""
    import argparse

    p = argparse.ArgumentParser(description="Offline dense semantic embedder")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--clip_model_dir", default=None,
                   help="a local CLIP or SigLIP checkpoint dir "
                        "(transformers' files, by config.json's "
                        "model_type); the colour-hash encoder without it")
    p.add_argument("--clip_backend", default="auto",
                   choices=["auto", "native", "hf"],
                   help="native = the port's CLIP or SigLIP; hf "
                        "(transformers) is not ported: raises; auto = "
                        "native for a CLIP or SigLIP config.json")
    p.add_argument("--device", default="cuda",
                   help="where CLIP, SigLIP and SAM2 run (cuda, or cpu)")
    p.add_argument("--masker", default="auto",
                   choices=["auto", "felzenszwalb", "grid", "sam2"],
                   help="auto = felzenszwalb where the native segmenter "
                        "builds, else grid (with a warning); sam2 = SAM2's "
                        "automatic mask generator")
    p.add_argument("--sam2_checkpoint", default=None,
                   help="sam2.1_hiera_base_plus .pt or converted .npz for "
                        "--masker sam2 (seeded random weights without)")
    p.add_argument("--target_size", type=int, default=518)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--shard_index", type=int, default=0)
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--num_procs", type=int, default=1,
                   help="spawn N worker processes sharding the folder")
    p.add_argument("--mask_vis_dir", default=None,
                   help="also write {stem}.masks.png mask overlays")
    p.add_argument("--bbox_expand_pct", type=float, default=0.0)
    args = p.parse_args(argv)

    if args.num_procs > 1:     # ignores --masker, as the reference does
        embed_folder_multiproc(args.image_dir, args.out_dir, args.num_procs,
                               limit=args.limit,
                               clip_model_dir=args.clip_model_dir,
                               target_size=args.target_size,
                               clip_backend=args.clip_backend,
                               device=args.device)
        return 0
    crop_encoder = text_encoder = None
    if args.clip_model_dir:
        crop_encoder, text_encoder = resolve_clip_encoders(
            args.clip_model_dir, args.clip_backend, args.device)
    mask_generator = {"grid": grid_mask_generator,
                      "felzenszwalb": felzenszwalb_mask_generator}.get(
                          args.masker)
    if args.masker == "sam2":
        from vggt_slam_tpu_torch.semantic.sam2_amg import \
            make_sam2_mask_generator
        mask_generator = make_sam2_mask_generator(
            checkpoint=args.sam2_checkpoint, device=args.device)
    emb = SemanticEmbedder(mask_generator=mask_generator,
                           crop_encoder=crop_encoder,
                           text_encoder=text_encoder,
                           target_hw=(args.target_size, args.target_size),
                           bbox_expand_pct=args.bbox_expand_pct)
    n = emb.embed_folder_to_npz(args.image_dir, args.out_dir,
                                limit=args.limit,
                                shard_index=args.shard_index,
                                num_shards=args.num_shards,
                                mask_vis_dir=args.mask_vis_dir)
    g = emb.mask_generator
    print(f"embedded {n} images -> {args.out_dir} "
          f"(masks: {getattr(g, '__name__', type(g).__name__)})")
    return n


if __name__ == "__main__":
    main()
