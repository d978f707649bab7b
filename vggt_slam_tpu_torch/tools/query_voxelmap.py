"""Text-query a saved semantic voxel map (counterpart of
vggt_slam_tpu/tools/query_voxelmap.py): load semantic_voxels.npz and
frame_names.json, embed the query, rank voxels by dot product, report (and
optionally copy) the latest contributing frame of each, and optionally
highlight them in viser.

    python -m vggt_slam_tpu_torch.tools.query_voxelmap --voxel_dir DIR \
        --query "a chair" [--top_k 5] [--image_dir DIR] [--visualize] \
        [--clip_model_dir DIR [--device cuda|cpu]]
"""
from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from vggt_slam_tpu_torch.semantic.voxel_map import SemanticVoxelMap


def text_embedding(query: str, dim: int, clip_model_dir: str | None,
                   clip_backend: str = "auto", device="cuda"):
    """The CLIP or SigLIP text embedding (the text tower on `device`), or
    without a checkpoint a unit vector drawn from a generator seeded by
    Python's hash(query), which is salted per process (PYTHONHASHSEED), as
    in the reference."""
    if clip_model_dir:
        from vggt_slam_tpu_torch.semantic.embedder import \
            resolve_clip_encoders
        _, encode_text = resolve_clip_encoders(clip_model_dir, clip_backend,
                                               device)
        return encode_text([query])[0]
    rng = np.random.default_rng(abs(hash(query)) % (2 ** 31))
    v = rng.normal(size=dim).astype(np.float32)
    return v / np.linalg.norm(v)


def main(argv=None):
    """Returns [(rank, voxel index, similarity, frame name, submap id,
    frame id)]."""
    p = argparse.ArgumentParser(description="Query a semantic voxel map")
    p.add_argument("--voxel_dir", required=True)
    p.add_argument("--query", required=True)
    p.add_argument("--top_k", type=int, default=1)
    p.add_argument("--clip_model_dir", default=None)
    p.add_argument("--clip_backend", default="auto",
                   choices=["auto", "native", "hf"])
    p.add_argument("--device", default="cuda",
                   help="where the text tower runs (cuda, or cpu)")
    p.add_argument("--image_dir", default=None,
                   help="if given, copy the retrieved frame image here")
    p.add_argument("--out_dir", default="query_results")
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--voxel_port", type=int, default=8081)
    args = p.parse_args(argv)

    vm = SemanticVoxelMap.load_from_directory(args.voxel_dir)
    qe = text_embedding(args.query, vm.get_features().shape[-1],
                        args.clip_model_dir, args.clip_backend, args.device)
    idx, coords, sims = vm.query_with_embedding(qe, top_k=args.top_k)
    print(f"query: {args.query!r}")
    results = []
    for rank, (i, c, s) in enumerate(zip(idx, coords, sims)):
        name, sid, fid = vm.get_latest_frame_at_voxel(i)
        center = vm.get_centers_world()[i]
        print(f"  #{rank}: voxel {i} coord {tuple(int(x) for x in c)} "
              f"center {np.round(center, 3).tolist()} sim {s:.4f} "
              f"frame {name} (submap {sid}, frame_id {fid})")
        results.append((rank, i, s, name, sid, fid))
        if args.image_dir and name:
            src = os.path.join(args.image_dir, name)
            if os.path.exists(src):
                os.makedirs(args.out_dir, exist_ok=True)
                shutil.copy(src, os.path.join(args.out_dir,
                                              f"rank{rank}_{name}"))
    if args.visualize:
        vm.visualize(port=args.voxel_port, color_mode="query",
                     query_voxel_indices=idx)
    return results


if __name__ == "__main__":
    main()
