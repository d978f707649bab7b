"""SLAM-state checkpoint and resume (counterpart of
vggt_slam_tpu/slam/checkpoint.py, the same layout and keys, so states
cross packages): submaps' arrays, the factor graph, the anchor cloud and
the solver flags as host numpy in {dir}/manifest.json, graph.npz and
submap_{id}.npz.
"""
from __future__ import annotations

import json
import os

import numpy as np

_SUBMAP_ARRAYS = ("H_world_map", "poses", "frames", "vggt_intrinsics",
                  "retrieval_vectors", "colors", "conf", "conf_masks",
                  "pointclouds", "semantic_embeddings")


def save_state(solver, directory: str, include_frames: bool = True) -> None:
    os.makedirs(directory, exist_ok=True)
    manifest = {
        "version": 1,
        "use_point_map": solver.use_point_map,
        "use_sim3": solver.use_sim3,
        "init_conf_threshold": solver.init_conf_threshold,
        "first_edge": solver.first_edge,
        "num_loop_closures": solver.graph.num_loop_closures,
        # the loop gate's threshold and its calibration so far
        "loop_inlier_thresh": solver.loop_inlier_thresh,
        "seq_reg_fracs": list(solver._seq_reg_fracs),
        "submaps": [],
    }

    for submap in solver.map.ordered_submaps_by_key():
        arrays = {}
        for name in _SUBMAP_ARRAYS:
            val = getattr(submap, name, None)
            if val is None:
                continue
            if name in ("frames", "semantic_embeddings") and not include_frames:
                continue
            arrays[name] = np.asarray(val)
        np.savez_compressed(
            os.path.join(directory, f"submap_{submap.get_id()}.npz"), **arrays)
        manifest["submaps"].append({
            "id": submap.get_id(),
            "conf_threshold": submap.conf_threshold,
            "last_non_loop_frame_index": submap.last_non_loop_frame_index,
            "frame_ids": submap.frame_ids,
            "frame_names": submap.frame_names,
            "frame_id_to_name": submap.frame_id_to_name,
        })

    g = solver.graph
    np.savez_compressed(
        os.path.join(directory, "graph.npz"),
        node_keys=np.asarray(sorted(g._key_to_idx,
                                    key=lambda k: g._key_to_idx[k])),
        node_values=np.stack(g._values) if g._values else np.zeros((0, 4, 4)),
        bet_i=np.asarray([b[0] for b in g._between], np.int32),
        bet_j=np.asarray([b[1] for b in g._between], np.int32),
        bet_meas=np.stack([b[2] for b in g._between]) if g._between
        else np.zeros((0, 4, 4)),
        bet_sqrt_info=np.stack([b[3] for b in g._between]) if g._between
        else np.zeros((0, g.dof)),
        pri_node=np.asarray([p[0] for p in g._priors], np.int32),
        pri_meas=np.stack([p[1] for p in g._priors]) if g._priors
        else np.zeros((0, 4, 4)),
        pri_sqrt_info=np.stack([p[2] for p in g._priors]) if g._priors
        else np.zeros((0, g.dof)),
    )

    if solver.prior_pcd is not None:
        np.savez_compressed(os.path.join(directory, "anchor.npz"),
                            prior_pcd=solver.prior_pcd,
                            prior_conf=solver.prior_conf)

    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)


def load_state(directory: str, retrieval=None, device="cpu"):
    """Rebuild a Solver (and its map/graph) on `device` from a checkpoint
    directory."""
    from vggt_slam_tpu_torch.slam.solver import Solver
    from vggt_slam_tpu_torch.slam.submap import Submap

    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)

    solver = Solver(init_conf_threshold=manifest["init_conf_threshold"],
                    use_point_map=manifest["use_point_map"],
                    use_sim3=manifest["use_sim3"],
                    retrieval=retrieval,
                    loop_inlier_thresh=manifest.get("loop_inlier_thresh",
                                                    0.0), device=device)
    solver.first_edge = manifest["first_edge"]
    solver._seq_reg_fracs = [float(x)
                             for x in manifest.get("seq_reg_fracs", [])]

    for meta in manifest["submaps"]:
        sub = Submap(meta["id"])
        data = np.load(os.path.join(directory, f"submap_{meta['id']}.npz"),
                       allow_pickle=False)
        for name in data.files:
            setattr(sub, name, data[name])
        sub.conf_threshold = meta["conf_threshold"]
        sub.last_non_loop_frame_index = meta["last_non_loop_frame_index"]
        sub.frame_ids = meta["frame_ids"]
        sub.frame_names = meta["frame_names"]
        sub.frame_id_to_name = meta["frame_id_to_name"]
        solver.map.add_submap(sub)

    g = np.load(os.path.join(directory, "graph.npz"))
    for key, value in zip(g["node_keys"].tolist(), g["node_values"]):
        solver.graph.add_homography(int(key), value)
    for i, j, Z, si in zip(g["bet_i"], g["bet_j"], g["bet_meas"],
                           g["bet_sqrt_info"]):
        solver.graph._between.append((int(i), int(j), Z, si))
    for n, Z, si in zip(g["pri_node"], g["pri_meas"], g["pri_sqrt_info"]):
        solver.graph._priors.append((int(n), Z, si))
    solver.graph.num_loop_closures = manifest["num_loop_closures"]

    anchor_path = os.path.join(directory, "anchor.npz")
    if os.path.exists(anchor_path):
        a = np.load(anchor_path)
        solver.prior_pcd = a["prior_pcd"]
        solver.prior_conf = a["prior_conf"]
    return solver
