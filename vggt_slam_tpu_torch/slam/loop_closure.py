"""Loop-closure retrieval (counterpart of vggt_slam_tpu/slam/loop_closure.py):
L2 matching of per-frame descriptors (SALAD, models/retrieval.py) against
older submaps' frames, the current and previous submap excluded, accepted
under 0.80, at most `max_loops` kept. Without a retrieval checkpoint the
descriptors are untrusted and detection is off, as in the reference.
"""
from __future__ import annotations

import heapq
import sys
from typing import NamedTuple

import numpy as np


class LoopMatch(NamedTuple):
    similarity_score: float
    query_submap_id: int
    query_submap_frame: int
    detected_submap_id: int
    detected_submap_frame: int


class LoopMatchQueue:
    """Bounded heap over score (smaller L2 = more similar); overflow evicts
    the least similar, get_matches() returns most similar first."""

    def __init__(self, max_size: int):
        self.max_size = max_size
        self.heap: list = []

    def add(self, match: LoopMatch) -> None:
        if self.max_size <= 0:
            return
        item = (-match.similarity_score, match)
        if len(self.heap) < self.max_size:
            heapq.heappush(self.heap, item)
        else:
            heapq.heappushpop(self.heap, item)

    def get_matches(self):
        return [m for _, m in sorted(self.heap, reverse=True)]


class ImageRetrieval:
    """Descriptor extraction + loop search. `descriptor_fn`: callable
    (S, 3, H, W) float [0, 1] -> (S, D); defaults to SALAD at `input_size`
    on `device`, trusted only with a converted `checkpoint`."""

    def __init__(self, descriptor_fn=None, input_size: int = 224,
                 batch_bucket: int | None = None,
                 checkpoint: str | None = None, device="cuda"):
        self.batch_bucket = batch_bucket
        if descriptor_fn is None:
            from vggt_slam_tpu_torch.models.retrieval import \
                default_descriptor_fn
            descriptor_fn = default_descriptor_fn(
                input_size=input_size, checkpoint=checkpoint, device=device)
        self.descriptor_fn = descriptor_fn
        self.trusted = bool(getattr(self.descriptor_fn, "trusted", True))
        self._warned_untrusted = False

    def get_all_submap_embeddings(self, submap) -> np.ndarray:
        frames = np.asarray(submap.get_all_frames(), dtype=np.float32)
        S = frames.shape[0]
        if not self.trusted:
            return np.zeros((S, 1), np.float32)
        if self.batch_bucket is not None and S < self.batch_bucket:
            # one shape a run; frames are encoded independently, so the
            # zero frames do not reach the real frames' descriptors
            pad = np.zeros((self.batch_bucket - S,) + frames.shape[1:],
                           np.float32)
            frames = np.concatenate([frames, pad], axis=0)
        return np.asarray(self.descriptor_fn(frames))[:S]

    def find_loop_closures(self, map, submap,
                           max_similarity_thres: float = 0.80,
                           max_loop_closures: int = 0,
                           skip_last: bool = True):
        if not self.trusted:
            if not self._warned_untrusted:
                self._warned_untrusted = True
                print("loop closure DISABLED: retrieval descriptors are "
                      "random-init (no checkpoint); pass a converted SALAD "
                      "checkpoint to enable place recognition",
                      file=sys.stderr)
            return []
        queue = LoopMatchQueue(max_size=max_loop_closures)
        for query_id, qvec in enumerate(submap.get_all_retrieval_vectors()):
            score, best_submap, best_frame = map.retrieve_best_score_frame(
                qvec, submap.get_id(), ignore_last_submap=skip_last)
            if score < max_similarity_thres:
                queue.add(LoopMatch(score, submap.get_id(), query_id,
                                    best_submap, best_frame))
        return queue.get_matches()
