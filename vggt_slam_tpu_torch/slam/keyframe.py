"""Keyframe selection by optical-flow disparity (counterpart of
vggt_slam_tpu/slam/keyframe.py): Shi-Tomasi corners tracked with pyramidal
LK; a frame is a keyframe when the mean track displacement exceeds
`min_disparity` or fewer than 10 tracks survive.

Backends: "cv2" (host OpenCV, imported when used) and "torch" (the
on-device tracker of slam/keyframe_torch.py, which needs no OpenCV).
Frames are (H, W, 3) uint8 BGR, as an image decoder returns them.
"""
from __future__ import annotations

import numpy as np


def bgr_to_gray(image: np.ndarray) -> np.ndarray:
    """uint8 BGR -> uint8 gray with OpenCV's fixed-point BGR2GRAY weights
    (Y = (9798 R + 19235 G + 3735 B + 2^14) >> 15)."""
    if image.ndim == 2:
        return image
    x = image.astype(np.int32)
    y = (x[..., 2] * 9798 + x[..., 1] * 19235 + x[..., 0] * 3735
         + 16384) >> 15
    return y.astype(np.uint8)


class FrameTracker:
    def __init__(self, backend: str = "cv2", max_corners: int = 1000,
                 device="cpu"):
        if backend not in ("cv2", "torch"):
            raise ValueError(f"unknown keyframe backend {backend!r}")
        self.backend = backend
        self.max_corners = max_corners
        self.last_kf = None
        self.kf_pts = None
        self.kf_gray = None
        self._tracker = None
        if backend == "torch":
            from vggt_slam_tpu_torch.slam.keyframe_torch import LKTracker
            self._tracker = LKTracker(max_corners=max_corners, device=device)

    def _to_gray(self, image: np.ndarray) -> np.ndarray:
        if image.ndim == 2:
            return image
        if self.backend == "cv2":
            import cv2
            return cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)
        return bgr_to_gray(image)

    def initialize_keyframe(self, image: np.ndarray) -> None:
        self.last_kf = image
        self.kf_gray = self._to_gray(image)
        if self.backend == "torch":
            self.kf_pts = self._tracker.detect(self.kf_gray)
        else:
            import cv2
            self.kf_pts = cv2.goodFeaturesToTrack(
                self.kf_gray, maxCorners=self.max_corners, qualityLevel=0.01,
                minDistance=8, blockSize=7)

    def compute_disparity(self, image: np.ndarray, min_disparity: float,
                          visualize: bool = False) -> bool:
        """True if `image` should start/extend the keyframe set.
        `visualize` is accepted and ignored, as in the reference."""
        if self.last_kf is None or self.kf_pts is None \
                or len(self.kf_pts) < 10:
            self.initialize_keyframe(image)
            return True
        curr_gray = self._to_gray(image)
        if self.backend == "torch":
            good_kf, good_next = self._tracker.track(self.kf_gray, curr_gray,
                                                     self.kf_pts)
        else:
            import cv2
            next_pts, status, _ = cv2.calcOpticalFlowPyrLK(
                self.kf_gray, curr_gray, self.kf_pts, None, winSize=(21, 21),
                maxLevel=3, criteria=(cv2.TERM_CRITERIA_EPS
                                      | cv2.TERM_CRITERIA_COUNT, 30, 0.01))
            status = status.flatten()
            good_kf = self.kf_pts[status == 1]
            good_next = next_pts[status == 1]
        if len(good_kf) < 10:
            self.initialize_keyframe(image)
            return True
        displacement = np.linalg.norm(
            np.asarray(good_next).reshape(-1, 2)
            - np.asarray(good_kf).reshape(-1, 2), axis=1)
        if float(np.mean(displacement)) > min_disparity:
            self.initialize_keyframe(image)
            return True
        return False
