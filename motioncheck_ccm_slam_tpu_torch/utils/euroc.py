"""EuRoC MAV dataset reader (ASL folder format).

A copy of ``motioncheck_ccm_slam_tpu/utils/euroc.py`` whose ``frames()``
reads the PNGs with ``utils/png.py`` (the card's machine has no PIL).

It replaces the reference's ROS bag/topic ingestion + launch files
(cslam/launch/EuRoC/*.launch): reads ``mav0/cam0/data.csv`` timestamps and
grayscale PNGs, exposing the same (timestamp, image) stream the client
consumes. Ground truth (``state_groundtruth_estimate0``) loads for ATE
evaluation.
"""
from __future__ import annotations

import csv
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from . import png


def _read_csv(path: str):
    rows = []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            rows.append(row)
    return rows


class EurocSequence:
    """One EuRoC sequence directory (the folder containing ``mav0``)."""

    def __init__(self, root: str, cam: str = "cam0"):
        self.root = root
        self.cam_dir = os.path.join(root, "mav0", cam)
        self.data_csv = os.path.join(self.cam_dir, "data.csv")
        if not os.path.exists(self.data_csv):
            raise FileNotFoundError(self.data_csv)
        self.entries = [
            (int(r[0]), r[1]) for r in _read_csv(self.data_csv)
        ]
        self.gt_csv = os.path.join(
            root, "mav0", "state_groundtruth_estimate0", "data.csv"
        )

    def __len__(self) -> int:
        return len(self.entries)

    def frames(self, start: int = 0, stop: Optional[int] = None,
               stride: int = 1) -> Iterator[Tuple[float, np.ndarray]]:
        """Yield (timestamp_s, grayscale f32 image)."""
        for ts_ns, fname in self.entries[start:stop:stride]:
            arr = png.read_png(os.path.join(self.cam_dir, "data", fname)).astype(np.float32)
            if arr.ndim == 3:
                arr = arr.mean(-1)
            yield ts_ns * 1e-9, arr

    def ground_truth(self) -> Optional[np.ndarray]:
        """(N, 8) rows: t_s, px, py, pz, qw, qx, qy, qz (body in world)."""
        if not os.path.exists(self.gt_csv):
            return None
        rows = _read_csv(self.gt_csv)
        out = np.array(
            [[float(r[0]) * 1e-9] + [float(x) for x in r[1:8]] for r in rows],
            np.float64,
        )
        return out

    def gt_positions_at(self, stamps) -> np.ndarray:
        """Linearly interpolated ground-truth positions at given stamps."""
        gt = self.ground_truth()
        if gt is None:
            raise RuntimeError("no ground truth in sequence")
        out = np.stack(
            [np.interp(stamps, gt[:, 0], gt[:, 1 + i]) for i in range(3)], -1
        )
        return out
