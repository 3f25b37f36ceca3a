"""KITTI odometry dataset reader (grayscale, cam0).

A copy of ``motioncheck_ccm_slam_tpu/utils/kitti.py`` whose ``frames()``
reads the PNGs with ``utils/png.py`` (the card's machine has no PIL). At
half resolution it downscales with ``resize_bicubic``, a numpy copy of the
filter that the JAX reader's ``Image.resize`` takes by default, so both
readers give the same frames.

It replaces the reference's KITTI launch files
(cslam/launch/KITTI/Client0_kitti.launch, cslam/conf/kitti_mono.yaml,
kitti_mono_half_res.yaml): reads a ``sequences/NN`` directory
(``image_0/%06d.png`` + ``times.txt``) and the optional ``poses/NN.txt``
ground truth (3x4 row-major T_w_cam0 per frame) for ATE evaluation.
"""
from __future__ import annotations

import glob
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from . import png


# Pillow's 8-bit resampling (libImaging/Resample.c): coefficients in fixed
# point with 22 fractional bits, each pass rounded and clipped to uint8
_PRECISION_BITS = 22


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's cubic convolution kernel, a = -0.5, support 2."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _resize_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's separable resize along ``axis`` of a uint8
    image: the kernel widened by the scale when shrinking, its taps
    normalised to sum 1 in float64 (summed in tap order), then rounded to
    fixed point; the integer sums rounded and clipped to uint8."""
    in_size = img.shape[axis]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    live = taps[None, :] < xmax[:, None]
    w = np.where(live, _bicubic(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5)
                                * (1.0 / filterscale)), 0.0)
    ww = np.zeros(out_size)
    for k in range(ksize):                 # Pillow's order of summation
        ww = ww + w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    fixed = w * (1 << _PRECISION_BITS)
    kk = np.trunc(np.where(fixed < 0, fixed - 0.5, fixed + 0.5)).astype(np.int64)
    src = np.minimum(taps[None, :] + xmin[:, None], in_size - 1)      # (out, ksize)
    moved = np.moveaxis(img, axis, 0).astype(np.int64)                # (in, ...)
    acc = np.full((out_size,) + moved.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for k in range(ksize):
        acc += moved[src[:, k]] * kk[:, k].reshape((-1,) + (1,) * (moved.ndim - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """A uint8 (H, W) or (H, W, C) image resized to (height, width) as
    Pillow's ``Image.resize((width, height))`` does with its default
    bicubic filter: the horizontal pass first, then the vertical, each
    only where the size changes."""
    if width != img.shape[1]:
        img = _resize_axis(img, width, 1)
    if height != img.shape[0]:
        img = _resize_axis(img, height, 0)
    return img


class KittiSequence:
    """One KITTI odometry sequence directory (e.g. ``.../sequences/00``)."""

    def __init__(self, root: str, poses: Optional[str] = None,
                 half_res: bool = False):
        self.root = root
        self.half_res = half_res
        self.img_dir = os.path.join(root, "image_0")
        times_path = os.path.join(root, "times.txt")
        if not os.path.isdir(self.img_dir):
            raise FileNotFoundError(self.img_dir)
        self.files = sorted(glob.glob(os.path.join(self.img_dir, "*.png")))
        if os.path.exists(times_path):
            self.times = np.loadtxt(times_path, np.float64).reshape(-1)
        else:
            # KITTI cam0 runs at 10 Hz
            self.times = np.arange(len(self.files), dtype=np.float64) * 0.1
        # ground truth: explicit path, or the standard ../../poses/NN.txt
        if poses is None:
            seq_name = os.path.basename(os.path.normpath(root))
            cand = os.path.join(os.path.dirname(os.path.dirname(
                os.path.normpath(root))), "poses", seq_name + ".txt")
            poses = cand if os.path.exists(cand) else None
        self.poses_path = poses

    def __len__(self) -> int:
        return len(self.files)

    def frames(self, start: int = 0, stop: Optional[int] = None,
               stride: int = 1) -> Iterator[Tuple[float, np.ndarray]]:
        """Yield (timestamp_s, grayscale f32 image)."""
        for i in range(start, stop if stop is not None else len(self.files),
                       stride):
            if i >= len(self.files):
                break
            arr = png.read_png(self.files[i])
            if self.half_res:
                arr = resize_bicubic(arr, arr.shape[1] // 2, arr.shape[0] // 2)
            arr = arr.astype(np.float32)
            if arr.ndim == 3:
                arr = arr.mean(-1)
            yield float(self.times[i]), arr

    def ground_truth(self) -> Optional[np.ndarray]:
        """(N, 3, 4) T_w_cam0 per frame, or None."""
        if self.poses_path is None or not os.path.exists(self.poses_path):
            return None
        flat = np.loadtxt(self.poses_path, np.float64)
        return flat.reshape(-1, 3, 4)

    def gt_positions_at(self, stamps) -> np.ndarray:
        """Ground-truth cam0 positions, interpolated at given stamps.

        KITTI ground truth is indexed by frame, not time; times.txt aligns
        frame index -> stamp, so interpolate each position channel over the
        per-frame timeline.
        """
        gt = self.ground_truth()
        if gt is None:
            raise RuntimeError("no ground-truth poses for sequence")
        n = min(len(gt), len(self.times))
        t = self.times[:n]
        pos = gt[:n, :3, 3]
        return np.stack(
            [np.interp(stamps, t, pos[:, i]) for i in range(3)], -1
        )
