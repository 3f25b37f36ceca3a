"""The tracking step's last data association, worked out plainly.

At a frame's tracked pose, every valid landmark of the map is projected; a
landmark is visible when it lies 5 cm or more in front of the camera, in
the image, within its scale-invariance distances and seen within 60
degrees of its mean viewing direction. Its predicted pyramid level is
``ceil(log(max_dist / dist) / log(scale))``, and it is matched to the
keypoint of least Hamming distance among those within a square window of
4 px times the level's scale and within one level of the prediction (ties
to the lower keypoint index), if that distance is at most 100 bits (ORB's
``TH_HIGH``). A keypoint that several landmarks chose keeps the one of
least distance (ties to the lower landmark index). A pair is kept when its
reprojection error at the pose passes the chi-square gate of 5.991 at the
keypoint's level (sigma 1 px at level 0) and the point lies in front of
the camera. These are ORB-SLAM's ``SearchByProjection`` and pose
optimisation's inlier test, in float64 unless asked otherwise.

The inputs are the frame's keypoints, the map's landmarks as they stood
and the pose: what the program built, read only to work out again which
pairs a sound association holds, to judge the program's.
"""
from __future__ import annotations

import math

import torch

from .orb import hamming

TH_HIGH = 100
CHI2_MONO = 5.991
RADIUS_PX = 4.0
MIN_DEPTH_M = 0.05
MAX_VIEW_DEG = 60.0


def pairs(Tcw, mp, feats, K, width: int, height: int, scale: float, n_levels: int,
          dtype=torch.float64) -> set:
    """The (keypoint, landmark) pairs of the association at ``Tcw``.

    ``mp`` holds ``Xw``, ``desc``, ``normal``, ``min_dist``, ``max_dist``
    and ``valid``; ``feats`` holds ``xy``, ``desc``, ``octave`` and
    ``valid``; positions and the pose are computed in ``dtype``."""
    f = dtype
    T, X, Kf = Tcw.to(f), mp.Xw.to(f), K.to(f)
    R, t = T[:3, :3], T[:3, 3]
    pc = X @ R.T + t
    z = pc[:, 2]
    zs = torch.where(z.abs() > 1e-9, z, torch.ones_like(z))
    u = Kf[0, 0] * pc[:, 0] / zs + Kf[0, 2]
    v = Kf[1, 1] * pc[:, 1] / zs + Kf[1, 2]
    centre = -(R.T @ t)
    ray = X - centre
    dist = torch.linalg.norm(ray, dim=-1)
    cos_view = (ray * mp.normal.to(f)).sum(-1) / torch.clamp_min(dist, 1e-9)
    visible = (mp.valid & (z > MIN_DEPTH_M) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
               & (dist >= mp.min_dist.to(f)) & (dist <= mp.max_dist.to(f))
               & (cos_view > math.cos(math.radians(MAX_VIEW_DEG))))
    ratio = torch.clamp_min(mp.max_dist.double() / torch.clamp_min(dist.double(), 1e-9), 1e-9)
    level = torch.clamp(torch.ceil(torch.log(ratio) / math.log(scale)), 0, n_levels - 1).long()
    radius = RADIUS_PX * torch.pow(torch.full_like(ratio, scale), level.double()).to(f)

    lm = torch.nonzero(visible).squeeze(1)
    kp = torch.nonzero(feats.valid).squeeze(1)
    xy = feats.xy.to(f)
    du = (u[lm, None] - xy[None, kp, 0]).abs()
    dv = (v[lm, None] - xy[None, kp, 1]).abs()
    dl = feats.octave[None, kp].long() - level[lm, None]
    cand = (du <= radius[lm, None]) & (dv <= radius[lm, None]) & (dl >= -1) & (dl <= 1)
    li, ki = torch.nonzero(cand, as_tuple=True)
    li, ki = lm[li], kp[ki]
    d = hamming(mp.desc[li], feats.desc[ki]).long()
    n_kp, n_lm = feats.xy.shape[0] + 1, mp.Xw.shape[0] + 1
    # each landmark's keypoint of least distance, ties to the lower index
    order = torch.argsort(li * (257 * n_kp) + d * n_kp + ki)
    li, ki, d = li[order], ki[order], d[order]
    first = torch.ones_like(li, dtype=torch.bool)
    first[1:] = li[1:] != li[:-1]
    li, ki, d = li[first], ki[first], d[first]
    keep = d <= TH_HIGH
    li, ki, d = li[keep], ki[keep], d[keep]
    # each keypoint keeps the landmark of least distance, ties to the lower index
    order = torch.argsort(ki * (257 * n_lm) + d * n_lm + li)
    li, ki = li[order], ki[order]
    first = torch.ones_like(ki, dtype=torch.bool)
    first[1:] = ki[1:] != ki[:-1]
    li, ki = li[first], ki[first]
    # the inlier test at the pose
    inv_s2 = torch.pow(torch.full((n_levels,), scale, dtype=torch.float64, device=li.device),
                       -2.0 * torch.arange(n_levels, device=li.device)).to(f)
    err2 = (u[li] - xy[ki, 0]) ** 2 + (v[li] - xy[ki, 1]) ** 2
    ok = (err2 * inv_s2[feats.octave[ki].long().clamp(0, n_levels - 1)] <= CHI2_MONO) & (z[li] > 1e-6)
    return set(zip(ki[ok].tolist(), li[ok].tolist()))


def program_pairs(mp_idx: torch.Tensor) -> set:
    """The (keypoint, landmark) pairs of a frame's per-keypoint slots."""
    k = torch.nonzero(mp_idx >= 0).squeeze(1)
    return set(zip(k.tolist(), mp_idx[k].long().tolist()))
