"""Projective geometry: projection, distortion, triangulation.

Counterpart of ``motioncheck_ccm_slam_tpu/ops/geometry.py`` on torch
tensors.
"""
from __future__ import annotations

import torch

_EPS = 1e-9


def project(pts_cam: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., N, 3) -> pixel coords (..., N, 2), no
    distortion (keypoints are undistorted once at extraction)."""
    z = pts_cam[..., 2:3]
    xy = pts_cam[..., :2] / torch.where(torch.abs(z) < _EPS, torch.full_like(z, _EPS), z)
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    u = fx[..., None] * xy[..., 0] + cx[..., None]
    v = fy[..., None] * xy[..., 1] + cy[..., None]
    return torch.stack([u, v], -1)


def distort_normalized(xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Apply radtan distortion to normalized coords (..., 2)."""
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], -1)


def undistort_points(uv: torch.Tensor, K: torch.Tensor, dist: torch.Tensor,
                     iters: int = 8) -> torch.Tensor:
    """Undistort pixel keypoints (..., 2) -> undistorted pixels (..., 2) by
    ``iters`` fixed-point iterations (cv::undistortPoints' scheme)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xd = (uv[..., 0] - cx) / fx
    yd = (uv[..., 1] - cy) / fy
    target = torch.stack([xd, yd], -1)
    xy = target
    for _ in range(iters):
        xy = xy + (target - distort_normalized(xy, dist))
    u = xy[..., 0] * fx + cx
    v = xy[..., 1] * fy + cy
    return torch.stack([u, v], -1)


def backproject(uv: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> normalized camera rays (..., 3) with z=1."""
    fx, fy, cx, cy = K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]
    if cx.dim():
        cx, cy = cx[..., None], cy[..., None]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return torch.stack([x, y, torch.ones_like(x)], -1)


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor,
                    uv2: torch.Tensor):
    """Linear (DLT) triangulation of correspondences.

    P1, P2 (..., 3, 4) projection matrices; uv1, uv2 (..., N, 2) pixels.
    Returns world points (..., N, 3) and the smallest singular value
    (..., N) of each point's 4x4 system.
    """
    r0 = uv1[..., 0:1, None] * P1[..., None, 2:3, :] - P1[..., None, 0:1, :]
    r1 = uv1[..., 1:2, None] * P1[..., None, 2:3, :] - P1[..., None, 1:2, :]
    r2 = uv2[..., 0:1, None] * P2[..., None, 2:3, :] - P2[..., None, 0:1, :]
    r3 = uv2[..., 1:2, None] * P2[..., None, 2:3, :] - P2[..., None, 1:2, :]
    A = torch.cat([r0, r1, r2, r3], -2)  # (..., N, 4, 4)
    # the homogeneous point is the right-singular vector of the smallest
    # singular value; its sign cancels in the division by w
    _, s, vt = torch.linalg.svd(A)
    X = vt[..., -1, :]
    w = X[..., 3]
    pts = X[..., :3] / torch.where(torch.abs(w) < _EPS, torch.full_like(w, _EPS), w)[..., None]
    return pts, s[..., -1]


def projection_matrix(K: torch.Tensor, Tcw: torch.Tensor) -> torch.Tensor:
    """K (3, 3) and Tcw (..., 4, 4) -> P = K [R|t] (..., 3, 4)."""
    return torch.einsum("ij,...jk->...ik", K, Tcw[..., :3, :])


def reprojection_chi2(pts_world, Tcw, K, uv_obs, inv_sigma2):
    """Per-observation chi2 of the reprojection error and the depth.

    pts_world (..., N, 3); Tcw (..., 4, 4); uv_obs (..., N, 2); inv_sigma2
    (..., N). Returns (chi2 (..., N), depth (..., N)).
    """
    R, t = Tcw[..., :3, :3], Tcw[..., :3, 3]
    pc = torch.einsum("...ij,...nj->...ni", R, pts_world) + t[..., None, :]
    err = project(pc, K) - uv_obs
    return torch.sum(err * err, -1) * inv_sigma2, pc[..., 2]


def parallax_cos(C1: torch.Tensor, C2: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Cosine of the parallax angle of points (..., N, 3) seen from camera
    centres C1/C2 (..., 3)."""
    v1 = pts - C1[..., None, :]
    v2 = pts - C2[..., None, :]
    n1 = torch.linalg.norm(v1, dim=-1)
    n2 = torch.linalg.norm(v2, dim=-1)
    return torch.sum(v1 * v2, -1) / torch.clamp_min(n1 * n2, _EPS)


def in_image(uv: torch.Tensor, width, height, margin: float = 0.0) -> torch.Tensor:
    return (
        (uv[..., 0] >= margin)
        & (uv[..., 0] < width - margin)
        & (uv[..., 1] >= margin)
        & (uv[..., 1] < height - margin)
    )


def camera_center(Tcw: torch.Tensor) -> torch.Tensor:
    """World-frame camera centre Ow = -R^T t from Tcw (..., 4, 4)."""
    R, t = Tcw[..., :3, :3], Tcw[..., :3, 3]
    return -torch.einsum("...ji,...j->...i", R, t)
