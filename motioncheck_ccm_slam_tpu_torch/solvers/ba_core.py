"""Bundle-adjustment building blocks shared by the optimizers.

Counterpart of ``motioncheck_ccm_slam_tpu/solvers/ba_core.py``. The problem
is flat structure-of-arrays: poses Tcw (C, 4, 4), landmarks Xw (L, 3) and
observations (``BAObservations``); invalid slots carry zero weight.
Per-entity reductions are scatter-adds (``index_add_``); the JAX package's
gather-based segment plans (``SegmentPlan``) exist for the TPU's serialised
scatters and are not carried over. ``SortedSegments``, the landmark sort
order of the matrix-free GBA, is a host-side numpy plan.

Perturbation convention: left-multiplicative se3, xi = (omega, upsilon),
Tcw <- exp(xi) @ Tcw (matches ops/lie.py).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import lie

CHI2_MONO = 5.991          # 2-dof 95% gate (reference Optimizer.cpp thHuberMono^2)
HUBER_DELTA = 2.447        # sqrt(5.991)


class BAObservations(NamedTuple):
    cam_idx: torch.Tensor     # (O,) i64
    lm_idx: torch.Tensor      # (O,) i64
    uv: torch.Tensor          # (O, 2) f32
    inv_sigma2: torch.Tensor  # (O,) f32
    valid: torch.Tensor       # (O,) bool


class SortedSegments(NamedTuple):
    """Segment reduction over observations pre-sorted by segment id:
    ``order`` permutes observations into sorted order once per problem;
    segment s occupies sorted positions [bounds[s], bounds[s+1])."""

    order: np.ndarray    # (O,) i64 permutation sorting obs by segment id
    bounds: np.ndarray   # (N+1,) i64 segment boundaries in sorted order


def build_sorted_segments(idx, n: int) -> SortedSegments:
    """Host-side plan (numpy) for segment ids ``idx`` in [0, n)."""
    idx = np.asarray(idx, np.int64)
    order = np.argsort(idx, kind="stable")
    bounds = np.zeros(n + 1, np.int64)
    bounds[1:] = np.cumsum(np.bincount(idx, minlength=n))
    return SortedSegments(order=order, bounds=bounds)


def reproject_residuals(Tcw, Xw, obs: BAObservations, K):
    """Residuals r = uv_meas - proj(Tcw_c Xw_l) and camera-frame points.

    Returns (r (O, 2), pc (O, 3), depth_ok (O,)).
    """
    Tc = Tcw[obs.cam_idx]
    X = Xw[obs.lm_idx]
    pc = torch.einsum("oij,oj->oi", Tc[:, :3, :3], X) + Tc[:, :3, 3]
    z = pc[:, 2]
    depth_ok = z > 1e-6
    zs = torch.where(depth_ok, z, torch.ones_like(z))
    u = K[0, 0] * pc[:, 0] / zs + K[0, 2]
    v = K[1, 1] * pc[:, 1] / zs + K[1, 2]
    return obs.uv - torch.stack([u, v], -1), pc, depth_ok


def reproject_jacobians(pc: torch.Tensor, Tcw_R: torch.Tensor, K: torch.Tensor):
    """Per-observation Jacobians of the residual r = uv - proj(pc) wrt the
    camera (6) and the landmark (3).

    pc: (O, 3) camera-frame points; Tcw_R: (O, 3, 3) rotation of each
    observation's camera. Returns (Jc (O, 2, 6), Jl (O, 2, 3)).
    """
    fx, fy = K[0, 0], K[1, 1]
    x, y, z = pc[:, 0], pc[:, 1], torch.clamp_min(pc[:, 2], 1e-6)
    iz = 1.0 / z
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    dproj = torch.stack(
        [
            torch.stack([fx * iz, zero, -fx * x * iz2], -1),
            torch.stack([zero, fy * iz, -fy * y * iz2], -1),
        ],
        -2,
    )
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    dpc_dxi = torch.cat([-lie.hat(pc), eye], -1)     # (O, 3, 6)
    Jc = -torch.einsum("oij,ojk->oik", dproj, dpc_dxi)
    Jl = -torch.einsum("oij,ojk->oik", dproj, Tcw_R)
    return Jc, Jl


def huber_weights(chi2: torch.Tensor, delta: float = HUBER_DELTA) -> torch.Tensor:
    """Huber IRLS weight per observation given unweighted chi2=r^T W r."""
    e = torch.sqrt(torch.clamp_min(chi2, 1e-12))
    return torch.where(e <= delta, torch.ones_like(e), delta / e)


def robust_obs_weights(r, obs: BAObservations, depth_ok, extra_mask=None):
    """Total scalar weight per obs: inv_sigma2 * huber * validity."""
    chi2 = torch.sum(r * r, -1) * obs.inv_sigma2
    w = obs.inv_sigma2 * huber_weights(chi2)
    m = obs.valid & depth_ok
    if extra_mask is not None:
        m = m & extra_mask
    return torch.where(m, w, torch.zeros_like(w)), chi2


def _scatter_sum(idx: torch.Tensor, x: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return out.index_add_(0, idx, x)


def assemble_blocks(Jc, Jl, r, w, cam_idx, lm_idx, C: int, L: int):
    """Per-entity Hessian blocks and gradients by scatter-add.

    Returns:
      Hcc (C, 6, 6), bc (C, 6)  — camera diagonal blocks & gradient
      Hll (L, 3, 3), bl (L, 3)  — landmark diagonal blocks & gradient
      Wcl (O, 6, 3)             — per-observation off-diagonal blocks
    """
    wJc = Jc * w[:, None, None]
    wJl = Jl * w[:, None, None]
    Hcc = _scatter_sum(cam_idx, torch.einsum("oic,oid->ocd", wJc, Jc), C)
    Hll = _scatter_sum(lm_idx, torch.einsum("oic,oid->ocd", wJl, Jl), L)
    # gradient of 0.5 r^T W r wrt params: b = -J^T W r (we solve H dx = b)
    bc = _scatter_sum(cam_idx, -torch.einsum("oic,oi->oc", wJc, r), C)
    bl = _scatter_sum(lm_idx, -torch.einsum("oic,oi->oc", wJl, r), L)
    Wcl = torch.einsum("oic,oid->ocd", wJc, Jl)     # (O, 6, 3)
    return Hcc, bc, Hll, bl, Wcl


def damp_blocks(H, lam):
    """LM damping: H + lam * diag(diag(H)) + tiny absolute floor."""
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    damp = lam * d + 1e-9
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return H + eye * damp[..., None, :]


def inv33(H, eps: float = 1e-8):
    """Batched 3x3 inverse with Tikhonov floor, by the adjugate (as the
    JAX package: ~30 elementwise ops over the batch, and on damped SPD
    blocks as accurate as LU)."""
    H = H + eps * torch.eye(3, dtype=H.dtype, device=H.device)
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    g, h, i = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    A = e * i - f * h
    B = f * g - d * i
    Cc = d * h - e * g
    det = a * A + b * B + c * Cc
    # sign-preserving floor: flooring a tiny negative determinant to +1e-30
    # would flip the inverse's sign
    det_floor = torch.where(det < 0, torch.full_like(det, -1e-30), torch.full_like(det, 1e-30))
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, det_floor, det)
    adj = torch.stack([
        torch.stack([A, c * h - b * i, b * f - c * e], -1),
        torch.stack([B, a * i - c * g, c * d - a * f], -1),
        torch.stack([Cc, b * g - a * h, a * e - b * d], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def inv66_spd(M, eps: float = 1e-8):
    """Batched 6x6 SPD inverse by the 2x2-block Schur complement of 3x3s
    (the PCG block-Jacobi preconditioner; its accuracy is uncritical)."""
    A = M[..., :3, :3]
    B = M[..., :3, 3:]
    D = M[..., 3:, 3:]
    Ai = inv33(A, eps)
    AiB = Ai @ B
    S = D - B.transpose(-1, -2) @ AiB
    Si = inv33(S, eps)
    TL = Ai + AiB @ Si @ AiB.transpose(-1, -2)
    TR = -(AiB @ Si)
    top = torch.cat([TL, TR], -1)
    bot = torch.cat([TR.transpose(-1, -2), Si], -1)
    return torch.cat([top, bot], -2)


def apply_pose_update(Tcw, dx, mask=None):
    """Tcw <- exp(dx) Tcw per camera; masked-out cameras stay fixed."""
    Tnew = lie.se3_exp(dx) @ Tcw
    if mask is not None:
        Tnew = torch.where(mask[:, None, None], Tnew, Tcw)
    return Tnew
