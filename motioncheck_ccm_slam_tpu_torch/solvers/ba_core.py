"""Bundle-adjustment building blocks shared by the optimizers.

Counterpart of ``motioncheck_ccm_slam_tpu/solvers/ba_core.py``. The problem
is flat structure-of-arrays: poses Tcw (C, 4, 4), landmarks Xw (L, 3) and
observations (``BAObservations``); invalid slots carry zero weight.
Per-entity reductions are scatter-adds (``index_add_``) unless the caller
passes a segment plan (``SegmentPlan``: a gather and a masked sum, built
on the host), as the JAX package does for the TPU's serialised scatters; no
solver of the port passes one. ``SortedSegments``, the landmark sort order
of the matrix-free GBA, is a host-side numpy plan; ``sorted_seg_sum``
reduces a stream sorted by it.

Perturbation convention: left-multiplicative se3, xi = (omega, upsilon),
Tcw <- exp(xi) @ Tcw (matches ops/lie.py).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

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


class SegmentPlan(NamedTuple):
    """Gather-based segment reduction: for segment ids ``idx`` (O,) over N
    segments, ``table[n, k]`` lists the observation positions of segment n
    (padded, ``mask`` marks the real ones); ``seg_sum(plan, x)`` then does
    the reduction as a gather and a masked sum. When the ids are exactly
    ``repeat(arange(N), k)`` (a camera-major contiguous stream), ``table``
    and ``mask`` are None and ``seg_size`` is k: a reshape-sum."""

    table: Optional[torch.Tensor]   # (N, Kmax) i64 observation positions
    mask: Optional[torch.Tensor]    # (N, Kmax) bool
    seg_size: int = 0               # contiguous fast path when > 0


def build_segment_plan(idx, n: int, valid=None, device="cpu") -> SegmentPlan:
    """Host-side plan (numpy) of segment ids ``idx`` in [0, n), placed on
    ``device``. ``valid`` (O,) bool leaves invalid observations out of the
    tables (their weights are zero; the product stream parks every empty
    feature slot at landmark 0, which would otherwise set Kmax)."""
    idx = np.asarray(idx, np.int64)
    if valid is not None:
        valid = np.asarray(valid, bool)
        if valid.all():
            valid = None
    if valid is None and len(idx) and len(idx) % n == 0:
        k = len(idx) // n
        if (idx == np.repeat(np.arange(n, dtype=np.int64), k)).all():
            return SegmentPlan(None, None, seg_size=k)
    keep = np.flatnonzero(valid) if valid is not None else np.arange(len(idx), dtype=np.int64)
    idx_k = idx[keep]
    order = np.argsort(idx_k, kind="stable")
    counts = np.bincount(idx_k, minlength=n)
    kmax = max(int(counts.max()) if len(idx_k) else 1, 1)
    starts = np.zeros(n + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    pos_in_seg = np.arange(len(idx_k), dtype=np.int64) - starts[idx_k[order]]
    table = np.zeros((n, kmax), np.int64)
    mask = np.zeros((n, kmax), bool)
    table[idx_k[order], pos_in_seg] = keep[order]
    mask[idx_k[order], pos_in_seg] = True
    return SegmentPlan(torch.from_numpy(table).to(device), torch.from_numpy(mask).to(device))


def seg_sum(plan: SegmentPlan, x: torch.Tensor) -> torch.Tensor:
    """(O, ...) -> (N, ...) segment sums by the plan's gather table (or a
    reshape-sum on contiguous segments)."""
    if plan.seg_size:
        k = plan.seg_size
        return x.reshape((x.shape[0] // k, k) + x.shape[1:]).sum(1)
    g = x[plan.table]
    m = plan.mask.reshape(plan.mask.shape + (1,) * (x.dim() - 1))
    return torch.where(m, g, torch.zeros_like(g)).sum(1)


def _seg_or_scatter(plan: Optional[SegmentPlan], idx, x, n: int) -> torch.Tensor:
    if plan is not None:
        return seg_sum(plan, x)
    return _scatter_sum(idx, x, n)


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


def sorted_seg_sum(x_sorted: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """(O, ...) sorted by segment -> (N, ...) by prefix sum and boundary
    difference along axis 0 (``bounds`` (N+1,) i64 on x's device). The
    prefix sum is taken in float64, as the matrix-free GBA's ``_lm_sum_t``:
    a float32 running sum would lose a small segment's digits to the total
    before it."""
    cs = torch.cumsum(x_sorted.double(), 0)
    cs = torch.cat([torch.zeros_like(cs[:1]), cs], 0)
    return (cs[bounds[1:]] - cs[bounds[:-1]]).to(x_sorted.dtype)


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


def assemble_blocks(Jc, Jl, r, w, cam_idx, lm_idx, C: int, L: int,
                    cam_plan: Optional[SegmentPlan] = None,
                    lm_plan: Optional[SegmentPlan] = None):
    """Per-entity Hessian blocks and gradients by segment sum (gather-based
    where a plan is given, scatter-add otherwise).

    Returns:
      Hcc (C, 6, 6), bc (C, 6)  — camera diagonal blocks & gradient
      Hll (L, 3, 3), bl (L, 3)  — landmark diagonal blocks & gradient
      Wcl (O, 6, 3)             — per-observation off-diagonal blocks
    """
    wJc = Jc * w[:, None, None]
    wJl = Jl * w[:, None, None]
    Hcc = _seg_or_scatter(cam_plan, cam_idx, torch.einsum("oic,oid->ocd", wJc, Jc), C)
    Hll = _seg_or_scatter(lm_plan, lm_idx, torch.einsum("oic,oid->ocd", wJl, Jl), L)
    # gradient of 0.5 r^T W r wrt params: b = -J^T W r (we solve H dx = b)
    bc = _seg_or_scatter(cam_plan, cam_idx, -torch.einsum("oic,oi->oc", wJc, r), C)
    bl = _seg_or_scatter(lm_plan, lm_idx, -torch.einsum("oic,oi->oc", wJl, r), L)
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
