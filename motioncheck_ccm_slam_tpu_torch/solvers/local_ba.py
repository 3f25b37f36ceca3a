"""Local and full bundle adjustment with a dense-W Schur complement.

Counterpart of ``motioncheck_ccm_slam_tpu/solvers/local_ba.py`` (the
reference's ``Optimizer::BundleAdjustmentClient`` and
``LocalBundleAdjustmentClient``, src/Optimizer.cpp:40, :349). Landmarks are
marginalised with an explicitly materialised dense W (6C x 3L), which fits
for client-scale problems:

    S  = Hcc - (W Hll^-1) W^T          (6C x 6C, dense Cholesky)
    br = bc  - (W Hll^-1) bl
    dl = Hll^-1 (bl - W^T dc)          (per-landmark 3x3 back-substitution)

Server-scale maps go to parallel/sharded_ba.py (matrix-free tile stream).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import ba_core


class BAResult(NamedTuple):
    Tcw: torch.Tensor         # (C, 4, 4)
    Xw: torch.Tensor          # (L, 3)
    obs_inlier: torch.Tensor  # (O,) bool final classification
    cost: torch.Tensor        # () final robust cost


def _scatter_W(Wcl, cam_idx, lm_idx, C: int, L: int):
    """Scatter per-observation (6, 3) blocks into dense (6C, 3L)."""
    dev = Wcl.device
    rows = cam_idx[:, None, None] * 6 + torch.arange(6, device=dev)[None, :, None]
    cols = lm_idx[:, None, None] * 3 + torch.arange(3, device=dev)[None, None, :]
    shape = (Wcl.shape[0], 6, 3)
    W = torch.zeros((C * 6, L * 3), dtype=Wcl.dtype, device=dev)
    return W.index_put_((rows.expand(shape), cols.expand(shape)), Wcl, accumulate=True)


def _solve_schur(Hcc, bc, Hll, bl, Wcl, cam_idx, lm_idx, lam, fixed_cam):
    """One damped Schur solve. Returns (dc (C, 6), dl (L, 3))."""
    C, L = Hcc.shape[0], Hll.shape[0]
    dev, dt = Hcc.device, Hcc.dtype
    Hcc_d = ba_core.damp_blocks(Hcc, lam)
    Hll_d = ba_core.damp_blocks(Hll, lam)
    # fixed cameras: identity blocks and zero gradient (dx forced ~0)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    Hcc_d = torch.where(fixed_cam[:, None, None], eye6, Hcc_d)
    bc = torch.where(fixed_cam[:, None], torch.zeros_like(bc), bc)

    Hll_inv = ba_core.inv33(Hll_d)
    W = _scatter_W(Wcl, cam_idx, lm_idx, C, L)              # (6C, 3L)
    # zero rows of fixed cameras so S keeps them decoupled
    fixed_rows = fixed_cam.repeat_interleave(6)
    W = torch.where(fixed_rows[:, None], torch.zeros_like(W), W)
    Wb = W.reshape(C * 6, L, 3)
    Y = torch.einsum("rlj,ljk->rlk", Wb, Hll_inv).reshape(C * 6, L * 3)
    S = torch.block_diag(*Hcc_d) - Y @ W.T
    br = bc.reshape(-1) - Y @ bl.reshape(-1)
    Sd = S + 1e-7 * torch.eye(C * 6, dtype=dt, device=dev)
    chol = torch.linalg.cholesky(Sd)
    dc_flat = torch.cholesky_solve(br[:, None], chol)[:, 0]
    dc = torch.where(fixed_cam[:, None], torch.zeros_like(bc), dc_flat.reshape(C, 6))
    # back-substitute landmarks: dl = Hll^-1 (bl - W^T dc)
    dc_free = torch.where(fixed_rows, torch.zeros_like(dc_flat), dc_flat)
    rhs = bl - torch.einsum("rlk,r->lk", Wb, dc_free)
    dl = torch.einsum("ljk,lk->lj", Hll_inv, rhs)
    return dc, dl


def _robust_cost(chi2, mask):
    """Summed Huber cost over active observations."""
    d = ba_core.HUBER_DELTA
    e = torch.sqrt(torch.clamp_min(chi2, 1e-12))
    rho = torch.where(e <= d, chi2, 2.0 * d * e - d * d)
    return torch.sum(torch.where(mask, rho, torch.zeros_like(rho)))


def bundle_adjust(Tcw0, Xw0, obs: ba_core.BAObservations, K, fixed_cam,
                  fixed_lm=None, iterations: int = 10, outlier_pass_at=None,
                  chi2_thres: float = ba_core.CHI2_MONO) -> BAResult:
    """Robust LM bundle adjustment with landmarks marginalised.

    fixed_cam: (C,) bool gauge / frontier cameras that stay put;
    fixed_lm: optional (L,) bool landmarks excluded from updates;
    outlier_pass_at: optional iteration index at which observations
    failing the chi2 gate are dropped for the remaining iterations (the
    reference's two-pass 5+10 local BA). The accept/reject decision stays
    on the device.
    """
    C = Tcw0.shape[0]
    L = Xw0.shape[0]
    dev = Tcw0.device
    if fixed_lm is None:
        fixed_lm = torch.zeros((L,), dtype=torch.bool, device=dev)
    Tcw, Xw = Tcw0, Xw0
    lam = torch.tensor(1e-4, dtype=torch.float32, device=dev)
    active = torch.ones_like(obs.valid)
    eye3 = torch.eye(3, dtype=Xw.dtype, device=dev)
    for it in range(iterations):
        r, pc, depth_ok = ba_core.reproject_residuals(Tcw, Xw, obs, K)
        w, chi2 = ba_core.robust_obs_weights(r, obs, depth_ok, extra_mask=active)
        # cost counts ALL active obs: steps that push points behind the
        # camera blow up their clamped-depth residuals and are rejected
        cost = _robust_cost(chi2, obs.valid & active)
        Rm = Tcw[obs.cam_idx][:, :3, :3]
        Jc, Jl = ba_core.reproject_jacobians(pc, Rm, K)
        Hcc, bc, Hll, bl, Wcl = ba_core.assemble_blocks(
            Jc, Jl, r, w, obs.cam_idx, obs.lm_idx, C, L)
        # freeze fixed landmarks: zero gradient and W blocks, identity Hll
        bl = torch.where(fixed_lm[:, None], torch.zeros_like(bl), bl)
        Hll = torch.where(fixed_lm[:, None, None], eye3, Hll)
        Wcl = torch.where(fixed_lm[obs.lm_idx][:, None, None], torch.zeros_like(Wcl), Wcl)
        dc, dl = _solve_schur(Hcc, bc, Hll, bl, Wcl, obs.cam_idx, obs.lm_idx,
                              lam, fixed_cam)
        dl = torch.where(fixed_lm[:, None], torch.zeros_like(dl), dl)
        T_new = ba_core.apply_pose_update(Tcw, dc, mask=~fixed_cam)
        X_new = Xw + dl
        r2, _, _ = ba_core.reproject_residuals(T_new, X_new, obs, K)
        chi2_new = torch.sum(r2 * r2, -1) * obs.inv_sigma2
        accept = _robust_cost(chi2_new, obs.valid & active) < cost
        Tcw = torch.where(accept, T_new, Tcw)
        Xw = torch.where(accept, X_new, Xw)
        lam = torch.where(accept, torch.clamp_min(lam * 0.5, 1e-8),
                          torch.clamp_max(lam * 4.0, 1e4))
        if outlier_pass_at is not None and it == outlier_pass_at:
            r3, _, d3ok = ba_core.reproject_residuals(Tcw, Xw, obs, K)
            chi2_cur = torch.sum(r3 * r3, -1) * obs.inv_sigma2
            active = active & (chi2_cur <= chi2_thres) & d3ok
    # final classification against the converged state, independent of the
    # mid-run gate (an observation dropped early is re-admitted if it fits)
    r, _, depth_ok = ba_core.reproject_residuals(Tcw, Xw, obs, K)
    chi2 = torch.sum(r * r, -1) * obs.inv_sigma2
    inlier = obs.valid & (chi2 <= chi2_thres) & depth_ok
    return BAResult(Tcw=Tcw, Xw=Xw, obs_inlier=inlier, cost=_robust_cost(chi2, inlier))
