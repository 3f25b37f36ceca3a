"""Sim3 pair refinement between two keyframes.

Counterpart of ``motioncheck_ccm_slam_tpu/solvers/sim3_opt.py`` (the
reference's ``Optimizer::OptimizeSim3``, src/Optimizer.cpp:867): given
matched landmarks seen by two keyframes, refine the Sim3 S12 (camera2 frame
-> camera1 frame) with bidirectional projection residuals, Huber
robustification, an outlier-removal pass, and a final inlier count the
caller gates on (>= 20 inliers accepts a loop candidate).

The Jacobian is forward-mode autodiff of the float32 residual with respect
to the 7-dof left-multiplicative sim3 perturbation (``lie.jacobian_fwd``:
one ``torch.func.jvp`` over seven copies), as the JAX package's ``jax.jacfwd``.
The LM loop is a Python loop whose accept/reject and outlier pass are
``torch.where`` on the device: no host read until the caller reads the
inlier count.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import lie

CHI2_SIM3 = 10.0  # reference th2 = 10 per direction


class Sim3OptResult(NamedTuple):
    S12: torch.Tensor       # (4, 4) refined [sR|t]
    inliers: torch.Tensor   # (N,) bool
    n_inliers: torch.Tensor  # () i64


def _project(K, pc):
    z = torch.clamp_min(pc[..., 2], 1e-6)
    u = K[0, 0] * pc[..., 0] / z + K[0, 2]
    v = K[1, 1] * pc[..., 1] / z + K[1, 2]
    return torch.stack([u, v], -1)


def _residuals(S12, X1, X2, uv1, uv2, K):
    """Bidirectional projection residuals (N, 4) and both depths.

    X1/X2: landmarks in camera-1/camera-2 frames; uv1: observation of the
    match in image 1 (paired with X2 through S12), uv2 vice versa.
    """
    S21 = lie.sim3_inv(S12)
    p1 = lie.sim3_apply(S12, X2[None])[0]
    p2 = lie.sim3_apply(S21, X1[None])[0]
    r1 = uv1 - _project(K, p1)
    r2 = uv2 - _project(K, p2)
    return torch.cat([r1, r2], -1), p1[..., 2], p2[..., 2]


def _huber_w(chi2, delta: float = 3.1623):  # sqrt(10)
    e = torch.sqrt(torch.clamp_min(chi2, 1e-12))
    return torch.where(e <= delta, 1.0, delta / e)


def _huber_rho(chi2, delta: float = 3.1623):
    e = torch.sqrt(torch.clamp_min(chi2, 1e-12))
    return torch.where(e <= delta, chi2, 2.0 * delta * e - delta * delta)


def optimize_sim3(S12_init, X1, X2, uv1, uv2, inv_sigma2_1, inv_sigma2_2, valid, K,
                  fix_scale: bool = False, iterations: int = 10,
                  outlier_pass_at: int = 5) -> Sim3OptResult:
    """Refine S12 (4, 4) [sR|t]. All arrays fixed capacity with ``valid``."""

    def res_of_xi(xi, S):
        return _residuals(lie.sim3_exp(xi[None])[0] @ S, X1, X2, uv1, uv2, K)[0]

    def res_batched(xi_b, S_b):
        """Residuals (B, N, 4) of a batch of perturbations of S."""
        return _residuals(lie.sim3_exp(xi_b) @ S_b, X1[None], X2[None], uv1[None], uv2[None],
                          K)[0]

    def jacobian(S):
        """(N, 4, 7) at xi = 0."""
        return lie.jacobian_fwd(res_batched, zero[None], S[None])[0]

    def chi2_of(r):
        c1 = torch.sum(r[:, :2] ** 2, -1) * inv_sigma2_1
        c2 = torch.sum(r[:, 2:] ** 2, -1) * inv_sigma2_2
        return c1, c2

    s_init = lie.split_sim3(S12_init)[2]
    zero = torch.zeros(7, dtype=torch.float32, device=X1.device)
    eye7 = torch.eye(7, dtype=torch.float32, device=X1.device)
    S, lam, active = S12_init, torch.tensor(1e-4, device=X1.device), valid
    for i in range(iterations):
        r = res_of_xi(zero, S)
        J = jacobian(S)                                      # (N, 4, 7)
        c1, c2 = chi2_of(r)
        # robust weights per direction
        w1 = inv_sigma2_1 * _huber_w(c1)
        w2 = inv_sigma2_2 * _huber_w(c2)
        w = active.to(torch.float32)
        W4 = torch.stack([w1 * w, w1 * w, w2 * w, w2 * w], -1)  # (N, 4)
        if fix_scale:
            J = torch.cat([J[:, :, :6], torch.zeros_like(J[:, :, 6:])], -1)
        H = torch.einsum("nif,ni,nig->fg", J, W4, J)
        b = -torch.einsum("nif,ni,ni->f", J, W4, r)
        if fix_scale:
            H = H + torch.diag(torch.cat([zero[:6], zero[:1] + 1.0]))
        else:
            # soft log-scale prior anchored at the Horn/RANSAC init: for a
            # small-baseline revisit the family (lam*s, lam*t) is a near
            # gauge freedom of two-view projections; a prior at ~1% of the
            # largest diagonal entry pins the null direction
            w_prior = 1e-2 * torch.max(torch.diagonal(H)) + 1e-6
            sigma_rel = torch.log(lie.split_sim3(S)[2] / s_init)
            H = H + eye7[6][:, None] * eye7[6][None, :] * w_prior
            b = b - eye7[6] * (w_prior * sigma_rel)
        # identity damping scaled by the largest diagonal entry (g2o's LM)
        Hd = H + eye7 * (lam * torch.max(torch.diagonal(H)) + 1e-9)
        dx = torch.linalg.solve(Hd, b)
        if fix_scale:
            dx = dx * (1.0 - eye7[6])
        S_new = lie.sim3_exp(dx[None])[0] @ S
        c1n, c2n = chi2_of(res_of_xi(zero, S_new))
        cost = torch.sum(torch.where(active, _huber_rho(c1) + _huber_rho(c2), 0.0))
        cost_new = torch.sum(torch.where(active, _huber_rho(c1n) + _huber_rho(c2n), 0.0))
        accept = cost_new < cost
        S = torch.where(accept, S_new, S)
        lam = torch.where(accept, torch.clamp_min(lam * 0.5, 1e-8),
                          torch.clamp_max(lam * 4.0, 1e4))
        # outlier pass: drop matches failing either direction
        if i == outlier_pass_at:
            c1c, c2c = chi2_of(res_of_xi(zero, S))
            active = active & (c1c <= CHI2_SIM3) & (c2c <= CHI2_SIM3)
    # final classification
    rr, z1, z2 = _residuals(S, X1, X2, uv1, uv2, K)
    c1, c2 = chi2_of(rr)
    inl = valid & active & (c1 <= CHI2_SIM3) & (c2 <= CHI2_SIM3) & (z1 > 0) & (z2 > 0)
    return Sim3OptResult(S12=S, inliers=inl, n_inliers=torch.sum(inl))
