"""Batched RANSAC solvers: two-view init (H/F), PnP, Sim3.

Counterpart of ``motioncheck_ccm_slam_tpu/ops/ransac.py`` on torch tensors:

- ``initialize_two_view`` (reference src/Initializer.cpp): RANSAC over
  homography H and fundamental F with robust symmetric-transfer scores,
  model selection by score ratio (RH > 0.40 -> H), motion recovery and
  triangulation with cheirality / parallax checks;
- ``pnp_ransac`` (reference src/PnPSolver.cpp): batched DLT-PnP minimal
  solves (6 points) and a pose-only polish on the winner's inliers;
- ``sim3_ransac`` (reference src/Sim3Solver.cpp): Horn's 3-point similarity
  with a mutual reprojection inlier check.

RANSAC's adaptive early exit is a fixed batch of hypotheses scored at once
with an argmax winner. Hypotheses are drawn from a ``torch.Generator`` on
the tensors' device. The small SVDs (a batch of 256 8x9 and 16x9 systems,
one 4x4 system a correspondence) are ``torch.linalg.svd`` calls, as the JAX
package leaves them to XLA.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import lie

_EPS = 1e-9


def _sample_indices(generator: torch.Generator, n_hyp: int, set_size: int, n_pts: int,
                    weights=None) -> torch.Tensor:
    """(n_hyp, set_size) i64 random indices into [0, n_pts), drawn on the
    generator's device. Draws are independent (a collision gives a
    degenerate model that loses the vote). With ``weights`` (n_pts,) the
    draws follow them, so a 0/1 mask draws only masked points (a weight
    floor of 1e-20 keeps an all-zero mask drawable, as the JAX package's
    ``log(max(w, 1e-20))`` logits do)."""
    if weights is None:
        return torch.randint(0, n_pts, (n_hyp, set_size), generator=generator,
                             device=generator.device)
    w = torch.clamp_min(weights.to(torch.float32), 1e-20)
    return torch.multinomial(w, n_hyp * set_size, replacement=True,
                             generator=generator).reshape(n_hyp, set_size)


def _null_vectors(A: torch.Tensor) -> torch.Tensor:
    """Right-singular vectors of the smallest singular value of (..., m, n)
    systems (full V only when m < n, where the null vector is not among
    the thin ones)."""
    return torch.linalg.svd(A, full_matrices=A.shape[-2] < A.shape[-1]).Vh[..., -1, :]


def _normalize_points(uv: torch.Tensor, mask: torch.Tensor):
    """Hartley normalization over the masked set: returns (uv_norm, T (3,3))."""
    m = mask.to(uv.dtype)
    n = torch.clamp_min(torch.sum(m), 1.0)
    mean = torch.sum(uv * m[:, None], 0) / n
    mean_dev = torch.sum(torch.abs(uv - mean) * m[:, None], 0) / n
    s = 1.0 / torch.clamp_min(mean_dev, _EPS)
    z, o = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], z, -mean[0] * s[0]]),
                     torch.stack([z, s[1], -mean[1] * s[1]]),
                     torch.stack([z, z, o])])
    return (uv - mean) * s, T


# ---------------------------------------------------------------------------
# Homography / fundamental estimation (minimal DLT per hypothesis)
# ---------------------------------------------------------------------------

def _solve_h_dlt(p1: torch.Tensor, p2: torch.Tensor, w=None) -> torch.Tensor:
    """Batched 4+-point homography DLT. p1, p2 (B, S, 2) -> H (B, 3, 3).
    Optional row weights w (B, S): a least-squares refit on an inlier set."""
    B = p1.shape[0]
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)
    r2 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1)
    A = torch.cat([r1, r2], -2)  # (B, 2S, 9)
    if w is not None:
        A = A * torch.cat([w, w], -1)[..., None]
    return _null_vectors(A).reshape(B, 3, 3)


def _solve_f_8pt(p1: torch.Tensor, p2: torch.Tensor, w=None) -> torch.Tensor:
    """Batched 8-point fundamental. p1, p2 (B, S, 2) -> F (B, 3, 3) rank 2."""
    B = p1.shape[0]
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], -1)  # (B, S, 9)
    if w is not None:
        A = A * w[..., None]
    F = _null_vectors(A).reshape(B, 3, 3)
    U, s, Vt = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], -1)   # rank 2
    return U @ (s[..., None] * Vt)


def _homogeneous(uv: torch.Tensor) -> torch.Tensor:
    return torch.cat([uv, torch.ones_like(uv[:, :1])], -1)


def _score_h(H, uv1, uv2, mask, sigma2: float):
    """Robust symmetric transfer score of homographies (B, 3, 3) over all
    correspondences. Returns (score (B,), inliers (B, N))."""
    th = 5.991
    inv_s2 = 1.0 / sigma2
    Hinv = torch.linalg.inv(H)
    x1, x2 = _homogeneous(uv1), _homogeneous(uv2)

    def transfer(M, src, dst):
        p = torch.einsum("bij,nj->bni", M, src)
        w = torch.where(torch.abs(p[..., 2]) < _EPS, torch.full_like(p[..., 2], _EPS), p[..., 2])
        uv = p[..., :2] / w[..., None]
        return torch.sum((uv - dst[None, :, :2]) ** 2, -1) * inv_s2

    chi2_12 = transfer(H, x1, x2)
    chi2_21 = transfer(Hinv, x2, x1)
    in12 = (chi2_12 < th) & mask[None]
    in21 = (chi2_21 < th) & mask[None]
    zero = torch.zeros_like(chi2_12)
    score = (torch.sum(torch.where(in12, th - chi2_12, zero), -1)
             + torch.sum(torch.where(in21, th - chi2_21, zero), -1))
    return score, in12 & in21


def _score_f(F, uv1, uv2, mask, sigma2: float):
    """Robust epipolar-distance score of fundamentals (B, 3, 3)."""
    th = 3.841
    th_score = 5.991
    inv_s2 = 1.0 / sigma2
    x1, x2 = _homogeneous(uv1), _homogeneous(uv2)
    l2 = torch.einsum("bij,nj->bni", F, x1)              # line in img2
    l1 = torch.einsum("bji,nj->bni", F, x2)              # line in img1
    d2 = torch.einsum("ni,bni->bn", x2, l2) ** 2 / torch.clamp_min(
        l2[..., 0] ** 2 + l2[..., 1] ** 2, _EPS)
    d1 = torch.einsum("ni,bni->bn", x1, l1) ** 2 / torch.clamp_min(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, _EPS)
    chi2_2 = d2 * inv_s2
    chi2_1 = d1 * inv_s2
    in2 = (chi2_2 < th) & mask[None]
    in1 = (chi2_1 < th) & mask[None]
    zero = torch.zeros_like(chi2_2)
    score = (torch.sum(torch.where(in2, th_score - chi2_2, zero), -1)
             + torch.sum(torch.where(in1, th_score - chi2_1, zero), -1))
    return score, in1 & in2


# ---------------------------------------------------------------------------
# Motion recovery
# ---------------------------------------------------------------------------

def _triangulate_and_check(R, t, K, uv1, uv2, mask, sigma2: float,
                           min_parallax_cos: float = 0.99998):
    """Cheirality check of one (R, t) candidate, camera 1 at the identity.

    Returns (n_good, pts3d (N, 3), good (N,), parallax cosines (N,)).
    """
    P1 = torch.cat([K, torch.zeros_like(K[:, :1])], -1)
    P2 = K @ lie.make_T(R, t)[:3, :]
    r0 = uv1[:, 0:1, None] * P1[None, 2:3, :] - P1[None, 0:1, :]
    r1 = uv1[:, 1:2, None] * P1[None, 2:3, :] - P1[None, 1:2, :]
    r2 = uv2[:, 0:1, None] * P2[None, 2:3, :] - P2[None, 0:1, :]
    r3 = uv2[:, 1:2, None] * P2[None, 2:3, :] - P2[None, 1:2, :]
    X = _null_vectors(torch.cat([r0, r1, r2, r3], 1))   # (N, 4)
    w = torch.where(torch.abs(X[:, 3]) < _EPS, torch.full_like(X[:, 3], _EPS), X[:, 3])
    pts = X[:, :3] / w[:, None]
    z1 = pts[:, 2]
    pc2 = pts @ R.T + t
    z2 = pc2[:, 2]
    C2 = -R.T @ t
    v2 = pts - C2
    cosp = torch.sum(pts * v2, -1) / torch.clamp_min(
        torch.linalg.norm(pts, dim=-1) * torch.linalg.norm(v2, dim=-1), _EPS)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    zc1, zc2 = torch.clamp_min(z1, _EPS), torch.clamp_min(z2, _EPS)
    e1 = torch.stack([fx * pts[:, 0] / zc1 + cx, fy * pts[:, 1] / zc1 + cy], -1) - uv1
    e2 = torch.stack([fx * pc2[:, 0] / zc2 + cx, fy * pc2[:, 1] / zc2 + cy], -1) - uv2
    th2 = 4.0 * sigma2
    good = (mask & (z1 > 0) & (z2 > 0) & (cosp < min_parallax_cos)
            & (torch.sum(e1 * e1, -1) < th2) & (torch.sum(e2 * e2, -1) < th2))
    return torch.sum(good), pts, good, cosp


def _rotation_y(c: torch.Tensor, s: torch.Tensor, diag: float, sign_s: float) -> torch.Tensor:
    """[[c, 0, -sign_s s], [0, diag, 0], [s, 0, sign_s diag c]] for the
    Faugeras candidates (diag 1: d' = +d2; diag -1: d' = -d2)."""
    z = torch.zeros_like(c)
    return torch.stack([torch.stack([c, z, -sign_s * s]),
                        torch.stack([z, z + diag, z]),
                        torch.stack([s, z, diag * c])])


def _homography_motions(U, s, Vt):
    """8 (R, t) candidates from the SVD of A = K^-1 H K (Faugeras 1988, as
    in reference Initializer::ReconstructH)."""
    d1, d2, d3 = s[0], s[1], s[2]
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    den13 = torch.clamp_min(d1 * d1 - d3 * d3, _EPS)
    x1_abs = torch.sqrt(torch.clamp_min((d1 * d1 - d2 * d2) / den13, 0.0))
    x3_abs = torch.sqrt(torch.clamp_min((d2 * d2 - d3 * d3) / den13, 0.0))
    root = torch.sqrt(torch.clamp_min((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0))
    zero = torch.zeros_like(d1)

    def candidate(Rp, tp):
        t = U @ tp
        return det * (U @ Rp @ Vt), t / torch.clamp_min(torch.linalg.norm(t), _EPS)

    cands = []
    # case d' = +d2
    sin_t = root / torch.clamp_min((d1 + d3) * d2, _EPS)
    cos_t = (d2 * d2 + d1 * d3) / torch.clamp_min((d1 + d3) * d2, _EPS)
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            tp = torch.stack([e1 * x1_abs, zero, -e3 * x3_abs]) * (d1 - d3)
            cands.append(candidate(_rotation_y(cos_t, e1 * e3 * sin_t, 1.0, 1.0), tp))
    # case d' = -d2
    sin_p = root / torch.clamp_min((d1 - d3) * d2, _EPS)
    cos_p = (d1 * d3 - d2 * d2) / torch.clamp_min((d1 - d3) * d2, _EPS)
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            tp = torch.stack([e1 * x1_abs, zero, e3 * x3_abs]) * (d1 + d3)
            cands.append(candidate(_rotation_y(cos_p, e1 * e3 * sin_p, -1.0, -1.0), tp))
    return cands


class TwoViewInit(NamedTuple):
    success: torch.Tensor          # () bool
    Tcw2: torch.Tensor             # (4, 4) pose of view 2 (view 1 = identity)
    pts3d: torch.Tensor            # (N, 3) triangulated points
    good: torch.Tensor             # (N,) which correspondences triangulated well
    used_homography: torch.Tensor  # () bool


def _best_model(M, score, inl, refit, to_pixels, uv1n, uv2n, scorer, uv1, uv2, mask,
                sigma2: float):
    """The best of a hypothesis batch M (B, 3, 3), refit on its inliers
    (the reference recomputes with all inliers of the best iteration); the
    refit replaces it where it scores higher. Returns (score, model)."""
    best = torch.argmax(score)
    w = inl[best].to(uv1.dtype)
    M_ref = to_pixels(refit(uv1n[None], uv2n[None], w=w[None])[0])
    score2, _ = scorer(M_ref[None], uv1, uv2, mask, sigma2)
    better = score2[0] > score[best]
    return torch.where(better, score2[0], score[best]), torch.where(better, M_ref, M[best])


def initialize_two_view(generator: torch.Generator, uv1, uv2, mask, K, n_hyp: int = 256,
                        sigma: float = 1.0, min_triangulated: int = 50) -> TwoViewInit:
    """Monocular two-view bootstrap (reference Initializer::Initialize).

    uv1/uv2 (N, 2) matched undistorted keypoints, mask (N,) valid matches.
    Nothing here reads the device: the caller reads ``success``.
    """
    sigma2 = sigma * sigma
    N = uv1.shape[0]
    idx = _sample_indices(generator, n_hyp, 8, N, weights=mask.to(torch.float32))
    # Hartley-normalize the full sets once (the reference's Normalize())
    uv1n, T1 = _normalize_points(uv1, mask)
    uv2n, T2 = _normalize_points(uv2, mask)
    s1n, s2n = uv1n[idx], uv2n[idx]

    T2_inv = torch.linalg.inv(T2)

    def h_pixels(Hn):
        return T2_inv @ Hn @ T1

    def f_pixels(Fn):
        return T2.T @ Fn @ T1

    H = h_pixels(_solve_h_dlt(s1n, s2n))
    score_h, inl_h = _score_h(H, uv1, uv2, mask, sigma2)
    SH, H_best = _best_model(H, score_h, inl_h, _solve_h_dlt, h_pixels, uv1n, uv2n,
                             _score_h, uv1, uv2, mask, sigma2)
    F = f_pixels(_solve_f_8pt(s1n, s2n))
    score_f, inl_f = _score_f(F, uv1, uv2, mask, sigma2)
    SF, F_best = _best_model(F, score_f, inl_f, _solve_f_8pt, f_pixels, uv1n, uv2n,
                             _score_f, uv1, uv2, mask, sigma2)
    use_h = SH / torch.clamp_min(SH + SF, _EPS) > 0.40   # reference threshold

    # from F: E = K^T F K -> 4 candidates
    U, _, Vt = torch.linalg.svd(K.T @ F_best @ K)
    W = torch.zeros_like(K)
    W[0, 1], W[1, 0], W[2, 2] = -1.0, 1.0, 1.0
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))
    R2 = R2 * torch.sign(torch.linalg.det(R2))
    tu = U[:, 2] / torch.clamp_min(torch.linalg.norm(U[:, 2]), _EPS)
    f_cands = [(R1, tu), (R1, -tu), (R2, tu), (R2, -tu)]
    # from H: Faugeras decomposition of A = K^-1 H K
    Ua, sa, Vta = torch.linalg.svd(torch.linalg.inv(K) @ H_best @ K)
    cands = f_cands + _homography_motions(Ua, sa, Vta)   # 4 + 8 candidates

    n_goods, ptss, goods, par50s = [], [], [], []
    for Rc, tc in cands:
        ng, pts, good, cosp = _triangulate_and_check(Rc, tc, K, uv1, uv2, mask, sigma2)
        n_goods.append(ng)
        ptss.append(pts)
        goods.append(good)
        # parallax gate at the larger cosine of the min(50, n_good)-th best
        # point (reference CheckRT) and the median point (noise at a
        # near-zero baseline inflates exactly the best few percent)
        cos_sorted = torch.sort(torch.where(good, cosp, torch.ones_like(cosp))).values
        kth = torch.clamp(torch.clamp_max(ng, 50) - 1, 0, N - 1)
        med = torch.clamp(torch.div(ng - 1, 2, rounding_mode="floor"), 0, N - 1)
        cos_km = torch.maximum(cos_sorted[kth], cos_sorted[med])
        par50s.append(torch.rad2deg(torch.arccos(torch.clamp(cos_km, -1.0, 1.0))))
    n_goods = torch.stack(n_goods)
    par50s = torch.stack(par50s)
    # restrict to the selected model's candidates
    cand_is_f = torch.arange(len(cands), device=uv1.device) < 4
    sel = torch.where(use_h, ~cand_is_f, cand_is_f)
    n_sel = torch.where(sel, n_goods, torch.full_like(n_goods, -1))
    win = torch.argmax(n_sel)
    n_best = n_sel[win]
    # a clear winner (reference: second best < 0.75 * best) with parallax
    # above the reference's minParallax of 1 degree
    n_second = torch.sort(n_sel).values[-2]
    distinct = n_second.to(torch.float32) < 0.75 * n_best.to(torch.float32)
    success = (n_best >= min_triangulated) & distinct & (par50s[win] > 1.0)
    Rs = torch.stack([c[0] for c in cands])
    ts = torch.stack([c[1] for c in cands])
    return TwoViewInit(success=success, Tcw2=lie.make_T(Rs[win], ts[win]),
                       pts3d=torch.stack(ptss)[win], good=torch.stack(goods)[win] & success,
                       used_homography=use_h)


# ---------------------------------------------------------------------------
# PnP RANSAC
# ---------------------------------------------------------------------------

class PnPResult(NamedTuple):
    success: torch.Tensor   # () bool
    Tcw: torch.Tensor       # (4, 4)
    inliers: torch.Tensor   # (N,) bool


def _dlt_pnp(Xw, uv, K):
    """Batched DLT pose from (B, S, 3) points and (B, S, 2) pixels: P =
    [R|t] up to scale by SVD, projected onto SE3."""
    rays = torch.einsum("ij,bsj->bsi", torch.linalg.inv(K),
                        torch.cat([uv, torch.ones_like(uv[..., :1])], -1))
    x, y = rays[..., 0], rays[..., 1]
    X, Y, Z = Xw[..., 0], Xw[..., 1], Xw[..., 2]
    o = torch.ones_like(x)
    z = torch.zeros_like(x)
    r1 = torch.stack([X, Y, Z, o, z, z, z, z, -x * X, -x * Y, -x * Z, -x], -1)
    r2 = torch.stack([z, z, z, z, X, Y, Z, o, -y * X, -y * Y, -y * Z, -y], -1)
    p = _null_vectors(torch.cat([r1, r2], -2)).reshape(-1, 3, 4)
    # nearest rotation R = U D V^T with det fixed by D; scale and sign from
    # the singular values and det(U V^T)
    U, s, Vt = torch.linalg.svd(p[:, :, :3])
    detUV = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(detUV), torch.ones_like(detUV), detUV], -1)
    R = U @ (D[:, :, None] * Vt)
    scale = torch.sum(s, -1) / 3.0 * torch.sign(detUV)
    scale = torch.where(torch.abs(scale) < _EPS, torch.full_like(scale, _EPS), scale)
    return R, p[:, :, 3] / scale[:, None]


def pnp_ransac(generator: torch.Generator, Xw, uv, mask, K, n_hyp: int = 128,
               chi2_thres: float = 5.991, min_inliers: int = 10,
               refine_iters: int = 8) -> PnPResult:
    """Pose from 2D-3D matches with outliers (reference PnPsolver::iterate)."""
    from ..solvers import pose_opt

    N = Xw.shape[0]
    idx = _sample_indices(generator, n_hyp, 6, N, weights=mask.to(torch.float32))
    R, t = _dlt_pnp(Xw[idx], uv[idx], K)
    pc = torch.einsum("bij,nj->bni", R, Xw) + t[:, None, :]
    z = torch.clamp_min(pc[..., 2], _EPS)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    err2 = ((fx * pc[..., 0] / z + cx - uv[None, :, 0]) ** 2
            + (fy * pc[..., 1] / z + cy - uv[None, :, 1]) ** 2)
    inl = (err2 < chi2_thres) & (pc[..., 2] > 0) & mask[None]
    win = torch.argmax(torch.sum(inl, -1))
    # pose-only polish seeded with the winner's inliers; later rounds
    # re-admit any masked observation that fits the refined pose
    res = pose_opt.optimize_pose(
        lie.make_T(R[win], t[win]), Xw, uv, torch.ones_like(uv[:, 0]), mask, K,
        n_rounds=3, iters_per_round=refine_iters, active0=inl[win])
    return PnPResult(success=res.n_inliers >= min_inliers, Tcw=res.Tcw, inliers=res.inliers)


# ---------------------------------------------------------------------------
# Sim3 RANSAC
# ---------------------------------------------------------------------------

class Sim3Result(NamedTuple):
    success: torch.Tensor   # () bool
    R: torch.Tensor         # (3, 3) with p2 ~ s R p1 + t
    t: torch.Tensor         # (3,)
    s: torch.Tensor         # ()
    inliers: torch.Tensor   # (N,) bool


def sim3_ransac(generator: torch.Generator, p1, p2, uv1, uv2, Tcw1, Tcw2, K, mask,
                n_hyp: int = 128, fix_scale: bool = False, chi2_thres: float = 9.21,
                min_inliers: int = 20) -> Sim3Result:
    """Similarity between matched 3D landmark sets with a mutual
    reprojection inlier check (reference Sim3Solver::iterate +
    CheckInliers).

    p1/p2 (N, 3) world points in map1/map2 frames; uv1/uv2 their observed
    pixels in KF1/KF2; Tcw1/Tcw2 the keyframe poses; mask valid matches.
    """
    N = p1.shape[0]
    idx = _sample_indices(generator, n_hyp, 3, N, weights=mask.to(torch.float32))
    R, t, s = lie.horn_align(p1[idx], p2[idx], fix_scale=fix_scale)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def reproj_err(pts_world, Tcw, uv):
        pc = lie.transform_points(Tcw, pts_world)
        z = torch.clamp_min(pc[..., 2], _EPS)
        return ((fx * pc[..., 0] / z + cx - uv[None, :, 0]) ** 2
                + (fy * pc[..., 1] / z + cy - uv[None, :, 1]) ** 2)

    p1_in_2 = s[:, None, None] * torch.einsum("bij,nj->bni", R, p1) + t[:, None, :]
    s_inv = 1.0 / torch.clamp_min(s, _EPS)
    Rt = R.transpose(-1, -2)
    t_inv = -s_inv[:, None] * torch.einsum("bij,bj->bi", Rt, t)
    p2_in_1 = s_inv[:, None, None] * torch.einsum("bij,nj->bni", Rt, p2) + t_inv[:, None, :]
    inl = ((reproj_err(p1_in_2, Tcw2, uv2) < chi2_thres)
           & (reproj_err(p2_in_1, Tcw1, uv1) < chi2_thres) & mask[None])
    counts = torch.sum(inl, -1)
    win = torch.argmax(counts)
    # refit on all points, weighted by the winner's inlier mask
    R_f, t_f, s_f = lie.horn_align(p1, p2, w=inl[win].to(p1.dtype), fix_scale=fix_scale)
    return Sim3Result(success=counts[win] >= min_inliers, R=R_f, t=t_f, s=s_f,
                      inliers=inl[win])
