"""Plain loop closing: the reference for a closed loop's essential graph,
its pose-graph solve and its Sim3.

Written from the reference's rules (ORB-SLAM2's
``Optimizer::OptimizeEssentialGraph`` as CCM-SLAM keeps it,
src/Optimizer.cpp:1064-1337, and g2o's Sim3), with nothing of either
package imported:

- ``covisibility``: two keyframes' weight is the number of landmarks both
  observe (a landmark held at two features counts once);
- ``correction_group``: the current keyframe and every keyframe of weight
  15 or more with it, before the correction;
- ``essential_graph``: the loop connections (the loop pair, and each
  corrected keyframe's strong links after fusion, weight ``min_feats`` or
  more, to keyframes outside the group that were not strong before it),
  then the spanning tree, the earlier loop edges and the strong
  covisibility before fusion, each pair once and a loop connection first;
- ``corrected_sim3``: the group's poses after the correction, each
  keyframe's pose relative to the current one carried onto the loop's Sim3
  (the loop's scale kept, as CorrectedSim3);
- ``measurements``: loop connections measured between the corrected poses,
  the rest between the poses before the correction;
- ``pose_graph_lm``: Levenberg-Marquardt over Sim3 vertices S_iw, an edge's
  error log(S_ji^-1 S_jw S_iw^-1) in R^7 (omega, upsilon, sigma), its
  Jacobians in each end's left perturbation by central differences, the
  normal equations assembled dense and solved by Cholesky, the gauge
  vertices held by identity rows;
- ``planted_sim3`` and ``sim3_terms``: the loop's true Sim3 between two
  keyframes of a drifted map, and how far a measured one lies from it
  (rotation in radians, log scale, translation in metres);
- ``aligned_rms``: the RMS of keyframe positions against the truth after
  the best similarity alignment (Umeyama).

``dtype`` is the precision of the LM's arithmetic: float64 for the
reference, bfloat16 for the precision control (torch factorises no
bfloat16, so the normal equations are rounded to bfloat16 and solved in
float32). Everything runs on the device of its inputs.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

GROUP_TH = 15
FD_STEP = 1e-6


class Edges(NamedTuple):
    i: np.ndarray          # (E,) slot of one end
    j: np.ndarray          # (E,) slot of the other (i < j)
    loop: np.ndarray       # (E,) bool: a loop connection


# ---------------------------------------------------------------------------
# the graph
# ---------------------------------------------------------------------------

def observed(mp_idx: torch.Tensor, feat_valid: torch.Tensor, kf_valid: torch.Tensor):
    """(NK, F) bool: a live feature of a live keyframe that holds a landmark."""
    return feat_valid & (mp_idx >= 0) & kf_valid[:, None]


def covisibility(mp_idx, feat_valid, kf_valid, nm: int, rows=None) -> torch.Tensor:
    """(R, NK) shared-landmark counts of keyframes ``rows`` (all if None)
    with every keyframe, 0 on a row's own keyframe."""
    nk = mp_idx.shape[0]
    ok = observed(mp_idx, feat_valid, kf_valid)
    memb = torch.zeros((nk, nm + 1), dtype=torch.float32, device=mp_idx.device)
    memb[torch.arange(nk, device=mp_idx.device)[:, None].expand_as(ok)[ok],
         mp_idx[ok].long()] = 1.0
    memb = memb[:, :nm]
    rows = torch.arange(nk, device=mp_idx.device) if rows is None else torch.as_tensor(
        rows, dtype=torch.int64, device=mp_idx.device)
    W = memb[rows] @ memb.T
    W[torch.arange(rows.shape[0], device=W.device), rows] = 0.0
    return W


def correction_group(W_before: np.ndarray, cur: int) -> np.ndarray:
    """Sorted slots of the current keyframe's covisibility group."""
    return np.union1d(np.flatnonzero(W_before[cur] >= GROUP_TH), [cur]).astype(np.int64)


def essential_graph(cur: int, cand: int, group, kf_valid, parent, loop_edge, W_before,
                    W_after_group, min_feats: int) -> Edges:
    """The essential graph's edges between keyframe slots. ``W_before``
    (NK, NK) covisibility before fusion, ``W_after_group`` (G, NK) the
    group's rows after it."""
    valid = np.asarray(kf_valid, bool)
    group = np.asarray(group, np.int64)
    in_group = np.zeros(valid.shape[0], bool)
    in_group[group] = True
    pairs = [(cur, cand)]
    for g, row in zip(group, W_after_group):
        for j in np.flatnonzero(row >= min_feats):
            if valid[j] and not in_group[j] and W_before[g, j] < min_feats:
                pairs.append((int(g), int(j)))
    n_loop = len(pairs)
    for s in np.flatnonzero(valid):
        p = int(parent[s])
        if p >= 0 and valid[p]:
            pairs.append((int(s), p))
    for s in np.flatnonzero(valid):
        q = int(loop_edge[s])
        if q >= 0 and valid[q]:
            pairs.append((int(s), q))
    a, b = np.nonzero(np.triu(W_before >= min_feats, 1))
    pairs += list(zip(a.tolist(), b.tolist()))
    seen, out_i, out_j, out_loop = set(), [], [], []
    for n, (x, y) in enumerate(pairs):
        key = (min(x, y), max(x, y))
        if x == y or key in seen:
            continue
        seen.add(key)
        out_i.append(key[0])
        out_j.append(key[1])
        out_loop.append(n < n_loop)
    return Edges(np.asarray(out_i, np.int64), np.asarray(out_j, np.int64),
                 np.asarray(out_loop, bool))


def edge_diff(port_pairs, edges: Edges) -> int:
    """Edges in one graph and not in the other (unordered slot pairs)."""
    a = {(min(int(x), int(y)), max(int(x), int(y))) for x, y in port_pairs}
    b = set(zip(edges.i.tolist(), edges.j.tolist()))
    return len(a ^ b)


# ---------------------------------------------------------------------------
# Sim3 in float64 (g2o's sim3.h)
# ---------------------------------------------------------------------------

def _hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _coeffs(theta, sigma):
    """(A, B, C) of V = A W + B W^2 + C I, g2o's naming, with its limits."""
    s = torch.exp(sigma)
    small_s = sigma.abs() < 1e-5
    small_t = theta < 1e-5
    one = torch.ones_like(theta)
    th = torch.where(small_t, one, theta)
    sg = torch.where(small_s, one, sigma)
    C = torch.where(small_s, one, (s - 1.0) / sg)
    a, b = s * torch.sin(th), s * torch.cos(th)
    c = th * th + sigma * sigma
    A_gen = (a * sigma + (1.0 - b) * th) / (th * c)
    B_gen = (C - ((b - 1.0) * sigma + a * th) / c) / (th * th)
    A_s0 = (1.0 - torch.cos(th)) / (th * th)
    B_s0 = (th - torch.sin(th)) / (th * th * th)
    A_t0 = torch.where(small_s, 0.5 * one, ((sg - 1.0) * s + 1.0) / (sg * sg))
    B_t0 = torch.where(small_s, one / 6.0, (s * (0.5 * sg * sg - sg + 1.0) - 1.0) / sg ** 3)
    A = torch.where(small_t, A_t0, torch.where(small_s, A_s0, A_gen))
    B = torch.where(small_t, B_t0, torch.where(small_s, B_s0, B_gen))
    return A, B, C


def _V(w, sigma):
    theta = torch.linalg.norm(w, dim=-1)
    A, B, C = _coeffs(theta, sigma)
    W = _hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return A[..., None, None] * W + B[..., None, None] * (W @ W) + C[..., None, None] * eye


def _so3_exp(w):
    theta = torch.linalg.norm(w, dim=-1)
    small = theta < 1e-8
    th = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, 1.0 - theta * theta / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - theta * theta / 24.0, (1.0 - torch.cos(th)) / (th * th))
    W = _hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def _so3_log(R):
    cos = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5, -1.0, 1.0)
    v = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], -1)
    sin = torch.linalg.norm(v, dim=-1)
    theta = torch.atan2(sin, cos)
    small = sin < 1e-10
    scale = torch.where(small, 1.0 + sin * sin / 6.0, theta / torch.where(small, 1.0, sin))
    return v * scale[..., None]


def split(S):
    """[sR | t] (..., 4, 4) -> (R, t, s)."""
    sR = S[..., :3, :3]
    s = torch.linalg.det(sR).abs() ** (1.0 / 3.0)
    return sR / s[..., None, None], S[..., :3, 3], s


def make(R, t, s):
    out = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    out[..., :3, :3] = s[..., None, None] * R
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def inv(S):
    R, t, s = split(S)
    Rt = R.transpose(-1, -2)
    return make(Rt, -torch.einsum("...ij,...j->...i", Rt, t) / s[..., None], 1.0 / s)


def exp(x):
    """(..., 7) = (omega, upsilon, sigma) -> [sR | t]."""
    w, u, sigma = x[..., :3], x[..., 3:6], x[..., 6]
    t = torch.einsum("...ij,...j->...i", _V(w, sigma), u)
    return make(_so3_exp(w), t, torch.exp(sigma))


def log(S):
    """[sR | t] -> (..., 7) = (omega, upsilon, sigma)."""
    R, t, s = split(S)
    w, sigma = _so3_log(R), torch.log(s)
    u = torch.linalg.solve(_V(w, sigma), t[..., None])[..., 0]
    return torch.cat([w, u, sigma[..., None]], -1)


def corrected_sim3(S12, T_before, cur: int, cand: int, group) -> torch.Tensor:
    """(G, 4, 4) float64 corrected Sim3 poses of the group's slots: S_cur =
    S12 T_cand, S_i = T_i T_cur^-1 S_cur, from the poses before the
    correction (SE3, world to camera)."""
    T = T_before.double()
    S_cur = S12.double() @ T[cand]
    g = torch.as_tensor(np.asarray(group), dtype=torch.int64, device=T.device)
    return T[g] @ inv(T[cur])[None] @ S_cur[None]


def measurement_diff(port_meas, ref_meas, tol: float = 1e-2) -> int:
    """Edges whose measured S_ji differ by more than ``tol`` in an entry."""
    d = (port_meas.double() - ref_meas.double())[:, :3, :].abs().amax((-1, -2))
    return int((d > tol).sum())


def measurements(S_corrected, S_before, edges: Edges) -> torch.Tensor:
    """(E, 4, 4) S_ji = S_jw S_iw^-1: loop connections between the corrected
    poses, the rest between the poses before the correction. Poses are
    indexed by slot."""
    i = torch.from_numpy(edges.i).to(S_corrected.device)
    j = torch.from_numpy(edges.j).to(S_corrected.device)
    loop = torch.from_numpy(edges.loop).to(S_corrected.device)[:, None, None]
    mc = S_corrected[j] @ inv(S_corrected[i])
    mb = S_before[j] @ inv(S_before[i])
    return torch.where(loop, mc, mb)


# ---------------------------------------------------------------------------
# the pose-graph LM
# ---------------------------------------------------------------------------

def residuals(S, i, j, meas_inv):
    return log(meas_inv @ S[j] @ inv(S[i]))


def cost(S, i, j, meas) -> float:
    """Sum over the edges of |log(S_ji^-1 S_jw S_iw^-1)|^2, in float64."""
    r = residuals(S.double(), i, j, inv(meas.double()))
    return float((r * r).sum())


def _jacobians(S, i, j, meas_inv):
    """(E, 7, 7) each: the error's central differences in the left
    perturbation of S_i and of S_j."""
    E = i.shape[0]
    Ji = torch.empty((E, 7, 7), dtype=S.dtype, device=S.device)
    Jj = torch.empty_like(Ji)
    Si, Sj = S[i], S[j]
    for k in range(7):
        d = torch.zeros((E, 7), dtype=S.dtype, device=S.device)
        d[:, k] = FD_STEP
        Ji[:, :, k] = (log(meas_inv @ Sj @ inv(exp(d) @ Si))
                       - log(meas_inv @ Sj @ inv(exp(-d) @ Si))) / (2 * FD_STEP)
        Jj[:, :, k] = (log(meas_inv @ exp(d) @ Sj @ inv(Si))
                       - log(meas_inv @ exp(-d) @ Sj @ inv(Si))) / (2 * FD_STEP)
    return Ji, Jj


def pose_graph_lm(S0, i, j, meas, fixed, iterations: int, dtype=torch.float64):
    """LM from S0 (V, 4, 4) over edges (i, j) -> S (V, 4, 4) float64;
    ``fixed`` (V,) bool. A step that lowers the cost is taken and the
    damping falls tenfold, else it rises tenfold."""
    V = S0.shape[0]
    dev = S0.device
    S = S0.double()
    i = torch.as_tensor(i, dtype=torch.int64, device=dev)
    j = torch.as_tensor(j, dtype=torch.int64, device=dev)
    meas_inv = inv(meas.double())
    fixed = torch.as_tensor(fixed, dtype=torch.bool, device=dev)
    free_rows = (~fixed).repeat_interleave(7)
    lam = 1e-6
    r = residuals(S, i, j, meas_inv)
    c = float((r * r).sum())
    rows = torch.arange(7, device=dev)
    ri = (i[:, None] * 7 + rows)[:, :, None].expand(-1, 7, 7)
    rj = (j[:, None] * 7 + rows)[:, :, None].expand(-1, 7, 7)
    for _ in range(iterations):
        Ji, Jj = _jacobians(S, i, j, meas_inv)
        if dtype != torch.float64:
            Ji, Jj, r = Ji.to(dtype).double(), Jj.to(dtype).double(), r.to(dtype).double()
        H = torch.zeros((7 * V, 7 * V), dtype=torch.float64, device=dev)
        for Ja, ra_, Jb, rb_ in ((Ji, ri, Ji, ri), (Jj, rj, Jj, rj), (Ji, ri, Jj, rj),
                                 (Jj, rj, Ji, ri)):
            blk = torch.einsum("eka,ekb->eab", Ja, Jb)
            H.index_put_((ra_.reshape(-1), rb_.transpose(1, 2).reshape(-1)), blk.reshape(-1),
                         accumulate=True)
        g = torch.zeros(7 * V, dtype=torch.float64, device=dev)
        g.index_add_(0, ri[:, :, 0].reshape(-1), torch.einsum("eka,ek->ea", Ji, r).reshape(-1))
        g.index_add_(0, rj[:, :, 0].reshape(-1), torch.einsum("eka,ek->ea", Jj, r).reshape(-1))
        H = H[free_rows][:, free_rows]
        g = g[free_rows]
        D = torch.diagonal(H).clone()
        solve = torch.float64 if dtype == torch.float64 else torch.float32
        A = H + torch.diag(lam * D + 1e-12)
        if dtype != torch.float64:
            A, g = A.to(dtype), g.to(dtype)
        L, info = torch.linalg.cholesky_ex(A.to(solve))
        if int(info) != 0:      # not positive definite at this precision: damp more
            lam = min(lam * 10.0, 1e6)
            continue
        dx_free = torch.cholesky_solve(-g.to(solve)[:, None], L)[:, 0].double()
        dx = torch.zeros(7 * V, dtype=torch.float64, device=dev)
        dx[free_rows] = dx_free
        S_new = exp(dx.view(V, 7)) @ S
        r_new = residuals(S_new, i, j, meas_inv)
        c_new = float((r_new * r_new).sum())
        if c_new < c:
            S, r, c, lam = S_new, r_new, c_new, max(lam * 0.1, 1e-12)
        else:
            lam = min(lam * 10.0, 1e6)
    return S


def cost_gap(S_port, S_ref, S_start, i, j, meas) -> tuple:
    """(gap, port's cost, reference's cost, the start's cost), each priced
    by ``cost``: the share of the reference's fall from the common start
    that the port's result misses. (Over the reference's own cost the gap
    would read float32's floor: a solve ends some 1e-7 of its start.)"""
    c_port, c_ref, c_0 = (cost(S, i, j, meas) for S in (S_port, S_ref, S_start))
    return (c_port - c_ref) / max(c_0 - c_ref, 1e-12), c_port, c_ref, c_0


# ---------------------------------------------------------------------------
# the loop's Sim3 and the drift left
# ---------------------------------------------------------------------------

def planted_sim3(T_true_cur, T_true_cand, scale: float, dtype=torch.float64):
    """S12 from the candidate's camera to the current one's in a map that
    carries a Sim3 drift of ``scale`` at the current keyframe and none at
    the candidate: scale * T_cur T_cand^-1, worked out in ``dtype``."""
    R1, t1 = T_true_cur[:3, :3].to(dtype), T_true_cur[:3, 3].to(dtype)
    R2, t2 = T_true_cand[:3, :3].to(dtype), T_true_cand[:3, 3].to(dtype)
    R = R1 @ R2.T
    t = t1 - R @ t2
    s = torch.tensor(scale, dtype=dtype, device=R.device)
    return make(R.double(), (s * t).double(), s.double())


def sim3_terms(S, S_true) -> tuple:
    """(rotation between them in radians, |log| of their scales' ratio,
    their translations' distance in metres): the translations lie in the
    current camera's frame at the map's scale there, which ``S_true``'s
    scale undoes."""
    R1, t1, s1 = split(S.double())
    R2, t2, s2 = split(S_true.double())
    rot = float(torch.linalg.norm(_so3_log(R1 @ R2.T)))
    sc = abs(float(torch.log(s1 / s2)))
    tr = float(torch.linalg.norm(t1 - t2) / s2)
    return rot, sc, tr


def centres(Tcw) -> torch.Tensor:
    """(N, 3) camera centres of world-to-camera poses."""
    T = Tcw.double()
    return -torch.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3])


def aligned_rms(est: torch.Tensor, true: torch.Tensor) -> float:
    """RMS of ``est`` (N, 3) against ``true`` after the similarity that
    brings ``est`` closest to it (Umeyama)."""
    x, y = est.double(), true.double()
    mx, my = x.mean(0), y.mean(0)
    xc, yc = x - mx, y - my
    cov = yc.T @ xc / x.shape[0]
    U, D, Vt = torch.linalg.svd(cov)
    E = torch.eye(3, dtype=x.dtype, device=x.device)
    if torch.det(U) * torch.det(Vt) < 0:
        E[2, 2] = -1.0
    R = U @ E @ Vt
    s = torch.trace(torch.diag(D) @ E) / (xc * xc).sum(-1).mean()
    t = my - s * R @ mx
    err = y - (s * x @ R.T + t)
    return float(torch.sqrt((err * err).sum(-1).mean()))
