"""Plain robust Levenberg-Marquardt bundle adjustment: the reference for
the GBA, the local BA and the tracker's pose.

The problem is the one the port states: poses Tcw (C, 4, 4) world to
camera, landmarks Xw (L, 3), pinhole observations with a per-observation
information weight, the Huber kernel at delta^2 = 5.991 (the reference's
thHuberMono), gauge cameras and landmarks held fixed. Each iteration
linearises every observation, marginalises the landmarks into the dense
reduced camera system S (6C x 6C) by summing Y_i W_j^T over each
landmark's pairs of observations, solves it by Cholesky and
back-substitutes the landmarks; a step that lowers the robust cost is
taken, and the damping halves, else it is refused and the damping
quadruples (Marquardt's rule, damping lam * diag + 1e-9). The port's
solvers use a preconditioned conjugate gradient or a dense W; this one
forms S exactly. Nothing here imports the port.

``dtype`` is the precision of every operation: float64 for the reference,
bfloat16 for the precision control (torch has no bfloat16 factorisation,
so S and the 3x3 blocks are rounded to bfloat16 and factorised in
float32).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

CHI2_MONO = 5.991
HUBER_DELTA = 5.991 ** 0.5
PAIR_CHUNK = 1 << 22


class Problem(NamedTuple):
    cam: torch.Tensor         # (O,) i64
    lm: torch.Tensor          # (O,) i64
    uv: torch.Tensor          # (O, 2)
    info: torch.Tensor        # (O,) information weight (1 / sigma^2)
    valid: torch.Tensor       # (O,) bool
    K: torch.Tensor           # (3, 3)
    fixed_cam: torch.Tensor   # (C,) bool
    fixed_lm: torch.Tensor    # (L,) bool


def hat(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(N, 6) tangents (omega, upsilon) -> (N, 4, 4), Rodrigues' formula."""
    w, v = xi[:, :3], xi[:, 3:]
    th2 = (w * w).sum(-1)
    small = th2 < 1e-10
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / (th * th))
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (th - torch.sin(th)) / (th * th * th))
    W = hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand_as(W)
    R = eye + a[:, None, None] * W + b[:, None, None] * W2
    V = eye + b[:, None, None] * W + c[:, None, None] * W2
    T = torch.zeros((xi.shape[0], 4, 4), dtype=xi.dtype, device=xi.device)
    T[:, :3, :3] = R
    T[:, :3, 3] = (V @ v[:, :, None])[:, :, 0]
    T[:, 3, 3] = 1.0
    return T


def residuals(Tcw, Xw, p: Problem):
    """(r (O, 2) = uv - proj, pc (O, 3), chi2 (O,), depth_ok (O,))."""
    T = Tcw[p.cam]
    pc = torch.einsum("oij,oj->oi", T[:, :3, :3], Xw[p.lm]) + T[:, :3, 3]
    z = pc[:, 2]
    ok = z > 1e-6
    zs = torch.where(ok, z, torch.ones_like(z))
    K = p.K.to(Tcw.dtype)
    proj = torch.stack([K[0, 0] * pc[:, 0] / zs + K[0, 2], K[1, 1] * pc[:, 1] / zs + K[1, 2]], -1)
    r = p.uv.to(Tcw.dtype) - proj
    chi2 = (r * r).sum(-1) * p.info.to(Tcw.dtype)
    return r, pc, chi2, ok


def huber(chi2: torch.Tensor) -> torch.Tensor:
    e = torch.sqrt(torch.clamp_min(chi2, 1e-12))
    return torch.where(e <= HUBER_DELTA, chi2, 2.0 * HUBER_DELTA * e - HUBER_DELTA ** 2)


def cost(Tcw, Xw, p: Problem, mask: torch.Tensor) -> float:
    """Summed Huber cost over ``mask``, evaluated in float64. A point
    behind its camera is projected at depth 1, as the port's solvers do,
    so it costs much and is not left out."""
    _, _, chi2, _ = residuals(Tcw.double(), Xw.double(), p)
    return float(torch.where(mask, huber(chi2), torch.zeros_like(chi2)).sum())


def inliers(Tcw, Xw, p: Problem) -> torch.Tensor:
    _, _, chi2, ok = residuals(Tcw.double(), Xw.double(), p)
    return p.valid & ok & (chi2 <= CHI2_MONO)


class Pairs(NamedTuple):
    a: torch.Tensor      # (P,) observation index
    b: torch.Tensor      # (P,) observation index, same landmark as a
    block: torch.Tensor  # (P,) i64 cam[a] * C + cam[b]


def landmark_pairs(p: Problem, C: int) -> Pairs:
    """Every ordered pair of valid observations of one landmark."""
    obs = torch.nonzero(p.valid & ~p.fixed_lm[p.lm]).squeeze(1)
    order = torch.argsort(p.lm[obs], stable=True)
    obs = obs[order]
    lm = p.lm[obs]
    counts = torch.bincount(lm, minlength=p.fixed_lm.shape[0])
    starts = torch.cumsum(counts, 0) - counts
    n_per = counts[lm]
    a_pos = torch.repeat_interleave(torch.arange(obs.numel(), device=obs.device), n_per)
    first = torch.cumsum(n_per, 0) - n_per
    offs = torch.arange(a_pos.numel(), device=obs.device) - first[a_pos]
    b_pos = starts[lm[a_pos]] + offs
    a, b = obs[a_pos], obs[b_pos]
    return Pairs(a=a, b=b, block=p.cam[a] * C + p.cam[b])


def _solve_spd(S: torch.Tensor, rhs: torch.Tensor, dtype) -> torch.Tensor:
    work = torch.float32 if dtype == torch.bfloat16 else dtype
    L, info = torch.linalg.cholesky_ex(S.to(work))
    x = torch.cholesky_solve(rhs.to(work)[:, None], L)[:, 0].to(dtype)
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))


def _inv33(V: torch.Tensor, dtype) -> torch.Tensor:
    work = torch.float32 if dtype == torch.bfloat16 else dtype
    return torch.linalg.inv(V.to(work)).to(dtype)


def step(Tcw, Xw, p: Problem, active, lam, pairs: Pairs, dtype):
    """One damped Gauss-Newton step from (Tcw, Xw): (T_new, X_new, cost)."""
    C, L = Tcw.shape[0], Xw.shape[0]
    dev = Tcw.device
    r, pc, chi2, ok = residuals(Tcw, Xw, p)
    m = active & ok
    e = torch.sqrt(torch.clamp_min(chi2, 1e-12))
    w = p.info.to(dtype) * torch.where(e <= HUBER_DELTA, torch.ones_like(e), HUBER_DELTA / e)
    w = torch.where(m, w, torch.zeros_like(w))
    f = torch.sum(torch.where(active, huber(chi2), torch.zeros_like(chi2)))
    K = p.K.to(dtype)
    x, y = pc[:, 0], pc[:, 1]
    iz = 1.0 / torch.clamp_min(pc[:, 2], 1e-6)
    zero = torch.zeros_like(x)
    dproj = torch.stack([torch.stack([K[0, 0] * iz, zero, -K[0, 0] * x * iz * iz], -1),
                         torch.stack([zero, K[1, 1] * iz, -K[1, 1] * y * iz * iz], -1)], -2)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Jc = -dproj @ torch.cat([-hat(pc), eye3.expand(pc.shape[0], 3, 3)], -1)   # (O, 2, 6)
    Jl = -dproj @ Tcw[p.cam][:, :3, :3]                                        # (O, 2, 3)
    fc = p.fixed_cam[p.cam]
    fl = p.fixed_lm[p.lm]
    wJc = Jc * w[:, None, None]
    wJl = Jl * w[:, None, None]
    U = torch.zeros((C, 6, 6), dtype=dtype, device=dev).index_add_(
        0, p.cam, wJc.transpose(1, 2) @ Jc)
    V = torch.zeros((L, 3, 3), dtype=dtype, device=dev).index_add_(
        0, p.lm, wJl.transpose(1, 2) @ Jl)
    gc = torch.zeros((C, 6), dtype=dtype, device=dev).index_add_(
        0, p.cam, -(wJc.transpose(1, 2) @ r[:, :, None])[:, :, 0])
    gl = torch.zeros((L, 3), dtype=dtype, device=dev).index_add_(
        0, p.lm, -(wJl.transpose(1, 2) @ r[:, :, None])[:, :, 0])
    W = wJc.transpose(1, 2) @ Jl                                               # (O, 6, 3)
    W = torch.where((fc | fl)[:, None, None], torch.zeros_like(W), W)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    U = U + eye6 * (lam * torch.diagonal(U, dim1=-2, dim2=-1) + 1e-9)[:, None, :]
    V = V + eye3 * (lam * torch.diagonal(V, dim1=-2, dim2=-1) + 1e-9)[:, None, :]
    U = torch.where(p.fixed_cam[:, None, None], eye6, U)
    gc = torch.where(p.fixed_cam[:, None], torch.zeros_like(gc), gc)
    V = torch.where(p.fixed_lm[:, None, None], eye3, V)
    gl = torch.where(p.fixed_lm[:, None], torch.zeros_like(gl), gl)
    Vinv = _inv33(V, dtype)
    Y = W @ Vinv[p.lm]                                                          # (O, 6, 3)
    S = torch.zeros((C * C, 6, 6), dtype=dtype, device=dev)
    S.view(C, C, 6, 6).diagonal(dim1=0, dim2=1).copy_(U.permute(1, 2, 0))
    for i in range(0, pairs.a.numel(), PAIR_CHUNK):
        a, b = pairs.a[i:i + PAIR_CHUNK], pairs.b[i:i + PAIR_CHUNK]
        S.index_add_(0, pairs.block[i:i + PAIR_CHUNK], -(Y[a] @ W[b].transpose(1, 2)))
    S = S.view(C, C, 6, 6).permute(0, 2, 1, 3).reshape(6 * C, 6 * C)
    rhs = gc.clone().index_add_(0, p.cam, -(Y @ gl[p.lm][:, :, None])[:, :, 0])
    dc = _solve_spd(S, rhs.reshape(-1), dtype).reshape(C, 6)
    dc = torch.where(p.fixed_cam[:, None], torch.zeros_like(dc), dc)
    back = torch.zeros((L, 3), dtype=dtype, device=dev).index_add_(
        0, p.lm, (W.transpose(1, 2) @ dc[p.cam][:, :, None])[:, :, 0])
    dl = (Vinv @ (gl - back)[:, :, None])[:, :, 0]
    dl = torch.where(p.fixed_lm[:, None], torch.zeros_like(dl), dl)
    T_new = torch.where(p.fixed_cam[:, None, None], Tcw, se3_exp(dc) @ Tcw)
    return T_new, Xw + dl, f


def bundle_adjust(Tcw0, Xw0, p: Problem, iterations: int, dtype=torch.float64,
                  outlier_pass_at: Optional[int] = None, kick=None, chunk: Optional[int] = None):
    """Robust LM from (Tcw0, Xw0) for ``iterations``; returns (Tcw, Xw) in
    ``dtype``. ``outlier_pass_at``: after that iteration, observations
    whose chi2 exceeds 5.991 or that lie behind their camera leave the
    problem. ``chunk``: the damping restarts every ``chunk`` iterations,
    after which ``kick(Tcw)`` (if given) alters the poses, as a driver
    that runs the solver in chunks does."""
    C = Tcw0.shape[0]
    pairs = landmark_pairs(p, C)
    Tcw, Xw = Tcw0.to(dtype), Xw0.to(dtype)
    active = p.valid.clone()
    chunk = chunk or iterations
    lam = None
    for it in range(iterations):
        if it % chunk == 0:
            lam = torch.tensor(1e-4, dtype=dtype, device=Tcw.device)
        T_new, X_new, f = step(Tcw, Xw, p, active, lam, pairs, dtype)
        # every active observation counts, a point pushed behind its camera
        # at its clamped depth, so such a step is refused
        _, _, chi2, _ = residuals(T_new, X_new, p)
        f_new = torch.sum(torch.where(active, huber(chi2), torch.zeros_like(chi2)))
        accept = (f_new < f) & torch.isfinite(f_new)
        Tcw = torch.where(accept, T_new, Tcw)
        Xw = torch.where(accept, X_new, Xw)
        lam = torch.where(accept, torch.clamp_min(lam * 0.5, 1e-8), torch.clamp_max(lam * 4.0, 1e4))
        if outlier_pass_at is not None and it == outlier_pass_at:
            _, _, chi2, ok = residuals(Tcw, Xw, p)
            active = active & ok & (chi2 <= CHI2_MONO)
        if kick is not None and (it + 1) % chunk == 0 and it + 1 < iterations:
            Tcw = kick(Tcw)
    return Tcw, Xw


def cost_gap(prog_Tcw, prog_Xw, ref_Tcw, ref_Xw, p: Problem, outlier_pass: bool) -> tuple:
    """(relative gap, program's cost, reference's cost): both states priced
    by ``cost`` on one set of observations, the valid ones in front of the
    reference's cameras (and within its chi2 gate where the solver drops
    outliers)."""
    if outlier_pass:
        mask = inliers(ref_Tcw, ref_Xw, p)
    else:
        mask = p.valid & residuals(ref_Tcw.double(), ref_Xw.double(), p)[3]
    c_prog = cost(prog_Tcw, prog_Xw, p, mask)
    c_ref = cost(ref_Tcw, ref_Xw, p, mask)
    return (c_prog - c_ref) / max(c_ref, 1e-12), c_prog, c_ref
