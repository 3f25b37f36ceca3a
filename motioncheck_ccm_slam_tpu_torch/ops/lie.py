"""SO3 / SE3 / Sim3 operations on torch tensors, batched over leading
dimensions.

Counterpart of ``motioncheck_ccm_slam_tpu/ops/lie.py``. Conventions are the
same: 4x4 row-major transforms, ``Tcw`` maps world -> camera, se3 tangents
are ``(omega[3], upsilon[3])``, sim3 tangents ``(omega[3], upsilon[3],
sigma)`` with scale ``s = exp(sigma)``; a Sim3 element is stored as the 4x4
``[sR, t; 0, 1]`` acting as ``x' = s R x + t``. Quaternions are (w, x, y, z).
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of w (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], -1),
            torch.stack([wz, zeros, -wx], -1),
            torch.stack([-wy, wx, zeros], -1),
        ],
        -2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation, with a Taylor
    fallback at small angles."""
    theta2 = torch.sum(w * w, -1)
    small = theta2 < _EPS
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    W = hat(w)
    return _eye3(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> axis-angle (..., 3).

    theta = atan2(|vee(W)|, (tr - 1) / 2), with a Taylor scale at the
    identity and the axis taken from the largest column of R + I near pi.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w = vee(0.5 * (R - R.transpose(-1, -2)))  # = sin(theta) * axis
    sin2 = torch.sum(w * w, -1)
    small = sin2 < 1e-12
    sin_safe = torch.sqrt(torch.where(small, torch.ones_like(sin2), sin2))
    sin_theta = torch.where(small, torch.zeros_like(sin2), sin_safe)
    theta = torch.atan2(sin_theta, cos_theta)
    near_pi = (cos_theta < 0.0) & (sin_theta < 1e-3)
    scale = torch.where(small, 1.0 + sin2 / 6.0, theta / sin_safe)
    w_generic = w * scale[..., None]
    # near pi the columns of R + I are parallel to the axis: take the
    # largest (the first of equal norms, as argmax does)
    S = R + _eye3(R)
    col_idx = torch.argmax(torch.linalg.norm(S, dim=-2), dim=-1)
    idx = col_idx[..., None, None].expand(S.shape[:-1] + (1,))
    axis_raw = torch.gather(S, -1, idx)[..., 0]
    axis = axis_raw / torch.clamp_min(torch.linalg.norm(axis_raw, dim=-1, keepdim=True), _EPS)
    sign = torch.where(torch.sum(axis * w, -1, keepdim=True) < 0.0, -1.0, 1.0)
    w_pi = axis * sign * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


def _V_coeffs(theta2: torch.Tensor):
    """Coefficients of the left Jacobian V = I + b*W + c*W^2."""
    small = theta2 < _EPS
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    c = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / (theta2_safe * theta),
    )
    return b, c


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se3 (..., 6) = (omega, upsilon) -> (..., 4, 4)."""
    w, v = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    b, c = _V_coeffs(torch.sum(w * w, -1))
    W = hat(w)
    V = _eye3(R) + b[..., None, None] * W + c[..., None, None] * (W @ W)
    t = torch.einsum("...ij,...j->...i", V, v)
    return make_T(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> se3 (..., 6) = (omega, upsilon)."""
    R, t = split_T(T)
    w = so3_log(R)
    b, c = _V_coeffs(torch.sum(w * w, -1))
    W = hat(w)
    V = _eye3(R) + b[..., None, None] * W + c[..., None, None] * (W @ W)
    v = torch.linalg.solve(V, t[..., None])[..., 0]
    return torch.cat([w, v], -1)


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], -1)
    # filled on the device: a tensor built from a host list would copy and
    # synchronize the stream on every call
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], -2)


def split_T(T: torch.Tensor):
    return T[..., :3, :3], T[..., :3, 3]


def inv_T(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform."""
    R, t = split_T(T)
    Rt = R.transpose(-1, -2)
    return make_T(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3)."""
    R, t = split_T(T)
    return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z): CSV export
# ---------------------------------------------------------------------------

def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) quaternion (w, x, y, z), w >= 0, from the
    construction with the largest pivot."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def half_root(x):
        q = torch.sqrt(torch.clamp_min(x, 0.0)) * 0.5
        return q, 4.0 * torch.clamp_min(q, _EPS)

    qw0, d0 = half_root(1.0 + tr)
    cand0 = torch.stack([qw0, (m21 - m12) / d0, (m02 - m20) / d0, (m10 - m01) / d0], -1)
    qx1, d1 = half_root(1.0 + m00 - m11 - m22)
    cand1 = torch.stack([(m21 - m12) / d1, qx1, (m01 + m10) / d1, (m02 + m20) / d1], -1)
    qy2, d2 = half_root(1.0 - m00 + m11 - m22)
    cand2 = torch.stack([(m02 - m20) / d2, (m01 + m10) / d2, qy2, (m12 + m21) / d2], -1)
    qz3, d3 = half_root(1.0 - m00 - m11 + m22)
    cand3 = torch.stack([(m10 - m01) / d3, (m02 + m20) / d3, (m12 + m21) / d3, qz3], -1)
    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], -1)
    best = torch.argmax(pivots, -1)
    cands = torch.stack([cand0, cand1, cand2, cand3], -2)      # (..., 4, 4)
    q = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    q = q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), _EPS)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) (w, x, y, z) -> (..., 3, 3)."""
    q = q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), _EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], -2)


# ---------------------------------------------------------------------------
# Sim3: (R, t, s) acting as x' = s R x + t, stored as [sR, t; 0, 1]
# ---------------------------------------------------------------------------

def make_sim3(R: torch.Tensor, t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3), (...) -> (..., 4, 4) [sR, t]. The scale is
    recoverable as det(sR)^(1/3)."""
    s = torch.as_tensor(s, dtype=R.dtype, device=R.device)
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1], s.shape)
    sR = (s[..., None, None] * R).expand(batch + (3, 3))
    return make_T(sR, t.expand(batch + (3,)))


def split_sim3(S: torch.Tensor):
    """(..., 4, 4) [sR, t] -> (R, t, s)."""
    sR, t = split_T(S)
    det = torch.linalg.det(sR)
    s = torch.sign(det) * torch.abs(det) ** (1.0 / 3.0)
    return sR / s[..., None, None], t, s


def sim3_inv(S: torch.Tensor) -> torch.Tensor:
    """Inverse of [sR, t]: [R^T / s, -R^T t / s]."""
    R, t, s = split_sim3(S)
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return make_sim3(Rt, -s_inv[..., None] * torch.einsum("...ij,...j->...i", Rt, t), s_inv)


def sim3_apply(S: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply Sim3 (..., 4, 4) to points (..., N, 3)."""
    sR, t = split_T(S)
    return torch.einsum("...ij,...nj->...ni", sR, pts) + t[..., None, :]


def _sim3_V(w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """V = A I + B W + C W^2 of sim3_exp (Strasdat's closed form, g2o
    sim3.h), with its sigma -> 0 and theta -> 0 limits."""
    s = torch.exp(sigma)
    theta2 = torch.sum(w * w, -1)
    theta = torch.sqrt(torch.clamp_min(theta2, 0.0))
    W = hat(w)
    W2 = W @ W
    one = torch.ones_like(sigma)
    eps_s = torch.abs(sigma) < 1e-5
    small_t = theta2 < _EPS
    safe_sigma = torch.where(eps_s, one, sigma)
    safe_theta = torch.where(small_t, one, theta)
    safe_theta2 = torch.where(small_t, one, theta2)
    A = torch.where(eps_s, 1.0 + sigma / 2.0, (s - 1.0) / safe_sigma)
    sig2_t2 = sigma * sigma + theta2
    safe_denom = torch.where(small_t & eps_s, one, torch.where(sig2_t2 == 0, one, sig2_t2))
    a = s * torch.sin(theta)
    b = s * torch.cos(theta)
    B_gen = (a * sigma + (1.0 - b) * theta) / (safe_theta * safe_denom)
    C_gen = (A - ((b - 1.0) * sigma + a * theta) / safe_denom) / safe_theta2
    B_s0 = (1.0 - torch.cos(theta)) / safe_theta2
    C_s0 = (theta - torch.sin(theta)) / (safe_theta2 * safe_theta)
    B_t0 = torch.where(eps_s, 0.5 + sigma / 3.0,
                       ((sigma - 1.0) * s + 1.0) / (safe_sigma * safe_sigma))
    C_t0 = torch.where(eps_s, 1.0 / 6.0 + sigma / 8.0,
                       (s * (sigma * sigma / 2.0 - sigma + 1.0) - 1.0) / (safe_sigma ** 3))
    B = torch.where(small_t, B_t0, torch.where(eps_s, B_s0, B_gen))
    C = torch.where(small_t, C_t0, torch.where(eps_s, C_s0, C_gen))
    return A[..., None, None] * _eye3(W) + B[..., None, None] * W + C[..., None, None] * W2


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """sim3 (..., 7) = (omega, upsilon, sigma) -> (..., 4, 4) [sR, t]."""
    w, v, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    t = torch.einsum("...ij,...j->...i", _sim3_V(w, sigma), v)
    return make_sim3(so3_exp(w), t, torch.exp(sigma))


def sim3_log(S: torch.Tensor) -> torch.Tensor:
    """[sR, t] (..., 4, 4) -> (..., 7) = (omega, upsilon, sigma), by a 3x3
    solve against sim3_exp's V."""
    R, t, s = split_sim3(S)
    w = so3_log(R)
    sigma = torch.log(s)
    v = torch.linalg.solve(_sim3_V(w, sigma), t[..., None])[..., 0]
    return torch.cat([w, v, sigma[..., None]], -1)


def jacobian_fwd(f, x: torch.Tensor, *args) -> torch.Tensor:
    """Forward-mode Jacobian of ``f(x, *args)`` at ``x`` (B, n), where
    row b of the output depends on row b of ``x`` and of each of ``args``
    only. One ``torch.func.jvp`` over n copies of the batch, copy k
    carrying the k-th unit tangent. Returns (B, ..., n) for an output
    (B, ...). (``torch.func.jacfwd`` vmaps the tangents instead, and under
    vmap torch's rules gave NaN tangents to all but the first of a batch of
    Sim3 logs and float64 tangents to 0-dim float32 tensors.)"""
    B, n = x.shape
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    copies = [a.repeat((n,) + (1,) * (a.dim() - 1)) for a in args]
    _, tangent = torch.func.jvp(lambda z: f(z, *copies), (x.repeat(n, 1),),
                                (eye.repeat_interleave(B, dim=0),))
    return tangent.reshape((n, B) + tangent.shape[1:]).movedim(0, -1)


# ---------------------------------------------------------------------------
# Horn closed-form similarity alignment (Sim3 RANSAC, ATE)
# ---------------------------------------------------------------------------

def horn_align(p1: torch.Tensor, p2: torch.Tensor, w=None, fix_scale: bool = False):
    """Closed-form similarity p2 ~ s R p1 + t by Horn's quaternion method
    (reference src/Sim3Solver.cpp:ComputeSim3), batched over leading dims.

    p1/p2 (..., N, 3); w optional per-point weights (..., N). Returns
    (R, t, s).
    """
    if w is None:
        w = torch.ones(p1.shape[:-1], dtype=p1.dtype, device=p1.device)
    wn = w / torch.clamp_min(torch.sum(w, -1, keepdim=True), _EPS)
    c1 = torch.sum(p1 * wn[..., None], -2)
    c2 = torch.sum(p2 * wn[..., None], -2)
    q1 = p1 - c1[..., None, :]
    q2 = p2 - c2[..., None, :]
    M = torch.einsum("...n,...ni,...nj->...ij", wn, q1, q2)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], -2)
    # eigenvector of the largest eigenvalue (ascending order); its sign
    # does not matter: q and -q give one rotation
    R = quat_to_rot(torch.linalg.eigh(N).eigenvectors[..., :, -1])
    Rq1 = torch.einsum("...ij,...nj->...ni", R, q1)
    num = torch.sum(wn[..., None] * q2 * Rq1, (-2, -1))
    den = torch.sum(wn[..., None] * Rq1 * Rq1, (-2, -1))
    s = torch.ones_like(num) if fix_scale else num / torch.clamp_min(den, _EPS)
    t = c2 - s[..., None] * torch.einsum("...ij,...j->...i", R, c1)
    return R, t, s
