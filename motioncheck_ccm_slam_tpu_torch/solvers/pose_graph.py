"""Sim3 essential-graph pose-graph optimization.

Counterpart of ``motioncheck_ccm_slam_tpu/solvers/pose_graph.py`` (the
reference's ``Optimizer::OptimizeEssentialGraphLoopClosure``,
src/Optimizer.cpp:1064, and ``OptimizeEssentialGraphMapFusion``, :1339):
after a loop closure or a map merge, distribute the Sim3 correction over
the keyframe graph (loop edges, spanning tree, strong covisibility), then
the map layer corrects landmarks through their reference keyframes.

Vertices are S_iw (world -> KF i Sim3, stored [sR|t] 4x4); an edge's error
is e_ij = log_sim3(S_ji_meas^-1 . S_jw . S_iw^-1) in R^7. The edge
Jacobians are forward-mode autodiff of that float32 error with respect to
each end's left perturbation, batched over the edges
(``lie.jacobian_fwd``), as the JAX package's ``jax.jacfwd``. Two solvers
share them:

- ``dense``: normal equations assembled into a (7V, 7V) system, Cholesky;
- ``cg``: only the (V, 7, 7) block diagonal is built; every H @ v is two
  edge-gather einsums and two scatter-adds, solved by PCG in float64 with a
  two-level preconditioner (block Jacobi plus an exact solve over one
  motion per ``COARSE_BLOCK`` consecutive vertices), so that a long chain
  (a street drive's essential graph) converges in the fixed sweeps.

``method="auto"`` takes the dense route up to ``DENSE_MAX_V`` vertices.
The LM and PCG loops are Python loops whose decisions are ``torch.where``
on the device: no host read inside. Fixed vertices are frozen by identity
rows.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import lie
from ..utils import trace

DENSE_MAX_V = 192   # above this, (7V)^2 assembly loses to matrix-free CG
PCG_RZ_STOP = 1e-24   # PCG stops where r^T M^-1 r falls this far below its start
COARSE_BLOCK = 8      # consecutive vertices that one coarse vertex of PCG moves
PCG_SWEEPS = 20       # sweeps a solve: the two-level PCG reaches a 2,048-vertex chain's optimum


class PoseGraphEdges(NamedTuple):
    """Fixed-capacity edge list (E slots, masked)."""

    i: torch.Tensor          # (E,) i64 — vertex index i
    j: torch.Tensor          # (E,) i64 — vertex index j
    S_ji_meas: torch.Tensor  # (E, 4, 4) measured S_jw S_iw^-1
    weight: torch.Tensor     # (E,) f32 edge information scale
    valid: torch.Tensor      # (E,) bool


class PoseGraphResult(NamedTuple):
    S_iw: torch.Tensor       # (V, 4, 4) optimized Sim3 poses
    cost: torch.Tensor


def make_edge_measurements(S_iw, edges_i, edges_j):
    """S_ji_meas = S_jw S_iw^-1 from the given vertex poses. Pass the
    PRE-correction poses for normal edges (reference ``NonCorrectedSim3``)
    and the corrected estimates for loop-connection edges."""
    return S_iw[edges_j] @ lie.sim3_inv(S_iw[edges_i])


def _edge_error(Si, Sj, S_ji_meas_inv):
    """log_sim3(S_ji_meas^-1 Sj Si^-1) -> (..., 7)."""
    return lie.sim3_log(S_ji_meas_inv @ Sj @ lie.sim3_inv(Si))


def _error_perturbed_i(x, Si, Sj, Minv):
    return _edge_error(lie.sim3_exp(x) @ Si, Sj, Minv)


def _error_perturbed_j(x, Si, Sj, Minv):
    return _edge_error(Si, lie.sim3_exp(x) @ Sj, Minv)


def _edge_jacobians(Si, Sj, Minv):
    """Each edge's Jacobians (E, 7, 7) of its error in each end's left
    perturbation, at zero."""
    with trace.span("ess_graph_jac"):
        zero = torch.zeros(Si.shape[:-2] + (7,), dtype=Si.dtype, device=Si.device)
        return (lie.jacobian_fwd(_error_perturbed_i, zero, Si, Sj, Minv),
                lie.jacobian_fwd(_error_perturbed_j, zero, Si, Sj, Minv))


def _edge_terms(S, edges: PoseGraphEdges, meas_inv):
    """Residuals, Jacobians, weights and cost for all edges."""
    Si, Sj = S[edges.i], S[edges.j]
    r = _edge_error(Si, Sj, meas_inv)                       # (E, 7)
    Ji, Jj = _edge_jacobians(Si, Sj, meas_inv)            # (E, 7, 7) each
    w = torch.where(edges.valid, edges.weight, 0.0)
    return r, Ji, Jj, w, torch.sum(w * torch.sum(r * r, -1))


def _edge_cost(S, edges: PoseGraphEdges, meas_inv):
    r = _edge_error(S[edges.i], S[edges.j], meas_inv)
    w = torch.where(edges.valid, edges.weight, 0.0)
    return torch.sum(w * torch.sum(r * r, -1))


def _lm_update(S, lam, dx, fixed, edges, meas_inv, cost):
    """Apply dx where it lowers the cost; adapt the damping."""
    dx = torch.where(fixed[:, None], 0.0, dx)
    S_new = lie.sim3_exp(dx) @ S
    accept = _edge_cost(S_new, edges, meas_inv) < cost
    S = torch.where(accept, S_new, S)
    lam = torch.where(accept, torch.clamp_min(lam * 0.3, 1e-16),
                      torch.clamp_max(torch.clamp_min(lam, 1e-10) * 10.0, 1e2))
    return S, lam


# ---------------------------------------------------------------------------
# Dense path (small compacted graphs)
# ---------------------------------------------------------------------------

def _assemble_dense(S, edges: PoseGraphEdges, meas_inv, V: int):
    r, Ji, Jj, w, cost = _edge_terms(S, edges, meas_inv)
    wJi = Ji * w[:, None, None]
    wJj = Jj * w[:, None, None]
    ar7 = torch.arange(7, device=S.device)
    ri = (edges.i[:, None] * 7 + ar7[None, :])[:, :, None].expand(-1, 7, 7)
    rj = (edges.j[:, None] * 7 + ar7[None, :])[:, :, None].expand(-1, 7, 7)
    ci, cj = ri.transpose(1, 2), rj.transpose(1, 2)
    Hij = torch.einsum("eai,eaj->eij", wJi, Jj)
    blocks = ((ri, ci, torch.einsum("eai,eaj->eij", wJi, Ji)),
              (rj, cj, torch.einsum("eai,eaj->eij", wJj, Jj)),
              (ri, cj, Hij), (rj, ci, Hij.transpose(-1, -2)))
    H = torch.zeros((V * 7, V * 7), dtype=torch.float32, device=S.device)
    for rows, cols, vals in blocks:
        H = H.index_put((rows.reshape(-1), cols.reshape(-1)), vals.reshape(-1), accumulate=True)
    b = torch.zeros((V * 7,), dtype=torch.float32, device=S.device)
    b = b.index_add(0, ri[:, :, 0].reshape(-1), (-torch.einsum("eai,ea->ei", wJi, r)).reshape(-1))
    b = b.index_add(0, rj[:, :, 0].reshape(-1), (-torch.einsum("eai,ea->ei", wJj, r)).reshape(-1))
    return H, b, cost


def _optimize_dense(S_iw_init, edges, fixed, meas_inv, iterations, lambda_init):
    V = S_iw_init.shape[0]
    dev = S_iw_init.device
    fixed_rows = torch.repeat_interleave(fixed, 7)
    eye = torch.eye(V * 7, dtype=torch.float32, device=dev)
    S, lam = S_iw_init, torch.tensor(lambda_init, dtype=torch.float32, device=dev)
    for _ in range(iterations):
        H, b, cost = _assemble_dense(S, edges, meas_inv, V)
        # freeze fixed vertices
        H = torch.where(fixed_rows[:, None] | fixed_rows[None, :], 0.0, H)
        H = H + torch.diag(fixed_rows.to(torch.float32))
        b = torch.where(fixed_rows, 0.0, b)
        Hd = H + torch.diag(lam * torch.diagonal(H) + 1e-10)
        # Cholesky without an error check (a host read): like the JAX
        # package's cho_factor, a failed factor gives a step that the cost
        # test rejects
        L, _ = torch.linalg.cholesky_ex(Hd + 1e-8 * eye)
        dx = torch.cholesky_solve(b[:, None], L)[:, 0].reshape(V, 7)
        S, lam = _lm_update(S, lam, dx, fixed, edges, meas_inv, cost)
    return S, _edge_cost(S, edges, meas_inv)


# ---------------------------------------------------------------------------
# Matrix-free PCG path (server-scale graphs)
# ---------------------------------------------------------------------------

def _adjoint(S):
    """(V, 7, 7) Adj(S_v): the left perturbation log(S_v exp(e) S_v^-1) of
    each vertex that one right perturbation e (a motion of the frame the
    poses map from) makes."""
    def conj(e, Sv):
        return lie.sim3_log(Sv @ lie.sim3_exp(e) @ lie.sim3_inv(Sv))
    zero = torch.zeros(S.shape[:-2] + (7,), dtype=S.dtype, device=S.device)
    return lie.jacobian_fwd(conj, zero, S)


def _two_level(S, edges, w, Ji, Jj, damp, fixed, M_inv):
    """The PCG preconditioner: block Jacobi plus an exact solve over coarse
    vertices, each one motion of ``COARSE_BLOCK`` consecutive vertices
    (``_adjoint`` maps it to their left perturbations; zero at fixed ones).
    Block Jacobi alone leaves a chain's long, smooth modes to the sweeps,
    which need about as many sweeps as the chain has vertices."""
    V, dev, dt = S.shape[0], S.device, Ji.dtype
    B = COARSE_BLOCK
    Vc = -(-V // B)
    g = torch.arange(V, device=dev) // B
    P = torch.where(fixed[:, None, None], 0.0, _adjoint(S).to(dt))          # (V, 7, 7)
    Ci = torch.einsum("eab,ebc->eac", Ji, P[edges.i])
    Cj = torch.einsum("eab,ebc->eac", Jj, P[edges.j])
    ar7 = torch.arange(7, device=dev)
    ri = (g[edges.i][:, None] * 7 + ar7[None, :])[:, :, None].expand(-1, 7, 7)
    rj = (g[edges.j][:, None] * 7 + ar7[None, :])[:, :, None].expand(-1, 7, 7)
    wCi, wCj = Ci * w[:, None, None], Cj * w[:, None, None]
    Hij = torch.einsum("eai,eaj->eij", wCi, Cj)
    Hc = torch.zeros((Vc * 7, Vc * 7), dtype=dt, device=dev)
    for rows, cols, vals in ((ri, ri.transpose(1, 2), torch.einsum("eai,eaj->eij", wCi, Ci)),
                             (rj, rj.transpose(1, 2), torch.einsum("eai,eaj->eij", wCj, Cj)),
                             (ri, rj.transpose(1, 2), Hij),
                             (rj, ri.transpose(1, 2), Hij.transpose(-1, -2))):
        Hc = Hc.index_put((rows.reshape(-1), cols.reshape(-1)), vals.reshape(-1),
                          accumulate=True)
    rv = (g[:, None] * 7 + ar7[None, :])[:, :, None].expand(-1, 7, 7)
    Hc = Hc.index_put((rv.reshape(-1), rv.transpose(1, 2).reshape(-1)),
                      torch.einsum("vai,va,vaj->vij", P, damp, P).reshape(-1), accumulate=True)
    diag = torch.diagonal(Hc)
    Lc, _ = torch.linalg.cholesky_ex(Hc + torch.diag(torch.where(diag > 0, 1e-12 * diag, 1.0)))
    # one matrix-vector product a sweep, not two triangular solves
    Hc_inv = torch.cholesky_inverse(Lc)
    pad = Vc * B - V
    Pg = torch.cat([P, P.new_zeros((pad, 7, 7))]).reshape(Vc, B, 7, 7)

    def apply(r):
        rc = torch.einsum("gkab,gka->gb", Pg, torch.cat([r, r.new_zeros((pad, 7))])
                          .reshape(Vc, B, 7))
        zc = (Hc_inv @ rc.reshape(-1)).reshape(Vc, 7)
        coarse = torch.einsum("gkab,gb->gka", Pg, zc).reshape(Vc * B, 7)[:V]
        return torch.einsum("vij,vj->vi", M_inv, r) + coarse
    return apply


def _optimize_cg(S_iw_init, edges, fixed, meas_inv, iterations, lambda_init, pcg_iters: int):
    """LM where each damped-normal-equation solve is PCG with H @ v computed
    edge-wise: u_e = [Ji Jj] [v_i; v_j], then one scatter of [wJi wJj]^T u_e.
    The solve runs in float64: a long chain's normal equations reach a
    condition number of 1e10, where float32 sweeps stall. Memory is
    O(E * 98 + V * 49 + (7V / COARSE_BLOCK)^2), no (7V)^2."""
    V = S_iw_init.shape[0]
    dev = S_iw_init.device
    f64 = torch.float64
    eye7 = torch.eye(7, dtype=f64, device=dev)
    fixed_v = fixed[:, None]
    ends = torch.stack([edges.i, edges.j], -1)                               # (E, 2)
    ends_flat = ends.reshape(-1)
    S, lam = S_iw_init, torch.tensor(lambda_init, dtype=torch.float32, device=dev)
    for _ in range(iterations):
        r, Ji, Jj, w, cost = _edge_terms(S, edges, meas_inv)
        r, Ji, Jj, w = r.to(f64), Ji.to(f64), Jj.to(f64), w.to(f64)
        J = torch.cat([Ji, Jj], -1)                                         # (E, 7, 14)
        wJ = J * w[:, None, None]
        # block diagonal + gradient
        Hd = torch.zeros((V, 7, 7), dtype=f64, device=dev)
        Hd = Hd.index_add(0, edges.i, torch.einsum("eai,eaj->eij", wJ[..., :7], Ji))
        Hd = Hd.index_add(0, edges.j, torch.einsum("eai,eaj->eij", wJ[..., 7:], Jj))
        b = torch.zeros((V, 7), dtype=f64, device=dev).index_add(
            0, ends_flat, -torch.einsum("eai,ea->ei", wJ, r).reshape(-1, 7))
        b = torch.where(fixed_v, 0.0, b)
        # damping on the diagonal entries (same rule as the dense path)
        damp = lam.to(f64) * torch.diagonal(Hd, dim1=-2, dim2=-1) + 1e-10      # (V, 7)

        def matvec(v):
            vz = torch.where(fixed_v, 0.0, v)
            u = torch.einsum("eab,eb->ea", J, vz[ends].reshape(-1, 14))
            out = torch.zeros((V, 7), dtype=f64, device=dev).index_add(
                0, ends_flat, torch.einsum("eab,ea->eb", wJ, u).reshape(-1, 7))
            return torch.where(fixed_v, v, torch.addcmul(out, damp, vz))

        Hd_damped = Hd + eye7[None] * damp[:, :, None]
        Hd_damped = torch.where(fixed[:, None, None], eye7[None], Hd_damped)
        M_inv = torch.linalg.inv_ex(Hd_damped + 1e-8 * eye7[None])[0]
        precond = _two_level(S, edges, w, Ji, Jj, damp, fixed, M_inv)
        x = torch.zeros_like(b)
        rr = b
        z = precond(rr)
        p, rz = z, torch.vdot(rr.reshape(-1), z.reshape(-1))
        rz_stop = PCG_RZ_STOP * rz
        for _ in range(pcg_iters):
            Ap = matvec(p)
            pAp = torch.vdot(p.reshape(-1), Ap.reshape(-1))
            # converged (or broken down): x stays where rounding would move it
            live = (rz > rz_stop) & (pAp > 0)
            alpha = torch.where(live, rz / pAp, 0.0)
            x = torch.addcmul(x, alpha, p)
            rr = torch.addcmul(rr, alpha, Ap, value=-1.0)
            z = precond(rr)
            rz_new = torch.vdot(rr.reshape(-1), z.reshape(-1))
            beta = torch.where(live, rz_new / rz, 0.0)
            p = torch.addcmul(z, beta, p)
            rz = torch.where(live, rz_new, rz)
        S, lam = _lm_update(S, lam, x.to(S.dtype), fixed, edges, meas_inv, cost)
    return S, _edge_cost(S, edges, meas_inv)


def optimize_pose_graph(S_iw_init, edges: PoseGraphEdges, fixed, iterations: int = 10,
                        lambda_init: float = 1e-16, method: str = "auto",
                        pcg_iters: int = PCG_SWEEPS) -> PoseGraphResult:
    """LM over the Sim3 pose graph.

    fixed: (V,) bool — gauge vertices (loop KF, reference Optimizer.cpp:1085).
    method: "dense" | "cg" | "auto" (dense up to DENSE_MAX_V vertices).
    """
    V = S_iw_init.shape[0]
    meas_inv = lie.sim3_inv(edges.S_ji_meas)
    if method == "auto":
        method = "dense" if V <= DENSE_MAX_V else "cg"
    if method == "dense":
        S, cost = _optimize_dense(S_iw_init, edges, fixed, meas_inv, iterations, lambda_init)
    else:
        S, cost = _optimize_cg(S_iw_init, edges, fixed, meas_inv, iterations, lambda_init,
                               pcg_iters)
    return PoseGraphResult(S_iw=S, cost=cost)


def correct_landmarks(Xw, ref_kf_idx, S_iw_before, S_iw_after):
    """Move landmarks with their reference keyframes after a pose-graph solve
    (reference Optimizer.cpp:1287-1326): X' = S_after^-1( S_before( X ) )."""
    Sb = S_iw_before[ref_kf_idx]          # (L, 4, 4) world->kf (old)
    Sa_inv = lie.sim3_inv(S_iw_after[ref_kf_idx])
    x_kf = torch.einsum("lij,lj->li", Sb[:, :3, :3], Xw) + Sb[:, :3, 3]
    return torch.einsum("lij,lj->li", Sa_inv[:, :3, :3], x_kf) + Sa_inv[:, :3, 3]


def se3_from_sim3(S):
    """Project optimized Sim3 back to SE3: divide translation by scale
    (reference: [R t/s; 0 1] after essential-graph optimization)."""
    R, t, s = lie.split_sim3(S)
    return lie.make_T(R, t / s[..., None])
