"""Tile-stream global bundle adjustment on one device.

Counterpart of the tile part of
``motioncheck_ccm_slam_tpu/parallel/sharded_ba.py`` (``make_tile_gba`` and
what it runs), the server's GBA at scale: the replacement for g2o's
``MapFusionGBA`` (reference src/Optimizer.cpp:646).

Observations are laid out in landmark-aligned tiles (``TilePlan``), so
every landmark-side quantity (Hll, bl, Hll^-1, u, dl) is a function of one
tile. Each LM iteration:

1. the carried linearisation (one K3 pass) gives Hcc, bc, Hll, bl and W;
2. damping and gauge fixing; landmark blocks inverted in closed form;
3. reduced RHS br = bc - W Hll^-1 bl (K7) and the true-Schur-diagonal
   block-Jacobi preconditioner (K5);
4. preconditioned CG on the (C, 6) camera system, every product one K4;
5. landmark back-substitution dl = Hll^-1 bl - Hll^-1 W^T dc (K6);
6. one K3 pass at the candidate state both prices the step (exact robust
   cost) and, when the step is accepted, is the next iteration's
   linearisation; accept/reject stays on the device.

The PCG loop is a Python loop: its exit test reads one scalar to the host
per sweep (the JAX package's ``while_loop`` keeps it on the device). The
multi-device mesh, the TPU routing toggles and the gather formulations of
the JAX module are not part of this module.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import schur_cuda
from ..solvers import ba_core
from ..solvers.local_ba import BAResult

# Eisenstat-Walker forcing for the inner PCG solve: rtol_k =
# clip(sqrt(|g_k| / |g_0|), EW_FLOOR, EW_MAX), loose while the gradient is
# large and tightening as it drops; the exact cost gate re-checks every
# step. It engages only from EW_MIN_CAMS cameras on: on small systems a
# tight solve is cheap and loose steps waste LM iterations.
EW_MAX = 0.1
EW_FLOOR = 1e-5
EW_MIN_CAMS = 512


def _ew_rtol(gnorm, g0, n_cams: int):
    """Forcing tolerance from the current and initial reduced-gradient
    norms (0-d tensors). ``g0 <= 0`` marks the first LM iteration (no
    reference yet) -> EW_MAX."""
    if n_cams < EW_MIN_CAMS:
        return EW_FLOOR
    ratio = torch.where(g0 > 0, gnorm / torch.clamp_min(g0, 1e-30), torch.ones_like(gnorm))
    return torch.clamp(torch.sqrt(ratio), EW_FLOOR, EW_MAX)


def _pcg(matvec, b, M_inv_blocks, iters: int, rtol=1e-5):
    """Block-Jacobi preconditioned CG on the (C, 6) camera system.

    At most ``iters`` sweeps; stops once the preconditioned residual r.z
    drops below rtol^2 * (r0.z0). ``rtol`` may be a 0-d tensor. The exit
    test reads one scalar to the host per sweep.
    """

    def precond(r):
        return torch.einsum("cij,cj->ci", M_inv_blocks, r)

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    thresh = (rtol * rtol) * rz
    one = torch.ones_like(rz)
    i = 0
    while i < iters and bool(rz > thresh):
        Ap = matvec(p)
        pAp = torch.sum(p * Ap)
        alpha = rz / torch.where(torch.abs(pAp) < 1e-12, one, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.where(torch.abs(rz) < 1e-12, one, rz)
        p = z + beta * p
        rz = rz_new
        i += 1
    return x


class TilePlan(NamedTuple):
    """A SchurPlan's slot streams on the device, with the maps between
    slots and the original observation order."""

    ntl: int
    TP: int
    L_pad: int
    camid: torch.Tensor    # (OP,) i32 camera per slot, pad -> 0
    lmloc: torch.Tensor    # (OP,) i32 tile-local landmark per slot, pad -> 0
    to_orig: torch.Tensor  # (OP,) i64 slot -> original obs position (pad -> O)
    slot_of: torch.Tensor  # (O,) i64 original obs -> slot (invalid -> 0)
    lm_p: torch.Tensor     # (OP,) i64 global landmark id per slot


def build_tile_plan(obs: ba_core.BAObservations, C: int, L: int) -> TilePlan:
    """Host-side tile plan for any observation stream, placed on the
    observations' device. Raises on a valid observation whose camera or
    landmark index is out of range (the kernels index with them)."""
    lm_np = obs.lm_idx.cpu().numpy().astype(np.int64)
    cam_np = obs.cam_idx.cpu().numpy().astype(np.int64)
    valid_np = obs.valid.cpu().numpy().astype(bool)
    if valid_np.any():
        lv, cv = lm_np[valid_np], cam_np[valid_np]
        if lv.min() < 0 or lv.max() >= L or cv.min() < 0 or cv.max() >= C:
            raise ValueError(f"observation index out of range (C={C}, L={L})")
    O = lm_np.shape[0]
    order = np.argsort(lm_np, kind="stable")
    sp = schur_cuda.build_schur_plan(lm_np[order], cam_np[order], L,
                                     valid_sorted=valid_np[order])
    to_orig = np.append(order, O)[sp.perm]
    real = to_orig < O
    slot_of = np.zeros(O, np.int64)
    slot_of[to_orig[real]] = np.flatnonzero(real)
    tiles = np.arange(sp.ntl * sp.TP, dtype=np.int64) // sp.TP
    lm_p = tiles * schur_cuda.LM_BLOCK + sp.lmloc

    dev = obs.cam_idx.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return TilePlan(ntl=sp.ntl, TP=sp.TP, L_pad=sp.L_pad, camid=t(sp.camid),
                    lmloc=t(sp.lmloc), to_orig=t(to_orig), slot_of=t(slot_of),
                    lm_p=t(lm_p))


class TileStreams(NamedTuple):
    """Per-call slot streams: what K3 reads besides the state."""

    uv: torch.Tensor       # (OP, 2)
    is2: torch.Tensor      # (OP,)
    valid: torch.Tensor    # (OP,) 0/1
    free: torch.Tensor     # (OP,) 0/1: neither camera nor landmark is fixed
    kp: torch.Tensor       # (4,) fx, fy, cx, cy


def tile_streams(tp: TilePlan, obs: ba_core.BAObservations, K, fixed_cam,
                 fixed_lm_pad) -> TileStreams:
    """Gathers the observation streams into slot order once per call (pad
    slots read an appended zero / False entry)."""
    dev = obs.uv.device
    uv = torch.cat([obs.uv, torch.zeros((1, 2), dtype=obs.uv.dtype, device=dev)])
    is2 = torch.cat([obs.inv_sigma2, torch.zeros((1,), dtype=obs.inv_sigma2.dtype, device=dev)])
    valid = torch.cat([obs.valid, torch.zeros((1,), dtype=torch.bool, device=dev)])
    free = ~(fixed_cam[tp.camid.long()] | fixed_lm_pad[tp.lm_p])
    kp = torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]).to(torch.float32)
    return TileStreams(uv=uv[tp.to_orig].contiguous(), is2=is2[tp.to_orig].contiguous(),
                       valid=valid[tp.to_orig].float(), free=free.float(),
                       kp=kp.contiguous())


def _pose_table(Tcw) -> torch.Tensor:
    """(C, 4, 4) -> (C, 12): R row-major, then t."""
    C = Tcw.shape[0]
    return torch.cat([Tcw[:, :3, :3].reshape(C, 9), Tcw[:, :3, 3]], 1).contiguous()


def _tile_linearize(Tcw, Xw_pad, tp: TilePlan, st: TileStreams):
    """One K3 pass at (Tcw, Xw): the full linearisation (W stream, aux
    rows, landmark Hll+bl, camera Hcc+bc) plus the exact robust cost."""
    W18, aux, hllbl, cam27 = schur_cuda.d1_assemble(
        tp.camid, tp.lmloc, st.uv, st.is2, st.valid, st.free, st.kp,
        _pose_table(Tcw), Xw_pad.contiguous(), TP=tp.TP)
    return W18, aux, hllbl, cam27, torch.sum(aux[0])


def _tile_iteration(state, fixed_cam, fixed_lm_pad, pcg_iters: int,
                    tp: TilePlan, st: TileStreams):
    """One LM iteration on the tile stream. The state carries the
    linearisation of the carried (Tcw, Xw); the candidate's K3 pass both
    prices the step and, if it is accepted, becomes the next linearisation.
    Returns (state, cost of the candidate)."""
    Tcw, Xw, lam, g0, W18, aux3, hllbl, cam27, cost = state
    C, L_pad, TP = Tcw.shape[0], tp.L_pad, tp.TP
    dev, dt = Tcw.device, Tcw.dtype
    Hcc = schur_cuda.sym6_from_tri(cam27[:, :21])
    bc = cam27[:, 21:]
    Hll = hllbl[0:9].T.reshape(L_pad, 3, 3)
    bl = hllbl[9:12].T

    eye6 = torch.eye(6, dtype=dt, device=dev)
    Hcc_d = ba_core.damp_blocks(Hcc, lam)
    Hcc_d = torch.where(fixed_cam[:, None, None], eye6, Hcc_d)
    bc = torch.where(fixed_cam[:, None], torch.zeros_like(bc), bc)
    Hll_d = ba_core.damp_blocks(Hll, lam)
    Hll_d = torch.where(fixed_lm_pad[:, None, None], torch.eye(3, dtype=dt, device=dev), Hll_d)
    bl = torch.where(fixed_lm_pad[:, None], torch.zeros_like(bl), bl)
    Hll_inv = ba_core.inv33(Hll_d)
    H9 = Hll_inv.reshape(L_pad, 9).T.contiguous()              # (9, L_pad)

    # reduced RHS br = bc - W Hll^-1 bl (K7)
    u0 = torch.einsum("lij,lj->li", Hll_inv, bl)               # (L_pad, 3)
    br = bc - schur_cuda.apply_b_raw(tp.camid, tp.lmloc, W18, u0.T.contiguous(),
                                     C, TP=TP)

    # block-Jacobi preconditioner on the true Schur diagonal (K5)
    S21 = schur_cuda.d2_precond(tp.camid, tp.lmloc, W18, H9, C, TP=TP)
    S_diag = Hcc_d - schur_cuda.sym6_from_tri(S21)
    M_inv = ba_core.inv66_spd(S_diag + 1e-6 * eye6)

    def matvec(v):
        Hv = torch.einsum("cij,cj->ci", Hcc_d, v)
        return Hv - schur_cuda.s_apply(tp.camid, tp.lmloc, W18, v.contiguous(), H9, TP=TP)

    gnorm = torch.linalg.norm(br)
    g0 = torch.where(g0 > 0, g0, gnorm)
    dc = _pcg(matvec, br, M_inv, pcg_iters, rtol=_ew_rtol(gnorm, g0, C))
    dc = torch.where(fixed_cam[:, None], torch.zeros_like(dc), dc)

    # landmark back-substitution: dl = u0 - Hll^-1 segsum(W^T dc) (K6)
    a3 = schur_cuda.apply_a_raw(tp.camid, tp.lmloc, W18, dc, H9, TP=TP)
    dl = u0 - a3.T
    dl = torch.where(fixed_lm_pad[:, None], torch.zeros_like(dl), dl)

    T_new = ba_core.apply_pose_update(Tcw, dc, mask=~fixed_cam)
    X_new = Xw + dl
    Wn, auxn, hllbln, cam27n, cost_new = _tile_linearize(T_new, X_new, tp, st)
    accept = cost_new < cost
    state = (
        torch.where(accept, T_new, Tcw),
        torch.where(accept, X_new, Xw),
        torch.where(accept, torch.clamp_min(lam * 0.5, 1e-8), torch.clamp_max(lam * 4.0, 1e4)),
        g0,
        torch.where(accept, Wn, W18),
        torch.where(accept, auxn, aux3),
        torch.where(accept, hllbln, hllbl),
        torch.where(accept, cam27n, cam27),
        torch.where(accept, cost_new, cost),
    )
    return state, cost_new


def _tile_body(Tcw, Xw_pad, fixed_cam, fixed_lm_pad, n_iters: int,
               pcg_iters: int, tp: TilePlan, st: TileStreams):
    """n_iters LM iterations and the final inlier classification on the
    tile stream. Returns (Tcw, Xw_pad, inlier per slot, cost)."""
    dev = Tcw.device
    state = (Tcw, Xw_pad, torch.tensor(1e-4, dtype=torch.float32, device=dev),
             torch.tensor(-1.0, dtype=torch.float32, device=dev)) \
        + _tile_linearize(Tcw, Xw_pad, tp, st)
    for _ in range(n_iters):
        state, _cost = _tile_iteration(state, fixed_cam, fixed_lm_pad, pcg_iters, tp, st)
    Tcw_o, Xw_o, _lam, _g0, _W, aux3, _h, _c27, _cost = state
    # the carried linearisation is of the carried state, so its aux rows are
    # the classification: no extra pass
    inlier = aux3[1] > 0.5
    return Tcw_o, Xw_o, inlier, torch.sum(aux3[1] * aux3[2])


def make_tile_gba(iterations: int = 5, pcg_iters: int = 25):
    """Tile-stream GBA on one device.

    Returns ``gba(Tcw, Xw, obs, K, fixed_cam, fixed_lm, n_iterations=None)
    -> BAResult``. Accepts any observation stream; the tile plan is built
    on the host once per problem and cached by the identity of the
    observation index arrays (strong references, so a recycled id() cannot
    alias a stale plan).
    """
    plan_cache: list = [None]

    def gba(Tcw, Xw, obs: ba_core.BAObservations, K, fixed_cam, fixed_lm,
            n_iterations=None) -> BAResult:
        C, L = int(Tcw.shape[0]), int(Xw.shape[0])
        ent = plan_cache[0]
        if (ent is None or ent[0] is not obs.lm_idx or ent[1] is not obs.cam_idx
                or ent[2] != (C, L) or ent[3] is not obs.valid):
            ent = (obs.lm_idx, obs.cam_idx, (C, L), obs.valid,
                   build_tile_plan(obs, C, L))
            plan_cache[0] = ent
        tp = ent[4]
        n_it = iterations if n_iterations is None else int(n_iterations)
        pad = tp.L_pad - L
        fixed_lm_pad = torch.cat([fixed_lm, torch.ones((pad,), dtype=torch.bool,
                                                       device=fixed_lm.device)])
        Xw_pad = torch.cat([Xw, torch.zeros((pad, 3), dtype=Xw.dtype, device=Xw.device)])
        st = tile_streams(tp, obs, K, fixed_cam, fixed_lm_pad)
        Tcw_o, Xw_o, inlier_slots, cost = _tile_body(
            Tcw, Xw_pad, fixed_cam, fixed_lm_pad, n_it, pcg_iters, tp, st)
        inlier = inlier_slots[tp.slot_of] & obs.valid
        return BAResult(Tcw=Tcw_o, Xw=Xw_o[:L], obs_inlier=inlier, cost=cost)

    return gba
