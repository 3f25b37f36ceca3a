"""Matrix-free global bundle adjustment, on one device or over shards.

Counterpart of ``motioncheck_ccm_slam_tpu/parallel/sharded_ba.py``: the
server's GBA at scale, the replacement for g2o's ``MapFusionGBA`` and its
OpenMP threads (reference src/Optimizer.cpp:646, initMultiThreading :792).
Three solvers:

- ``make_tile_gba``: the tile-stream GBA (kernels K3-K7), on one device or
  with the landmark-tile axis split over shards (``Shards``: devices of
  this process, and ranks of a ``torch.distributed`` group);
- ``make_sharded_gba``: the gather formulation (plain torch, no kernel),
  with the observation axis split over shards;
- ``make_matrix_free_gba``: the dual-layout solver on one device (K9 and
  the plan-form Schur products), at the end of the module.

**Shards.** The counterpart of the JAX package's 1-D mesh: a shard is a
device plus an equal contiguous range of the work axis. Camera-side
quantities live on the first local device and the shards' camera-side
partials are summed there in shard order, then over the group (``psum``'s
counterpart, deterministic: no atomics across shards); the landmark side
stays on its shard.

**The tile-stream GBA.**

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
per sweep (the JAX package's ``while_loop`` keeps it on the device).

**The matrix-free GBA** (``_gba_iteration_cm``) keeps the observation
stream in two layouts: camera-major (the caller's order, observation o =
c * seg + i) for the camera blocks, the cost and the preconditioner, and
the plan's landmark-aligned tile stream for the landmark blocks and the W
stream the Schur products read. It always runs the JAX module's plan form
(its ``sp_statics`` branch with the stream and br/dl toggles on): K9
materialises the tile stream's R, t and X, every PCG product is one
``schur_apply``, br one ``apply_b`` and the back-substitution one
``apply_a``.

Left out, as TPU routing: the ``MCSLAM_PALLAS_*`` / ``MCSLAM_TILE_GBA`` /
``PALLAS_SCHUR_MIN_CAMS`` switches and ``make_tile_gba``'s ``fallback``
(the port's tile plan always exists); the caller picks a solver.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import schur_cuda
from ..solvers import ba_core
from ..solvers.local_ba import BAResult, _robust_cost
from ..utils import trace

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


def _pcg(matvec, b, M_inv_blocks, iters: int, rtol=1e-5, decide=bool):
    """Block-Jacobi preconditioned CG on the (C, 6) camera system.

    At most ``iters`` sweeps; stops once the preconditioned residual r.z
    drops below rtol^2 * (r0.z0). ``rtol`` may be a 0-d tensor. The exit
    test reads one scalar to the host per sweep, through ``decide`` (a
    0-d bool tensor -> bool): ``Shards.all_true`` over a process group, so
    that every rank takes the same number of sweeps. The solve is span
    ``pcg``, each exit test's read span ``pcg_exit_read`` and a host sync
    (``utils/trace``).
    """

    def precond(r):
        return torch.einsum("cij,cj->ci", M_inv_blocks, r)

    with trace.span("pcg"):
        x = torch.zeros_like(b)
        r = b
        z = precond(r)
        p = z
        rz = torch.sum(r * z)
        thresh = (rtol * rtol) * rz
        one = torch.ones_like(rz)
        i = 0
        while i < iters:
            flag = rz > thresh
            with trace.span("pcg_exit_read"):
                go = decide(flag)
            trace.count("host_syncs")
            if not go:
                break
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


# ---------------------------------------------------------------------------
# Shards: the counterpart of the JAX package's 1-D device mesh
# ---------------------------------------------------------------------------

class Shards:
    """The shards of a sharded GBA and the reduction between them.

    A shard is a device plus one of ``n`` equal contiguous ranges of a work
    axis: landmark tiles (the tile GBA) or observations (the gather
    formulation). This process holds the local shards, one a device of
    ``devices`` (a device may hold several); with a ``torch.distributed``
    group every rank holds as many, and rank r's are the global shards
    [r * len(devices), (r + 1) * len(devices)). One process driving all
    shards is the counterpart of JAX's single-controller ``shard_map``, one
    process a shard that of its multi-controller mesh.

    Camera-side quantities (poses, the (C, 6) PCG state, Hcc and every
    product) live on the first local device, ``home``: ``reduce`` sums the
    shards' camera-side partials there in shard order (then over the
    group), the counterpart of ``psum``; ``replicate`` hands a home tensor
    to each shard's device. The landmark side stays on its shard. With one
    local shard and no group both are the identity.
    """

    def __init__(self, devices, group=None):
        if not devices:
            raise ValueError("Shards: no device")
        self.devices = [_device(d) for d in devices]
        self.home = self.devices[0]
        self.group = group
        self.world = 1 if group is None else dist.get_world_size(group)
        rank = 0 if group is None else dist.get_rank(group)
        self.first = rank * len(self.devices)
        self.n = self.world * len(self.devices)

    def ranges(self, total: int):
        """The local shards' (start, stop) of an axis of ``total`` entries,
        a multiple of ``n``."""
        if total % self.n:
            raise ValueError(f"Shards: {total} entries do not split into {self.n} shards")
        part = total // self.n
        return [((self.first + k) * part, (self.first + k + 1) * part)
                for k in range(len(self.devices))]

    def reduce(self, partials):
        """The sum of the local shards' partials on ``home``, added in
        shard order, then summed over the group. May reuse the first
        partial's storage."""
        acc = partials[0].to(self.home)
        for p in partials[1:]:
            acc = acc + p.to(self.home)
        if self.group is not None:
            dist.all_reduce(acc, group=self.group)
        return acc

    def replicate(self, x):
        """A home tensor on each local shard's device (no copy where that
        device is home)."""
        return [x.to(d) for d in self.devices]

    def all_true(self, flag) -> bool:
        """A 0-d bool tensor's value that every rank agrees on: True only
        where it is True on every rank (summed over the group)."""
        if self.group is None:
            return bool(flag)
        n = flag.to(torch.int32).reshape(1)
        dist.all_reduce(n, group=self.group)
        return int(n) == self.world

    def gather(self, parts, total: int):
        """The local shards' parts (each rows ``ranges(total)[k]`` of an
        axis of ``total`` rows) as one tensor of all ``total`` rows on
        home; over a group, summed into zeros (exact: every row has one
        non-zero writer)."""
        if self.group is None and len(parts) == 1:
            return parts[0]
        if self.group is None:
            return torch.cat([p.to(self.home) for p in parts])
        dtype = parts[0].dtype
        full = torch.zeros((total,) + tuple(parts[0].shape[1:]), device=self.home,
                           dtype=torch.int32 if dtype == torch.bool else dtype)
        for (a, b), p in zip(self.ranges(total), parts):
            full[a:b] = p.to(self.home)
        dist.all_reduce(full, group=self.group)
        return full.bool() if dtype == torch.bool else full


def _device(d) -> torch.device:
    """``d`` as a torch.device with its index ("cuda" -> the current card)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _shards(devices, group, default_device) -> Shards:
    return Shards(list(devices) if devices else [default_device], group)


# ---------------------------------------------------------------------------
# The gather formulation over shards of the observation axis
# ---------------------------------------------------------------------------

def _pad_obs(obs: ba_core.BAObservations, n_dev: int) -> ba_core.BAObservations:
    """Observations padded with invalid entries (camera 0, landmark 0) to a
    multiple of ``n_dev``."""
    O = obs.cam_idx.shape[0]
    pad = (-O) % n_dev
    if pad == 0:
        return obs
    return ba_core.BAObservations(*[
        torch.cat([a, torch.zeros((pad,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)])
        for a in obs])


def _schur_matvec(v, Hcc_d, Hll_inv, Wcls, obs_shards, C: int, L: int, sh: Shards):
    """S v for the reduced camera system: v (C, 6) on home; per shard two
    gather / scatter-add sweeps over its observations (Wcls[k] (O_k, 6,
    3)), each reduced over the shards."""
    Hv = torch.einsum("cij,cj->ci", Hcc_d, v)
    # u_l = sum_obs Wcl^T v[cam] -> (L, 3)
    u = sh.reduce([
        ba_core._scatter_sum(o.lm_idx, torch.einsum("oij,oi->oj", W, vk[o.cam_idx]), L)
        for o, W, vk in zip(obs_shards, Wcls, sh.replicate(v))])
    u = torch.einsum("lij,lj->li", Hll_inv, u)
    # w_c = sum_obs Wcl u[lm] -> (C, 6)
    w = sh.reduce([
        ba_core._scatter_sum(o.cam_idx, torch.einsum("oij,oj->oi", W, uk[o.lm_idx]), C)
        for o, W, uk in zip(obs_shards, Wcls, sh.replicate(u))])
    return Hv - w


def _gba_iteration(state, obs_shards, K, fixed_cam, fixed_lm, C: int, L: int, pcg_iters: int,
                   sh: Shards):
    """One LM iteration of the gather formulation. Poses and landmarks are
    replicated: each shard linearises its observations (residuals,
    Jacobians, scatter sums), the blocks Hcc, bc, Hll, bl are reduced and
    the damped system is formed on home. Returns (state, cost of the
    candidate)."""
    Tcw, Xw, lam, g0 = state
    dev, dt = Tcw.device, Tcw.dtype
    Ts, Xs, Ks = sh.replicate(Tcw), sh.replicate(Xw), sh.replicate(K)
    fcs, fls = sh.replicate(fixed_cam), sh.replicate(fixed_lm)
    costs, blocks, Wcls = [], [], []
    for o, Tk, Xk, Kk, fck, flk in zip(obs_shards, Ts, Xs, Ks, fcs, fls):
        r, pc, depth_ok = ba_core.reproject_residuals(Tk, Xk, o, Kk)
        w, chi2 = ba_core.robust_obs_weights(r, o, depth_ok)
        costs.append(_robust_cost(chi2, o.valid))
        Jc, Jl = ba_core.reproject_jacobians(pc, Tk[o.cam_idx][:, :3, :3], Kk)
        Hcc_k, bc_k, Hll_k, bl_k, W = ba_core.assemble_blocks(
            Jc, Jl, r, w, o.cam_idx, o.lm_idx, C, L)
        blocks.append((Hcc_k, bc_k, Hll_k, bl_k))
        free = ~(fck[o.cam_idx] | flk[o.lm_idx])
        Wcls.append(torch.where(free[:, None, None], W, torch.zeros_like(W)))
    cost = sh.reduce(costs)
    Hcc, bc, Hll, bl = (sh.reduce([b[i] for b in blocks]) for i in range(4))

    eye6 = torch.eye(6, dtype=dt, device=dev)
    Hcc_d = ba_core.damp_blocks(Hcc, lam)
    Hcc_d = torch.where(fixed_cam[:, None, None], eye6, Hcc_d)
    bc = torch.where(fixed_cam[:, None], torch.zeros_like(bc), bc)
    Hll_d = ba_core.damp_blocks(Hll, lam)
    Hll_d = torch.where(fixed_lm[:, None, None], torch.eye(3, dtype=dt, device=dev), Hll_d)
    bl = torch.where(fixed_lm[:, None], torch.zeros_like(bl), bl)
    Hll_inv = ba_core.inv33(Hll_d)
    Hinvs = sh.replicate(Hll_inv)

    # reduced RHS: br = bc - W Hll^-1 bl
    u = torch.einsum("lij,lj->li", Hll_inv, bl)
    Wu = sh.reduce([
        ba_core._scatter_sum(o.cam_idx, torch.einsum("oij,oj->oi", W, uk[o.lm_idx]), C)
        for o, W, uk in zip(obs_shards, Wcls, sh.replicate(u))])
    br = bc - Wu

    def matvec(v):
        return _schur_matvec(v, Hcc_d, Hll_inv, Wcls, obs_shards, C, L, sh)

    # block-Jacobi on the true Schur diagonal
    S_obs = []
    for o, W, Hk in zip(obs_shards, Wcls, Hinvs):
        WG = torch.einsum("oij,ojk->oik", W, Hk[o.lm_idx])
        S_obs.append(ba_core._scatter_sum(o.cam_idx, torch.einsum("oik,ojk->oij", WG, W), C))
    S_diag = Hcc_d - sh.reduce(S_obs)
    M_inv = ba_core.inv66_spd(S_diag + 1e-6 * eye6)
    gnorm = torch.linalg.norm(br)
    g0 = torch.where(g0 > 0, g0, gnorm)
    dc = _pcg(matvec, br, M_inv, pcg_iters, rtol=_ew_rtol(gnorm, g0, C), decide=sh.all_true)
    dc = torch.where(fixed_cam[:, None], torch.zeros_like(dc), dc)
    # back-substitute landmarks: dl = Hll^-1 (bl - W^T dc)
    Wt_dc = sh.reduce([
        ba_core._scatter_sum(o.lm_idx, torch.einsum("oij,oi->oj", W, dk[o.cam_idx]), L)
        for o, W, dk in zip(obs_shards, Wcls, sh.replicate(dc))])
    dl = torch.einsum("lij,lj->li", Hll_inv, bl - Wt_dc)
    dl = torch.where(fixed_lm[:, None], torch.zeros_like(dl), dl)

    T_new = ba_core.apply_pose_update(Tcw, dc, mask=~fixed_cam)
    X_new = Xw + dl
    costs_new = []
    for o, Tk, Xk, Kk in zip(obs_shards, sh.replicate(T_new), sh.replicate(X_new), Ks):
        r2, _, _ = ba_core.reproject_residuals(Tk, Xk, o, Kk)
        costs_new.append(_robust_cost(torch.sum(r2 * r2, -1) * o.inv_sigma2, o.valid))
    cost_new = sh.reduce(costs_new)
    accept = cost_new < cost
    state = (torch.where(accept, T_new, Tcw), torch.where(accept, X_new, Xw),
             torch.where(accept, torch.clamp_min(lam * 0.5, 1e-8),
                         torch.clamp_max(lam * 4.0, 1e4)),
             g0)
    return state, cost_new


def _gba_body(Tcw, Xw, K, fixed_cam, fixed_lm, n_iters: int, obs_shards, pcg_iters: int,
              sh: Shards):
    """n_iters LM iterations and the final inlier classification on the
    local observation shards. Returns (Tcw, Xw, inlier per local shard,
    cost)."""
    C, L = Tcw.shape[0], Xw.shape[0]
    state = (Tcw, Xw, torch.tensor(1e-4, dtype=torch.float32, device=Tcw.device),
             torch.tensor(-1.0, dtype=torch.float32, device=Tcw.device))
    for _ in range(n_iters):
        state, _cost = _gba_iteration(state, obs_shards, K, fixed_cam, fixed_lm, C, L,
                                      pcg_iters, sh)
    Tcw, Xw = state[0], state[1]
    inliers, costs = [], []
    for o, Tk, Xk, Kk in zip(obs_shards, sh.replicate(Tcw), sh.replicate(Xw), sh.replicate(K)):
        r, _, depth_ok = ba_core.reproject_residuals(Tk, Xk, o, Kk)
        chi2 = torch.sum(r * r, -1) * o.inv_sigma2
        inlier = o.valid & (chi2 <= ba_core.CHI2_MONO) & depth_ok
        inliers.append(inlier)
        costs.append(_robust_cost(chi2, inlier))
    return Tcw, Xw, inliers, sh.reduce(costs)


def make_sharded_gba(iterations: int = 5, pcg_iters: int = 25, devices=None, group=None):
    """The gather formulation of the GBA over shards of the observation
    axis (the JAX package's ``make_sharded_gba``).

    Returns ``gba(Tcw, Xw, obs, K, fixed_cam, fixed_lm, n_iterations=None)
    -> BAResult``. The observations are padded to a multiple of the shard
    count and split into equal contiguous ranges, one a shard (``devices``
    and ``group`` as for ``Shards``; None: one shard on the observations'
    device). Plain torch: no kernel. The tile plan of ``make_tile_gba``
    always exists, so nothing routes here; it is reached by an explicit
    call. Every rank of a group returns the full result.
    """

    def gba(Tcw, Xw, obs: ba_core.BAObservations, K, fixed_cam, fixed_lm,
            n_iterations=None) -> BAResult:
        dev_in = Tcw.device
        sh = _shards(devices, group, obs.cam_idx.device)
        n_it = iterations if n_iterations is None else int(n_iterations)
        O = obs.cam_idx.shape[0]
        obs_p = _pad_obs(obs, sh.n)
        obs_shards = [ba_core.BAObservations(*[a[s0:s1].to(d) for a in obs_p])
                      for (s0, s1), d in zip(sh.ranges(obs_p.cam_idx.shape[0]), sh.devices)]
        h = sh.home
        Tcw_o, Xw_o, inliers, cost = _gba_body(
            Tcw.to(h), Xw.to(h), K.to(h), fixed_cam.to(h), fixed_lm.to(h), n_it, obs_shards,
            pcg_iters, sh)
        inlier = sh.gather(inliers, obs_p.cam_idx.shape[0])[:O]
        return BAResult(Tcw=Tcw_o.to(dev_in), Xw=Xw_o.to(dev_in), obs_inlier=inlier.to(dev_in),
                        cost=cost.to(dev_in))

    return gba


# ---------------------------------------------------------------------------
# The tile-stream GBA over shards of the tile axis
# ---------------------------------------------------------------------------

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


def build_tile_plan(obs: ba_core.BAObservations, C: int, L: int,
                    n_shards: int = 1) -> TilePlan:
    """Host-side tile plan for any observation stream, placed on the
    observations' device; L_pad a multiple of 128 * ``n_shards``, so that
    the tiles split into ``n_shards`` equal ranges. Raises on a valid
    observation whose camera or landmark index is out of range (the kernels
    index with them)."""
    with trace.span("tile_plan"):
        with trace.span("tile_plan_read"):
            lm_h, cam_h, valid_h = obs.lm_idx.cpu(), obs.cam_idx.cpu(), obs.valid.cpu()
        trace.count("host_syncs", 3)
        lm_np = lm_h.numpy().astype(np.int64)
        cam_np = cam_h.numpy().astype(np.int64)
        valid_np = valid_h.numpy().astype(bool)
        if valid_np.any():
            lv, cv = lm_np[valid_np], cam_np[valid_np]
            if lv.min() < 0 or lv.max() >= L or cv.min() < 0 or cv.max() >= C:
                raise ValueError(f"observation index out of range (C={C}, L={L})")
        O = lm_np.shape[0]
        order = np.argsort(lm_np, kind="stable")
        sp = schur_cuda.build_schur_plan(lm_np[order], cam_np[order], L,
                                         valid_sorted=valid_np[order], lpad_multiple=n_shards)
        to_orig = np.append(order, O)[sp.perm]
        real = to_orig < O
        slot_of = np.zeros(O, np.int64)
        slot_of[to_orig[real]] = np.flatnonzero(real)
        tiles = np.arange(sp.ntl * sp.TP, dtype=np.int64) // sp.TP
        lm_p = tiles * schur_cuda.LM_BLOCK + sp.lmloc

        dev = obs.cam_idx.device

        def t(a):
            trace.count("host_syncs")      # an upload from pageable memory
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


def shard_tile_plan(tp: TilePlan, st: TileStreams, tiles, device):
    """The plan and streams of the tiles [tiles[0], tiles[1]) on
    ``device``: the slot streams' contiguous ranges (whole tiles, so each
    starts 16-byte aligned). The shard's plan holds what the kernels read;
    the maps to and from the observation order stay with the whole plan."""
    t0, t1 = tiles
    s0, s1 = t0 * tp.TP, t1 * tp.TP

    def cut(a):
        return a[s0:s1].to(device)

    plan = TilePlan(ntl=t1 - t0, TP=tp.TP, L_pad=(t1 - t0) * schur_cuda.LM_BLOCK,
                    camid=cut(tp.camid), lmloc=cut(tp.lmloc), to_orig=None, slot_of=None,
                    lm_p=None)
    return plan, TileStreams(uv=cut(st.uv), is2=cut(st.is2), valid=cut(st.valid),
                             free=cut(st.free), kp=st.kp.to(device))


def _tile_linearize(Tcw, Xw_locs, plans, streams, sh: Shards):
    """One K3 pass on each shard at (Tcw, Xw): per shard the W stream, aux
    rows and landmark Hll+bl; the reduced camera Hcc+bc and the exact
    robust cost of the state."""
    outs = [schur_cuda.d1_assemble(tp.camid, tp.lmloc, st.uv, st.is2, st.valid, st.free,
                                   st.kp, pose, X.contiguous(), TP=tp.TP)
            for tp, st, pose, X in zip(plans, streams,
                                       sh.replicate(schur_cuda.pose_table(Tcw)), Xw_locs)]
    cam27 = sh.reduce([o[3] for o in outs])
    cost = sh.reduce([torch.sum(o[1][0]) for o in outs])
    return [o[0] for o in outs], [o[1] for o in outs], [o[2] for o in outs], cam27, cost


def _tile_iteration(state, fixed_cam, fixed_lm_locs, pcg_iters: int, plans, streams,
                    sh: Shards):
    """One LM iteration on the tile streams. The state carries the
    linearisation of the carried (Tcw, Xw): per shard its landmarks, W,
    aux and Hll+bl; on home Tcw, lam, g0, the reduced cam27 and cost. The
    candidate's K3 pass both prices the step and, if it is accepted,
    becomes the next linearisation. Returns (state, cost of the
    candidate)."""
    Tcw, Xws, lam, g0, W18s, aux3s, hllbls, cam27, cost = state
    C = Tcw.shape[0]
    dev, dt = Tcw.device, Tcw.dtype
    Hcc = schur_cuda.sym6_from_tri(cam27[:, :21])
    # sym6_from_tri indexes by numpy arrays: four uploads from pageable memory
    trace.count("host_syncs", 4)
    bc = cam27[:, 21:]
    eye6 = torch.eye(6, dtype=dt, device=dev)
    Hcc_d = ba_core.damp_blocks(Hcc, lam)
    Hcc_d = torch.where(fixed_cam[:, None, None], eye6, Hcc_d)
    bc = torch.where(fixed_cam[:, None], torch.zeros_like(bc), bc)

    # landmark side, shard by shard: damped blocks inverted in closed form
    u0s, H9s = [], []
    for tp, hllbl, flk, lamk in zip(plans, hllbls, fixed_lm_locs, sh.replicate(lam)):
        Hll = hllbl[0:9].T.reshape(tp.L_pad, 3, 3)
        bl = hllbl[9:12].T
        Hll_d = ba_core.damp_blocks(Hll, lamk)
        Hll_d = torch.where(flk[:, None, None], torch.eye(3, dtype=dt, device=flk.device), Hll_d)
        bl = torch.where(flk[:, None], torch.zeros_like(bl), bl)
        Hll_inv = ba_core.inv33(Hll_d)
        H9s.append(Hll_inv.reshape(tp.L_pad, 9).T.contiguous())          # (9, L_loc)
        u0s.append(torch.einsum("lij,lj->li", Hll_inv, bl))              # (L_loc, 3)

    # reduced RHS br = bc - W Hll^-1 bl (K7)
    br = bc - sh.reduce([schur_cuda.apply_b_raw(tp.camid, tp.lmloc, W, u0.T.contiguous(), C,
                                                TP=tp.TP)
                         for tp, W, u0 in zip(plans, W18s, u0s)])

    # block-Jacobi preconditioner on the true Schur diagonal (K5)
    S21 = sh.reduce([schur_cuda.d2_precond(tp.camid, tp.lmloc, W, H9, C, TP=tp.TP)
                     for tp, W, H9 in zip(plans, W18s, H9s)])
    S_diag = Hcc_d - schur_cuda.sym6_from_tri(S21)
    trace.count("host_syncs", 4)
    M_inv = ba_core.inv66_spd(S_diag + 1e-6 * eye6)

    def matvec(v):
        Hv = torch.einsum("cij,cj->ci", Hcc_d, v)
        return Hv - sh.reduce([schur_cuda.s_apply(tp.camid, tp.lmloc, W, vk, H9, TP=tp.TP)
                               for tp, W, vk, H9 in zip(plans, W18s,
                                                        sh.replicate(v.contiguous()), H9s)])

    gnorm = torch.linalg.norm(br)
    g0 = torch.where(g0 > 0, g0, gnorm)
    dc = _pcg(matvec, br, M_inv, pcg_iters, rtol=_ew_rtol(gnorm, g0, C), decide=sh.all_true)
    dc = torch.where(fixed_cam[:, None], torch.zeros_like(dc), dc)

    # landmark back-substitution: dl = u0 - Hll^-1 segsum(W^T dc) (K6; the
    # landmark sums are tile-local, so nothing is reduced)
    X_news = []
    for tp, W, dck, H9, u0, flk, X in zip(plans, W18s, sh.replicate(dc), H9s, u0s,
                                          fixed_lm_locs, Xws):
        a3 = schur_cuda.apply_a_raw(tp.camid, tp.lmloc, W, dck, H9, TP=tp.TP)
        dl = u0 - a3.T
        X_news.append(X + torch.where(flk[:, None], torch.zeros_like(dl), dl))

    T_new = ba_core.apply_pose_update(Tcw, dc, mask=~fixed_cam)
    Wn, auxn, hllbln, cam27n, cost_new = _tile_linearize(T_new, X_news, plans, streams, sh)
    accept = cost_new < cost
    acc = sh.replicate(accept)

    def pick(new, old):
        return [torch.where(a, x, y) for a, x, y in zip(acc, new, old)]

    state = (
        torch.where(accept, T_new, Tcw),
        pick(X_news, Xws),
        torch.where(accept, torch.clamp_min(lam * 0.5, 1e-8), torch.clamp_max(lam * 4.0, 1e4)),
        g0,
        pick(Wn, W18s),
        pick(auxn, aux3s),
        pick(hllbln, hllbls),
        torch.where(accept, cam27n, cam27),
        torch.where(accept, cost_new, cost),
    )
    return state, cost_new


def _tile_body(Tcw, Xw_locs, fixed_cam, fixed_lm_locs, n_iters: int, pcg_iters: int,
               plans, streams, sh: Shards):
    """n_iters LM iterations and the final inlier classification on the
    local shards' tile streams. Returns (Tcw, Xw per local shard, inlier
    per slot per local shard, cost)."""
    dev = Tcw.device
    state = (Tcw, Xw_locs, torch.tensor(1e-4, dtype=torch.float32, device=dev),
             torch.tensor(-1.0, dtype=torch.float32, device=dev)) \
        + _tile_linearize(Tcw, Xw_locs, plans, streams, sh)
    trace.count("host_syncs", 2)     # the two scalars' uploads
    for _ in range(n_iters):
        state, _cost = _tile_iteration(state, fixed_cam, fixed_lm_locs, pcg_iters, plans,
                                       streams, sh)
    Tcw_o, Xw_o, _lam, _g0, _W, aux3s, _h, _c27, _cost = state
    # the carried linearisation is of the carried state, so its aux rows are
    # the classification: no extra pass
    return (Tcw_o, Xw_o, [aux[1] > 0.5 for aux in aux3s],
            sh.reduce([torch.sum(aux[1] * aux[2]) for aux in aux3s]))


def make_tile_gba(iterations: int = 5, pcg_iters: int = 25, devices=None, group=None):
    """Tile-stream GBA (kernels K3-K7), on one device or over shards of the
    tile axis.

    Returns ``gba(Tcw, Xw, obs, K, fixed_cam, fixed_lm, n_iterations=None)
    -> BAResult``. Accepts any observation stream; the tile plan is built
    on the host once per problem and cached by the identity of the
    observation index arrays (strong references, so a recycled id() cannot
    alias a stale plan).

    ``devices`` and ``group`` as for ``Shards``: the plan's tiles split
    into equal contiguous ranges, one a shard, each shard's slot streams
    and landmarks on its device; K3's camera sums and cost, K5, K7 and each
    K4 product are reduced, K6 and the landmark update are shard-local.
    Neither (the default): one shard on the observations' device, which
    launches what the one-device solver always did. Over a group every rank
    passes the same problem and returns the full result: the landmark rows
    and inlier slots are gathered over the group.
    """
    plan_cache: list = [None]

    def gba(Tcw, Xw, obs: ba_core.BAObservations, K, fixed_cam, fixed_lm,
            n_iterations=None) -> BAResult:
        C, L = int(Tcw.shape[0]), int(Xw.shape[0])
        dev_in = Tcw.device
        sh = _shards(devices, group, obs.cam_idx.device)
        ent = plan_cache[0]
        if (ent is None or ent[0] is not obs.lm_idx or ent[1] is not obs.cam_idx
                or ent[2] != (C, L) or ent[3] is not obs.valid):
            ent = (obs.lm_idx, obs.cam_idx, (C, L), obs.valid,
                   build_tile_plan(obs, C, L, n_shards=sh.n))
            plan_cache[0] = ent
        tp = ent[4]
        n_it = iterations if n_iterations is None else int(n_iterations)
        pad = tp.L_pad - L
        fixed_lm_pad = torch.cat([fixed_lm, torch.ones((pad,), dtype=torch.bool,
                                                       device=fixed_lm.device)])
        Xw_pad = torch.cat([Xw, torch.zeros((pad, 3), dtype=Xw.dtype, device=Xw.device)])
        st = tile_streams(tp, obs, K, fixed_cam, fixed_lm_pad)
        if sh.n == 1 and sh.home == obs.cam_idx.device:
            plans, streams, Xws, fls = [tp], [st], [Xw_pad], [fixed_lm_pad]
        else:
            cuts = [shard_tile_plan(tp, st, (a // schur_cuda.LM_BLOCK, b // schur_cuda.LM_BLOCK), d)
                    for (a, b), d in zip(sh.ranges(tp.L_pad), sh.devices)]
            plans, streams = [c[0] for c in cuts], [c[1] for c in cuts]
            Xws = [Xw_pad[a:b].to(d) for (a, b), d in zip(sh.ranges(tp.L_pad), sh.devices)]
            fls = [fixed_lm_pad[a:b].to(d) for (a, b), d in zip(sh.ranges(tp.L_pad), sh.devices)]
        h = sh.home
        Tcw_o, Xw_locs, inlier_locs, cost = _tile_body(
            Tcw.to(h), Xws, fixed_cam.to(h), fls, n_it, pcg_iters, plans, streams, sh)
        Xw_o = sh.gather(Xw_locs, tp.L_pad)
        inlier_slots = sh.gather(inlier_locs, tp.ntl * tp.TP).to(dev_in)
        inlier = inlier_slots[tp.slot_of] & obs.valid
        return BAResult(Tcw=Tcw_o.to(dev_in), Xw=Xw_o[:L].to(dev_in), obs_inlier=inlier,
                        cost=cost.to(dev_in))

    return gba


# ---------------------------------------------------------------------------
# The dual-layout matrix-free GBA
# ---------------------------------------------------------------------------

def _rep_cam(x, seg: int):
    """(..., C) -> (..., C*seg): a per-camera quantity repeated for each of
    its observations in a camera-major stream (a broadcast, not a gather)."""
    b = x[..., None].expand(x.shape + (seg,))
    return b.reshape(x.shape[:-1] + (x.shape[-1] * seg,))


def _cam_sum_t(x, C: int, seg: int):
    """(..., C*seg) camera-major -> (..., C) reshape-sum."""
    return x.reshape(x.shape[:-1] + (C, seg)).sum(-1)


def _lm_sum_t(x_sorted, bounds):
    """(..., O) sorted by landmark -> (..., L): segment sums by prefix sum
    and boundary difference along the last axis. The prefix sum is taken
    in float64: at 2M observations a float32 running sum of ~1e4-sized
    Hessian entries would lose ~1e-2 of a landmark's ~1e5-sized block to
    cancellation."""
    cs = torch.cumsum(x_sorted.double(), -1)
    cs = torch.cat([torch.zeros_like(cs[..., :1]), cs], -1)
    return (cs[..., bounds[1:]] - cs[..., bounds[:-1]]).to(x_sorted.dtype)


def _pair_sum(a, b):
    """sum_k a[k, i, o] b[k, j, o] -> (I, J, O), written out over the k
    axis (2 rows) rather than as a batched product of tiny matrices."""
    return sum(a[k][:, None] * b[k][None, :] for k in range(a.shape[0]))


def _obs_pipeline(R_t, t_t, X_t, uv_t, inv_sigma2, valid, K):
    """Residual and Jacobian pipeline of one observation stream in
    component-major layout (every array (components..., O)). Pure
    per-element arithmetic, so the same observation gives the same values
    in either layout. Returns (r (2, O), chi2 (O,), w (O,), Jc (2, 6, O),
    Jl (2, 3, O))."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    pc = (R_t * X_t[None]).sum(1) + t_t                        # (3, O)
    z = pc[2]
    depth_ok = z > 1e-6
    iz = 1.0 / torch.where(depth_ok, z, torch.ones_like(z))
    r_t = uv_t - torch.stack([fx * pc[0] * iz + cx, fy * pc[1] * iz + cy])
    chi2 = torch.sum(r_t * r_t, 0) * inv_sigma2
    w = inv_sigma2 * ba_core.huber_weights(chi2)
    w = torch.where(valid & depth_ok, w, torch.zeros_like(w))
    # dproj/dpc (2, 3); dpc/dxi = [-hat(pc) | I]; dpc/dX = R
    iz2 = iz * iz
    zo = torch.zeros_like(z)
    d00, d02 = fx * iz, -fx * pc[0] * iz2
    d11, d12 = fy * iz, -fy * pc[1] * iz2
    # Jc = -dproj @ [-hat(pc) | I], rows (omega, upsilon)
    Jc = torch.stack([
        torch.stack([-(d02 * pc[1]), -(d00 * pc[2] - d02 * pc[0]), d00 * pc[1],
                     -d00, zo, -d02]),
        torch.stack([d11 * pc[2] - d12 * pc[1], d12 * pc[0], -(d11 * pc[0]),
                     zo, -d11, -d12]),
    ])                                                         # (2, 6, O)
    Jl = -torch.stack([d00 * R_t[0] + d02 * R_t[2],
                       d11 * R_t[1] + d12 * R_t[2]])           # (2, 3, O)
    return r_t, chi2, w, Jc, Jl


class MatrixFreePlan(NamedTuple):
    """Host-built, per-problem plan of the matrix-free GBA, on the device:
    the Schur plan and the landmark-side stream of its padded tile order."""

    sp: schur_cuda.SchurPlan   # on the device (SchurPlan.to)
    seg: int                   # observations per camera (O = C * seg)
    to_orig: torch.Tensor      # (OP,) i64 slot -> camera-major obs (pad -> O)
    bounds: torch.Tensor       # (L+1,) i64 landmark segments in slot order
    lm_p: torch.Tensor         # (OP,) i64 landmark per slot (clamped to L-1)


def build_matrix_free_plan(obs: ba_core.BAObservations, C: int, L: int) -> MatrixFreePlan:
    """Landmark sort order and tile plan of a camera-major observation
    stream, built with numpy and placed on the observations' device.
    Invalid observations are left out of the tile stream. Raises on a
    stream that is not camera-major with O = C * seg (observation o of
    camera o // seg), and on a valid observation whose landmark index is
    out of range."""
    O = obs.cam_idx.shape[0]
    seg = O // C
    lm_np = obs.lm_idx.cpu().numpy().astype(np.int64)
    valid_all = obs.valid.cpu().numpy().astype(bool)
    cam_of = np.arange(O, dtype=np.int64) // max(seg, 1)
    if O % C or (obs.cam_idx.cpu().numpy()[valid_all] != cam_of[valid_all]).any():
        raise ValueError("matrix-free GBA needs camera-major contiguous obs")
    lv = lm_np[valid_all]
    if lv.size and (lv.min() < 0 or lv.max() >= L):
        raise ValueError(f"observation index out of range (L={L})")
    lm_np = np.where(valid_all, lm_np, 0)
    ss = ba_core.build_sorted_segments(lm_np, L)
    order = ss.order
    cam_l = cam_of[order]
    lm_sorted = lm_np[order]
    valid_s = valid_all[order]
    sp = schur_cuda.build_schur_plan(lm_sorted, cam_l, L, valid_sorted=valid_s)
    OP = sp.ntl * sp.TP
    to_orig = np.append(order, O)[sp.perm]
    tiles = np.arange(OP, dtype=np.int64) // sp.TP
    lm_p = np.minimum(tiles * schur_cuda.LM_BLOCK + sp.lmloc, L - 1)
    # bounds over the padded stream: the valid observations of landmark l
    # are contiguous; tile-tail pads fall between landmark runs
    bv = np.zeros(L + 1, np.int64)
    bv[1:] = np.cumsum(np.bincount(lm_sorted[valid_s], minlength=L))
    t_l = np.arange(L, dtype=np.int64) // schur_cuda.LM_BLOCK
    bounds = np.append(t_l * sp.TP + bv[:L] - bv[t_l * schur_cuda.LM_BLOCK], OP)
    dev = obs.cam_idx.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)

    return MatrixFreePlan(sp=sp.to(dev), seg=seg, to_orig=t(to_orig), bounds=t(bounds),
                          lm_p=t(lm_p))


def _gba_iteration_cm(state, K, fixed_cam, fixed_lm, pcg_iters: int, uv_t, inv_sigma2,
                      valid, lm_idx, uv_s, is2_s, valid_s, mp: MatrixFreePlan):
    """One LM iteration of the dual-layout matrix-free GBA.

    Camera-major pass (observation o = c * seg + i): Hcc, bc, the cost and
    the camera-side W copy for the preconditioner. Landmark pass on the
    plan's tile stream (K9 gives R, t, X per slot): Hll, bl and the W
    stream of the Schur products. The residual/Jacobian pipeline gives the
    same values for an observation in either layout, so the PCG operator
    stays symmetric. Returns (state, cost of the candidate)."""
    Tcw, Xw, lam, g0 = state
    C, L, seg = Tcw.shape[0], Xw.shape[0], mp.seg
    sp = mp.sp
    dev, dt = Tcw.device, Tcw.dtype

    # ---- camera-major pass -------------------------------------------
    R_t = _rep_cam(Tcw[:, :3, :3].permute(1, 2, 0), seg)       # (3, 3, O)
    t_t = _rep_cam(Tcw[:, :3, 3].T, seg)                       # (3, O)
    X_t = Xw.T[:, lm_idx]                                      # (3, O)
    r_t, chi2, w, Jc, Jl = _obs_pipeline(R_t, t_t, X_t, uv_t, inv_sigma2, valid, K)
    del R_t, t_t, X_t
    cost = _robust_cost(chi2, valid)
    wJc = Jc * w
    Hcc = _cam_sum_t(_pair_sum(wJc, Jc), C, seg).permute(2, 0, 1)      # (C, 6, 6)
    bc = -_cam_sum_t((wJc * r_t[:, None]).sum(0), C, seg).T            # (C, 6)
    Wcl_t = _pair_sum(wJc, Jl)                                         # (6, 3, O)
    del r_t, chi2, w, Jc, Jl, wJc

    # ---- landmark pass on the tile stream (K9) -----------------------
    R_l, t_l, X_l = schur_cuda.expand_sorted_streams(sp, Tcw, Xw)
    r_l, _chi2_l, w_l, Jc_l, Jl_l = _obs_pipeline(R_l, t_l, X_l, uv_s, is2_s, valid_s, K)
    del R_l, t_l, X_l
    wJl_l = Jl_l * w_l
    Hll = _lm_sum_t(_pair_sum(wJl_l, Jl_l), mp.bounds).permute(2, 0, 1)  # (L, 3, 3)
    bl = -_lm_sum_t((wJl_l * r_l[:, None]).sum(0), mp.bounds).T         # (L, 3)
    Wl_t = _pair_sum(Jc_l * w_l, Jl_l)                                  # (6, 3, OP)
    del r_l, w_l, Jc_l, Jl_l, wJl_l

    # ---- damping / gauge fixing ---------------------------------------
    eye6 = torch.eye(6, dtype=dt, device=dev)
    Hcc_d = ba_core.damp_blocks(Hcc, lam)
    Hcc_d = torch.where(fixed_cam[:, None, None], eye6, Hcc_d)
    bc = torch.where(fixed_cam[:, None], torch.zeros_like(bc), bc)
    Hll_d = ba_core.damp_blocks(Hll, lam)
    Hll_d = torch.where(fixed_lm[:, None, None], torch.eye(3, dtype=dt, device=dev), Hll_d)
    bl = torch.where(fixed_lm[:, None], torch.zeros_like(bl), bl)
    free_obs = ~(_rep_cam(fixed_cam, seg) | fixed_lm[lm_idx])
    Wcl_t = torch.where(free_obs, Wcl_t, torch.zeros_like(Wcl_t))
    free_l = ~(fixed_cam[mp.sp.camid.long()] | fixed_lm[mp.lm_p])
    Wl_t = torch.where(free_l, Wl_t, torch.zeros_like(Wl_t))
    Hll_inv = ba_core.inv33(Hll_d)                                     # (L, 3, 3)

    # ---- reduced camera system on the plan ----------------------------
    # the products read W in J-major rows (row j*6+i = W[i, j])
    Wp = Wl_t.permute(1, 0, 2).reshape(18, -1).contiguous()
    del Wl_t
    H9 = torch.zeros((9, sp.L_pad), dtype=dt, device=dev)
    H9[:, :L] = Hll_inv.reshape(L, 9).T

    def matvec(v):
        Hv = torch.einsum("cij,cj->ci", Hcc_d, v)
        return Hv - schur_cuda.schur_apply(sp, Wp, v.contiguous(), H9)

    u0 = torch.einsum("lij,lj->il", Hll_inv, bl)                       # (3, L)
    u0_pad = torch.zeros((3, sp.L_pad), dtype=dt, device=dev)
    u0_pad[:, :L] = u0
    br = bc - schur_cuda.apply_b(sp, Wp, u0_pad, C)
    # block-Jacobi preconditioner on the true Schur diagonal
    # M_c = Hcc_c - sum_{o in c} W_o Hll^-1[l(o)] W_o^T (camera-major)
    G = Hll_inv.permute(1, 2, 0)[:, :, lm_idx]                         # (3, 3, O)
    WG = sum(Wcl_t[:, j][:, None] * G[j][None] for j in range(3))      # (6, 3, O)
    del G
    S66 = sum(WG[:, k][:, None] * Wcl_t[:, k][None] for k in range(3))  # (6, 6, O)
    del WG, Wcl_t
    S_diag = Hcc_d - _cam_sum_t(S66, C, seg).permute(2, 0, 1)
    del S66
    M_inv = ba_core.inv66_spd(S_diag + 1e-6 * eye6)
    gnorm = torch.linalg.norm(br)
    g0 = torch.where(g0 > 0, g0, gnorm)
    dc = _pcg(matvec, br, M_inv, pcg_iters, rtol=_ew_rtol(gnorm, g0, C))
    dc = torch.where(fixed_cam[:, None], torch.zeros_like(dc), dc)

    # ---- landmark back-substitution: dl = u0 - Hll^-1 segsum(W^T dc) ----
    a_dc = schur_cuda.apply_a(sp, Wp, dc.contiguous(), H9)[:, :L]
    dl = (u0 - a_dc).T
    dl = torch.where(fixed_lm[:, None], torch.zeros_like(dl), dl)

    # ---- accept / reject ----------------------------------------------
    T_new = ba_core.apply_pose_update(Tcw, dc, mask=~fixed_cam)
    X_new = Xw + dl
    cost_new = _robust_cost(_cm_chi2(T_new, X_new, uv_t, inv_sigma2, lm_idx, K, seg)[0], valid)
    accept = cost_new < cost
    state = (torch.where(accept, T_new, Tcw), torch.where(accept, X_new, Xw),
             torch.where(accept, torch.clamp_min(lam * 0.5, 1e-8),
                         torch.clamp_max(lam * 4.0, 1e4)),
             g0)
    return state, cost_new


def _cm_chi2(Tcw, Xw, uv_t, inv_sigma2, lm_idx, K, seg: int):
    """chi2 (O,) and the depth test of the camera-major stream at a state."""
    R_t = _rep_cam(Tcw[:, :3, :3].permute(1, 2, 0), seg)
    t_t = _rep_cam(Tcw[:, :3, 3].T, seg)
    pc = (R_t * Xw.T[:, lm_idx][None]).sum(1) + t_t
    depth_ok = pc[2] > 1e-6
    z = torch.where(depth_ok, pc[2], torch.ones_like(pc[2]))
    r = uv_t - torch.stack([K[0, 0] * pc[0] / z + K[0, 2], K[1, 1] * pc[1] / z + K[1, 2]])
    return torch.sum(r * r, 0) * inv_sigma2, depth_ok


def make_matrix_free_gba(iterations: int = 5, pcg_iters: int = 25):
    """Single-device dual-layout matrix-free GBA (``_gba_iteration_cm``).

    Returns ``gba(Tcw, Xw, obs, K, fixed_cam, fixed_lm, n_iterations=None)
    -> BAResult``. Needs camera-major contiguous observations (O = C * F),
    which is what ``map_state.gather_observations`` gives; raises
    ValueError on any other stream. The plan is
    built on the host once per problem and cached by the identity of the
    observations' ``lm_idx``, ``cam_idx`` and ``valid`` tensors (strong
    references, so a recycled id() cannot alias a stale plan): the plan
    leaves invalid observations out, so a changed mask needs a new plan.
    """
    plan_cache: list = [None]

    def gba(Tcw, Xw, obs: ba_core.BAObservations, K, fixed_cam, fixed_lm,
            n_iterations=None) -> BAResult:
        C, L = int(Tcw.shape[0]), int(Xw.shape[0])
        ent = plan_cache[0]
        if (ent is None or ent[0] is not obs.lm_idx or ent[1] is not obs.cam_idx
                or ent[2] != (C, L) or ent[3] is not obs.valid):
            ent = (obs.lm_idx, obs.cam_idx, (C, L), obs.valid,
                   build_matrix_free_plan(obs, C, L))
            plan_cache[0] = ent
        mp = ent[4]
        n_it = iterations if n_iterations is None else int(n_iterations)
        dev = Tcw.device
        uv_t = obs.uv.T.contiguous()
        # loop-invariant tile-order streams (pad slots read the appended
        # zero / False column and carry zero weight)
        uv_s = torch.cat([uv_t, torch.zeros((2, 1), dtype=uv_t.dtype, device=dev)], 1)[
            :, mp.to_orig]
        is2_s = torch.cat([obs.inv_sigma2, torch.zeros(1, dtype=obs.inv_sigma2.dtype,
                                                       device=dev)])[mp.to_orig]
        valid_s = torch.cat([obs.valid, torch.zeros(1, dtype=torch.bool, device=dev)])[
            mp.to_orig]
        lm_idx = torch.where(obs.valid, obs.lm_idx, torch.zeros_like(obs.lm_idx))
        state = (Tcw, Xw, torch.tensor(1e-4, dtype=torch.float32, device=dev),
                 torch.tensor(-1.0, dtype=torch.float32, device=dev))
        for _ in range(n_it):
            state, _cost = _gba_iteration_cm(state, K, fixed_cam, fixed_lm, pcg_iters,
                                             uv_t, obs.inv_sigma2, obs.valid, lm_idx,
                                             uv_s, is2_s, valid_s, mp)
        Tcw_o, Xw_o = state[0], state[1]
        # final inlier classification
        chi2, depth_ok = _cm_chi2(Tcw_o, Xw_o, uv_t, obs.inv_sigma2, lm_idx, K, mp.seg)
        inlier = obs.valid & (chi2 <= ba_core.CHI2_MONO) & depth_ok
        return BAResult(Tcw=Tcw_o, Xw=Xw_o, obs_inlier=inlier,
                        cost=_robust_cost(chi2, inlier))

    return gba
