"""Global bundle adjustment driver with Motion Check gating.

Counterpart of ``motioncheck_ccm_slam_tpu/models/gba.py``. Replaces the
reference's GBA orchestration (``Map::RunGBA`` src/Map.cpp:1491,
``Optimizer::MapFusionGBA`` src/Optimizer.cpp:646, and the MC-triggered
re-run ``RunGBA_fromCorrectKF`` :1919):

1. snapshot pre-GBA state (poses + landmark positions + MC body positions),
2. run the full-map robust LM with landmarks marginalized (Schur),
   interruptible between iteration chunks (INTERRUPTBA semantics —
   reference Communicator.cpp:453-462 aborts on fresh agent data),
3. run Motion Check per client and apply the verdict: accept, surgically
   delete violating keyframes, or roll everything back.

The job's pose and landmark copies and its revert snapshot are clones of
the map's tensors, so nothing written to the map while the job runs (in
place or not) reaches them, and an aborted job leaves the map bit for bit
as it was.

The solver is the dense-W ``local_ba.bundle_adjust`` while its W fits.
Above that it is the tile-stream ``parallel/sharded_ba.make_tile_gba``:
sharded over every card when the map lies on a card and more than one is
visible (no configuration, as the JAX package's mesh), else on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..config import Config
from ..ops import orb
from ..solvers import ba_core, local_ba
from ..utils import trace
from . import map_state as ms
from . import motion_check as mc


@dataclasses.dataclass
class GBAResult:
    interrupted: bool = False
    reverted: bool = False
    n_deleted_kfs: int = 0
    cost: float = 0.0
    mc_longest_run: int = 0
    mc_gated: bool = False   # gating-mode MC flagged the GBA as unreliable


# Above this dense-W footprint (6C x 3L f32) the Schur solve switches to the
# matrix-free tile-stream solver — at the server operating point (2048 KFs,
# 65k MPs) the dense W alone would be ~9.7 GB.
DENSE_W_MAX_BYTES = 256 * 2 ** 20

_solver_cache: dict = {}


def _pick_solver(C: int, L: int, pcg_iters: int = 25, device=None):
    """Solver selection for the product GBA path.

    None -> the dense-W local_ba path while the dense Schur complement fits.
    Above that, a map on a CUDA ``device`` with more than one card visible
    takes the tile GBA with its tiles sharded over cards 0 .. n-1, the
    counterpart of the reference's multi-threaded MapFusionGBA
    (src/Optimizer.cpp:646, initMultiThreading :792) and of the JAX
    package's mesh route; any other map the one-device tile GBA, whose plan
    always exists, so it needs no fallback. The JAX package takes its mesh
    before the dense-W test; here a map small enough for dense W stays on
    one device, since a shard adds its own launches and a host sum a sweep.
    Solvers are cached by route and ``pcg_iters``."""
    from ..parallel import sharded_ba

    if 6 * C * 3 * L * 4 <= DENSE_W_MAX_BYTES:
        return None
    n_dev = torch.cuda.device_count()
    if device is not None and torch.device(device).type == "cuda" and n_dev > 1:
        key = ("mesh", n_dev, pcg_iters)
        if key not in _solver_cache:
            _solver_cache[key] = sharded_ba.make_tile_gba(
                pcg_iters=pcg_iters, devices=[torch.device("cuda", i) for i in range(n_dev)])
        return _solver_cache[key]
    if pcg_iters not in _solver_cache:
        _solver_cache[pcg_iters] = sharded_ba.make_tile_gba(pcg_iters=pcg_iters)
    return _solver_cache[pcg_iters]


def build_observations(kf: ms.KFBlock, config: Config) -> ba_core.BAObservations:
    cam, _feat, lm, uv, octv, ok = ms.gather_observations(kf)
    inv_s2 = torch.as_tensor(orb.inv_level_sigma2(config.extractor), device=uv.device)
    trace.count("host_syncs")      # an upload from pageable memory
    return ba_core.BAObservations(
        cam_idx=cam, lm_idx=lm, uv=uv,
        inv_sigma2=inv_s2[torch.clamp(octv, 0, config.extractor.n_levels - 1).long()],
        valid=ok,
    )


@dataclasses.dataclass
class GBAJob:
    """Incremental, interruptible full-map GBA (INTERRUPTBA semantics).

    The reference runs GBA in a detached thread and aborts it when fresh
    agent data arrives (Communicator.cpp:453-496, g2o setForceStopFlag);
    here the job owns device-side COPIES of the poses/landmarks and the
    orchestrator advances it in iteration chunks between comm ticks — the
    map itself is untouched until ``finalize``, so an abort costs nothing
    and new keyframes can stream into the map while the job runs.

    KFs/MPs inserted mid-job are not part of the optimization problem; on
    finalize their poses/positions are propagated through the spanning tree
    / reference KF exactly like the reference does for KFs created during a
    running GBA (src/Map.cpp:1536-1662, src/LoopFinder.cpp:1016-1056).
    """

    m: ms.MapState
    config: Config
    iterations: int
    enable_motion_check: bool
    chunk: int = 5
    solver: Optional[Callable] = None
    # "full": delete/revert verdict (final GBA, reference CorrectKF_V3
    # isGBA=true); "gating": flags only after a loop-closure GBA — may latch
    # CorrectKF_switch off and request a follow-up GBA (isGBA=false,
    # reference src/Map.cpp:3784-3799, src/LoopFinder.cpp:1200-1202,754-762)
    mc_mode: str = "full"
    done: int = 0
    interrupted: bool = False
    _cost: float = 0.0

    def __post_init__(self):
        m, config = self.m, self.config
        dev = m.device
        self.T_SC_inv = torch.from_numpy(
            np.linalg.inv(config.camera.T_SC()).astype(np.float32)).to(dev)
        trace.count("host_syncs")        # an upload from pageable memory
        # snapshot pre-GBA state on the live blocks (reference SetTcwCurrent
        # :1520); the landmark snapshot is the job's own copy for revert
        m.kf = mc.snapshot_pre_gba(m.kf, self.T_SC_inv)
        self.Xw_snapshot = m.mp.Xw.clone()
        self.Tcw_snapshot = m.kf.Tcw.clone()
        # membership: what the optimization problem covers (KFs/MPs valid
        # NOW; anything allocated later is out-of-problem until finalize)
        self.kf_in = m.kf.valid.cpu().numpy().copy()
        self.mp_in = m.mp.valid.cpu().numpy().copy()
        trace.count("host_syncs", 2)
        self.obs = build_observations(m.kf, config)
        self.K = torch.from_numpy(config.camera.K()).to(dev)
        kf_ids = m.kf.kf_id.cpu().numpy()
        trace.count("host_syncs", 2)
        fixed = ~self.kf_in
        if self.kf_in.any():
            origin = np.flatnonzero(self.kf_in)[np.argmin(kf_ids[self.kf_in])]
            fixed = fixed.copy()
            fixed[origin] = True
        self.fixed_j = torch.from_numpy(fixed).to(dev)
        trace.count("host_syncs")
        self.fixed_lm = ~m.mp.valid
        if self.solver is None:
            self.solver = _pick_solver(int(m.kf.Tcw.shape[0]), int(m.mp.Xw.shape[0]),
                                       device=dev)
        self.Tcw = self.Tcw_snapshot.clone()
        self.Xw = self.Xw_snapshot.clone()

    # -- stepping --------------------------------------------------------
    @property
    def finished(self) -> bool:
        return self.done >= self.iterations

    def step(self, n_iters: Optional[int] = None) -> bool:
        """Advance by one chunk. Returns True when all iterations are done."""
        if self.finished:
            return True
        n_it = min(n_iters or self.chunk, self.iterations - self.done)
        if self.solver is not None:
            ba = self.solver(self.Tcw, self.Xw, self.obs, self.K,
                             self.fixed_j, self.fixed_lm, n_it)
        else:
            ba = local_ba.bundle_adjust(
                self.Tcw, self.Xw, self.obs, self.K, self.fixed_j,
                fixed_lm=self.fixed_lm, iterations=n_it,
            )
        self.Tcw, self.Xw = ba.Tcw, ba.Xw
        self._cost = float(ba.cost)
        trace.count("host_syncs")
        self.done += n_it
        return self.finished

    def abort(self) -> GBAResult:
        """INTERRUPTBA: discard the job. The map was never written, so this
        only reports the interruption (reference Map::isGBAinterrupted)."""
        self.interrupted = True
        return GBAResult(interrupted=True, cost=self._cost)

    # -- completion ------------------------------------------------------
    def _propagate_to_new_entities(self):
        """Spanning-tree propagation of the correction to KFs inserted while
        the job ran, and reference-KF propagation for their landmarks
        (reference src/Map.cpp:1536-1662)."""
        m = self.m
        dev = m.device
        valid_now = m.kf.valid.cpu().numpy()
        trace.count("host_syncs")
        new_kfs = np.flatnonzero(valid_now & ~self.kf_in)
        if len(new_kfs):
            parent = m.kf.parent.cpu().numpy()
            pred = m.kf.pred.cpu().numpy()
            kf_ids = m.kf.kf_id.cpu().numpy()
            Tcw_cur = m.kf.Tcw.cpu().numpy()
            # host working copy, updated in place so that a mid-job KF whose
            # nearest in-problem ancestor is ANOTHER mid-job KF corrected
            # earlier in this loop chains off the corrected pose, not the
            # stale pre-propagation copy
            Tcw_opt = self.Tcw.cpu().numpy().copy()
            trace.count("host_syncs", 5)
            updated = []
            # nearest in-problem ancestor through parent (pred fallback)
            for s in sorted(new_kfs, key=lambda s: kf_ids[s]):
                anc = parent[s] if parent[s] >= 0 else pred[s]
                hops = 0
                while anc >= 0 and not self.kf_in[anc] and hops < 64:
                    anc = parent[anc] if parent[anc] >= 0 else pred[anc]
                    hops += 1
                if anc < 0 or not self.kf_in[anc]:
                    continue  # disconnected: leave untouched
                T_rel = Tcw_cur[s] @ np.linalg.inv(Tcw_cur[anc])
                Tcw_opt[s] = (T_rel @ Tcw_opt[anc]).astype(np.float32)
                self.kf_in[s] = True  # now carries an optimized-frame pose
                updated.append(int(s))
            if updated:
                idx = torch.as_tensor(updated, dtype=torch.long, device=dev)
                Tcw = self.Tcw.clone()
                Tcw[idx] = torch.from_numpy(Tcw_opt[updated]).to(dev)
                trace.count("host_syncs", 2)
                self.Tcw = Tcw
        mp_valid_now = m.mp.valid.cpu().numpy()
        trace.count("host_syncs")
        new_mps = np.flatnonzero(mp_valid_now & ~self.mp_in)
        if len(new_mps):
            ref = m.mp.ref_kf.cpu().numpy()
            trace.count("host_syncs")
            ok = (ref[new_mps] >= 0) & self.kf_in[np.clip(ref[new_mps], 0, m.nk - 1)]
            sel = new_mps[ok]
            if len(sel):
                r = torch.as_tensor(ref[sel], dtype=torch.long, device=dev)
                sel_t = torch.as_tensor(sel, dtype=torch.long, device=dev)
                trace.count("host_syncs", 2)
                Tb = m.kf.Tcw[r]          # current (pre-writeback) ref pose
                Ta = self.Tcw[r]          # optimized ref pose
                X = m.mp.Xw[sel_t]
                x_cam = torch.einsum("lij,lj->li", Tb[:, :3, :3], X) + Tb[:, :3, 3]
                Ta_inv = torch.linalg.inv(Ta)
                trace.count("host_syncs")   # linalg.inv reads its error flags
                X_new = torch.einsum("lij,lj->li", Ta_inv[:, :3, :3], x_cam) \
                    + Ta_inv[:, :3, 3]
                Xw = self.Xw.clone()
                Xw[sel_t] = X_new
                self.Xw = Xw
                self.mp_in[sel] = True  # now expressed in the optimized frame

    def _pad_to_current(self):
        """The map blocks may have GROWN while the job ran (capacity growth
        is append-only); pad the job's copies/masks so writeback indexes
        line up — grown slots are out-of-problem (mask False)."""
        m = self.m
        nk, nm = m.nk, m.nm
        if len(self.kf_in) < nk:
            pad = nk - len(self.kf_in)
            self.kf_in = np.concatenate([self.kf_in, np.zeros(pad, bool)])
            self.Tcw = torch.cat([self.Tcw, m.kf.Tcw[-pad:]], 0)
            self.Tcw_snapshot = torch.cat([self.Tcw_snapshot, m.kf.Tcw[-pad:]], 0)
        if len(self.mp_in) < nm:
            pad = nm - len(self.mp_in)
            self.mp_in = np.concatenate([self.mp_in, np.zeros(pad, bool)])
            self.Xw = torch.cat([self.Xw, m.mp.Xw[-pad:]], 0)
            self.Xw_snapshot = torch.cat([self.Xw_snapshot, m.mp.Xw[-pad:]], 0)

    def finalize(self) -> GBAResult:
        """Write back optimized state (+ mid-job propagation), then the
        Motion Check verdict (reference RunGBA :1683-1687)."""
        m = self.m
        dev = m.device
        self._pad_to_current()
        result = GBAResult(cost=self._cost)
        kf_in_start = torch.from_numpy(self.kf_in.copy()).to(dev)
        mp_in_start = torch.from_numpy(self.mp_in.copy()).to(dev)
        trace.count("host_syncs", 2)
        self._propagate_to_new_entities()
        # live pre-writeback state: an MC revert restores in-problem entities
        # to the pre-GBA snapshot and mid-job entities to this
        Tcw_live = m.kf.Tcw
        Xw_live = m.mp.Xw
        # only entities the job optimized or propagated are written back;
        # anything else (e.g. a mid-job landmark with no in-problem reference
        # yet) keeps its live map state rather than the job's stale copy
        write_kf = torch.from_numpy(self.kf_in).to(dev) & m.kf.valid
        write_mp = torch.from_numpy(self.mp_in).to(dev) & m.mp.valid
        trace.count("host_syncs", 2)
        m.kf = m.kf._replace(Tcw=torch.where(write_kf[:, None, None], self.Tcw, m.kf.Tcw))
        m.mp = m.mp._replace(Xw=torch.where(write_mp[:, None], self.Xw, m.mp.Xw))

        run_corrective = (self.enable_motion_check
                          and (self.mc_mode == "gating" or m.correct_kf_switch))
        if run_corrective:
            valid = m.kf.valid.cpu().numpy() & self.kf_in
            clients = np.unique(m.kf.client_id.cpu().numpy()[valid])
            trace.count("host_syncs", 2)
            for cid in clients:
                if cid < 0:
                    continue
                verdict, order = mc.check_after_gba(
                    m.kf, self.T_SC_inv, self.config.motion_check, client_id=int(cid))
                result.mc_longest_run = max(result.mc_longest_run, int(verdict.longest_run))
                if self.mc_mode == "gating":
                    # flags only (reference isGBA=false): a bad verdict
                    # disables future corrective action and requests a
                    # follow-up GBA; the map is left as optimized
                    if verdict.revert:
                        m.correct_kf_switch = False
                        m.request_gba = True
                        result.mc_gated = True
                    continue
                kf2, mp2, reverted = mc.apply_verdict(m.kf, m.mp, verdict, order)
                if reverted:
                    m.kf = kf2._replace(Tcw=torch.where(
                        (kf2.valid & kf_in_start)[:, None, None],
                        kf2.Tcw_pre_gba,
                        torch.where(kf2.valid[:, None, None], Tcw_live, kf2.Tcw),
                    ))
                    m.mp = m.mp._replace(Xw=torch.where(
                        mp_in_start[:, None], self.Xw_snapshot, Xw_live))
                    result.reverted = True
                    break
                n_del = int(m.kf.valid.sum()) - int(kf2.valid.sum())
                trace.count("host_syncs", 2)
                result.n_deleted_kfs += n_del
                m.kf, m.mp = kf2, mp2
            if result.n_deleted_kfs:
                m.sync_host_index()
        return result


def run_gba(
    m: ms.MapState,
    config: Config,
    interrupt_check: Optional[Callable[[], bool]] = None,
    iterations: Optional[int] = None,
    chunk: int = 5,
    enable_motion_check: Optional[bool] = None,
    sharded_solver=None,
    mc_mode: str = "full",
    on_chunk: Optional[Callable[[int], None]] = None,
) -> GBAResult:
    """Full-map GBA with MC gating, driven to completion (or interruption)
    synchronously. Mutates ``m`` in place. ``interrupt_check`` is polled
    between iteration chunks — INTERRUPTBA semantics; an interrupted GBA
    leaves the map exactly as it was (the job works on copies).

    ``sharded_solver``: a solver with ``make_tile_gba``'s signature to use
    instead of ``_pick_solver``'s (e.g. ``make_matrix_free_gba``).

    mc_mode: "full" = delete/revert verdict (final GBA); "gating" = flags
    only (after a loop-closure GBA) — may latch ``m.correct_kf_switch`` off
    and set ``m.request_gba`` for a follow-up GBA.

    ``on_chunk(iterations_done)`` fires after every chunk — a liveness
    heartbeat for long GBAs."""
    if iterations is None:
        iterations = config.opt.gba_iterations
    if enable_motion_check is None:
        enable_motion_check = config.motion_check.enabled
    job = GBAJob(m=m, config=config, iterations=iterations,
                 enable_motion_check=enable_motion_check, chunk=chunk,
                 solver=sharded_solver, mc_mode=mc_mode)
    while not job.step():
        if on_chunk is not None:
            on_chunk(job.done)
        if interrupt_check is not None and interrupt_check():
            return job.abort()
    if on_chunk is not None:
        on_chunk(job.done)
    return job.finalize()
