"""Server-side intra-map loop closing.

Counterpart of ``motioncheck_ccm_slam_tpu/models/loop_closing.py`` (the
reference ``LoopFinder``, src/LoopFinder.cpp): BoW candidate detection with
covisibility-consistency confirmation, Sim3 RANSAC + refinement between the
current and loop keyframes, correction propagation over the current
covisibility neighborhood, landmark fusion, essential-graph optimization,
and a Motion-Check-gated GBA.

``LoopCloser.process_keyframe`` runs per arriving KF. The numeric stages
are tensor code on the map's device; the host reads each decision (match
and inlier counts, RANSAC success, the scale gate), the covisibility rows
that pick groups, and the index lists that build the essential graph, as
the JAX package does. RANSAC draws come from the closer's
``torch.Generator`` (seeded 42 on the map's device), where the JAX package
splits ``PRNGKey(42)`` once an attempt.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Set, Tuple

import numpy as np
import torch

from ..config import Config
from ..ops import lie, matching, orb, ransac
from ..solvers import pose_graph, sim3_opt
from ..utils import trace
from . import database as db_mod
from . import gba as gba_mod
from . import map_state as ms
from . import mapping as mapping_mod


def _unit_sim3(T):
    """SE3 pose(s) (..., 4, 4) as a Sim3 of scale 1."""
    return lie.make_sim3(T[..., :3, :3], T[..., :3, 3],
                         torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device))


def kf_landmark_side(kf: ms.KFBlock, mp: ms.MPBlock, slot: int) -> dict:
    """Per-feature landmark view of one keyframe for Sim3-guided matching:
    descriptors, camera-frame landmark coords, uv, octave, landmark slots
    (host), and validity (feature valid, associated, landmark alive)."""
    idx = kf.mp_idx[slot].long()
    safe = torch.clamp(idx, 0, mp.Xw.shape[0] - 1)
    valid = kf.feat_valid[slot] & (idx >= 0) & mp.valid[safe]
    Xc = lie.transform_points(kf.Tcw[slot], mp.Xw[safe][None])[0]
    return {"desc": kf.desc[slot], "Xc": Xc, "valid": valid, "uv": kf.xy[slot],
            "octave": kf.octave[slot], "mp": idx.cpu().numpy()}


def sim3_guided_refine(side1, side2, S12_cam, feat1, feat2, inliers, config: Config, K,
                       radius: float = 7.5):
    """Sim3-guided correspondence harvest + joint re-optimization (reference
    ComputeSim3's second stage: matcher.SearchBySim3 with radius 7.5 then
    OptimizeSim3 over the union — src/LoopFinder.cpp:326-345,
    src/MapMatcher.cpp:330-345).

    side1/side2: outputs of :func:`kf_landmark_side`. ``S12_cam`` maps
    camera-2 coords into camera 1. feat1/feat2/inliers: the RANSAC stage's
    matched feature pairs (host) + inlier mask. Returns (Sim3OptResult,
    union_feat1, union_feat2, union_mp1, union_mp2), the last four on the
    host.
    """
    guided = matching.search_by_sim3(
        side1["desc"], side1["Xc"], side1["valid"],
        side2["desc"], side2["Xc"], side2["valid"], S12_cam, K, radius=radius)
    g_ok = guided.ok.cpu().numpy()
    g_idx = guided.idx.cpu().numpy()
    have1 = np.zeros(g_ok.shape[0], bool)
    have1[feat1] = True
    have2 = np.zeros(side2["valid"].shape[0], bool)
    have2[feat2] = True
    add1 = np.flatnonzero(g_ok & ~have1 & ~have2[g_idx])
    add2 = g_idx[add1]
    u1 = np.concatenate([feat1, add1])
    u2 = np.concatenate([feat2, add2])
    dev = side1["Xc"].device
    active0 = torch.from_numpy(np.concatenate([np.asarray(inliers, bool),
                                               np.ones(len(add1), bool)])).to(dev)
    j1 = torch.from_numpy(u1.astype(np.int64)).to(dev)
    j2 = torch.from_numpy(u2.astype(np.int64)).to(dev)
    inv_s2 = torch.from_numpy(orb.inv_level_sigma2(config.extractor)).to(dev)
    nlev = config.extractor.n_levels - 1
    opt = sim3_opt.optimize_sim3(
        S12_cam, side1["Xc"][j1], side2["Xc"][j2], side1["uv"][j1], side2["uv"][j2],
        inv_s2[torch.clamp(side1["octave"][j1], 0, nlev).long()],
        inv_s2[torch.clamp(side2["octave"][j2], 0, nlev).long()],
        active0, K)
    return opt, u1, u2, side1["mp"][u1], side2["mp"][u2]


@dataclasses.dataclass
class LoopCloser:
    config: Config
    map: ms.MapState
    database: db_mod.KeyFrameDatabase
    map_id: int = 0
    # covisibility-consistency state (reference DetectLoop :103):
    # list of (group: set[slot], count)
    consistent_groups: List[Tuple[Set[int], int]] = dataclasses.field(default_factory=list)
    last_loop_kf_id: int = -1
    n_loops_closed: int = 0
    # RANSAC draws, seeded 42 on the map's device when None
    generator: Optional[torch.Generator] = None
    run_gba_after_loop: bool = True
    # injectable GBA solver (tests corrupt it to exercise the MC gate);
    # None = run_gba's size-based selection
    gba_solver: Optional[object] = None
    n_regba: int = 0

    def __post_init__(self):
        if self.generator is None:
            self.generator = torch.Generator(device=self.map.device)
            self.generator.manual_seed(42)

    # ------------------------------------------------------------------
    def _covis_group(self, slot: int, thres: float = 15.0) -> Set[int]:
        # one row is enough — avoids the full O(NK^2) matrix per tick
        w = ms.covisibility_row(self.map.kf, self.map.nm, slot).cpu().numpy()
        return set(np.flatnonzero(w >= thres).tolist()) | {slot}

    # ------------------------------------------------------------------
    def detect(self, slot: int) -> Optional[int]:
        """BoW detection + consistency confirmation. Returns the accepted
        loop candidate slot or None (reference DetectLoop)."""
        with trace.span("loop_detect"):
            cfg = self.config.placerec
            kf = self.map.kf
            kf_id = int(kf.kf_id[slot].item())
            # respect the cooldown after a closed loop (reference: NewLoopThres)
            if self.last_loop_kf_id >= 0 and kf_id < self.last_loop_kf_id + cfg.new_loop_thres:
                self.database.add(slot, kf.desc[slot], kf.feat_valid[slot], map_id=self.map_id)
                return None
            covis_mask = np.zeros(self.map.nk, bool)
            covis_mask[list(self._covis_group(slot))] = True
            qbow = self.database.add(slot, kf.desc[slot], kf.feat_valid[slot], map_id=self.map_id)
            cands, _ = self.database.detect_loop_candidates(slot, qbow, covis_mask)
            if len(cands) == 0:
                self.consistent_groups = []
                return None
            # consistency: a candidate's covis group must intersect a previous
            # group for covisibility_consistency_th consecutive detections
            new_groups: List[Tuple[Set[int], int]] = []
            accepted = None
            for cand in cands:
                cand_grp = self._covis_group(int(cand))
                best_count = 0
                for grp_prev, count in self.consistent_groups:
                    if cand_grp & grp_prev:
                        best_count = max(best_count, count + 1)
                new_groups.append((cand_grp, best_count))
                if best_count + 1 >= cfg.covisibility_consistency_th and accepted is None:
                    accepted = int(cand)
            self.consistent_groups = new_groups
            return accepted

    # ------------------------------------------------------------------
    def compute_sim3(self, cur: int, cand: int):
        """Sim3 between current and candidate KF from matched landmarks
        (reference ComputeSim3 :231). Returns (S12 [sR|t] mapping cand-camera
        coords -> cur-camera coords, matched mp pairs) or None."""
        with trace.span("loop_sim3"):
            kf, mp = self.map.kf, self.map.mp
            dev = self.map.device
            m = matching.mutual_match(
                kf.desc[cur], kf.feat_valid[cur] & (kf.mp_idx[cur] >= 0),
                kf.desc[cand], kf.feat_valid[cand] & (kf.mp_idx[cand] >= 0),
                max_dist=matching.TH_LOW)
            ok = m.ok.cpu().numpy()
            if ok.sum() < self.config.opt.matches_thres:
                return None
            feat1 = np.flatnonzero(ok)
            feat2 = m.idx.cpu().numpy()[feat1]
            f1 = torch.from_numpy(feat1).to(dev)
            f2 = torch.from_numpy(feat2).to(dev)
            mp1 = kf.mp_idx[cur][f1].long()
            mp2 = kf.mp_idx[cand][f2].long()
            # camera-frame coordinates
            p1 = lie.transform_points(kf.Tcw[cur], mp.Xw[mp1][None])[0]
            p2 = lie.transform_points(kf.Tcw[cand], mp.Xw[mp2][None])[0]
            K = torch.from_numpy(self.config.camera.K()).to(dev)
            eye4 = torch.eye(4, dtype=torch.float32, device=dev)
            # RANSAC maps p2 -> p1 (S12) and needs only opt.min_inliers
            # (reference Opt.MinInliers = 6, cslam/conf/config.yaml:127); the
            # strict inliers_thres gate applies AFTER Sim3-guided densification
            # (reference LoopFinder.cpp:277,326-333)
            res = ransac.sim3_ransac(
                self.generator, p2, p1, kf.xy[cand][f2], kf.xy[cur][f1], eye4, eye4, K,
                torch.ones(len(feat1), dtype=torch.bool, device=dev),
                min_inliers=self.config.opt.min_inliers, fix_scale=False)
            if not bool(res.success.item()):
                return None
            S12 = lie.make_sim3(res.R, res.t, res.s)
            # Sim3-guided harvest of additional correspondences, then refine on
            # the union with bidirectional projection residuals (reference
            # SearchBySim3 radius 7.5 + second OptimizeSim3,
            # src/LoopFinder.cpp:326-345)
            side1 = kf_landmark_side(kf, mp, cur)
            side2 = kf_landmark_side(kf, mp, cand)
            opt, feat1, feat2, mp1, mp2 = sim3_guided_refine(
                side1, side2, S12, feat1, feat2, res.inliers.cpu().numpy(), self.config, K)
            if int(opt.n_inliers.item()) < self.config.opt.inliers_thres:
                return None
            # scale plausibility gate: monocular drift between a revisit and the
            # stored map is bounded; a wildly scaled fit latched onto a
            # degenerate configuration and would shear the neighborhood
            s = float(lie.split_sim3(opt.S12)[2].item())
            if not (0.5 < s < 2.0):
                return None
            return opt.S12, (feat1, feat2, mp1, mp2, opt.inliers.cpu().numpy())

    # ------------------------------------------------------------------
    def correct_loop(self, cur: int, cand: int, S12, match_info, interrupt_check=None) -> bool:
        """Propagate the loop correction, fuse, optimize the essential graph,
        and trigger the Motion-Check-gated GBA (reference CorrectLoop :407)."""
        with trace.span("loop_correct"):
            grp, S_before, Wb_ge, Wa_grp_ge, owner_of, S_corr = self._correct_and_fuse(
                cur, cand, S12)
        m = self.map
        self._optimize_essential_graph(cur, cand, grp, S_before, Wb_ge, Wa_grp_ge, owner_of,
                                       S_corr)

        # record the loop edge AFTER the solve (reference LoopFinder.cpp:699)
        loop_edge = m.kf.loop_edge.clone()
        loop_edge[cur] = cand
        loop_edge[cand] = cur
        m.kf = m.kf._replace(loop_edge=loop_edge)

        # loop-closure GBA with the Motion Check in GATING mode (reference
        # LoopFinder::RunGBA :1200-1202: flags only; a bad verdict latches
        # CorrectKF_switch off and sets request_GBA), then the MC-triggered
        # follow-up GBA (reference RequestBA_fromCorrectKF,
        # src/LoopFinder.cpp:754-762)
        if self.run_gba_after_loop:
            gba_mod.run_gba(m, self.config, interrupt_check=interrupt_check,
                            sharded_solver=self.gba_solver, mc_mode="gating")
            if m.request_gba:
                m.request_gba = False
                gba_mod.run_gba(m, self.config, interrupt_check=interrupt_check, mc_mode="full")
                self.n_regba += 1
        self.last_loop_kf_id = int(m.kf.kf_id[cur].item())
        self.n_loops_closed += 1
        return True

    def _correct_and_fuse(self, cur: int, cand: int, S12):
        """The correction's propagation over the current KF's covisibility
        group and the fusion around it. Returns the group, the
        pre-correction Sim3 poses, the pre-fusion covisibility test, the
        group's post-fusion one, each corrected landmark's owner and the
        group's corrected Sim3 poses (the loop's scale kept)."""
        cfg = self.config
        m = self.map
        kf, mp = m.kf, m.mp
        dev = m.device
        minfeat = cfg.opt.ess_graph_min_feats
        # pre-fusion covisibility: computed once on the device, fetched as
        # the thresholded boolean matrix + the current KF's row
        Wd = ms.covisibility(kf, m.nm)
        row_cur = Wd[cur].cpu().numpy()
        Wb_ge = (Wd >= minfeat).cpu().numpy()
        del Wd

        # the pre-correction poses: the reference's NonCorrectedSim3
        # (src/LoopFinder.cpp:520-566); the essential graph's normal edges
        # measure relative transforms from THESE
        S_before = _unit_sim3(kf.Tcw)

        # corrected Sim3 world pose of the current KF:
        # S_cur_w(corrected) = S12 . T_cand_w  (reference mg2oScw = gScm*gSmw)
        S_cur_corr = S12 @ _unit_sim3(kf.Tcw[cand])

        # neighborhood to correct: covis group of cur
        grp = sorted(set(np.flatnonzero(row_cur >= 15.0).tolist()) | {cur})
        grp_arr = np.array(grp, np.int64)
        grp_idx = torch.from_numpy(grp_arr).to(dev)
        # relative transforms S_ic = T_iw . T_cw^-1 (scale 1), corrected
        # S_iw' = S_ic . S_cur_corr
        S_grp = _unit_sim3(kf.Tcw[grp_idx])
        S_ic = S_grp @ lie.sim3_inv(_unit_sim3(kf.Tcw[cur]))[None]
        S_corr = S_ic @ S_cur_corr[None]

        # correct landmarks of the neighborhood: X' = S_corr^-1( S_old(X) )
        # for each landmark referenced by a corrected KF; remember the owner
        # (reference mCorrectedReference_LC) so the essential-graph landmark
        # correction uses the CORRECTED owner pose as its "before".
        # First-group-member-wins: scatter in REVERSE group order so the
        # earliest member's write lands last.
        lm_rows = kf.mp_idx[grp_idx].cpu().numpy()
        owner_of = np.full(m.nm, -1, np.int64)   # group-slot that corrected it
        flat = lm_rows[::-1].ravel()
        srcs = np.repeat(grp_arr[::-1], lm_rows.shape[1])
        okm = flat >= 0
        owner_of[flat[okm]] = srcs[okm]
        sel = np.flatnonzero(owner_of >= 0)
        if len(sel):
            slot_to_gi = np.full(m.nk, -1, np.int64)
            slot_to_gi[grp_arr] = np.arange(len(grp))
            gi = torch.from_numpy(slot_to_gi[owner_of[sel]]).to(dev)
            sel_t = torch.from_numpy(sel).to(dev)
            S_old = S_grp[gi]
            S_new_inv = lie.sim3_inv(S_corr[gi])
            x_cam = torch.einsum("lij,lj->li", S_old[:, :3, :3], mp.Xw[sel_t]) + S_old[:, :3, 3]
            X_new = torch.einsum("lij,lj->li", S_new_inv[:, :3, :3], x_cam) + S_new_inv[:, :3, 3]
            mp = mp._replace(Xw=mp.Xw.index_put((sel_t,), X_new))

        # write corrected poses (SE3 projection: t/s)
        kf = kf._replace(Tcw=kf.Tcw.index_put((grp_idx,), pose_graph.se3_from_sim3(S_corr)))
        m.kf, m.mp = kf, mp

        # landmark fusion around the corrected region (reference
        # SearchAndFuse): project loop-side landmarks into corrected KFs
        mapping_mod.fuse_neighbors(m, grp, cfg)

        # essential-graph optimization (reference
        # OptimizeEssentialGraphLoopClosure :696 / Optimizer.cpp:1064);
        # fusion created new cross-loop covis links (LoopConnections) —
        # only the corrected group's rows can have gained links
        Wa_grp_ge = (ms.covisibility_rows(m.kf, m.nm, grp_arr) >= minfeat).cpu().numpy()
        return grp, S_before, Wb_ge, Wa_grp_ge, owner_of, S_corr

    # ------------------------------------------------------------------
    def _optimize_essential_graph(self, cur: int, cand: int, grp, S_before_full, Wb_ge,
                                  Wa_grp_ge, lm_owner, S_corr):
        """Build and solve the Sim3 pose graph, compacted to valid KFs.

        Reference semantics (Optimizer.cpp:1064-1337):
        - vertex estimates: the covis group's corrected Sim3 ``S_corr``
          (G, 4, 4, in ``grp``'s sorted order), the loop's scale kept
          (reference CorrectedSim3); the current, pre-correction poses for
          everyone else; the loop KF is the fixed gauge;
        - loop-connection edges (new covis links across the loop created by
          fusion, plus the cur-cand pair) measure from the CORRECTED
          estimates (vScw);
        - normal edges (spanning tree, previous loop edges, strong covis)
          measure from the PRE-correction poses (NonCorrectedSim3).

        ``Wb_ge``: (NK, NK) bool, pre-fusion covis >= min_feats (invalid
        KFs have all-zero rows by construction). ``Wa_grp_ge``: (G, NK)
        bool, post-fusion covis >= min_feats for the corrected group's rows
        only. Edge assembly is vectorized on the host.
        """
        with trace.span("ess_graph"):
            cfg = self.config
            m = self.map
            kf = m.kf
            dev = m.device
            valid = kf.valid.cpu().numpy()
            slots = np.flatnonzero(valid)
            V = len(slots)
            if V < 2:
                return
            comp = np.full(m.nk, -1, np.int64)
            comp[slots] = np.arange(V)
            slots_t = torch.from_numpy(slots).to(dev)

            # vertex init: current poses = corrected group + uncorrected rest
            grp_arr = np.array(sorted(grp), np.int64)
            S_init = _unit_sim3(kf.Tcw[slots_t])
            S_init = S_init.index_put((torch.from_numpy(comp[grp_arr]).to(dev),), S_corr)
            S_bef = S_before_full[slots_t]
            parent = kf.parent.cpu().numpy()
            loop_edge = kf.loop_edge.cpu().numpy()

            # loop-connection edges (reference sets them first and skips
            # duplicates in the normal sections): always the cur-cand pair, plus
            # new strong links from corrected KFs to outside the group
            in_grp = np.zeros(m.nk, bool)
            in_grp[grp_arr] = True
            new_mask = Wa_grp_ge & ~Wb_ge[grp_arr] & valid[None, :] & ~in_grp[None, :]
            gi_new, j_new = np.nonzero(new_mask)
            loopc = np.concatenate([np.array([[cur, cand]], np.int64),
                                    np.stack([grp_arr[gi_new], j_new], -1)], 0)
            # normal edges: spanning tree + previous loop edges + strong covis,
            # all measured from the pre-correction poses
            p = parent[slots]
            p_ok = (p >= 0) & valid[np.clip(p, 0, m.nk - 1)]
            st = np.stack([slots[p_ok], p[p_ok]], -1)
            le_t = loop_edge[slots]
            le_ok = (le_t >= 0) & valid[np.clip(le_t, 0, m.nk - 1)]
            le = np.stack([slots[le_ok], le_t[le_ok]], -1)
            cov = np.argwhere(np.triu(Wb_ge, 1))
            norm = np.concatenate([st, le, cov], 0)

            # canonicalize + dedup, loop-connection edges take priority
            all_e = np.concatenate([loopc, norm], 0)
            a = np.minimum(all_e[:, 0], all_e[:, 1])
            b = np.maximum(all_e[:, 0], all_e[:, 1])
            keep = a != b
            a, b = a[keep], b[keep]
            n_loopc_cand = int(keep[:len(loopc)].sum())
            _, first = np.unique(a * m.nk + b, return_index=True)
            first.sort()
            a, b = a[first], b[first]
            is_loopc = first < n_loopc_cand
            order = np.argsort(~is_loopc, kind="stable")  # loop edges first
            a, b = a[order], b[order]
            nl = int(is_loopc.sum())
            if len(a) == 0:
                return

            ei = torch.from_numpy(comp[a]).to(dev)
            ej = torch.from_numpy(comp[b]).to(dev)
            meas = torch.cat([pose_graph.make_edge_measurements(S_init, ei[:nl], ej[:nl]),
                              pose_graph.make_edge_measurements(S_bef, ei[nl:], ej[nl:])], 0)
            E = int(ei.shape[0])
            trace.count("ess_graph_edges", E)
            edges = pose_graph.PoseGraphEdges(
                i=ei, j=ej, S_ji_meas=meas,
                weight=torch.ones(E, dtype=torch.float32, device=dev),
                valid=torch.ones(E, dtype=torch.bool, device=dev))
            fixed = np.zeros(V, bool)
            fixed[comp[cand]] = True   # loop KF anchors the gauge (ref :1119)
            res = pose_graph.optimize_pose_graph(S_init, edges, torch.from_numpy(fixed).to(dev),
                                                 iterations=cfg.opt.ess_graph_iterations)

            # landmark correction through reference keyframes (reference
            # Optimizer.cpp:1287-1326): landmarks moved by the Sim3 propagation
            # correct through their *owner* group KF (whose S_init is already
            # corrected); everyone else through its reference KF.
            ref_slot = m.mp.ref_kf.cpu().numpy().astype(np.int64)
            owned = lm_owner >= 0
            ref_slot[owned] = lm_owner[owned]
            ref_ok = (ref_slot >= 0) & valid[np.clip(ref_slot, 0, m.nk - 1)]
            ref_c = np.where(ref_ok, comp[np.clip(ref_slot, 0, m.nk - 1)], 0)
            X_new = pose_graph.correct_landmarks(m.mp.Xw, torch.from_numpy(ref_c).to(dev),
                                                 S_init, res.S_iw)
            move = m.mp.valid & torch.from_numpy(ref_ok).to(dev)
            m.mp = m.mp._replace(Xw=torch.where(move[:, None], X_new, m.mp.Xw))
            # scatter optimized poses back to their slots
            m.kf = kf._replace(Tcw=kf.Tcw.index_put((slots_t,),
                                                    pose_graph.se3_from_sim3(res.S_iw)))

    # ------------------------------------------------------------------
    def process_keyframe(self, slot: int, interrupt_check=None) -> bool:
        """Full loop-closing attempt for one arriving KF. Returns True if a
        loop was closed."""
        cand = self.detect(slot)
        if cand is None:
            return False
        got = self.compute_sim3(slot, cand)
        if got is None:
            return False
        S12, match_info = got
        return self.correct_loop(slot, cand, S12, match_info, interrupt_check=interrupt_check)
