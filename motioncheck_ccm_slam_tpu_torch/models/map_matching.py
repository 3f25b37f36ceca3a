"""Cross-map place recognition and merge triggering.

Counterpart of ``motioncheck_ccm_slam_tpu/models/map_matching.py`` (the
reference ``MapMatcher``, src/MapMatcher.cpp): one global matcher watches
every per-agent server map through a shared BoW database whose retrieval
excludes the query's own map (``DetectMapMatchCandidates``); candidates
must pass the same covisibility-consistency confirmation as loop closing
(reference MapMatcher::DetectLoop src/MapMatcher.cpp:104) before a
cross-map Sim3 is computed and handed to the merger — a single aliased BoW
hit must NOT fuse two maps.

RANSAC draws come from the matcher's ``torch.Generator`` (seeded 7 on the
device), where the JAX package splits ``PRNGKey(7)`` once an attempt.
Maps are compared by identity (``is``): after a merge several handlers
share one ``MapState``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..config import Config
from ..ops import lie, matching, ransac
from . import database as db_mod
from . import loop_closing as lc_mod
from . import map_state as ms
from . import vocabulary as vocab_mod


@dataclasses.dataclass
class MapMatchHit:
    """A confirmed cross-map correspondence (reference MapMatcher.h:66-81)."""

    map_id_cur: int
    map_id_match: int
    slot_cur: int
    slot_match: int
    S_match_from_cur: torch.Tensor     # Sim3: cur-map world -> match-map world
    # matched landmark duplicates (cur-map slot, match-map slot), RANSAC
    # inliers only — the merger collapses these (reference matchedMPs)
    mp_pairs: np.ndarray = None
    # auxiliary confirmed hits from the same consistency chain:
    # (slot_cur, slot_match, S_match_from_cur_k), each an independently
    # measured alignment for the merge's seam essential graph (reference
    # MergeMaps takes a vector<MapMatchHit>, src/MapMatcher.cpp:439-448)
    aux: List[Tuple[int, int, torch.Tensor]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class MapMatcher:
    """Global cross-map matcher over all per-agent maps."""

    config: Config
    maps: Dict[int, ms.MapState]
    vocab: vocab_mod.Vocabulary = None
    # one shared database; rows are (map_id, slot) pairs flattened
    db: db_mod.KeyFrameDatabase = None
    row_of: Dict[Tuple[int, int], int] = dataclasses.field(default_factory=dict)
    key_of_row: Dict[int, Tuple[int, int]] = dataclasses.field(default_factory=dict)
    next_row: int = 0
    # RANSAC draws, seeded 7 on the maps' device when None
    generator: Optional[torch.Generator] = None
    # covisibility-consistency state per query map id:
    # list of (cand_map_id, group: set[slot-in-cand-map], count)
    consistent_groups: Dict[int, List[Tuple[int, Set[int], int]]] = \
        dataclasses.field(default_factory=dict)
    # trailing (slot_q, cand_map_id, cand_slot) detections of the live
    # consistency chain — on acceptance these yield auxiliary Sim3 hits
    chain_pairs: Dict[int, List[Tuple[int, int, int]]] = \
        dataclasses.field(default_factory=dict)
    max_aux_hits: int = 2

    def __post_init__(self):
        device = next(iter(self.maps.values())).device
        if self.vocab is None:
            self.vocab = vocab_mod.default_vocabulary()
        if self.db is None:
            cap = sum(m.nk for m in self.maps.values())
            self.db = db_mod.KeyFrameDatabase(vocab=self.vocab, capacity=cap, device=device)
        if self.generator is None:
            self.generator = torch.Generator(device=device)
            self.generator.manual_seed(7)

    # ------------------------------------------------------------------
    def add_keyframe(self, map_id: int, slot: int):
        m = self.maps[map_id]
        row = self.row_of.get((map_id, slot))
        if row is None:
            row = self.next_row
            self.next_row += 1
            self.row_of[(map_id, slot)] = row
            self.key_of_row[row] = (map_id, slot)
        self.db.add(row, m.kf.desc[slot], m.kf.feat_valid[slot], map_id=map_id)

    # ------------------------------------------------------------------
    def _covis_group(self, map_id: int, slot: int, thres: float = 15.0) -> Set[int]:
        m = self.maps[map_id]
        w = ms.covisibility_row(m.kf, m.nm, slot).cpu().numpy()
        return set(np.flatnonzero(w >= thres).tolist()) | {slot}

    def check(self, map_id: int, slot: int) -> Optional[MapMatchHit]:
        """Look for a cross-map hit for a newly arrived KF. A candidate is
        accepted only after ``covisibility_consistency_th`` consecutive
        detections hit overlapping covis groups of the same foreign map
        (reference MapMatcher::DetectLoop)."""
        m = self.maps[map_id]
        kf_id = int(m.kf.kf_id[slot].item())
        if kf_id < self.config.placerec.start_map_matching_after_kf:
            self.add_keyframe(map_id, slot)
            return None
        _, qbow = vocab_mod.make_transform(self.vocab, m.device)(m.kf.desc[slot],
                                                                 m.kf.feat_valid[slot])
        self.add_keyframe(map_id, slot)
        # similarity bar: the lowest BoW score among the query's own covis
        # neighbors (reference MapMatcher::DetectLoop
        # src/MapMatcher.cpp:133-150; no neighbors => bar stays at 1.0)
        s_all = self.db.scores(qbow).cpu().numpy()
        neigh_rows = [self.row_of[(map_id, s)] for s in self._covis_group(map_id, slot) - {slot}
                      if (map_id, s) in self.row_of]
        min_score = min((float(s_all[r]) for r in neigh_rows), default=1.0)
        cands, _ = self.db.detect_map_match_candidates(qbow, map_id,
                                                       min_score=max(min_score, 0.05))
        prev_groups = self.consistent_groups.get(map_id, [])
        if len(cands) == 0:
            self.consistent_groups[map_id] = []
            self.chain_pairs[map_id] = []
            return None
        th = self.config.placerec.covisibility_consistency_th
        new_groups: List[Tuple[int, Set[int], int]] = []
        accepted: Optional[Tuple[int, int, int]] = None
        for row in cands:
            mid2, slot2 = self.key_of_row[int(row)]
            if self.maps[mid2] is m:
                continue   # maps fused since the row was added
            grp = self._covis_group(mid2, slot2)
            best = 0
            for pm, pg, pc in prev_groups:
                if pm == mid2 and (grp & pg):
                    best = max(best, pc + 1)
            new_groups.append((mid2, grp, best))
            if best + 1 >= th and accepted is None:
                accepted = (int(row), mid2, slot2)
        self.consistent_groups[map_id] = new_groups
        # remember this detection's strongest candidate for aux-hit harvest
        mid_t, slot_t = self.key_of_row[int(cands[0])]
        chain = self.chain_pairs.get(map_id, [])
        chain.append((slot, mid_t, slot_t))
        self.chain_pairs[map_id] = chain[-(self.max_aux_hits + 2):]
        if accepted is None:
            return None
        _, mid2, slot2 = accepted
        hit = self._compute_cross_sim3(map_id, slot, mid2, slot2)
        if hit is not None:
            # harvest auxiliary alignments from the chain's earlier
            # detections of the same foreign map
            for sq, mt, st in reversed(self.chain_pairs.get(map_id, [])):
                if len(hit.aux) >= self.max_aux_hits:
                    break
                if mt != mid2 or (sq == slot and st == slot2):
                    continue
                aux = self._compute_cross_sim3(map_id, sq, mt, st)
                if aux is not None:
                    hit.aux.append((sq, st, aux.S_match_from_cur))
            self.consistent_groups[map_id] = []
            self.chain_pairs[map_id] = []
        return hit

    # ------------------------------------------------------------------
    def _compute_cross_sim3(self, mid1, slot1, mid2, slot2) -> Optional[MapMatchHit]:
        m1, m2 = self.maps[mid1], self.maps[mid2]
        kf1, kf2 = m1.kf, m2.kf
        dev = m1.device
        mm = matching.mutual_match(
            kf1.desc[slot1], kf1.feat_valid[slot1] & (kf1.mp_idx[slot1] >= 0),
            kf2.desc[slot2], kf2.feat_valid[slot2] & (kf2.mp_idx[slot2] >= 0),
            max_dist=matching.TH_LOW)
        ok = mm.ok.cpu().numpy()
        if ok.sum() < self.config.opt.matches_thres:
            return None
        feat1 = np.flatnonzero(ok)
        feat2 = mm.idx.cpu().numpy()[feat1]
        f1 = torch.from_numpy(feat1).to(dev)
        f2 = torch.from_numpy(feat2).to(dev)
        X1w = m1.mp.Xw[kf1.mp_idx[slot1][f1].long()]     # cur-map world
        X2w = m2.mp.Xw[kf2.mp_idx[slot2][f2].long()]     # match-map world
        K = torch.from_numpy(self.config.camera.K()).to(dev)
        # Sim3 on WORLD coordinates: X2w ~ S(X1w); reprojection check via the
        # two keyframes' poses. The RANSAC gate is opt.min_inliers
        # (reference Opt.MinInliers = 6); the strict inliers_thres applies
        # after Sim3-guided densification
        res = ransac.sim3_ransac(
            self.generator, X1w, X2w, kf1.xy[slot1][f1], kf2.xy[slot2][f2],
            kf1.Tcw[slot1], kf2.Tcw[slot2], K,
            torch.ones(len(feat1), dtype=torch.bool, device=dev),
            min_inliers=self.config.opt.min_inliers)
        if not bool(res.success.item()):
            return None
        S = lie.make_sim3(res.R, res.t, res.s)      # A: w1 -> w2
        # Sim3-guided densification + joint refinement (reference
        # MapMatcher::ComputeSim3, src/MapMatcher.cpp:330-345), in camera
        # frames: S12_cam (cam2 -> cam1) = U(T1) . A^-1 . U(T2)^-1
        U1 = lc_mod._unit_sim3(kf1.Tcw[slot1])
        U2 = lc_mod._unit_sim3(kf2.Tcw[slot2])
        S12_cam = U1 @ lie.sim3_inv(S) @ lie.sim3_inv(U2)
        side1 = lc_mod.kf_landmark_side(kf1, m1.mp, slot1)
        side2 = lc_mod.kf_landmark_side(kf2, m2.mp, slot2)
        opt, _, _, mp1u, mp2u = lc_mod.sim3_guided_refine(
            side1, side2, S12_cam, feat1, feat2, res.inliers.cpu().numpy(), self.config, K)
        if int(opt.n_inliers.item()) < self.config.opt.inliers_thres:
            return None
        S_ref = lie.sim3_inv(U2) @ lie.sim3_inv(opt.S12) @ U1
        inl = opt.inliers.cpu().numpy()
        return MapMatchHit(map_id_cur=mid1, map_id_match=mid2, slot_cur=slot1,
                           slot_match=slot2, S_match_from_cur=S_ref,
                           mp_pairs=np.stack([mp1u[inl], mp2u[inl]], -1))
