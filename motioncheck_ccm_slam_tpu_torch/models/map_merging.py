"""Map fusion: merge one agent's map into another after a cross-map match.

Counterpart of ``motioncheck_ccm_slam_tpu/models/map_merging.py`` (the
reference ``MapMerger::MergeMaps``, src/MapMerger.cpp:39, and the Map merge
constructor, src/Map.cpp:100): the current map's keyframes and landmarks
are Sim3-transformed into the matched map's frame and re-allocated into
its blocks; association tables are remapped through a slot lookup; the
matched landmark pairs are fused (the kept map's landmark wins, reference
SearchAndFuse semantics); an essential-graph optimization then rigidifies
the seam, before the server's Motion-Check-gated GBA.

The copies are batched: one gather from the source blocks and one scatter
into the target's per field, for all moved keyframes and all moved
landmarks; slot allocation and the id -> slot maps stay on the host.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..config import Config
from ..ops import lie
from ..solvers import pose_graph
from . import map_state as ms
from .loop_closing import _unit_sim3


def sim3_transform_map(m: ms.MapState, S_ba) -> ms.MapState:
    """Express every pose/landmark of map ``m`` in the frame defined by Sim3
    ``S_ba`` (maps m's world coords into the target world): X' = S_ba(X),
    Tcw' = SE3(S_cw . S_ba^-1)."""
    kf, mp = m.kf, m.mp
    S_ab = lie.sim3_inv(S_ba)[None]
    keep = kf.valid[:, None, None]
    m.kf = kf._replace(
        Tcw=torch.where(keep, pose_graph.se3_from_sim3(_unit_sim3(kf.Tcw) @ S_ab), kf.Tcw),
        Tcw_pre_gba=torch.where(keep, pose_graph.se3_from_sim3(_unit_sim3(kf.Tcw_pre_gba) @ S_ab),
                                kf.Tcw_pre_gba))
    m.mp = mp._replace(Xw=torch.where(mp.valid[:, None], lie.sim3_apply(S_ba, mp.Xw[None])[0],
                                      mp.Xw))
    return m


_MP_COPIED = ("mp_id", "client_id", "unique_id", "Xw", "desc", "normal", "min_dist", "max_dist",
              "first_kf_id", "n_visible", "n_found")
_KF_COPIED = ("kf_id", "client_id", "unique_id", "timestamp", "Tcw", "xy", "angle", "octave",
              "desc", "feat_valid", "Tcw_pre_gba", "tracking_tws")


def merge_maps(m_from: ms.MapState, m_into: ms.MapState, S_ba, mp_fuse_pairs=None,
               config: Config = None) -> Tuple[ms.MapState, Dict[int, int], Dict[int, int]]:
    """Move every entity of ``m_from`` (already Sim3-transformed via
    ``sim3_transform_map``) into ``m_into``'s blocks.

    mp_fuse_pairs: optional array (N, 2) of (from_mp_slot, into_mp_slot) —
    matched landmark duplicates; the target map's landmark is kept and the
    source's observations are rewired onto it (reference landmark fusion in
    MergeMaps).

    Returns (m_into, kf_slot_map, mp_slot_map).
    """
    kf_from, mp_from = m_from.kf, m_from.mp
    dev = m_into.device
    from_kf_slots = np.flatnonzero(kf_from.valid.cpu().numpy())
    from_mp_slots = np.flatnonzero(mp_from.valid.cpu().numpy())

    fuse_map: Dict[int, int] = {}
    if mp_fuse_pairs is not None:
        for a, b in mp_fuse_pairs:
            fuse_map[int(a)] = int(b)

    # allocate landmark slots in the target (skip fused duplicates)
    alloc_list = np.array([s for s in from_mp_slots if int(s) not in fuse_map], np.int64)
    mp_ids = mp_from.mp_id.cpu().numpy()
    mp_cids = mp_from.client_id.cpu().numpy()
    ids = [(int(mp_ids[s]), int(mp_cids[s])) for s in alloc_list]
    new_slots = np.asarray(m_into.alloc_mp_slots(len(alloc_list), ids), np.int64)
    mp_slot_map: Dict[int, int] = {int(s): int(ns) for s, ns in zip(alloc_list, new_slots)}
    mp_slot_map.update(fuse_map)

    # landmark reference keyframes follow the KF slot map, filled below
    kf_slot_map: Dict[int, int] = {}
    kf_ids = kf_from.kf_id.cpu().numpy()
    kf_cids = kf_from.client_id.cpu().numpy()
    for s in from_kf_slots:
        kf_slot_map[int(s)] = m_into.alloc_kf_slot(int(kf_ids[s]), int(kf_cids[s]))
    kf_lut = np.full(m_from.nk + 1, -1, np.int64)      # -1 passthrough
    for old, new in kf_slot_map.items():
        kf_lut[old] = new

    if len(alloc_list):
        src = torch.from_numpy(alloc_list).to(dev)
        dst = torch.from_numpy(new_slots).to(dev)
        tgt = m_into.mp
        fields = {k: getattr(tgt, k).index_put((dst,), getattr(mp_from, k)[src])
                  for k in _MP_COPIED}
        ref_old = mp_from.ref_kf.cpu().numpy()[alloc_list].astype(np.int64)
        ref_new = np.where(ref_old >= 0, kf_lut[ref_old], -1)
        m_into.mp = tgt._replace(
            valid=tgt.valid.index_fill(0, dst, True),
            ref_kf=tgt.ref_kf.index_put((dst,), torch.from_numpy(ref_new).to(tgt.ref_kf)),
            **fields)

    # landmark slot LUT for association remapping (-1 passthrough)
    lut = np.full(m_from.nm + 1, -1, np.int64)
    for old, new in mp_slot_map.items():
        lut[old] = new

    if len(from_kf_slots):
        src = torch.from_numpy(from_kf_slots).to(dev)
        dst = torch.from_numpy(np.array([kf_slot_map[int(s)] for s in from_kf_slots],
                                        np.int64)).to(dev)
        old_assoc = kf_from.mp_idx.cpu().numpy()[from_kf_slots].astype(np.int64)
        new_assoc = np.where(old_assoc >= 0, lut[np.maximum(old_assoc, 0)], -1)
        # graph links through the slot map
        parent_old = kf_from.parent.cpu().numpy()[from_kf_slots].astype(np.int64)
        pred_old = kf_from.pred.cpu().numpy()[from_kf_slots].astype(np.int64)
        tgt = m_into.kf
        fields = {k: getattr(tgt, k).index_put((dst,), getattr(kf_from, k)[src])
                  for k in _KF_COPIED}

        def links(a):
            return torch.from_numpy(np.where(a >= 0, kf_lut[a], -1)).to(tgt.parent)

        m_into.kf = tgt._replace(
            mp_idx=tgt.mp_idx.index_put((dst,), torch.from_numpy(new_assoc).to(tgt.mp_idx)),
            valid=tgt.valid.index_fill(0, dst, True),
            parent=tgt.parent.index_put((dst,), links(parent_old)),
            pred=tgt.pred.index_put((dst,), links(pred_old)),
            **fields)
    m_into.sync_host_index()
    return m_into, kf_slot_map, mp_slot_map


def seam_measurement(Tcw_cur_pre, Tcw_match, S_align):
    """Measured Sim3 edge for one map-match hit.

    ``Tcw_cur_pre``: the current-map KF's pose BEFORE the alignment was
    applied (its own world); ``Tcw_match``: the matched KF's pose in the
    fused world; ``S_align``: this hit's measured Sim3 (cur world -> fused
    world). The hit implies the cur KF should sit at
    ``se3(U(Tcw_cur_pre) . S_align^-1)`` in the fused world; the edge
    measures S_ji = U(T_match) . U(T_implied)^-1, so the hit whose alignment
    was actually applied has zero residual and any additional hit's
    disagreement with it becomes signal for the solver.
    """
    T_impl = pose_graph.se3_from_sim3((_unit_sim3(Tcw_cur_pre) @ lie.sim3_inv(S_align))[None])[0]
    return _unit_sim3(Tcw_match) @ lie.sim3_inv(_unit_sim3(T_impl))


def optimize_seam_essential_graph(m: ms.MapState, seam_edges, fixed_slot: int, config: Config):
    """Essential-graph optimization over the fused map (reference
    ``Optimizer::OptimizeEssentialGraphMapFusion`` src/Optimizer.cpp:1339,
    called from MapMerger::MergeMaps :500 before the fused-map GBA).

    ``seam_edges``: list of ``(cur_slot, match_slot, S_ji_meas)`` — one per
    confirmed map-match hit, measured via :func:`seam_measurement` from the
    hit's own Sim3. Intra-map edges (spanning tree, old loop edges, strong
    covis) are measured from the CURRENT poses: the whole current map was
    rigidly aligned, so they are zero-residual rigidity anchors, as in the
    reference (Optimizer.cpp:1395, 1437-1460). The signal is the
    disagreement between several seam hits; with one hit the solve is a
    consistent fixed point. Gauge = the matched KF of the primary hit.
    """
    kf = m.kf
    dev = m.device
    valid = kf.valid.cpu().numpy()
    slots = np.flatnonzero(valid)
    V = len(slots)
    if V < 2 or not seam_edges:
        return
    comp = np.full(m.nk, -1, np.int64)
    comp[slots] = np.arange(V)
    slots_t = torch.from_numpy(slots).to(dev)
    S_init = _unit_sim3(kf.Tcw[slots_t])
    # thresholded covis fetched once as bool; edge assembly vectorized
    # (invalid KFs have all-zero covis rows by construction)
    W_ge = (ms.covisibility(kf, m.nm) >= config.opt.ess_graph_min_feats).cpu().numpy()
    parent = kf.parent.cpu().numpy()
    loop_edge = kf.loop_edge.cpu().numpy()

    live = [(int(c), int(s_), meas) for c, s_, meas in seam_edges if valid[c] and valid[s_]]
    seam = np.array([(c, s_) for c, s_, _ in live], np.int64).reshape(-1, 2)
    seam_meas_list = [meas for _, _, meas in live]
    p = parent[slots]
    p_ok = (p >= 0) & valid[np.clip(p, 0, m.nk - 1)]
    st = np.stack([slots[p_ok], p[p_ok]], -1)
    le_t = loop_edge[slots]
    le_ok = (le_t >= 0) & valid[np.clip(le_t, 0, m.nk - 1)]
    le = np.stack([slots[le_ok], le_t[le_ok]], -1)
    cov = np.argwhere(np.triu(W_ge, 1))

    all_e = np.concatenate([seam, st, le, cov], 0)
    a = np.minimum(all_e[:, 0], all_e[:, 1])
    b = np.maximum(all_e[:, 0], all_e[:, 1])
    keep = a != b
    a, b = a[keep], b[keep]
    n_seam_cand = int(keep[:len(seam)].sum())
    seam_meas_list = [mm for mm, k in zip(seam_meas_list, keep[:len(seam)]) if k]
    _, first = np.unique(a * m.nk + b, return_index=True)
    first.sort()
    a, b = a[first], b[first]
    is_seam = first < n_seam_cand
    order = np.argsort(~is_seam, kind="stable")    # seam edges first
    a, b = a[order], b[order]
    n_seam = int(is_seam.sum())
    # dedup may drop seam candidates; keep the surviving measurements in
    # first-occurrence order
    seam_meas_list = [seam_meas_list[i] for i in first[is_seam]]
    if len(a) == 0 or n_seam == 0:
        return
    ei = torch.from_numpy(comp[a]).to(dev)
    ej = torch.from_numpy(comp[b]).to(dev)
    meas = pose_graph.make_edge_measurements(S_init, ei, ej)
    meas = torch.cat([torch.stack(seam_meas_list, 0), meas[n_seam:]], 0)
    edges = pose_graph.PoseGraphEdges(
        i=ei, j=ej, S_ji_meas=meas,
        weight=torch.ones(len(a), dtype=torch.float32, device=dev),
        valid=torch.ones(len(a), dtype=torch.bool, device=dev))
    fixed = np.zeros(V, bool)
    fixed[comp[fixed_slot]] = True
    res = pose_graph.optimize_pose_graph(S_init, edges, torch.from_numpy(fixed).to(dev),
                                         iterations=config.opt.solver_iterations)
    # landmarks follow their reference keyframes
    ref_slot = m.mp.ref_kf.cpu().numpy().astype(np.int64)
    ref_ok = (ref_slot >= 0) & valid[np.clip(ref_slot, 0, m.nk - 1)]
    ref_c = np.where(ref_ok, comp[np.clip(ref_slot, 0, m.nk - 1)], 0)
    X_new = pose_graph.correct_landmarks(m.mp.Xw, torch.from_numpy(ref_c).to(dev), S_init,
                                         res.S_iw)
    move = m.mp.valid & torch.from_numpy(ref_ok).to(dev)
    m.mp = m.mp._replace(Xw=torch.where(move[:, None], X_new, m.mp.Xw))
    m.kf = kf._replace(Tcw=kf.Tcw.index_put((slots_t,), pose_graph.se3_from_sim3(res.S_iw)))
