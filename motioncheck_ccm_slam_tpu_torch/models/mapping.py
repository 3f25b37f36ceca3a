"""Local mapping: per-keyframe map growth and maintenance.

Counterpart of ``motioncheck_ccm_slam_tpu/models/mapping.py`` (the
reference client's ``LocalMapping::RunClient``, src/Mapping.cpp:44): insert
the new KF -> cull recent landmarks -> triangulate new landmarks with
covisible neighbours -> fuse duplicates -> refresh landmark statistics ->
clip the local map (``Map::MapTrimming`` src/Map.cpp:869) -> local BA. The
server's landmark probation and redundant-keyframe culling live here too.

``LocalMapper.process_keyframe`` runs the stages in order on the client's
``MapState``. Each stage is tensor code on the blocks' device; the host
reads what the JAX package reads: each neighbour's triangulation count,
each fused keyframe's claims, the cull and trim counts and the
covisibility row that picks the neighbours.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..ops import geometry, lie, matching, orb
from ..solvers import ba_core, local_ba
from . import map_state as ms
from .frame import Frame

N_TRIANG_NEIGHBORS = 20    # covis neighbours used for triangulation
                           # (reference CreateNewMapPoints searches 20,
                           # src/Mapping.cpp:302): the strongest neighbours
                           # are the nearest KFs, whose baselines fail the
                           # triangulation parallax gate; the wide-baseline
                           # pairs among 20 keep landmark creation alive.


def _camera_tensors(config: Config, device):
    """K, per-octave 1/sigma^2 and scale factors on ``device``."""
    return (torch.from_numpy(config.camera.K()).to(device),
            torch.from_numpy(orb.inv_level_sigma2(config.extractor)).to(device),
            torch.from_numpy(orb.scale_factors(config.extractor)).to(device))


def covis_neighbors_of(m: ms.MapState, slot: int, k: int = N_TRIANG_NEIGHBORS,
                       thres: float = 15.0):
    """Strongest covisibility neighbours of one KF (weight >= thres), in the
    order of numpy's ``argsort`` of the negated row on the host."""
    w = ms.covisibility_row(m.kf, m.nm, slot).cpu().numpy()
    valid = m.kf.valid.cpu().numpy()
    order = np.argsort(-w)
    return [int(s) for s in order[:k] if w[s] >= thres and valid[s]]


# ---------------------------------------------------------------------------
# KF insertion
# ---------------------------------------------------------------------------

def _set_row(t: torch.Tensor, slot: int, value) -> torch.Tensor:
    """A copy of ``t`` with row ``slot`` set to ``value``."""
    t = t.clone()
    t[slot] = value
    return t


def insert_keyframe(m: ms.MapState, fr: Frame, kf_id: int, client_id: int,
                    parent_slot: int = -1, pred_slot: int = -1) -> int:
    """Allocate a slot and write the frame into the KF block."""
    slot = m.alloc_kf_slot(kf_id, client_id)
    kf, f = m.kf, fr.feats
    m.kf = kf._replace(
        kf_id=_set_row(kf.kf_id, slot, kf_id),
        client_id=_set_row(kf.client_id, slot, client_id),
        timestamp=_set_row(kf.timestamp, slot, fr.timestamp),
        Tcw=_set_row(kf.Tcw, slot, fr.Tcw),
        xy=_set_row(kf.xy, slot, f.xy),
        angle=_set_row(kf.angle, slot, f.angle),
        octave=_set_row(kf.octave, slot, f.octave.to(torch.int32)),
        desc=_set_row(kf.desc, slot, f.desc),
        feat_valid=_set_row(kf.feat_valid, slot, f.valid),
        mp_idx=_set_row(kf.mp_idx, slot, fr.mp_idx.to(torch.int32)),
        parent=_set_row(kf.parent, slot, parent_slot),
        pred=_set_row(kf.pred, slot, pred_slot),
        valid=_set_row(kf.valid, slot, True),
        loop_edge=_set_row(kf.loop_edge, slot, -1),
    )
    return slot


# ---------------------------------------------------------------------------
# Triangulation of new landmarks with covisible neighbours
# ---------------------------------------------------------------------------

def _triangulate_with_neighbor(xy1, desc1, octave1, free1, Tcw1,
                               xy2, desc2, octave2, free2, Tcw2,
                               K, inv_sigma2_arr, scale_factors, n_levels: int):
    """Epipolar-match free features of KF1 against free features of one
    neighbour KF2 and triangulate (reference CreateNewMapPoints
    src/Mapping.cpp:302). Returns per KF1 feature: (pts3d (F, 3), match
    into KF2 (F,), ok (F,))."""
    T21 = Tcw2 @ lie.inv_T(Tcw1)
    Kinv = torch.linalg.inv(K)
    F12 = Kinv.T @ (lie.hat(T21[:3, 3]) @ T21[:3, :3]) @ Kinv   # x2^T F12 x1 = 0
    m = matching.search_for_triangulation(
        desc1, xy1, free1, desc2, xy2, free2, F12, inv_sigma2_arr, octave2,
        max_dist=matching.TH_LOW)
    uv2 = xy2[m.idx]
    pts = geometry.triangulate_dlt(geometry.projection_matrix(K, Tcw1),
                                   geometry.projection_matrix(K, Tcw2),
                                   xy1[None], uv2[None])[0][0]
    # positive depth in both views, parallax, reprojection chi2, scale
    C1 = geometry.camera_center(Tcw1)
    C2 = geometry.camera_center(Tcw2)
    cosp = geometry.parallax_cos(C1[None], C2[None], pts[None])[0]
    pc1 = lie.transform_points(Tcw1, pts[None])[0]
    pc2 = lie.transform_points(Tcw2, pts[None])[0]
    uvp1 = geometry.project(pc1[None], K)[0]
    uvp2 = geometry.project(pc2[None], K)[0]
    oct1 = torch.clamp(octave1, 0, n_levels - 1).long()
    oct2 = torch.clamp(octave2[m.idx], 0, n_levels - 1).long()
    e1 = torch.sum((uvp1 - xy1) ** 2, -1) * inv_sigma2_arr[oct1]
    e2 = torch.sum((uvp2 - uv2) ** 2, -1) * inv_sigma2_arr[oct2]
    # scale consistency: distance ratio against octave ratio
    ratio_d = (torch.linalg.norm(pts - C1, dim=-1)
               / torch.clamp_min(torch.linalg.norm(pts - C2, dim=-1), 1e-9))
    ratio_o = scale_factors[oct1] / scale_factors[oct2]
    ratio_factor = 1.5 * scale_factors[1] / scale_factors[0]
    ok = (m.ok & (pc1[:, 2] > 0) & (pc2[:, 2] > 0) & (cosp < 0.9998)
          & (e1 < 5.991) & (e2 < 5.991)
          & (ratio_d < ratio_o * ratio_factor) & (ratio_d * ratio_factor > ratio_o))
    return pts, m.idx, ok


def _write_new_mps(mp: ms.MPBlock, slots, pts, descs, ids, client_id: int,
                   first_kf_id, ref_kf_slot: int) -> ms.MPBlock:
    """Landmarks ``ids`` at ``slots`` (i64 tensors) with positions and
    descriptors, fresh statistics and their first KF."""
    def put(t, v):
        if isinstance(v, torch.Tensor):
            return t.index_put((slots,), v.to(t.dtype))
        return t.index_fill(0, slots, v)   # a host scalar: no copy to the device

    return mp._replace(
        mp_id=put(mp.mp_id, ids),
        client_id=put(mp.client_id, client_id),
        Xw=put(mp.Xw, pts),
        desc=put(mp.desc, descs),
        normal=put(mp.normal, 0.0),
        min_dist=put(mp.min_dist, 0.0),
        max_dist=put(mp.max_dist, 1e9),
        ref_kf=put(mp.ref_kf, ref_kf_slot),
        first_kf_id=put(mp.first_kf_id, first_kf_id),
        n_visible=put(mp.n_visible, 1),
        n_found=put(mp.n_found, 1),
        valid=put(mp.valid, True),
    )


def _write_assocs(kf: ms.KFBlock, slot1: int, feat1, slot2: int, feat2, mp_slots) -> ms.KFBlock:
    mp_slots = mp_slots.to(torch.int32)
    mp_idx = kf.mp_idx.clone()
    mp_idx[slot1, feat1] = mp_slots
    mp_idx[slot2, feat2] = mp_slots
    return kf._replace(mp_idx=mp_idx)


def create_new_map_points(m: ms.MapState, new_slot: int, neighbor_slots, config: Config,
                          next_mp_id: int, client_id: int):
    """Triangulate new landmarks between the new KF and its covis
    neighbours, one neighbour after another (each sees the landmarks the
    ones before it created), allocate MP slots and write the associations.
    Returns (# created, next landmark id)."""
    dev = m.device
    K, inv_s2, sf = _camera_tensors(config, dev)
    created = 0
    for nb in neighbor_slots:
        kf = m.kf
        free1 = kf.feat_valid[new_slot] & (kf.mp_idx[new_slot] < 0)
        free2 = kf.feat_valid[nb] & (kf.mp_idx[nb] < 0)
        pts, idx2, ok = _triangulate_with_neighbor(
            kf.xy[new_slot], kf.desc[new_slot], kf.octave[new_slot], free1, kf.Tcw[new_slot],
            kf.xy[nb], kf.desc[nb], kf.octave[nb], free2, kf.Tcw[nb],
            K, inv_s2, sf, config.extractor.n_levels)
        feat1_np = np.flatnonzero(ok.cpu().numpy())
        n_new = len(feat1_np)
        if n_new == 0:
            continue
        ids = [(next_mp_id + i, client_id) for i in range(n_new)]
        slots = torch.from_numpy(m.alloc_mp_slots(n_new, ids)).to(dev)
        next_mp_id += n_new
        created += n_new
        feat1 = torch.from_numpy(feat1_np).to(dev)
        m.mp = _write_new_mps(
            m.mp, slots, pts[feat1], m.kf.desc[new_slot][feat1],
            torch.arange(ids[0][0], ids[0][0] + n_new, dtype=torch.int32, device=dev),
            client_id, m.kf.kf_id[new_slot], new_slot)
        m.kf = _write_assocs(m.kf, new_slot, feat1, nb, idx2[feat1], slots)
    return created, next_mp_id


# ---------------------------------------------------------------------------
# Fuse: project landmarks into neighbours to densify observations
# ---------------------------------------------------------------------------

def _fuse_match(kf_xy, kf_desc, kf_octave, kf_feat_valid, kf_mp_idx, Tcw,
                mp_Xw, mp_desc, mp_valid, K, width, height, inv_sigma2_arr, n_levels: int):
    """Projection-match landmarks into one KF's features (reference
    ORBmatcher::Fuse) over all valid features: an occupied best match is a
    replace candidate, a free one a claim. Returns per landmark (best
    feature index, ok and not already here, ok and already here).

    The gate is strict (Hamming 35, 3 px, per-octave chi2): a loose fuse
    claims the sibling corners every blob makes across pyramid levels.
    """
    R, t = Tcw[:3, :3], Tcw[:3, 3]
    pc = mp_Xw @ R.T + t
    uv = geometry.project(pc[None], K)[0]
    vis = mp_valid & (pc[:, 2] > 0.05) & geometry.in_image(uv, width, height)
    octv = torch.zeros(mp_Xw.shape[0], dtype=torch.int64, device=mp_Xw.device)
    m = matching.search_by_projection(
        mp_desc, uv, octv, vis, kf_desc, kf_xy, kf_octave, kf_feat_valid,
        radius=3.0, max_dist=35, nn_ratio=1.0, use_octave=False)
    # chi2 gate at the claimed feature's octave (reference Fuse: e2 *
    # invSigma2 <= 5.99, src/ORBmatcher.cpp:950)
    err = kf_xy[m.idx] - uv
    chi2 = torch.sum(err * err, -1) * inv_sigma2_arr[
        torch.clamp(kf_octave[m.idx], 0, n_levels - 1).long()]
    # a landmark must not re-claim a feature it already owns in this KF
    already_here = kf_mp_idx[m.idx].long() == torch.arange(mp_Xw.shape[0], device=mp_Xw.device)
    ok = m.ok & (chi2 <= 5.991)
    return m.idx, ok & ~already_here, ok & already_here


def _apply_replacement(mp_idx: torch.Tensor, repl: torch.Tensor) -> torch.Tensor:
    """Rewire associations through a landmark-replacement map ``repl``
    (NM,) -> winner slot (identity where none), then drop per-row
    duplicates, preferring the original association and then the earlier
    feature (reference MapPoint::Replace: observers of the loser re-point
    to the winner unless the winner is already observed in that KF)."""
    nk, F = mp_idx.shape
    old = mp_idx.long()
    new = torch.where(old >= 0, repl.long()[torch.clamp_min(old, 0)], -1)
    rewired = (new != old) & (old >= 0)
    fidx = torch.arange(F, device=mp_idx.device)[None, :]
    big = torch.iinfo(torch.int64).max
    key = torch.where(new >= 0, new * (2 * F) + rewired.long() * F + fidx, big)
    skey = torch.sort(key, dim=1).values
    mp_sorted = skey // (2 * F)
    dup = torch.cat([torch.zeros_like(skey[:, :1], dtype=torch.bool),
                     (mp_sorted[:, 1:] == mp_sorted[:, :-1]) & (skey[:, 1:] != big)], 1)
    drop = torch.zeros((nk, F + 1), dtype=torch.bool, device=mp_idx.device)
    drop = drop.scatter(1, torch.where(dup, skey % F, F), True)[:, :F]
    return torch.where(drop, -1, new).to(mp_idx.dtype)


def _merge_mp_stats(mp: ms.MPBlock, losers: torch.Tensor, winners: torch.Tensor) -> ms.MPBlock:
    return mp._replace(
        n_visible=mp.n_visible.index_add(0, winners, mp.n_visible[losers]),
        n_found=mp.n_found.index_add(0, winners, mp.n_found[losers]),
        valid=mp.valid.index_fill(0, losers, False),
    )


def replace_map_points(m: ms.MapState, pairs) -> int:
    """Collapse duplicate landmarks: of each (a, b) pair the one with more
    observations survives and absorbs the other's observers and statistics
    (reference ORBmatcher::Fuse :977 + MapPoint::Replace). Returns the
    number of landmarks replaced."""
    nm = m.nm
    n_obs = ms.mp_observation_counts(m.kf, nm).cpu().numpy()
    repl = np.arange(nm, dtype=np.int64)

    def find(x):
        while repl[x] != x:
            x = repl[x]
        return int(x)

    n = 0
    for a, b in pairs:
        ra, rb = find(int(a)), find(int(b))
        if ra == rb:
            continue
        w, l = (ra, rb) if n_obs[ra] >= n_obs[rb] else (rb, ra)
        repl[l] = w
        n += 1
    if n == 0:
        return 0
    while True:
        r2 = repl[repl]
        if np.array_equal(r2, repl):
            break
        repl = r2
    dev = m.device
    m.kf = m.kf._replace(mp_idx=_apply_replacement(m.kf.mp_idx, torch.from_numpy(repl).to(dev)))
    losers = np.flatnonzero(repl != np.arange(nm))
    m.mp = _merge_mp_stats(m.mp, torch.from_numpy(losers).to(dev),
                           torch.from_numpy(repl[losers]).to(dev))
    m.sync_host_index()
    return n


def fuse_neighbors(m: ms.MapState, kf_slots, config: Config):
    """Project all valid landmarks into each listed KF: claim free
    features, and collapse duplicate landmarks where the best feature is
    already held (reference SearchInNeighbors src/Mapping.cpp:489 +
    ORBmatcher::Fuse with Replace). Returns (n_claimed, n_replaced)."""
    K, inv_s2, _ = _camera_tensors(config, m.device)
    n_claim = 0
    pairs = []
    for s in kf_slots:
        kf = m.kf
        feat_idx, ok, _ = _fuse_match(
            kf.xy[s], kf.desc[s], kf.octave[s], kf.feat_valid[s], kf.mp_idx[s], kf.Tcw[s],
            m.mp.Xw, m.mp.desc, m.mp.valid, K, config.camera.width, config.camera.height,
            inv_s2, config.extractor.n_levels)
        cand = np.flatnonzero(ok.cpu().numpy())
        if not len(cand):
            continue
        feats = feat_idx.cpu().numpy()[cand]
        row = kf.mp_idx[s].cpu().numpy().copy()
        incumbent = row[feats]
        free = incumbent < 0
        if free.any():
            row[feats[free]] = cand[free]
            m.kf = kf._replace(mp_idx=_set_row(kf.mp_idx, s, torch.from_numpy(row)))
            n_claim += int(free.sum())
        for c, inc in zip(cand[~free], incumbent[~free]):
            if int(c) != int(inc):
                pairs.append((int(c), int(inc)))
    n_repl = replace_map_points(m, pairs) if pairs else 0
    return n_claim, n_repl


# ---------------------------------------------------------------------------
# Landmark culling / map trimming
# ---------------------------------------------------------------------------

def _drop_dead_observations(kf: ms.KFBlock, dead: torch.Tensor) -> ms.KFBlock:
    """Clear associations to landmarks marked ``dead`` (NM,)."""
    obs_dead = dead[torch.clamp_min(kf.mp_idx, 0).long()] & (kf.mp_idx >= 0)
    return kf._replace(mp_idx=torch.where(obs_dead, -1, kf.mp_idx))


def _cull_mps_kernel(kf: ms.KFBlock, mp: ms.MPBlock, newest_kf_id: int):
    """Erase weak recent landmarks (reference MapPointCullingClient): within
    ~3 keyframes of its creation a landmark must keep a found/visible ratio
    of 0.25 and, from its second KF on, more than 2 observations; after
    that window it is never tested again."""
    n_obs = ms.mp_observation_counts(kf, mp.valid.shape[0])
    age = newest_kf_id - mp.first_kf_id
    ratio = mp.n_found.to(torch.float32) / torch.clamp_min(mp.n_visible.to(torch.float32), 1.0)
    bad = mp.valid & (age <= 3) & ((ratio < 0.25) | ((age >= 2) & (n_obs <= 2)))
    return _drop_dead_observations(kf, bad), mp._replace(valid=mp.valid & ~bad), torch.sum(bad)


def cull_map_points(m: ms.MapState, newest_kf_id: int) -> int:
    m.kf, m.mp, n = _cull_mps_kernel(m.kf, m.mp, newest_kf_id)
    n = int(n)
    if n:
        m.sync_host_index()
    return n


def _cull_server_kernel(kf: ms.KFBlock, mp: ms.MPBlock, mp_tick, tick: int, client_id: int):
    """Server recent-landmark probation (reference MapPointCullingServer
    src/Mapping.cpp:756-787): an own-client landmark leaving its 3-KF
    probation window with <= 3 observations is erased (the found-ratio rule
    is client-only: the wire schema carries no visibility statistics)."""
    n_obs = ms.mp_observation_counts(kf, mp.valid.shape[0])
    leaving = (mp_tick >= 0) & (tick - mp_tick == 3)
    bad = mp.valid & leaving & (mp.client_id == client_id) & (n_obs <= 3)
    return _drop_dead_observations(kf, bad), mp._replace(valid=mp.valid & ~bad), torch.sum(bad)


def cull_recent_mps_server(m: ms.MapState, mp_tick: np.ndarray, tick: int,
                           client_id: int) -> int:
    """Run the server landmark probation check; ``mp_tick`` maps MP slot ->
    processed-KF count at insertion (-1 = untracked)."""
    m.kf, m.mp, n = _cull_server_kernel(
        m.kf, m.mp, torch.from_numpy(np.asarray(mp_tick)).to(m.device), tick, client_id)
    n = int(n)
    if n:
        m.sync_host_index()
    return n


def _trim_kernel(kf: ms.KFBlock, mp: ms.MPBlock, min_keep_kf_id: int):
    """Clip the client map to the newest window (reference Map::MapTrimming
    src/Map.cpp:869): drop KFs older than min_keep_kf_id and landmarks left
    with no observations."""
    drop_kf = kf.valid & (kf.kf_id < min_keep_kf_id)
    kf_valid = kf.valid & ~drop_kf
    kf2 = kf._replace(
        valid=kf_valid,
        mp_idx=torch.where(kf_valid[:, None], kf.mp_idx, -1),
        feat_valid=kf.feat_valid & kf_valid[:, None],
    )
    mp_valid = mp.valid & (ms.mp_observation_counts(kf2, mp.valid.shape[0]) > 0)
    return (_drop_dead_observations(kf2, ~mp_valid), mp._replace(valid=mp_valid),
            torch.sum(drop_kf))


def map_trimming(m: ms.MapState, config: Config) -> int:
    """Keep only the newest local_map_size (+ buffer grace) keyframes."""
    ids = np.sort(m.kf.kf_id.cpu().numpy()[m.kf.valid.cpu().numpy()])
    limit = config.mapping.local_map_size
    if len(ids) <= limit + config.mapping.local_map_buffer:
        return 0
    m.kf, m.mp, n = _trim_kernel(m.kf, m.mp, int(ids[-limit]))
    n = int(n)
    if n:
        m.sync_host_index()
    return n


def _redundancy_kernel(kf: ms.KFBlock, nm: int, n_levels: int = 8) -> torch.Tensor:
    """Per-KF fraction of redundant observations (reference
    KeyFrameCullingV3 src/Mapping.cpp:816-881): an observation of landmark
    L at octave o is redundant iff L has > 3 observations and >= 3 other
    ones at the same or a finer scale (octave' <= o + 1). A (landmark,
    octave) histogram and its cumulative sum, no per-observation loop."""
    obs_ok = kf.feat_valid & (kf.mp_idx >= 0) & kf.valid[:, None]
    lm = torch.where(obs_ok, kf.mp_idx, nm).long()     # row nm for invalid
    o = torch.clamp(kf.octave, 0, n_levels - 1).long()
    hist = torch.zeros((nm + 1) * n_levels, dtype=torch.int32, device=lm.device)
    hist = hist.index_add(0, (lm * n_levels + o).reshape(-1),
                          torch.ones(lm.numel(), dtype=torch.int32, device=lm.device))
    cum = torch.cumsum(hist.reshape(nm + 1, n_levels)[:nm], dim=1)
    lm0 = torch.clamp_min(kf.mp_idx, 0).long()
    others_finer = cum[lm0, torch.clamp(o + 1, 0, n_levels - 1)] - 1   # own <= o+1
    red = obs_ok & (cum[:, -1][lm0] > 3) & (others_finer >= 3)
    return red.sum(1).to(torch.float32) / torch.clamp_min(obs_ok.sum(1).to(torch.float32), 1.0)


def cull_redundant_keyframes(m: ms.MapState, config: Config, protect=None,
                             max_cull: int = 2) -> int:
    """Server-side redundancy culling (reference KeyFrameCullingV3): a KF
    whose observations are overwhelmingly redundant is deleted, the most
    redundant first, at most ``max_cull`` a call. The origin KFs, protected
    slots and their spanning tree stay: children adopt the culled KF's
    parent."""
    protect = protect or set()
    frac = _redundancy_kernel(m.kf, nm=m.nm, n_levels=config.extractor.n_levels).cpu().numpy()
    valid = m.kf.valid.cpu().numpy()
    kf_ids = m.kf.kf_id.cpu().numpy()
    parent = m.kf.parent.cpu().numpy()
    children = {}
    for s in np.flatnonzero(valid):
        if parent[s] >= 0:
            children.setdefault(int(parent[s]), []).append(int(s))
    cand = [int(s) for s in np.flatnonzero(valid)
            if frac[s] >= config.mapping.redundancy_thres and int(s) not in protect
            and kf_ids[s] > 1]
    cand.sort(key=lambda s: -frac[s])
    culled = 0
    for s in cand[:max_cull]:
        kf = m.kf
        par = kf.parent.clone()
        par[children.get(s, [])] = int(parent[s])
        m.kf = kf._replace(parent=par, valid=_set_row(kf.valid, s, False),
                           mp_idx=_set_row(kf.mp_idx, s, -1),
                           feat_valid=_set_row(kf.feat_valid, s, False))
        culled += 1
    if culled:
        m.sync_host_index()
    return culled


# ---------------------------------------------------------------------------
# Local BA over the clipped map
# ---------------------------------------------------------------------------

def observations_for_ba(kf: ms.KFBlock, config: Config):
    """The association table as ``BAObservations`` with per-octave
    weights."""
    cam, _, lm, uv, octv, ok = ms.gather_observations(kf)
    inv_s2 = torch.from_numpy(orb.inv_level_sigma2(config.extractor)).to(uv.device)
    return ba_core.BAObservations(
        cam_idx=cam, lm_idx=lm, uv=uv,
        inv_sigma2=inv_s2[torch.clamp(octv, 0, config.extractor.n_levels - 1).long()],
        valid=ok)


def run_local_ba(m: ms.MapState, config: Config, iterations: int = 15,
                 fix_oldest: int = 2) -> torch.Tensor:
    """Local bundle adjustment over the whole clipped client map (the clip
    is the reference's covis window: LocalBundleAdjustmentClient with
    MapTrimming makes them coincide). The ``fix_oldest`` oldest KFs are the
    fixed gauge. Outlier observations are dropped from the association
    table. Returns the final robust cost as a device tensor (nothing
    here waits for the device)."""
    kf, mp = m.kf, m.mp
    obs = observations_for_ba(kf, config)
    kf_ids = kf.kf_id.cpu().numpy()
    valid = kf.valid.cpu().numpy()
    order = np.argsort(np.where(valid, kf_ids, np.iinfo(np.int32).max))
    fixed = ~valid
    fixed[order[:min(fix_oldest, valid.sum())]] = True
    res = local_ba.bundle_adjust(
        kf.Tcw, mp.Xw, obs, torch.from_numpy(config.camera.K()).to(m.device),
        torch.from_numpy(fixed).to(m.device), fixed_lm=~mp.valid, iterations=iterations,
        outlier_pass_at=iterations // 3)
    inl = res.obs_inlier.reshape(kf.mp_idx.shape)
    m.kf = kf._replace(Tcw=res.Tcw, mp_idx=torch.where((kf.mp_idx >= 0) & ~inl, -1, kf.mp_idx))
    m.mp = mp._replace(Xw=res.Xw)
    return res.cost


# ---------------------------------------------------------------------------
# LocalMapper: the per-KF pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LocalMapper:
    """Client-side local mapping pipeline (reference RunClient)."""

    config: Config
    map: ms.MapState
    next_mp_id: int = 0
    next_kf_id: int = 0
    client_id: int = 0
    n_culled: int = 0
    n_created: int = 0
    last_kf_slot: int = -1

    def covis_neighbors(self, slot: int, k: int = N_TRIANG_NEIGHBORS):
        return covis_neighbors_of(self.map, slot, k=k)

    def process_keyframe(self, fr: Frame) -> int:
        """Insert a new KF from a tracked frame and run the mapping
        pipeline. Returns the KF slot."""
        m = self.map
        kf_id = self.next_kf_id
        self.next_kf_id += 1
        pred = self.last_kf_slot
        slot = insert_keyframe(m, fr, kf_id, self.client_id, parent_slot=pred, pred_slot=pred)
        self.last_kf_slot = slot
        # parent = strongest covis neighbour
        nbs = self.covis_neighbors(slot)
        if nbs:
            m.kf = m.kf._replace(parent=_set_row(m.kf.parent, slot, nbs[0]))
        self.n_culled += cull_map_points(m, kf_id)
        created, self.next_mp_id = create_new_map_points(
            m, slot, nbs, self.config, self.next_mp_id, self.client_id)
        self.n_created += created
        fuse_neighbors(m, [slot] + nbs, self.config)
        m.mp = ms.update_mp_descriptors_and_normals(
            m.kf, m.mp, orb.scale_factors(self.config.extractor))
        map_trimming(m, self.config)
        run_local_ba(m, self.config)
        return slot
