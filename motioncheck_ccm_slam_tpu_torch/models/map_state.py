"""Device-resident SoA map state.

Counterpart of ``motioncheck_ccm_slam_tpu/models/map_state.py``: the map is
a pair of fixed-capacity structure-of-arrays blocks with validity masks
(keyframes and landmarks), wrapped by a small host-side allocator
(``MapState``). Descriptors are int32 words holding the uint32 bits of the
JAX package's (see ops/orb.py).

Every write to a block makes new tensors (``NamedTuple._replace`` with the
result of ``torch.where`` or of ``index_put`` on a clone), so a reference
to an older block, such as the GBA job's pre-GBA snapshot, never sees a
later write.

Derived structures the reference maintains incrementally (covisibility
weights, observation lists, per-landmark observation counts) are recomputed
on the device when needed from the (NK, F) association table.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..ops import matching

INVALID = -1


class KFBlock(NamedTuple):
    """Keyframe SoA, capacity NK, F features per KF."""

    kf_id: torch.Tensor        # (NK,) i32 client-local id
    client_id: torch.Tensor    # (NK,) i32 owning agent
    unique_id: torch.Tensor    # (NK,) i32 server-global uid (0 = unset)
    timestamp: torch.Tensor    # (NK,) f32 seconds
    Tcw: torch.Tensor          # (NK, 4, 4) world->camera
    xy: torch.Tensor           # (NK, F, 2) undistorted keypoints (level-0 px)
    angle: torch.Tensor        # (NK, F) f32
    octave: torch.Tensor       # (NK, F) i32
    desc: torch.Tensor         # (NK, F, 8) i32 descriptor bits
    feat_valid: torch.Tensor   # (NK, F) bool
    mp_idx: torch.Tensor       # (NK, F) i32 landmark slot or -1 (observations)
    parent: torch.Tensor       # (NK,) i32 spanning-tree parent slot or -1
    pred: torch.Tensor         # (NK,) i32 temporal predecessor slot or -1
    valid: torch.Tensor        # (NK,) bool
    loop_edge: torch.Tensor    # (NK,) i32 loop-closure partner slot or -1
    # Motion Check snapshots (reference KeyFrame.h:187-216)
    Tcw_pre_gba: torch.Tensor  # (NK, 4, 4) pose snapshot before GBA
    tracking_tws: torch.Tensor  # (NK, 3) pre-GBA body-frame position


class MPBlock(NamedTuple):
    """Landmark SoA, capacity NM."""

    mp_id: torch.Tensor        # (NM,) i32
    client_id: torch.Tensor    # (NM,) i32
    unique_id: torch.Tensor    # (NM,) i32
    Xw: torch.Tensor           # (NM, 3) world position
    desc: torch.Tensor         # (NM, 8) i32 distinctive descriptor
    normal: torch.Tensor       # (NM, 3) mean viewing direction
    min_dist: torch.Tensor     # (NM,) scale-invariance range
    max_dist: torch.Tensor     # (NM,)
    ref_kf: torch.Tensor       # (NM,) i32 reference keyframe slot
    first_kf_id: torch.Tensor  # (NM,) i32 kf_id at creation (culling rules)
    n_visible: torch.Tensor    # (NM,) i32 — frames it was in frustum
    n_found: torch.Tensor      # (NM,) i32 — frames it was matched
    valid: torch.Tensor        # (NM,) bool


def _full(device):
    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)
    return full


def _eyes(n: int, device) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=device).repeat(n, 1, 1)


def empty_kf_block(nk: int, f: int, device: torch.device | str = "cuda") -> KFBlock:
    full = _full(device)
    i32, f32 = torch.int32, torch.float32
    return KFBlock(
        kf_id=full((nk,), INVALID, i32),
        client_id=full((nk,), INVALID, i32),
        unique_id=full((nk,), 0, i32),
        timestamp=full((nk,), 0.0, f32),
        Tcw=_eyes(nk, device),
        xy=full((nk, f, 2), 0.0, f32),
        angle=full((nk, f), 0.0, f32),
        octave=full((nk, f), 0, i32),
        desc=full((nk, f, 8), 0, i32),
        feat_valid=full((nk, f), False, torch.bool),
        mp_idx=full((nk, f), INVALID, i32),
        parent=full((nk,), INVALID, i32),
        pred=full((nk,), INVALID, i32),
        valid=full((nk,), False, torch.bool),
        loop_edge=full((nk,), INVALID, i32),
        Tcw_pre_gba=_eyes(nk, device),
        tracking_tws=full((nk, 3), 0.0, f32),
    )


def empty_mp_block(nm: int, device: torch.device | str = "cuda") -> MPBlock:
    full = _full(device)
    i32, f32 = torch.int32, torch.float32
    return MPBlock(
        mp_id=full((nm,), INVALID, i32),
        client_id=full((nm,), INVALID, i32),
        unique_id=full((nm,), 0, i32),
        Xw=full((nm, 3), 0.0, f32),
        desc=full((nm, 8), 0, i32),
        normal=full((nm, 3), 0.0, f32),
        min_dist=full((nm,), 0.0, f32),
        max_dist=full((nm,), 1e9, f32),
        ref_kf=full((nm,), INVALID, i32),
        first_kf_id=full((nm,), INVALID, i32),
        n_visible=full((nm,), 1, i32),
        n_found=full((nm,), 1, i32),
        valid=full((nm,), False, torch.bool),
    )


# ---------------------------------------------------------------------------
# Device kernels over blocks
# ---------------------------------------------------------------------------

def _observed(kf: KFBlock) -> torch.Tensor:
    """(NK, F) bool: the feature is live and associated with a landmark."""
    return kf.feat_valid & (kf.mp_idx >= 0) & kf.valid[:, None]


def observation_membership(kf: KFBlock, nm: int) -> torch.Tensor:
    """(NK, NM) bool: does KF k observe landmark m (via the mp_idx table)."""
    nk = kf.mp_idx.shape[0]
    safe_idx = torch.where(_observed(kf), kf.mp_idx.long(), nm)  # park in slot nm
    memb = torch.zeros((nk, nm + 1), dtype=torch.bool, device=kf.mp_idx.device)
    return memb.scatter(1, safe_idx, True)[:, :nm]


def covisibility(kf: KFBlock, nm: int) -> torch.Tensor:
    """(NK, NK) f32 covisibility weights = # shared landmarks (reference
    KeyFrame::UpdateConnections), one matmul over the membership."""
    memb = observation_membership(kf, nm).to(torch.float32)
    W = memb @ memb.T
    return W - torch.diag(torch.diagonal(W))


def covisibility_row(kf: KFBlock, nm: int, slot: int) -> torch.Tensor:
    """(NK,) f32 covisibility weights of one keyframe: for each keyframe,
    its observations (features, so a landmark held twice counts twice) of
    landmarks that ``slot`` observes; 0 at ``slot``."""
    obs_ok = kf.feat_valid[slot] & (kf.mp_idx[slot] >= 0) & kf.valid[slot]
    memb_row = torch.zeros((nm + 1,), dtype=torch.bool, device=kf.mp_idx.device)
    memb_row = memb_row.index_fill(0, torch.where(obs_ok, kf.mp_idx[slot].long(), nm), True)
    row = (_observed(kf) & memb_row[torch.clamp_min(kf.mp_idx, 0).long()]).sum(1)
    row = row.to(torch.float32)
    row[slot] = 0.0
    return row


def covisibility_rows(kf: KFBlock, nm: int, slots) -> torch.Tensor:
    """(S, NK) f32 covisibility rows of a batch of keyframes, one membership
    matmul; 0 at each row's own slot."""
    slots = torch.as_tensor(slots, dtype=torch.int64, device=kf.mp_idx.device)
    memb = observation_membership(kf, nm).to(torch.float32)
    rows = memb[slots] @ memb.T
    return rows.index_put((torch.arange(slots.shape[0], device=slots.device), slots),
                          torch.zeros((), device=slots.device))


def mp_observation_counts(kf: KFBlock, nm: int) -> torch.Tensor:
    """(NM,) i32 number of keyframes observing each landmark. A keyframe
    that holds one landmark at two features counts once: the (KF, landmark)
    pairs are deduplicated before the bincount."""
    ok = _observed(kf)
    k = torch.arange(kf.mp_idx.shape[0], device=kf.mp_idx.device)[:, None].expand_as(ok)
    pairs = torch.unique(k[ok] * nm + kf.mp_idx[ok].long())
    return torch.bincount(pairs % nm, minlength=nm).to(torch.int32)


def gather_observations(kf: KFBlock):
    """Flatten the (NK, F) association table into BA observation arrays.

    Returns (cam_idx, feat_idx, lm_idx, uv, octave, valid), each (NO,) /
    (NO, 2) with NO = NK * F in camera-major order; index arrays are i64.
    Slots that observe nothing have lm_idx 0; callers mask by ``valid``.
    """
    nk, f = kf.mp_idx.shape
    dev = kf.mp_idx.device
    ok = _observed(kf)
    cam = torch.arange(nk, device=dev)[:, None].expand(nk, f)
    feat = torch.arange(f, device=dev)[None, :].expand(nk, f)
    return (
        cam.reshape(-1),
        feat.reshape(-1),
        torch.where(ok, kf.mp_idx, 0).long().reshape(-1),
        kf.xy.reshape(-1, 2),
        kf.octave.reshape(-1),
        ok.reshape(-1),
    )


def update_mp_descriptors_and_normals(kf: KFBlock, mp: MPBlock, scale_factors,
                                      max_obs: int = 16) -> MPBlock:
    """Recompute distinctive descriptors, normals and scale ranges of all
    landmarks from their observations (reference
    MapPoint::ComputeDistinctiveDescriptors + UpdateNormalAndDepth),
    batched over each landmark's first ``max_obs`` observations in
    keyframe-major order.

    The distinctive descriptor is the observation with the least mean
    Hamming distance to the others, less a bonus of 16 for observations
    from the newest observing keyframe (the first of equal scores wins).
    """
    nm = mp.Xw.shape[0]
    nk, f = kf.mp_idx.shape
    dev = kf.mp_idx.device
    flat_lm = torch.where(_observed(kf), kf.mp_idx.long(), nm).reshape(-1)
    # per-landmark observation lists: a stable sort keeps keyframe order
    sorted_lm, order = torch.sort(flat_lm, stable=True)
    rank = torch.arange(sorted_lm.shape[0], device=dev) - torch.searchsorted(
        sorted_lm, sorted_lm, side="left")
    slot_ok = (sorted_lm < nm) & (rank < max_obs)
    obs_table = torch.full((nm + 1, max_obs), -1, dtype=torch.int64, device=dev)
    obs_table = obs_table.index_put(
        (torch.where(slot_ok, sorted_lm, nm), torch.where(slot_ok, rank, 0)),
        torch.where(slot_ok, order, -1))[:nm]                          # (NM, max_obs)
    has_obs = obs_table >= 0
    obs_flat = torch.clamp_min(obs_table, 0)
    flat_cam = torch.arange(nk, device=dev).repeat_interleave(f)
    obs_cam = torch.where(has_obs, flat_cam[obs_flat], 0)
    obs_desc = kf.desc.reshape(-1, 8)[obs_flat]                       # (NM, max_obs, 8)

    dmat = matching.popcount_u32(obs_desc[:, :, None, :] ^ obs_desc[:, None, :, :]).sum(-1)
    pair_ok = has_obs[:, :, None] & has_obs[:, None, :]
    dsum = torch.where(pair_ok, dmat, 0).sum(-1)
    cnt = torch.clamp_min(pair_ok.sum(-1), 1)
    mean_d = torch.where(has_obs, dsum.to(torch.float32) / cnt.to(torch.float32),
                         torch.full_like(dsum, float("inf"), dtype=torch.float32))
    obs_kf_id = torch.where(has_obs, kf.kf_id[obs_cam], -1)
    newest = torch.amax(obs_kf_id, dim=-1, keepdim=True)
    recency_bonus = torch.where(obs_kf_id == newest, 16.0, 0.0)
    best = torch.argmin(mean_d - recency_bonus, -1)
    new_desc = torch.gather(obs_desc, 1, best[:, None, None].expand(nm, 1, 8))[:, 0]
    any_obs = has_obs.any(-1)
    desc = torch.where(any_obs[:, None], new_desc, mp.desc)

    # normal: mean of the unit vectors from the observing camera centres;
    # the scale range from the first observation's octave and distance
    centers = -torch.einsum("kji,kj->ki", kf.Tcw[:, :3, :3], kf.Tcw[:, :3, 3])
    v = mp.Xw[:, None, :] - centers[obs_cam]
    vn = v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), 1e-9)
    mean_vn = (torch.where(has_obs[..., None], vn, 0.0).sum(1)
               / torch.clamp_min(has_obs.sum(-1, keepdim=True), 1))
    normal = torch.where(any_obs[:, None], mean_vn, mp.normal)
    first_obs = obs_flat[:, 0]
    first_cam = torch.where(any_obs, flat_cam[first_obs], 0)
    first_oct = torch.where(any_obs, kf.octave.reshape(-1)[first_obs], 0)
    dist_ref = torch.linalg.norm(mp.Xw - centers[first_cam], dim=-1)
    sf = torch.as_tensor(scale_factors, dtype=torch.float32, device=dev)
    n_levels = sf.shape[0]
    max_d = dist_ref * sf[torch.clamp(first_oct, 0, n_levels - 1).long()]
    min_d = max_d / sf[n_levels - 1]
    return mp._replace(
        desc=desc,
        normal=normal,
        max_dist=torch.where(any_obs, max_d * 1.2, mp.max_dist),
        min_dist=torch.where(any_obs, min_d * 0.8, mp.min_dist),
        ref_kf=torch.where(any_obs, first_cam.to(torch.int32), mp.ref_kf),
    )


def check_structure(m: "MapState", repair: bool = False):
    """Map-invariant checker (reference Map::CheckStructure src/Map.cpp:5444,
    DEBUGGING2): associations out of range or to dead landmarks,
    self-parents, dead parents and predecessors, landmarks whose reference
    keyframe died. Returns a list of violation strings; with ``repair=True``
    the fixable ones are repaired in place, as the reference's auto-repair
    does."""
    problems = []
    kf_valid = m.kf.valid.cpu().numpy()
    mp_valid = m.mp.valid.cpu().numpy()
    mp_idx = m.kf.mp_idx.cpu().numpy()
    parent = m.kf.parent.cpu().numpy()
    pred = m.kf.pred.cpu().numpy()
    ref_kf = m.mp.ref_kf.cpu().numpy()

    assoc = mp_idx[kf_valid]
    bad_range = assoc >= m.nm
    bad_dead = (assoc >= 0) & (assoc < m.nm) & ~mp_valid[np.clip(assoc, 0, m.nm - 1)]
    if bad_range.any():
        problems.append(f"{bad_range.sum()} associations out of range")
    if bad_dead.any():
        problems.append(f"{bad_dead.sum()} associations to dead landmarks")
    live = np.flatnonzero(kf_valid)
    for s in live[parent[live] == live]:
        problems.append(f"KF slot {s} is its own parent")
    pl_ = parent[live]
    for s in live[(pl_ >= 0) & ~kf_valid[np.clip(pl_, 0, m.nk - 1)]]:
        problems.append(f"KF slot {s} parent {parent[s]} is dead")
    pr_ = pred[live]
    for s in live[(pr_ >= 0) & ~kf_valid[np.clip(pr_, 0, m.nk - 1)]]:
        problems.append(f"KF slot {s} pred {pred[s]} is dead")
    mlive = np.flatnonzero(mp_valid)
    rf = ref_kf[mlive]
    for s in mlive[(rf >= 0) & ~kf_valid[np.clip(rf, 0, m.nk - 1)]]:
        problems.append(f"MP slot {s} ref_kf {ref_kf[s]} is dead")

    if repair and problems:
        kf = m.kf
        dead_kf = ~kf.valid

        def drop_dead(link):
            return torch.where(dead_kf[torch.clamp_min(link, 0).long()] & (link >= 0), -1, link)

        dead_assoc = (kf.mp_idx >= 0) & ~m.mp.valid[torch.clamp_min(kf.mp_idx, 0).long()]
        m.kf = kf._replace(mp_idx=torch.where(dead_assoc, -1, kf.mp_idx),
                           parent=drop_dead(kf.parent), pred=drop_dead(kf.pred))
        # re-anchor landmarks whose reference KF died: first live observer
        memb = observation_membership(m.kf, m.nm).cpu().numpy()
        new_ref = ref_kf.copy()
        for s in np.flatnonzero(mp_valid):
            if new_ref[s] >= 0 and not kf_valid[new_ref[s]]:
                obs = np.flatnonzero(memb[:, s])
                new_ref[s] = obs[0] if len(obs) else -1
        m.mp = m.mp._replace(ref_kf=torch.from_numpy(new_ref).to(m.mp.ref_kf.device))
    return problems


# ---------------------------------------------------------------------------
# Host-side allocator / wrapper
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MapState:
    """Host wrapper owning the device blocks plus slot allocation.

    One instance per (role, map); after a server-side merge several agents
    share one instance (reference Map merge ctor src/Map.cpp:100).
    """

    kf: KFBlock
    mp: MPBlock
    config: Config
    next_kf_slot: int = 0
    next_mp_slot: int = 0
    # id -> slot lookup kept on the host
    kf_slot_by_id: dict = dataclasses.field(default_factory=dict)
    mp_slot_by_id: dict = dataclasses.field(default_factory=dict)
    # Motion Check latches (reference Map.h:304 request_GBA and the
    # CorrectKF_switch latch, src/Map.cpp:3784-3799): a gating-mode MC run
    # after a loop-closure GBA may disable future corrective action and/or
    # request a follow-up GBA.
    correct_kf_switch: bool = True
    request_gba: bool = False
    # Blocks grow by doubling when full (append-only: existing slot indices
    # stay valid). The reference's server map is unbounded (std::map); the
    # client's is bounded by MapTrimming, so client blocks rarely grow.
    n_kf_growths: int = 0
    n_mp_growths: int = 0

    @classmethod
    def create(cls, config: Config, server: bool = False,
               device: torch.device | str = "cuda") -> "MapState":
        cap = config.capacity
        nk = cap.server_max_kfs if server else cap.client_max_kfs
        nm = cap.server_max_mps if server else cap.client_max_mps
        f = config.extractor.max_features
        return cls(kf=empty_kf_block(nk, f, device), mp=empty_mp_block(nm, device),
                   config=config)

    # -- capacities ---------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.kf.valid.device

    @property
    def nk(self) -> int:
        return self.kf.valid.shape[0]

    @property
    def nm(self) -> int:
        return self.mp.valid.shape[0]

    @property
    def n_kfs(self) -> int:
        return len(self.kf_slot_by_id)

    @property
    def n_mps(self) -> int:
        return len(self.mp_slot_by_id)

    # -- capacity growth ------------------------------------------------
    def _grow_kf_block(self):
        extra = empty_kf_block(self.nk, self.kf.xy.shape[1], self.device)
        self.kf = KFBlock(*[torch.cat([a, b], 0) for a, b in zip(self.kf, extra)])
        self.n_kf_growths += 1

    def _grow_mp_block(self):
        extra = empty_mp_block(self.nm, self.device)
        self.mp = MPBlock(*[torch.cat([a, b], 0) for a, b in zip(self.mp, extra)])
        self.n_mp_growths += 1

    # -- slot management ----------------------------------------------------
    def alloc_kf_slot(self, kf_id: int, client_id: int) -> int:
        """Next free KF slot (round-robin over invalid slots); grows the
        block when full."""
        valid = self.kf.valid.cpu().numpy()
        for probe in range(self.nk):
            s = (self.next_kf_slot + probe) % self.nk
            if not valid[s]:
                self.next_kf_slot = (s + 1) % self.nk
                self.kf_slot_by_id[(kf_id, client_id)] = s
                return s
        s = self.nk
        self._grow_kf_block()
        self.next_kf_slot = s + 1
        self.kf_slot_by_id[(kf_id, client_id)] = s
        return s

    def alloc_mp_slots(self, n: int, ids) -> np.ndarray:
        free = np.flatnonzero(~self.mp.valid.cpu().numpy())
        while len(free) < n:
            old_nm = self.nm
            self._grow_mp_block()
            free = np.concatenate([free, np.arange(old_nm, self.nm)])
        slots = free[:n]
        for s, pid in zip(slots, ids):
            self.mp_slot_by_id[pid] = int(s)
        return slots

    def drop_kf_id(self, kf_id: int, client_id: int):
        self.kf_slot_by_id.pop((kf_id, client_id), None)

    def drop_mp_id(self, pid):
        self.mp_slot_by_id.pop(pid, None)

    def sync_host_index(self):
        """Rebuild the host id->slot dicts from device state (after batched
        device-side deletions like culling, trimming or Motion Check)."""
        kf_valid = self.kf.valid.cpu().numpy()
        kf_ids = self.kf.kf_id.cpu().numpy()
        kf_cids = self.kf.client_id.cpu().numpy()
        self.kf_slot_by_id = {
            (int(kf_ids[s]), int(kf_cids[s])): s for s in np.flatnonzero(kf_valid)
        }
        mp_valid = self.mp.valid.cpu().numpy()
        mp_ids = self.mp.mp_id.cpu().numpy()
        mp_cids = self.mp.client_id.cpu().numpy()
        self.mp_slot_by_id = {
            (int(mp_ids[s]), int(mp_cids[s])): s for s in np.flatnonzero(mp_valid)
        }
