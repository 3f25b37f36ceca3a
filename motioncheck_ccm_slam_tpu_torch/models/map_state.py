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

Covisibility, descriptor/normal refresh and the structure checker belong
to the client-mapping slice and are not here yet.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import Config

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
