"""Client tracking: the frame-rate visual-odometry state machine.

Counterpart of ``motioncheck_ccm_slam_tpu/models/tracking.py``. The
numeric stage is the same two passes of one dense projection-match against
the whole clipped client map: pass 1 with a wide radius at two pose
candidates (motion model and last pose), pose-optimize, pass 2 with a tight
radius at the refined pose, pose-optimize again. Everything in
``_track_two_pass`` stays on the device; ``Tracker`` reads back only the
inlier count and the pose for its log.

Monocular initialization and relocalization need ``ops/ransac.py``, which
is not ported yet.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

from ..config import Config
from ..ops import geometry, lie, matching, orb
from ..solvers import pose_opt
from . import frame as frame_mod


class TrackState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


def _project_and_predict(Tcw, Xw, normal, min_dist, max_dist, mp_valid, K,
                         width, height, scale_factor, n_levels: int):
    """Frustum/scale/angle visibility + predicted octave for all landmarks
    (reference Frame::isInFrustum + MapPoint::PredictScale)."""
    R, t = Tcw[:3, :3], Tcw[:3, 3]
    pc = Xw @ R.T + t
    z = pc[:, 2]
    uv = geometry.project(pc[None], K)[0]
    Ow = -R.T @ t
    v = Xw - Ow
    dist = torch.linalg.norm(v, dim=-1)
    cos_view = torch.sum(v * normal, -1) / torch.clamp_min(dist, 1e-9)
    visible = (
        mp_valid
        & (z > 0.05)
        & geometry.in_image(uv, width, height)
        & (dist >= min_dist)
        & (dist <= max_dist)
        & (cos_view > 0.5)
    )
    ratio = torch.clamp_min(max_dist / torch.clamp_min(dist, 1e-9), 1e-9)
    octave = torch.ceil(torch.log(ratio) / torch.log(scale_factor)).to(torch.int64)
    return uv, torch.clamp(octave, 0, n_levels - 1), visible


def _track_two_pass(
    feats_xy, feats_desc, feats_octave, feats_angle, feats_valid,
    Tcw_pred, Tcw_last,
    mp_Xw, mp_desc, mp_normal, mp_min_dist, mp_max_dist, mp_valid,
    K, width, height, scale_factor_arr, inv_sigma2_arr,
    n_levels: int,
):
    """Two-pass projection tracking. Returns (Tcw, per-feature mp slot,
    n_inliers, visible mask, found mask)."""
    scale_factor = scale_factor_arr[1] / scale_factor_arr[0]
    F = feats_xy.shape[0]
    NM = mp_Xw.shape[0]
    dev = feats_xy.device
    inv_s2 = inv_sigma2_arr[torch.clamp(feats_octave, 0, n_levels - 1)]
    # the frame's descriptors are the same in every pass: one distance matrix
    dist = matching.hamming_matrix(mp_desc, feats_desc)
    slots = torch.arange(NM, dtype=torch.int64, device=dev)

    def match_pass(Tcw, base_radius, nn_ratio):
        uv_proj, oct_pred, visible = _project_and_predict(
            Tcw, mp_Xw, mp_normal, mp_min_dist, mp_max_dist, mp_valid,
            K, width, height, scale_factor, n_levels,
        )
        radius = base_radius * scale_factor_arr[oct_pred]
        m = matching.search_by_projection(
            mp_desc, uv_proj, oct_pred, visible,
            feats_desc, feats_xy, feats_octave, feats_valid,
            radius, max_dist=matching.TH_HIGH, nn_ratio=nn_ratio, dist=dist,
        )
        return m, visible

    def feature_slots(m):
        """Per-feature landmark slot (or -1) from per-landmark matches;
        unmatched landmarks scatter into a dropped extra slot F."""
        feat_mp = torch.full((F + 1,), -1, dtype=torch.int64, device=dev)
        feat_mp[torch.where(m.ok, m.idx, F)] = torch.where(m.ok, slots, -1)
        return feat_mp[:F]

    def pass1(Tcw0):
        """Wide-radius match at a pose candidate + quick pose opt."""
        feat_mp = feature_slots(match_pass(Tcw0, 15.0, 0.9)[0])
        has = feat_mp >= 0
        return pose_opt.optimize_pose(
            Tcw0, mp_Xw[torch.clamp_min(feat_mp, 0)], feats_xy, inv_s2,
            has & feats_valid, K, n_rounds=2, iters_per_round=8,
        )

    # pass 1 evaluates both pose candidates — the constant-velocity
    # prediction and the last frame's pose — and keeps the one with more
    # inliers (the reference's TrackReferenceKeyFrame fallback plays this
    # role, src/Tracking.cpp:516-567)
    resA = pass1(Tcw_pred)
    resB = pass1(Tcw_last)
    use_a = resA.n_inliers >= resB.n_inliers
    Tcw1 = torch.where(use_a, resA.Tcw, resB.Tcw)
    # pass 2: tight radius at refined pose, full map again
    m2, vis2 = match_pass(Tcw1, 4.0, 1.0)
    feat_mp2 = feature_slots(m2)
    has2 = feat_mp2 >= 0
    res2 = pose_opt.optimize_pose(
        Tcw1, mp_Xw[torch.clamp_min(feat_mp2, 0)], feats_xy, inv_s2,
        has2 & feats_valid, K, n_rounds=2, iters_per_round=10,
    )
    final_assoc = torch.where(res2.inliers, feat_mp2, -1)
    # per-landmark stats for culling (reference IncreaseVisible/IncreaseFound)
    found = torch.zeros((NM + 1,), dtype=torch.bool, device=dev)
    found[torch.where(res2.inliers, feat_mp2, NM)] = True
    return res2.Tcw, final_assoc, res2.n_inliers, vis2, found[:NM]


@dataclasses.dataclass
class Tracker:
    """Per-agent tracking front-end. Owns no map: ``map`` is the client map
    state, of which the tracker reads and updates only ``map.mp`` (an
    ``MPBlock``)."""

    config: Config
    map: object
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cuda"))
    state: TrackState = TrackState.NO_IMAGES_YET
    velocity: Optional[torch.Tensor] = None      # Tcl: last->current
    last_frame: Optional[frame_mod.Frame] = None
    init_ref_frame: Optional[frame_mod.Frame] = None
    frames_since_kf: int = 0
    last_kf_tracked: int = 0                      # inliers of last KF creation
    max_tracked_since_kf: int = 0                 # running max since last KF
    n_frames: int = 0
    # trajectory log: (timestamp, Tcw (4,4) np) per frame for CSV export
    trajectory: list = dataclasses.field(default_factory=list)
    trajectory_ok: list = dataclasses.field(default_factory=list)

    def _camera_arrays(self):
        cam, ex = self.config.camera, self.config.extractor
        K = torch.from_numpy(cam.K()).to(self.device)
        sf = torch.from_numpy(orb.scale_factors(ex)).to(self.device)
        inv_s2 = torch.from_numpy(orb.inv_level_sigma2(ex)).to(self.device)
        return K, sf, inv_s2

    def process(self, img, timestamp: float) -> frame_mod.Frame:
        """Main per-frame entry (reference GrabImageMonocular + Track)."""
        fr = frame_mod.make_frame(self.config, self.n_frames, timestamp, img,
                                  self.device)
        self.n_frames += 1
        if self.state == TrackState.NO_IMAGES_YET:
            self.state = TrackState.NOT_INITIALIZED
            self.init_ref_frame = fr
        elif self.state == TrackState.NOT_INITIALIZED:
            self._try_initialize(fr)
        elif self.state == TrackState.OK:
            self._track(fr)
        elif self.state == TrackState.LOST and self.config.tracking.relocalize:
            self._relocalize(fr)
        self.last_frame = fr
        self.trajectory.append((timestamp, fr.Tcw.cpu().numpy()))
        self.trajectory_ok.append(self.state == TrackState.OK)
        return fr

    def _try_initialize(self, fr: frame_mod.Frame):
        raise NotImplementedError(
            "two-view initialization needs ops/ransac.py: ROADMAP queue 1 item 9")

    def _track(self, fr: frame_mod.Frame):
        cfg = self.config
        K, sf, inv_s2 = self._camera_arrays()
        Tcw_last = self.last_frame.Tcw if self.last_frame is not None else fr.Tcw
        if self.velocity is not None and self.last_frame is not None:
            Tcw_pred = self.velocity @ self.last_frame.Tcw
        else:
            Tcw_pred = Tcw_last
        mp = self.map.mp
        Tcw, assoc, n_inl, vis_mask, found_mask = _track_two_pass(
            fr.feats.xy, fr.feats.desc, fr.feats.octave, fr.feats.angle,
            fr.feats.valid,
            Tcw_pred, Tcw_last,
            mp.Xw, mp.desc, mp.normal, mp.min_dist, mp.max_dist, mp.valid,
            K, cfg.camera.width, cfg.camera.height, sf, inv_s2,
            cfg.extractor.n_levels,
        )
        n_inliers = int(n_inl)
        fr.Tcw = Tcw
        fr.mp_idx = assoc
        fr.n_tracked = n_inliers
        # landmark visibility/found statistics feed MapPoint culling
        self.map.mp = mp._replace(
            n_visible=mp.n_visible + vis_mask.to(torch.int32),
            n_found=mp.n_found + found_mask.to(torch.int32),
        )
        if n_inliers < cfg.tracking.matches_inliers_thres:
            self.state = TrackState.LOST
            self.velocity = None
            return
        # motion model update
        if self.last_frame is not None:
            self.velocity = Tcw @ lie.inv_T(self.last_frame.Tcw)
        self.frames_since_kf += 1
        self.max_tracked_since_kf = max(self.max_tracked_since_kf, n_inliers)

    def _relocalize(self, fr: frame_mod.Frame) -> bool:
        raise NotImplementedError(
            "relocalization needs ops/ransac.py: ROADMAP queue 1 item 9")

    def need_new_keyframe(self, fr: frame_mod.Frame) -> bool:
        """KF decision (reference NeedNewKeyFrame :730, simplified to its
        active conditions: enough frames elapsed or tracking weakening vs the
        best tracking since the last KF, with a minimum quality bar)."""
        if self.state != TrackState.OK:
            return False
        cfg = self.config.tracking
        if fr.n_tracked < cfg.matches_inliers_thres:
            return False
        bar = max(self.max_tracked_since_kf, self.last_kf_tracked, 1)
        weak = fr.n_tracked < cfg.ref_ratio * bar
        stale = self.frames_since_kf >= cfg.max_frames
        return weak or stale

    def notify_kf_created(self, n_tracked: int):
        self.frames_since_kf = 0
        self.last_kf_tracked = n_tracked
        self.max_tracked_since_kf = n_tracked

    def reset(self):
        """Tracking reset (reference Tracking::Reset via ClientHandler)."""
        self.state = TrackState.NO_IMAGES_YET
        self.velocity = None
        self.last_frame = None
        self.init_ref_frame = None
        self.frames_since_kf = 0
