"""Client system: tracking + local mapping for one agent.

Counterpart of ``motioncheck_ccm_slam_tpu/system/client.py`` (the
reference's ``ClientSystem`` + ``ClientHandler`` client role,
src/client/ClientSystem.cpp, src/ClientHandler.cpp:157-188): a synchronous
per-frame pipeline, tracking every frame and mapping on keyframe creation,
in place of four threads synchronized with spin-locks, with the
communicator (``parallel/comm.ClientComm``, attached by the runner)
draining its outbox between frames. The map lives on ``device`` (the card
unless the caller asks for the CPU).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..models import map_state as ms
from ..models import mapping as mapping_mod
from ..models import tracking as tracking_mod
from ..models.frame import Frame
from ..ops import lie, orb
from ..solvers import local_ba
from ..utils import csv_io, watchdog as watchdog_mod


@dataclasses.dataclass
class ClientSystem:
    config: Config
    map: ms.MapState = None
    tracker: tracking_mod.Tracker = None
    mapper: mapping_mod.LocalMapper = None
    comm: object = None      # optional ClientComm, set by the runner
    # liveness watchdog (reference estd::mylog; tracking/mapping/comm beats)
    watchdog: watchdog_mod.Watchdog = dataclasses.field(
        default_factory=lambda: watchdog_mod.Watchdog(timeout_s=30.0))
    device: torch.device | str = "cuda"

    def __post_init__(self):
        if self.map is None:
            self.map = ms.MapState.create(self.config, server=False, device=self.device)
        if self.tracker is None:
            self.tracker = tracking_mod.Tracker(config=self.config, map=self.map,
                                                device=torch.device(self.device))
        if self.mapper is None:
            self.mapper = mapping_mod.LocalMapper(config=self.config, map=self.map,
                                                  client_id=self.config.sys.client_id)

    @property
    def client_id(self) -> int:
        return self.config.sys.client_id

    def process_image(self, img, timestamp: float) -> Frame:
        fr = self.tracker.process(img, timestamp)
        if (self.tracker.state == tracking_mod.TrackState.LOST
                and self.map.n_kfs <= self.config.tracking.init_kfs):
            # lost soon after init: full reset (reference Tracking::Track
            # src/Tracking.cpp:249-259 via ClientHandler::Reset)
            self._reset_map()
            return fr
        self.watchdog.beat("tracking", self.tracker.state.name)
        self.watchdog.beat("mapping", f"{self.map.n_kfs} kfs")
        if self.tracker.init_result is not None:
            self._create_initial_map()
        elif (self.tracker.state == tracking_mod.TrackState.OK
              and self.tracker.need_new_keyframe(fr)):
            slot = self.mapper.process_keyframe(fr)
            self.tracker.notify_kf_created(fr.n_tracked)
            self.watchdog.beat("mapping", f"kf slot {slot}")
            if self.comm is not None:
                self.comm.on_new_keyframe(self.map, slot)
        if self.comm is not None:
            self.comm.tick(self.map)
            self.watchdog.beat("comm", f"pub {self.comm.n_published}")
        return fr

    # ------------------------------------------------------------------
    def _create_initial_map(self):
        """Build the 2-KF bootstrap map (reference
        Tracking::CreateInitialMapMonocular src/Tracking.cpp:362): both
        keyframes and the triangulated landmarks, a 20-iteration full BA
        with the first KF fixed, and the map scaled to a median scene depth
        of 1 (:418-443). The median is numpy's, in float32, on the host."""
        cfg = self.config
        res = self.tracker.init_result
        self.tracker.init_result = None
        ref: Frame = res["ref_frame"]
        cur: Frame = res["cur_frame"]
        m = self.map
        mapper = self.mapper
        dev = m.device

        feat1_np = np.flatnonzero(res["good"].cpu().numpy())
        n_new = len(feat1_np)
        ids = [(mapper.next_mp_id + i, self.client_id) for i in range(n_new)]
        slots = torch.from_numpy(m.alloc_mp_slots(n_new, ids)).to(dev)
        mapper.next_mp_id += n_new
        feat1 = torch.from_numpy(feat1_np).to(dev)
        feat2 = res["match_idx"][feat1]

        # keyframes: ref at the identity, cur at the bootstrap pose
        kf0_id = mapper.next_kf_id
        kf1_id = kf0_id + 1
        mapper.next_kf_id += 2
        n_feat = cfg.extractor.max_features
        assoc0 = torch.full((n_feat,), -1, dtype=torch.int64, device=dev)
        assoc1 = torch.full((n_feat,), -1, dtype=torch.int64, device=dev)
        assoc0[feat1] = slots
        assoc1[feat2] = slots
        ref.Tcw = torch.eye(4, dtype=torch.float32, device=dev)
        ref.mp_idx = assoc0
        cur.mp_idx = assoc1
        slot0 = mapping_mod.insert_keyframe(m, ref, kf0_id, self.client_id)
        slot1 = mapping_mod.insert_keyframe(m, cur, kf1_id, self.client_id,
                                            parent_slot=slot0, pred_slot=slot0)
        mapper.last_kf_slot = slot1
        m.mp = mapping_mod._write_new_mps(
            m.mp, slots, res["pts3d"][feat1], ref.feats.desc[feat1],
            torch.arange(ids[0][0], ids[0][0] + n_new, dtype=torch.int32, device=dev),
            self.client_id, kf0_id, slot0)

        # full BA, 20 iterations, first KF fixed (reference
        # GlobalBundleAdjustemntClient at Tracking.cpp:415)
        fixed = ~m.kf.valid.cpu().numpy()
        fixed[slot0] = True
        ba = local_ba.bundle_adjust(
            m.kf.Tcw, m.mp.Xw, mapping_mod.observations_for_ba(m.kf, cfg),
            torch.from_numpy(cfg.camera.K()).to(dev), torch.from_numpy(fixed).to(dev),
            fixed_lm=~m.mp.valid, iterations=20)
        m.kf = m.kf._replace(Tcw=ba.Tcw)
        m.mp = m.mp._replace(Xw=ba.Xw)

        # median-depth scale normalization
        depths = lie.transform_points(m.kf.Tcw[slot0], m.mp.Xw[None])[0][:, 2].cpu().numpy()
        med = float(np.median(depths[m.mp.valid.cpu().numpy()]))
        if med <= 0 or not np.isfinite(med):
            # degenerate bootstrap: wipe and retry later
            self._reset_map()
            return
        inv_med = 1.0 / med
        Tcw = m.kf.Tcw.clone()
        Tcw[slot1, :3, 3] *= inv_med
        m.kf = m.kf._replace(Tcw=Tcw)
        m.mp = m.mp._replace(Xw=m.mp.Xw * inv_med)

        m.mp = ms.update_mp_descriptors_and_normals(m.kf, m.mp, orb.scale_factors(cfg.extractor))
        # tracker state
        cur.Tcw = m.kf.Tcw[slot1]
        self.tracker.last_frame = cur
        self.tracker.notify_kf_created(n_new)
        self.tracker.velocity = None
        # the bootstrap frame was logged before the BA and the scale
        # normalization: log it again at map scale
        if self.tracker.trajectory:
            t_last, _ = self.tracker.trajectory[-1]
            self.tracker.trajectory[-1] = (t_last, cur.Tcw.cpu().numpy())
        if self.comm is not None:
            self.comm.on_new_keyframe(m, slot0)
            self.comm.on_new_keyframe(m, slot1)

    def _reset_map(self):
        self.map = ms.MapState.create(self.config, server=False, device=self.device)
        self.tracker.map = self.map
        self.mapper.map = self.map
        self.tracker.reset()

    # ------------------------------------------------------------------
    def trajectory_tum(self) -> str:
        """TUM-format trajectory of all tracked frames (reference
        Map::WriteStateToCsv trajectory_format=1)."""
        return csv_io.trajectory_tum(self.tracker.trajectory, self.config)
