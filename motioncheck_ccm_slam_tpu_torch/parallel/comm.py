"""Agent <-> server communication backend, in process.

Counterpart of ``motioncheck_ccm_slam_tpu/parallel/comm.py``, which
replaces the reference's ROS pub/sub Communicator + wire schema
(src/Communicator.cpp, cslam_msgs/msg/*.msg) with message dataclasses and
an in-memory duplex channel. Messages carry numpy arrays (descriptors as
(F, 8) uint32), exactly as the JAX package's, so a wire codec takes them
unchanged; the maps on either side live on the device.

Semantics preserved from the reference — these define its robustness to
loss/reordering/mid-merge frame changes:

- **relative pose encoding**: a keyframe's pose is shipped relative to its
  temporal predecessor (``mTcpred``, KeyFrame::ConvertToMessage
  src/KeyFrame.cpp:1420-1458), landmark positions relative to a reference
  keyframe; the receiver reconstructs world poses against ITS version of the
  reference, so messages survive map-frame changes from merges/GBA.
- **ack / weak-ack**: the receiver acks individual ids; a weak ack covers
  every id <= it (Communicator.h:198-205). Unacked entities are retransmitted
  as full messages; acked ones switch to reduced (pose-only) updates.
- **budgets**: per-cycle message caps (<=40 KFs + 2500 MPs client->server per
  publish; server processes <=400/12000 per cycle — conf/config.yaml:88-100).
- **FINALBA idle detection**: ~30 s of empty messages marks an agent
  finished (Communicator.cpp:465-496); the server triggers the final GBA when
  all agents are done.

Device reads are batched as in the JAX package: each tick snapshots the
map's per-slot scalars and poses once (one ``.cpu()`` a field), and the
shipped keyframes' per-feature payloads in one indexed fetch a field.
"""
from __future__ import annotations

import dataclasses
import queue
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..config import Config
from ..models import map_state as ms
from ..models import mapping as mapping_mod
from ..models.frame import Frame
from ..ops.orb import OrbFeatures

# "never published" sentinels for the vectorized movement tests: +inf
# always registers as moved
_NEVER44 = np.full((4, 4), np.inf, np.float32)
_NEVER3 = np.full((3,), np.inf, np.float32)


# ---------------------------------------------------------------------------
# Wire messages (numpy payloads; dataclasses are the schema)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KfMsg:
    """Full keyframe message (reference cslam_msgs/KF.msg)."""

    kf_id: int
    client_id: int
    timestamp: float
    Tcp: np.ndarray            # (4,4) pose relative to predecessor
    pred_id: int               # predecessor kf id (-1 for origin)
    parent_id: int
    xy: np.ndarray             # (F, 2) f32
    angle: np.ndarray          # (F,) f32
    octave: np.ndarray         # (F,) i32
    desc: np.ndarray           # (F, 8) u32
    feat_valid: np.ndarray     # (F,) bool
    mp_ids: np.ndarray         # (F,) i64 landmark id or -1 (same client)
    # fallback pose relative to the PARENT KF (reference KF.msg mTcpar,
    # src/KeyFrame.cpp:1420-1458): a predecessor trimmed client-side after
    # this KF was encoded would otherwise strand the KF in the server's
    # deferral queue forever
    Tcpar: Optional[np.ndarray] = None


@dataclasses.dataclass
class KfRedMsg:
    """Reduced keyframe update: pose only (reference KFred.msg)."""

    kf_id: int
    client_id: int
    Tcp: np.ndarray
    pred_id: int


@dataclasses.dataclass
class MpMsg:
    """Full landmark message (reference MP.msg)."""

    mp_id: int
    client_id: int
    pos_ref: np.ndarray        # (3,) position in reference-KF camera frame
    ref_kf_id: int
    desc: np.ndarray           # (8,) u32
    normal: np.ndarray         # (3,)
    min_dist: float
    max_dist: float


@dataclasses.dataclass
class MpRedMsg:
    mp_id: int
    client_id: int
    pos_ref: np.ndarray
    ref_kf_id: int


@dataclasses.dataclass
class MapMsg:
    """One publish cycle (reference Map.msg)."""

    sender_client_id: int
    keyframes: List[KfMsg] = dataclasses.field(default_factory=list)
    keyframes_red: List[KfRedMsg] = dataclasses.field(default_factory=list)
    map_points: List[MpMsg] = dataclasses.field(default_factory=list)
    map_points_red: List[MpRedMsg] = dataclasses.field(default_factory=list)
    acks_kf: List[int] = dataclasses.field(default_factory=list)
    acks_mp: List[int] = dataclasses.field(default_factory=list)
    weak_ack_kf: int = -1
    weak_ack_mp: int = -1
    closest_kf_id: int = -1
    # explicit end-of-stream marker (the reference's only signal is ~30 s
    # of empty messages, Communicator.cpp:465-496; agents also say goodbye)
    agent_done: bool = False

    @property
    def empty(self) -> bool:
        return not (self.keyframes or self.keyframes_red or self.map_points
                    or self.map_points_red)


class Channel:
    """Duplex in-memory channel (stand-in for the ROS topic pair)."""

    def __init__(self):
        self.to_server: "queue.Queue[MapMsg]" = queue.Queue()
        self.to_client: "queue.Queue[MapMsg]" = queue.Queue()

    def client_send(self, msg: MapMsg):
        self.to_server.put(msg)

    def server_send(self, msg: MapMsg):
        self.to_client.put(msg)

    def client_recv(self) -> Optional[MapMsg]:
        try:
            return self.to_client.get_nowait()
        except queue.Empty:
            return None

    def server_recv(self) -> Optional[MapMsg]:
        try:
            return self.to_server.get_nowait()
        except queue.Empty:
            return None

    def pending_to_server(self) -> bool:
        """Unconsumed agent data (drives INTERRUPTBA)."""
        return not self.to_server.empty()


def _tick_stats(count: int, total_s: float, max_s: float) -> Dict[str, float]:
    n = max(count, 1)
    return {"ticks": count, "tick_ms_mean": round(1e3 * total_s / n, 3),
            "tick_ms_max": round(1e3 * max_s, 3)}


# ---------------------------------------------------------------------------
# Client side
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ClientComm:
    """Client communicator (reference Communicator::RunClient +
    PublishMapClient)."""

    config: Config
    channel: Channel
    client_id: int = 0
    # send state
    pending_kfs: List[int] = dataclasses.field(default_factory=list)  # slots
    sent_unacked_kf: Set[int] = dataclasses.field(default_factory=set)  # ids
    acked_kf: Set[int] = dataclasses.field(default_factory=set)
    sent_unacked_mp: Set[int] = dataclasses.field(default_factory=set)
    acked_mp: Set[int] = dataclasses.field(default_factory=set)
    n_published: int = 0
    # last-published state: reduced updates are emitted only for entities
    # whose pose/position CHANGED since the last publish (the reference
    # queues an entity via KeyFrame::SendMe() when an optimization moves it)
    last_pub_kf_pose: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    last_pub_mp_pos: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    # highest kf id ever shipped (reference Map.msg mClosestKfId)
    _max_pub_kf_id: int = -1
    # per-tick wall time aggregates (reference output_commtime.txt,
    # src/Communicator.cpp:119-137)
    tick_count: int = 0
    tick_time_total_s: float = 0.0
    tick_time_max_s: float = 0.0

    def on_new_keyframe(self, m: ms.MapState, slot: int):
        self.pending_kfs.append(slot)

    def tick_stats(self) -> Dict[str, float]:
        return _tick_stats(self.tick_count, self.tick_time_total_s, self.tick_time_max_s)

    def tick(self, m: ms.MapState):
        """One comm cycle: drain server messages (acks), publish pending."""
        t0 = time.perf_counter()
        try:
            return self._tick(m)
        finally:
            dt = time.perf_counter() - t0
            self.tick_count += 1
            self.tick_time_total_s += dt
            self.tick_time_max_s = max(self.tick_time_max_s, dt)

    def _tick(self, m: ms.MapState):
        kf = m.kf
        kf_ids_np = kf.kf_id.cpu().numpy()
        kf_valid_np = kf.valid.cpu().numpy()
        pred_np = kf.pred.cpu().numpy()
        parent_np = kf.parent.cpu().numpy()
        ts_np = kf.timestamp.cpu().numpy()
        Tcw_np = kf.Tcw.cpu().numpy().copy()       # mutable working copy
        mp_id_np = m.mp.mp_id.cpu().numpy()
        mp_valid_np = m.mp.valid.cpu().numpy()
        Xw_np = m.mp.Xw.cpu().numpy()
        ref_kf_np = m.mp.ref_kf.cpu().numpy()
        normal_np = m.mp.normal.cpu().numpy()
        min_d_np = m.mp.min_dist.cpu().numpy()
        max_d_np = m.mp.max_dist.cpu().numpy()

        # process acks from server
        vic_slots: List[int] = []
        vic_poses: List[np.ndarray] = []
        while True:
            msg = self.channel.client_recv()
            if msg is None:
                break
            for i in msg.acks_kf:
                self.acked_kf.add(i)
                self.sent_unacked_kf.discard(i)
            for i in msg.acks_mp:
                self.acked_mp.add(i)
                self.sent_unacked_mp.discard(i)
            if msg.weak_ack_kf >= 0:
                for i in list(self.sent_unacked_kf):
                    if i <= msg.weak_ack_kf:
                        self.acked_kf.add(i)
                        self.sent_unacked_kf.discard(i)
            if msg.weak_ack_mp >= 0:
                for i in list(self.sent_unacked_mp):
                    if i <= msg.weak_ack_mp:
                        self.acked_mp.add(i)
                        self.sent_unacked_mp.discard(i)
            # server-corrected vicinity poses (reference ProcessKfInClient
            # :748), chained through the host working copy and written in
            # one scatter
            for r in msg.keyframes_red:
                if r.client_id != self.client_id:
                    continue
                slot = m.kf_slot_by_id.get((r.kf_id, self.client_id))
                if slot is None:
                    continue
                if r.pred_id >= 0:
                    pred_slot = m.kf_slot_by_id.get((r.pred_id, self.client_id))
                    if pred_slot is None:
                        continue
                    Tcw = r.Tcp @ Tcw_np[pred_slot]
                else:
                    Tcw = r.Tcp
                Tcw_np[slot] = Tcw.astype(np.float32)
                vic_slots.append(slot)
                vic_poses.append(Tcw_np[slot])
        if vic_slots:
            m.kf = m.kf._replace(Tcw=m.kf.Tcw.index_put(
                (torch.tensor(vic_slots, device=m.device),),
                torch.from_numpy(np.stack(vic_poses)).to(m.device)))

        out = MapMsg(sender_client_id=self.client_id)
        cfg = self.config.comm
        kf_budget = cfg.client_pub_max_kfs
        mp_budget = cfg.client_pub_max_mps

        # full KFs: pending + unacked retransmits
        slots_to_send: List[int] = []
        for slot in list(self.pending_kfs):
            if len(slots_to_send) >= kf_budget:
                break
            if kf_valid_np[slot]:
                slots_to_send.append(slot)
            self.pending_kfs.remove(slot)
        # retransmit unacked (reference: resend until ack'd)
        if len(slots_to_send) < kf_budget:
            for kf_id in sorted(self.sent_unacked_kf):
                if len(slots_to_send) >= kf_budget:
                    break
                slot = m.kf_slot_by_id.get((kf_id, self.client_id))
                if slot is not None and kf_valid_np[slot] and slot not in slots_to_send:
                    slots_to_send.append(slot)
        # one batched gather per per-feature field for ALL shipped KFs
        if slots_to_send:
            sl = torch.tensor(slots_to_send, device=m.device)
            xy_b = kf.xy[sl].cpu().numpy()
            angle_b = kf.angle[sl].cpu().numpy()
            octave_b = kf.octave[sl].cpu().numpy()
            desc_b = kf.desc[sl].cpu().numpy().view(np.uint32)
            fv_b = kf.feat_valid[sl].cpu().numpy()
            mpidx_b = kf.mp_idx[sl].cpu().numpy()
        mp_sent = 0
        mp_pending: List[Tuple[int, int]] = []   # (mslot, msg position)
        for i, slot in enumerate(slots_to_send):
            kf_id = int(kf_ids_np[slot])
            pred = int(pred_np[slot])
            if pred >= 0 and kf_valid_np[pred]:
                pred_id = int(kf_ids_np[pred])
                Tcp = Tcw_np[slot] @ np.linalg.inv(Tcw_np[pred])
            else:
                pred_id = -1
                Tcp = Tcw_np[slot]
            parent = int(parent_np[slot])
            parent_id = int(kf_ids_np[parent]) if parent >= 0 else -1
            Tcpar = (Tcw_np[slot] @ np.linalg.inv(Tcw_np[parent])
                     if parent >= 0 and kf_valid_np[parent] else None)
            mp_slots_row = mpidx_b[i]
            mp_ids = np.full(mp_slots_row.shape, -1, np.int64)
            have = mp_slots_row >= 0
            mp_ids[have] = mp_id_np[mp_slots_row[have]]
            out.keyframes.append(KfMsg(
                kf_id=kf_id, client_id=self.client_id, timestamp=float(ts_np[slot]),
                Tcp=Tcp, pred_id=pred_id, parent_id=parent_id,
                xy=xy_b[i], angle=angle_b[i], octave=octave_b[i],
                desc=desc_b[i], feat_valid=fv_b[i], mp_ids=mp_ids, Tcpar=Tcpar))
            self.sent_unacked_kf.add(kf_id)
            self._max_pub_kf_id = max(self._max_pub_kf_id, kf_id)
            self.last_pub_kf_pose[kf_id] = Tcw_np[slot].copy()
            # ship this KF's new landmarks (descriptors gathered in one
            # fetch after selection)
            for mslot in np.unique(mp_slots_row):
                if mslot < 0 or mp_sent >= mp_budget:
                    continue
                mp_id = int(mp_id_np[mslot])
                if mp_id in self.acked_mp or mp_id in self.sent_unacked_mp:
                    continue
                ref = int(ref_kf_np[mslot])
                if ref < 0 or not kf_valid_np[ref]:
                    continue
                Tcw_ref = Tcw_np[ref]
                X = Xw_np[mslot]
                out.map_points.append(MpMsg(
                    mp_id=mp_id, client_id=self.client_id,
                    pos_ref=Tcw_ref[:3, :3] @ X + Tcw_ref[:3, 3],
                    ref_kf_id=int(kf_ids_np[ref]), desc=None, normal=normal_np[mslot],
                    min_dist=float(min_d_np[mslot]), max_dist=float(max_d_np[mslot])))
                mp_pending.append((int(mslot), len(out.map_points) - 1))
                self.sent_unacked_mp.add(mp_id)
                self.last_pub_mp_pos[mp_id] = X.copy()
                mp_sent += 1
        if mp_pending:
            msl = torch.tensor([s for s, _ in mp_pending], device=m.device)
            desc_mb = m.mp.desc[msl].cpu().numpy().view(np.uint32)
            for j, (_, pos) in enumerate(mp_pending):
                out.map_points[pos].desc = desc_mb[j]
        # reduced pose updates for acked KFs whose pose CHANGED since the
        # last publish, budgeted like full messages (reference KFred.msg +
        # Comm.Client.KfItBound conf/config.yaml:89); the scan iterates
        # live slots with one vectorized movement test
        red_budget = max(0, cfg.client_kf_it_bound - len(out.keyframes))
        own_kf = np.flatnonzero(kf_valid_np & (m.kf.client_id.cpu().numpy() == self.client_id))
        if red_budget > 0 and len(own_kf):
            cand = [(int(kf_ids_np[s]), int(s)) for s in own_kf
                    if int(kf_ids_np[s]) in self.acked_kf]
            cand.sort(reverse=True)
            if cand:
                slots_c = np.asarray([s for _, s in cand])
                lasts = np.stack([self.last_pub_kf_pose.get(i, _NEVER44) for i, _ in cand])
                moved = ~np.all(np.abs(Tcw_np[slots_c] - lasts) <= 1e-6, axis=(1, 2))
                for (kf_id, slot), mv in zip(cand, moved):
                    if len(out.keyframes_red) >= red_budget:
                        break
                    if not mv:
                        continue
                    Tcw = Tcw_np[slot]
                    pred = int(pred_np[slot])
                    if pred >= 0 and kf_valid_np[pred]:
                        pred_id = int(kf_ids_np[pred])
                        Tcp = Tcw @ np.linalg.inv(Tcw_np[pred])
                    else:
                        pred_id = -1
                        Tcp = Tcw
                    out.keyframes_red.append(KfRedMsg(kf_id=kf_id, client_id=self.client_id,
                                                      Tcp=Tcp, pred_id=pred_id))
                    self.last_pub_kf_pose[kf_id] = Tcw.copy()
        # reduced position updates for acked landmarks that moved
        # (reference MPred.msg + MpItBound) — same bounded slot scan
        mp_red_budget = max(0, cfg.client_mp_it_bound - mp_sent)
        own_mp = np.flatnonzero(mp_valid_np & (m.mp.client_id.cpu().numpy() == self.client_id))
        if mp_red_budget > 0 and len(own_mp):
            cand = [(int(mp_id_np[s]), int(s)) for s in own_mp
                    if int(mp_id_np[s]) in self.acked_mp]
            cand.sort(reverse=True)
            if cand:
                slots_c = np.asarray([s for _, s in cand])
                lasts = np.stack([self.last_pub_mp_pos.get(i, _NEVER3) for i, _ in cand])
                moved = ~np.all(np.abs(Xw_np[slots_c] - lasts) <= 1e-6, axis=1)
                for (mp_id, mslot), mv in zip(cand, moved):
                    if len(out.map_points_red) >= mp_red_budget:
                        break
                    if not mv:
                        continue
                    X = Xw_np[mslot]
                    ref = int(ref_kf_np[mslot])
                    if ref < 0 or not kf_valid_np[ref]:
                        continue
                    Tcw_ref = Tcw_np[ref]
                    out.map_points_red.append(MpRedMsg(
                        mp_id=mp_id, client_id=self.client_id,
                        pos_ref=Tcw_ref[:3, :3] @ X + Tcw_ref[:3, 3],
                        ref_kf_id=int(kf_ids_np[ref])))
                    self.last_pub_mp_pos[mp_id] = X.copy()
        # bound the last-published dicts: ids trimmed out of the clipped
        # client map can never be re-published — drop their entries (and
        # their acked-set ids) once the dicts outgrow the live map 4x
        if len(self.last_pub_mp_pos) > 4 * max(len(own_mp), 16):
            live_ids = {int(mp_id_np[s]) for s in own_mp}
            self.last_pub_mp_pos = {i: v for i, v in self.last_pub_mp_pos.items()
                                    if i in live_ids}
            self.acked_mp &= (live_ids | self.sent_unacked_mp)
        if len(self.last_pub_kf_pose) > 4 * max(len(own_kf), 16):
            live_ids = {int(kf_ids_np[s]) for s in own_kf}
            self.last_pub_kf_pose = {i: v for i, v in self.last_pub_kf_pose.items()
                                     if i in live_ids}
            self.acked_kf &= (live_ids | self.sent_unacked_kf)
        # current reference KF: the server centers its vicinity window on it
        # (reference Map.msg mClosestKfId)
        if self._max_pub_kf_id >= 0:
            out.closest_kf_id = self._max_pub_kf_id
        self.channel.client_send(out)
        self.n_published += 1

    def send_goodbye(self):
        """Explicit end-of-stream: the server arms FINALBA for this agent
        immediately instead of waiting out the idle heuristic."""
        self.channel.client_send(MapMsg(sender_client_id=self.client_id, agent_done=True))


# ---------------------------------------------------------------------------
# Server side
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServerComm:
    """Server communicator for one agent (reference Communicator::RunServer +
    ProcessKfInServer/ProcessMpInServer)."""

    config: Config
    channel: Channel
    map: ms.MapState
    client_id: int = 0
    # entities whose reference wasn't resolvable yet (reference in/out
    # buffers + HandleMissingParent)
    deferred_kfs: List[KfMsg] = dataclasses.field(default_factory=list)
    deferred_mps: List[MpMsg] = dataclasses.field(default_factory=list)
    processed_kf_ids: Set[int] = dataclasses.field(default_factory=set)
    processed_mp_ids: Set[int] = dataclasses.field(default_factory=set)
    new_kf_slots: List[int] = dataclasses.field(default_factory=list)
    idle_cycles: int = 0
    got_data: bool = False
    # server-global uid source shared across handlers (reference
    # UniqueIdDispenser estd.h:83-108; uid 0 = unset)
    uid_dispenser: object = None
    # the client's current reference KF (reference Map.msg mClosestKfId):
    # centers the vicinity window the server ships back
    closest_kf_id: int = -1
    # the agent sent an explicit goodbye
    agent_said_done: bool = False
    # per-tick staging (batched device IO)
    _mp_new: List = dataclasses.field(default_factory=list)
    _mp_upd: List = dataclasses.field(default_factory=list)
    _tcw_snap: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 4, 4), np.float32))
    _tcw_overlay: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    _kf_valid_snap: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, bool))
    # client-world -> map-world Sim3 (reference mg2oS_wcurmap_wclientmap,
    # include/cslam/CentralControl.h:86): identity until this agent's map is
    # fused into another map by a scale-changing Sim3; after that every
    # client<->server pose/position crossing this channel is re-metrized by
    # its scale (reference KeyFrame::ConvertToMessageClient
    # src/KeyFrame.cpp:1351,1367)
    S_wm_wc: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4, dtype=np.float64))
    tick_count: int = 0
    tick_time_total_s: float = 0.0
    tick_time_max_s: float = 0.0

    def tick_stats(self) -> Dict[str, float]:
        return _tick_stats(self.tick_count, self.tick_time_total_s, self.tick_time_max_s)

    def compose_fusion_sim3(self, S_fusion: np.ndarray):
        """The map this agent streams into was transformed by ``S_fusion``
        (old-map world -> fused-map world) during a merge."""
        self.S_wm_wc = np.asarray(S_fusion, np.float64) @ self.S_wm_wc

    @property
    def map_scale(self) -> float:
        """Scale of the client-world -> map-world Sim3."""
        return float(np.cbrt(np.linalg.det(self.S_wm_wc[:3, :3])))

    def _pose_client_to_map(self, Tcw_c: np.ndarray) -> np.ndarray:
        """Absolute client pose -> map-frame SE3 in the map's metric:
        Tcw_map = re-metrize(Tcw_client . S_wm_wc^-1)."""
        s = self.map_scale
        S = self.S_wm_wc
        R = S[:3, :3] / s
        Rm = Tcw_c[:3, :3] @ R.T
        out = np.eye(4)
        out[:3, :3] = Rm
        out[:3, 3] = s * Tcw_c[:3, 3] - Rm @ S[:3, 3]
        return out

    def _pose_map_to_client(self, Tcw_m: np.ndarray) -> np.ndarray:
        """Inverse of :meth:`_pose_client_to_map`."""
        s = self.map_scale
        S = self.S_wm_wc
        R = S[:3, :3] / s
        out = np.eye(4)
        out[:3, :3] = Tcw_m[:3, :3] @ R
        out[:3, 3] = (Tcw_m[:3, 3] + Tcw_m[:3, :3] @ S[:3, 3]) / s
        return out

    def _rel_client_to_map(self, Tcp: np.ndarray) -> np.ndarray:
        """Relative SE3 (client metric) -> map metric: translations scale by
        s (frames conjugate the scaling away: L_s Tcp L_s^-1 = [R | s t])."""
        out = Tcp.copy().astype(np.float64)
        out[:3, 3] *= self.map_scale
        return out

    def _rel_map_to_client(self, Tcp: np.ndarray) -> np.ndarray:
        out = Tcp.copy().astype(np.float64)
        out[:3, 3] /= self.map_scale
        return out

    def _resolve_kf(self, kf_id: int) -> Optional[int]:
        return self.map.kf_slot_by_id.get((kf_id, self.client_id))

    # -- per-tick host snapshot (one device read per field) --------------
    def _snapshot(self):
        m = self.map
        self._tcw_snap = m.kf.Tcw.cpu().numpy()
        self._tcw_overlay = {}
        self._kf_valid_snap = m.kf.valid.cpu().numpy()

    def _tcw_host(self, slot: int) -> np.ndarray:
        """Pose of ``slot`` as this tick sees it: this-tick writes (inserts,
        reduced updates) overlay the start-of-tick snapshot."""
        p = self._tcw_overlay.get(slot)
        if p is not None:
            return p
        if slot < len(self._tcw_snap):
            return self._tcw_snap[slot]
        return self.map.kf.Tcw[slot].cpu().numpy()   # post-growth slot

    def _insert_kf(self, msg: KfMsg) -> bool:
        m = self.map
        if msg.pred_id >= 0:
            pred_slot = self._resolve_kf(msg.pred_id)
            if pred_slot is None:
                # mTcpar fallback (reference src/KeyFrame.cpp:1420-1458):
                # chain through the parent instead — a predecessor trimmed
                # client-side after this KF was encoded may never arrive
                par_slot = (self._resolve_kf(msg.parent_id)
                            if msg.parent_id >= 0 and msg.Tcpar is not None else None)
                if par_slot is None:
                    return False  # defer until a reference arrives
                Tcw = self._rel_client_to_map(msg.Tcpar) @ self._tcw_host(par_slot)
                pred = -1
            else:
                Tcw = self._rel_client_to_map(msg.Tcp) @ self._tcw_host(pred_slot)
                pred = pred_slot
        else:
            Tcw = self._pose_client_to_map(msg.Tcp)
            pred = -1
        parent = self._resolve_kf(msg.parent_id) if msg.parent_id >= 0 else None
        mp_idx = np.full(msg.mp_ids.shape, -1, np.int64)
        for f in np.flatnonzero(msg.mp_ids >= 0):
            mslot = m.mp_slot_by_id.get((int(msg.mp_ids[f]), self.client_id))
            if mslot is not None:
                mp_idx[f] = mslot
        dev = m.device

        def t(a, dtype):
            return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

        feats = OrbFeatures(
            xy=t(msg.xy, torch.float32),
            response=torch.zeros(msg.xy.shape[0], dtype=torch.float32, device=dev),
            angle=t(msg.angle, torch.float32), octave=t(msg.octave, torch.int64),
            desc=t(np.ascontiguousarray(msg.desc, np.uint32).view(np.int32), torch.int32),
            valid=t(msg.feat_valid, torch.bool))
        fr = Frame(frame_id=msg.kf_id, timestamp=msg.timestamp, feats=feats,
                   Tcw=t(Tcw.astype(np.float32), torch.float32), mp_idx=t(mp_idx, torch.int64))
        slot = mapping_mod.insert_keyframe(
            m, fr, msg.kf_id, self.client_id,
            parent_slot=parent if parent is not None else (pred if pred >= 0 else -1),
            pred_slot=pred if pred >= 0 else -1)
        if self.uid_dispenser is not None:
            uid = m.kf.unique_id.clone()
            uid[slot] = self.uid_dispenser.fetch()
            m.kf = m.kf._replace(unique_id=uid)
        self._tcw_overlay[slot] = Tcw.astype(np.float32)
        self.new_kf_slots.append(slot)
        return True

    def _insert_mp(self, msg: MpMsg) -> bool:
        """Stage one landmark insert/update; device writes are flushed in one
        batched scatter per tick (:meth:`_flush_mp_batch`)."""
        m = self.map
        ref_slot = self._resolve_kf(msg.ref_kf_id)
        if ref_slot is None:
            return False
        Twc_ref = np.linalg.inv(self._tcw_host(ref_slot))
        # pos_ref is in the reference-KF camera frame in CLIENT metric;
        # re-metrize before lifting through the map-frame reference pose
        pos_ref = msg.pos_ref * self.map_scale
        Xw = (Twc_ref[:3, :3] @ pos_ref + Twc_ref[:3, 3]).astype(np.float32)
        key = (msg.mp_id, self.client_id)
        slot = m.mp_slot_by_id.get(key)
        if slot is not None:
            self._mp_upd.append((slot, Xw))
            return True
        self._mp_new.append((key, msg, ref_slot, Xw))
        return True

    def _flush_mp_batch(self):
        """One batched scatter for every landmark staged this tick."""
        m = self.map
        dev = m.device
        if self._mp_new:
            keys = [k for k, _, _, _ in self._mp_new]
            sj = torch.from_numpy(np.asarray(m.alloc_mp_slots(len(self._mp_new), keys),
                                             np.int64)).to(dev)
            msgs = [msg for _, msg, _, _ in self._mp_new]
            mp = m.mp

            def put(field, values, dtype):
                col = getattr(mp, field)
                return col.index_put((sj,), torch.from_numpy(np.asarray(values)).to(
                    device=dev, dtype=dtype))

            desc = np.ascontiguousarray(np.stack([mm.desc for mm in msgs]), np.uint32)
            m.mp = mp._replace(
                mp_id=put("mp_id", [mm.mp_id for mm in msgs], torch.int32),
                client_id=mp.client_id.index_fill(0, sj, self.client_id),
                Xw=put("Xw", np.stack([x for _, _, _, x in self._mp_new]), torch.float32),
                desc=put("desc", desc.view(np.int32), torch.int32),
                normal=put("normal", np.stack([mm.normal for mm in msgs]), torch.float32),
                min_dist=put("min_dist", [mm.min_dist for mm in msgs], torch.float32),
                max_dist=put("max_dist", [mm.max_dist for mm in msgs], torch.float32),
                ref_kf=put("ref_kf", [r for _, _, r, _ in self._mp_new], torch.int32),
                first_kf_id=put("first_kf_id", [mm.ref_kf_id for mm in msgs], torch.int32),
                valid=mp.valid.index_fill(0, sj, True))
        if self._mp_upd:
            sj = torch.tensor([s for s, _ in self._mp_upd], device=dev)
            m.mp = m.mp._replace(Xw=m.mp.Xw.index_put(
                (sj,), torch.from_numpy(np.stack([x for _, x in self._mp_upd])).to(dev)))
        self._mp_new, self._mp_upd = [], []

    def _late_bind_mp_assocs(self, kf_msgs: List[KfMsg]):
        """Resolve landmark associations that arrived after their KF — one
        batched gather + one batched scatter for all bound KFs."""
        m = self.map
        pairs = []
        for kf_msg in kf_msgs:
            slot = self._resolve_kf(kf_msg.kf_id)
            if slot is not None:
                pairs.append((slot, kf_msg))
        if not pairs:
            return
        sj = torch.tensor([s for s, _ in pairs], device=m.device)
        rows = m.kf.mp_idx[sj].cpu().numpy().copy()
        changed = False
        for i, (slot, kf_msg) in enumerate(pairs):
            for f in np.flatnonzero(kf_msg.mp_ids >= 0):
                if rows[i, f] >= 0:
                    continue
                mslot = m.mp_slot_by_id.get((int(kf_msg.mp_ids[f]), self.client_id))
                if mslot is not None:
                    rows[i, f] = mslot
                    changed = True
        if changed:
            m.kf = m.kf._replace(mp_idx=m.kf.mp_idx.index_put((sj,), torch.from_numpy(rows).to(
                m.device)))

    def tick(self) -> MapMsg:
        """One server comm cycle: ingest messages, send acks back.

        Device IO is batched: one host snapshot of the pose/valid blocks at
        tick start, one scatter per staged batch (landmark inserts, landmark
        updates, reduced pose updates, late-bound associations) at the end."""
        t0 = time.perf_counter()
        try:
            return self._tick()
        finally:
            dt = time.perf_counter() - t0
            self.tick_count += 1
            self.tick_time_total_s += dt
            self.tick_time_max_s = max(self.tick_time_max_s, dt)

    def _tick(self) -> MapMsg:
        cfg = self.config.comm
        self._snapshot()
        self._mp_new, self._mp_upd = [], []
        self.new_kf_slots = []
        kf_processed: List[int] = []
        mp_processed: List[int] = []
        kf_count = 0
        mp_count = 0
        self.got_data = False
        incoming: List[MapMsg] = []
        while True:
            msg = self.channel.server_recv()
            if msg is None:
                break
            incoming.append(msg)
        if any(msg.agent_done for msg in incoming):
            self.agent_said_done = True
        if any(not msg.empty for msg in incoming):
            self.idle_cycles = 0
            self.got_data = True
        else:
            self.idle_cycles += 1
        # deferred retries first (references may have arrived)
        kf_msgs = self.deferred_kfs + [k for msg in incoming for k in msg.keyframes]
        mp_msgs = self.deferred_mps + [p for msg in incoming for p in msg.map_points]
        self.deferred_kfs, self.deferred_mps = [], []
        bound_kf_msgs: List[KfMsg] = []
        for k in sorted(kf_msgs, key=lambda x: x.kf_id):
            if kf_count >= cfg.server_kf_it_bound:
                self.deferred_kfs.append(k)
                continue
            if k.kf_id in self.processed_kf_ids:
                kf_processed.append(k.kf_id)  # duplicate receipt tolerated
                continue
            if self._insert_kf(k):
                self.processed_kf_ids.add(k.kf_id)
                kf_processed.append(k.kf_id)
                bound_kf_msgs.append(k)
                kf_count += 1
            else:
                self.deferred_kfs.append(k)
        for p in sorted(mp_msgs, key=lambda x: x.mp_id):
            if mp_count >= cfg.server_mp_it_bound:
                self.deferred_mps.append(p)
                continue
            if p.mp_id in self.processed_mp_ids:
                mp_processed.append(p.mp_id)
                continue
            if self._insert_mp(p):
                self.processed_mp_ids.add(p.mp_id)
                mp_processed.append(p.mp_id)
                mp_count += 1
            else:
                self.deferred_mps.append(p)
        # flush staged landmark writes (late-binding needs their slot ids)
        self._flush_mp_batch()
        self._late_bind_mp_assocs(bound_kf_msgs)
        # reduced updates: pose refresh through predecessor relativity, in
        # one scatter a cycle; chains resolve through the host overlay so a
        # predecessor updated earlier in this drain is seen by successors
        red_slots, red_poses = [], []
        mp_red_slots, mp_red_pos = [], []
        for msg in incoming:
            if msg.closest_kf_id >= 0:
                self.closest_kf_id = msg.closest_kf_id
            for r in msg.keyframes_red:
                slot = self._resolve_kf(r.kf_id)
                if slot is None:
                    continue
                if r.pred_id >= 0:
                    pred_slot = self._resolve_kf(r.pred_id)
                    if pred_slot is None:
                        continue
                    Tcw = self._rel_client_to_map(r.Tcp) @ self._tcw_host(pred_slot)
                else:
                    Tcw = self._pose_client_to_map(r.Tcp)
                self._tcw_overlay[slot] = Tcw.astype(np.float32)
                red_slots.append(slot)
                red_poses.append(Tcw.astype(np.float32))
            # landmark position refresh relative to the reference KF
            # (reference MPred.msg / ProcessMpInServer reduced path)
            for r in msg.map_points_red:
                mslot = self.map.mp_slot_by_id.get((r.mp_id, self.client_id))
                ref_slot = self._resolve_kf(r.ref_kf_id)
                if mslot is None or ref_slot is None:
                    continue
                Twc = np.linalg.inv(self._tcw_host(ref_slot))
                pos_ref = r.pos_ref * self.map_scale
                mp_red_slots.append(mslot)
                mp_red_pos.append((Twc[:3, :3] @ pos_ref + Twc[:3, 3]).astype(np.float32))
        dev = self.map.device
        if red_slots:
            self.map.kf = self.map.kf._replace(Tcw=self.map.kf.Tcw.index_put(
                (torch.tensor(red_slots, device=dev),), torch.from_numpy(np.stack(red_poses)).to(
                    dev)))
        if mp_red_slots:
            self.map.mp = self.map.mp._replace(Xw=self.map.mp.Xw.index_put(
                (torch.tensor(mp_red_slots, device=dev),),
                torch.from_numpy(np.stack(mp_red_pos)).to(dev)))
        # acks back (weak ack = contiguous prefix of processed ids)
        reply = MapMsg(sender_client_id=-1)
        reply.acks_kf = kf_processed
        reply.acks_mp = mp_processed
        if self.processed_kf_ids:
            wa = -1
            while (wa + 1) in self.processed_kf_ids:
                wa += 1
            reply.weak_ack_kf = wa
        if self.processed_mp_ids:
            wa = -1
            while (wa + 1) in self.processed_mp_ids:
                wa += 1
            reply.weak_ack_mp = wa
        # vicinity packing: ship the server-corrected poses of the covis
        # neighborhood of the client's newest KF back down (reference
        # Map::PackVicinityToMsg src/Map.cpp:1077; active when KfsToClient>0)
        if cfg.server_kfs_to_client > 0:
            reply.keyframes_red = self._pack_vicinity(cfg.server_kfs_to_client)
        self.channel.server_send(reply)
        return reply

    def _pack_vicinity(self, max_kfs: int) -> List[KfRedMsg]:
        m = self.map
        valid = m.kf.valid.cpu().numpy()
        cids = m.kf.client_id.cpu().numpy()
        own = valid & (cids == self.client_id)
        if not own.any():
            return []
        kf_ids = m.kf.kf_id.cpu().numpy()
        # center on the client's reported reference KF (mClosestKfId);
        # newest own KF as fallback
        newest = None
        if self.closest_kf_id >= 0:
            newest = m.kf_slot_by_id.get((self.closest_kf_id, self.client_id))
        if newest is None:
            newest = np.flatnonzero(own)[np.argmax(kf_ids[own])]
        w = ms.covisibility_row(m.kf, m.nm, int(newest)).cpu().numpy()
        order = np.argsort(-w)
        vicinity = [int(newest)] + [int(s) for s in order if w[s] >= 15 and valid[s]]
        pred_np = m.kf.pred.cpu().numpy()
        out: List[KfRedMsg] = []
        for slot in vicinity[:max_kfs]:
            if cids[slot] != self.client_id:
                continue  # only this agent's frames go down its channel
            pred = int(pred_np[slot])
            Tcw = self._tcw_host(slot)
            # downlink re-metrization: map-frame poses -> the client's own
            # world/metric (reference src/KeyFrame.cpp:1351-1418)
            if pred >= 0 and valid[pred]:
                pred_id = int(kf_ids[pred])
                Tcp = self._rel_map_to_client(Tcw @ np.linalg.inv(self._tcw_host(pred)))
            else:
                pred_id = -1
                Tcp = self._pose_map_to_client(Tcw)
            out.append(KfRedMsg(kf_id=int(kf_ids[slot]), client_id=self.client_id,
                                Tcp=Tcp, pred_id=pred_id))
        return out

    @property
    def agent_finished(self) -> bool:
        """FINALBA arming: explicit goodbye, or the idle heuristic in cycles
        (the runner maps cycles to wall-clock; reference uses ~30 s of empty
        messages)."""
        if self.agent_said_done and not self.channel.pending_to_server():
            return True
        cycles = max(1, int(self.config.comm.final_ba_idle_s * self.config.comm.client_pub_freq_hz))
        return self.got_data is False and self.idle_cycles >= cycles
