"""Server system: per-agent maps, loop closing, cross-map matching/merging,
final GBA.

Counterpart of ``motioncheck_ccm_slam_tpu/system/server.py`` (the
reference's ``ServerSystem`` + server-role ``ClientHandler``,
src/server/ServerSystem.cpp:29-218, src/ClientHandler.cpp:190-219): each
agent is mirrored by a handler owning a communicator + loop closer over the
agent's map; one shared ``MapMatcher`` watches all maps; after a confirmed
cross-map hit the maps are fused and the affected handlers re-point to the
fused map (``ChangeMap`` src/ClientHandler.cpp:221-241). When every agent
has gone idle, the final Motion-Check-gated GBA runs (FINALBA,
Map::RequestBA src/Map.cpp:1329).

The maps live on ``device`` (the card unless the caller asks for the CPU);
handlers and the matcher refer to maps by identity, and a merge re-points
them without copying a map. Each host read of the device state is an
explicit ``.item()`` or ``.cpu()``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..models import database as db_mod
from ..models import gba as gba_mod
from ..models import loop_closing, map_matching, map_merging
from ..models import map_state as ms
from ..models import mapping as mapping_mod
from ..models import vocabulary as vocab_mod
from ..ops import orb
from ..parallel import comm as comm_mod
from ..utils import csv_io
from ..utils import ids as ids_mod
from ..utils import watchdog as watchdog_mod


def _kf_valid(m: ms.MapState, slot: int) -> bool:
    """One host read: is keyframe ``slot`` alive."""
    return bool(m.kf.valid[slot].item())


@dataclasses.dataclass
class ServerClientHandler:
    """Server-side mirror of one agent."""

    config: Config
    client_id: int
    map: ms.MapState
    channel: comm_mod.Channel
    comm: comm_mod.ServerComm = None
    loop_closer: loop_closing.LoopCloser = None
    vocab: vocab_mod.Vocabulary = None
    n_kfs_processed: int = 0
    # landmark probation bookkeeping (reference mlpRecentAddedMapPoints):
    # MP slot -> processed-KF count at first sight; -1 untracked, -2 exempt
    mp_tick: np.ndarray = None
    recent_slots: List[int] = dataclasses.field(default_factory=list)
    # KF slots invalidated in the last spin (for shared-DB hygiene)
    stale_kf_slots: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int64))

    def __post_init__(self):
        if self.mp_tick is None:
            self.mp_tick = np.full(self.map.nm, -1, np.int32)
        if self.comm is None:
            self.comm = comm_mod.ServerComm(config=self.config, channel=self.channel,
                                            map=self.map, client_id=self.client_id)
        if self.vocab is None:
            self.vocab = vocab_mod.default_vocabulary()
        if self.loop_closer is None:
            self.loop_closer = loop_closing.LoopCloser(
                config=self.config, map=self.map,
                database=db_mod.KeyFrameDatabase(vocab=self.vocab, capacity=self.map.nk,
                                                 device=self.map.device),
                map_id=self.client_id)

    def change_map(self, new_map: ms.MapState, kf_slot_map: Dict[int, int],
                   mp_slot_map: Optional[Dict[int, int]] = None):
        """Re-point to a fused map (reference ClientHandler::ChangeMap)."""
        old_tick = self.mp_tick
        old_map = self.map
        self.map = new_map
        self.comm.map = new_map
        self.loop_closer.map = new_map
        # the loop database rows referenced old slots: re-add the KFs under
        # their new slots
        db = db_mod.KeyFrameDatabase(vocab=self.vocab, capacity=new_map.nk,
                                     device=new_map.device)
        for new in kf_slot_map.values():
            db.add(new, new_map.kf.desc[new], new_map.kf.feat_valid[new], map_id=self.client_id)
        self.loop_closer.database = db
        self.loop_closer.consistent_groups = []
        # landmarks from the other map are mature (exempt, -2); this
        # handler's own mid-probation entries carry their tick through the
        # slot remap so the merge does not reset their trial (reference
        # keeps mlpRecentAddedMapPoints per server LocalMapping across
        # ChangeMap — src/Mapping.cpp:737-775, src/ClientHandler.cpp:221)
        self.mp_tick = np.where(new_map.mp.valid.cpu().numpy(), -2, -1).astype(np.int32)
        if mp_slot_map and old_map is not new_map:
            old_ids = old_map.mp.mp_id.cpu().numpy()
            old_cids = old_map.mp.client_id.cpu().numpy()
            new_ids = new_map.mp.mp_id.cpu().numpy()
            new_cids = new_map.mp.client_id.cpu().numpy()
            for old, new in mp_slot_map.items():
                # only identity-preserving remaps carry; a landmark FUSED
                # into an existing target landmark dies (reference
                # MapPoint::Replace SetBadFlags it out of the recent list)
                if (old < len(old_tick) and old_tick[old] >= 0
                        and new_ids[new] == old_ids[old] and new_cids[new] == old_cids[old]):
                    self.mp_tick[new] = old_tick[old]

    def _interrupt_check(self):
        """INTERRUPTBA: fresh agent data queued on the channel aborts a
        running GBA (reference Communicator.cpp:453-462)."""
        if not self.config.comm.interrupt_gba_on_input:
            return None
        return lambda: self.channel.pending_to_server()

    def spin(self) -> List[int]:
        """One server cycle for this agent: the server mapping pipeline per
        arriving KF (reference LocalMapping::RunServer src/Mapping.cpp:141):
        landmark probation culling per KF; neighbor fuse-with-replace, stat
        refresh and scale-aware redundancy culling once per burst; then loop
        closing. Returns new KF slots."""
        self.comm.tick()
        new_slots = list(self.comm.new_kf_slots)
        if len(self.mp_tick) < self.map.nm:    # map blocks grew
            self.mp_tick = np.concatenate([
                self.mp_tick, np.full(self.map.nm - len(self.mp_tick), -1, np.int32)])
        for slot in new_slots:
            if not _kf_valid(self.map, slot):
                continue
            self.n_kfs_processed += 1
            # register freshly arrived landmarks for probation
            fresh = self.map.mp.valid.cpu().numpy() & (self.mp_tick == -1)
            self.mp_tick[fresh] = self.n_kfs_processed
            mapping_mod.cull_recent_mps_server(self.map, self.mp_tick, self.n_kfs_processed,
                                               self.client_id)
            self.recent_slots.append(slot)
        window = self.config.mapping.recent_kf_window
        self.recent_slots = self.recent_slots[-window:]
        if new_slots:
            last = new_slots[-1]
            nbs = mapping_mod.covis_neighbors_of(self.map, last)
            mapping_mod.fuse_neighbors(self.map, [last] + nbs, self.config)
            self.map.mp = ms.update_mp_descriptors_and_normals(
                self.map.kf, self.map.mp, orb.scale_factors(self.config.extractor))
            # redundancy-based KF culling (reference KeyFrameCullingV3);
            # recent arrivals are protected (reference mlpRecentAddedKFs)
            mapping_mod.cull_redundant_keyframes(self.map, self.config,
                                                 protect=set(self.recent_slots))
        for slot in new_slots:
            if _kf_valid(self.map, slot):
                self.loop_closer.process_keyframe(slot, interrupt_check=self._interrupt_check())
        # slots freed by culling/replacement this cycle lose their probation
        # bookkeeping — a future landmark reusing the slot must not inherit
        # the dead one's tick
        self.mp_tick[~self.map.mp.valid.cpu().numpy()[:len(self.mp_tick)]] = -1
        # database hygiene: culled / MC-deleted KFs must stop scoring in the
        # loop database (reference mpKeyFrameDB->erase,
        # src/KeyFrame.cpp:850,1171); the caller also erases them from the
        # shared map-match database via ``stale_kf_slots``
        db = self.loop_closer.database
        kf_valid = self.map.kf.valid.cpu().numpy()
        present = db.present.cpu().numpy()[:self.map.nk]
        stale = np.flatnonzero(present & ~kf_valid[:len(present)])
        if len(stale):
            db.erase_many(stale)
        self.stale_kf_slots = stale
        return new_slots


@dataclasses.dataclass
class ServerSystem:
    config: Config
    n_agents: int = 1
    handlers: Dict[int, ServerClientHandler] = dataclasses.field(default_factory=dict)
    channels: Dict[int, comm_mod.Channel] = dataclasses.field(default_factory=dict)
    matcher: map_matching.MapMatcher = None
    vocab: vocab_mod.Vocabulary = None
    final_gba_done: bool = False
    n_merges: int = 0
    n_gba_interrupts: int = 0
    uid_dispenser: ids_mod.UniqueIdDispenser = None
    watchdog: watchdog_mod.Watchdog = None
    device: torch.device | str = "cuda"

    def __post_init__(self):
        if self.vocab is None:
            self.vocab = vocab_mod.default_vocabulary()
        if self.uid_dispenser is None:
            self.uid_dispenser = ids_mod.UniqueIdDispenser()
        if self.watchdog is None:
            self.watchdog = watchdog_mod.Watchdog(timeout_s=30.0)
        maps = {}
        for cid in range(self.n_agents):
            ch = comm_mod.Channel()
            m = ms.MapState.create(self.config, server=True, device=self.device)
            self.channels[cid] = ch
            self.handlers[cid] = ServerClientHandler(config=self.config, client_id=cid, map=m,
                                                     channel=ch, vocab=self.vocab)
            self.handlers[cid].comm.uid_dispenser = self.uid_dispenser
            maps[cid] = m
        if self.matcher is None:
            self.matcher = map_matching.MapMatcher(config=self.config, maps=maps,
                                                   vocab=self.vocab)

    def channel_for(self, client_id: int) -> comm_mod.Channel:
        return self.channels[client_id]

    # ------------------------------------------------------------------
    def spin_once(self):
        for cid, h in self.handlers.items():
            new_slots = h.spin()
            # the reference's mylog stamps every thread-loop pass
            # (estd.h:206-400), not only passes with work
            self.watchdog.beat(f"comm{cid}", f"{h.comm.idle_cycles} idle cycles")
            self.watchdog.beat(f"mapping{cid}", f"{len(new_slots)} kfs")
            self.watchdog.beat(f"placerec{cid}")
            # keep the matcher's map table pointing at live maps
            self.matcher.maps[cid] = h.map
            # erase deleted KFs from the shared map-match database too
            if len(h.stale_kf_slots):
                rows = [self.matcher.row_of[(cid, int(s))] for s in h.stale_kf_slots
                        if (cid, int(s)) in self.matcher.row_of]
                self.matcher.db.erase_many(rows)
            for slot in new_slots:
                if not _kf_valid(h.map, slot):
                    continue
                hit = self.matcher.check(cid, slot)
                if hit is not None and self._distinct_maps(hit):
                    self._merge(hit)
                    break

    def _distinct_maps(self, hit: map_matching.MapMatchHit) -> bool:
        return self.handlers[hit.map_id_cur].map is not self.handlers[hit.map_id_match].map

    # ------------------------------------------------------------------
    def _merge(self, hit: map_matching.MapMatchHit):
        """Fuse the current map into the matched map (reference
        MapMerger::MergeMaps)."""
        h_cur = self.handlers[hit.map_id_cur]
        h_match = self.handlers[hit.map_id_match]
        m_cur, m_match = h_cur.map, h_match.map
        # seam measurements need the cur map's PRE-alignment poses: one
        # measured Sim3 edge per hit (primary + auxiliary) before the rigid
        # transform overwrites them
        all_hits = [(hit.slot_cur, hit.slot_match, hit.S_match_from_cur)] + list(hit.aux)
        seam_meas = [map_merging.seam_measurement(m_cur.kf.Tcw[sc], m_match.kf.Tcw[sm], S_k)
                     for sc, sm, S_k in all_hits]
        # handlers streaming into the transformed map carry the fusion Sim3
        # on their client<->map channel from now on (reference
        # mg2oS_wcurmap_wclientmap, include/cslam/CentralControl.h:86)
        moved = [h for h in self.handlers.values() if h.map is m_cur or h is h_cur]
        S_fusion = hit.S_match_from_cur.cpu().numpy().astype(np.float64)
        m_cur = map_merging.sim3_transform_map(m_cur, hit.S_match_from_cur)
        m_match, kf_map, mp_map = map_merging.merge_maps(
            m_cur, m_match, hit.S_match_from_cur, mp_fuse_pairs=hit.mp_pairs, config=self.config)
        # every handler pointing at the old map re-points to the fused one
        merged_in = [ns for ns in mp_map.values() if ns < m_match.nm]
        for cid, h in self.handlers.items():
            if h in moved:
                h.change_map(m_match, kf_map, mp_map)
                h.comm.compose_fusion_sim3(S_fusion)
            else:
                # match-side handlers keep their own probation books, but
                # the merged-in landmarks land in slots they saw as free
                # (tick -1): they are exempt, not fresh arrivals
                if len(h.mp_tick) < m_match.nm:
                    h.mp_tick = np.concatenate([
                        h.mp_tick, np.full(m_match.nm - len(h.mp_tick), -1, np.int32)])
                idx = np.asarray(merged_in, np.int64)
                if len(idx):
                    h.mp_tick[idx] = np.where(h.mp_tick[idx] == -1, -2, h.mp_tick[idx])
            self.matcher.maps[cid] = self.handlers[cid].map
        # fuse duplicates around the seam, rigidify with the fusion
        # essential graph, then the Motion-Check-gated GBA (reference
        # MapMerger::MergeMaps :476-618 SearchAndFuse + ess-graph + RunGBA)
        cur_slot = kf_map[hit.slot_cur]
        mapping_mod.fuse_neighbors(m_match, [cur_slot, hit.slot_match], self.config)
        seam_edges = [(kf_map[sc], sm, meas) for (sc, sm, _), meas in zip(all_hits, seam_meas)
                      if sc in kf_map]
        map_merging.optimize_seam_essential_graph(m_match, seam_edges, hit.slot_match,
                                                  self.config)
        gba_mod.run_gba(m_match, self.config, interrupt_check=h_match._interrupt_check())
        self.n_merges += 1

    # ------------------------------------------------------------------
    def _fresh_data_for(self, map_obj) -> bool:
        return any(h.channel.pending_to_server() for h in self.handlers.values()
                   if h.map is map_obj)

    def maybe_final_gba(self) -> bool:
        """FINALBA: when every agent is idle, run the final Motion-Check-
        gated GBA on every distinct map (reference Map::RequestBA). Fresh
        agent data arriving mid-GBA aborts it and re-arms FINALBA — the
        caller's next cycles ingest the data and retry once agents go quiet
        again (reference Communicator.cpp:465-496, Map::isGBAinterrupted)."""
        if self.final_gba_done:
            return False
        if not all(h.comm.agent_finished for h in self.handlers.values()):
            return False
        seen = set()
        for h in self.handlers.values():
            if id(h.map) in seen:
                continue
            seen.add(id(h.map))
            ic = None
            if self.config.comm.interrupt_gba_on_input:
                ic = lambda m=h.map: self._fresh_data_for(m)  # noqa: E731
            res = gba_mod.run_gba(h.map, self.config, interrupt_check=ic,
                                  on_chunk=lambda done: self.watchdog.beat(
                                      "final_gba", f"{done} iters"))
            if res.interrupted:
                self.n_gba_interrupts += 1
                # re-arm: the agent(s) of this map came back; require a
                # fresh quiet period before retrying
                for h2 in self.handlers.values():
                    if h2.map is h.map:
                        h2.comm.idle_cycles = 0
                        h2.comm.got_data = True
                return False
        self.final_gba_done = True
        return True

    # ------------------------------------------------------------------
    def save_maps(self, out_dir: str) -> List[str]:
        """Persist every distinct map (the reference's ccmslam_savemap
        service, src/server/ServerSystem.cpp:36,63-79)."""
        import os

        from .. import persistence

        os.makedirs(out_dir, exist_ok=True)
        seen, paths = set(), []
        for cid, h in sorted(self.handlers.items()):
            if id(h.map) in seen:
                continue
            seen.add(id(h.map))
            path = os.path.join(out_dir, f"map_{cid}.npz")
            persistence.save_map(h.map, path)
            paths.append(path)
        return paths

    def add_loaded_map(self, path: str) -> int:
        """Mount a previously saved map as a PRIOR map under its own handler
        slot (the reference's LoadMap launch param mounts a saved map for a
        dedicated client slot, src/server/ServerSystem.cpp:96-116); live
        agents can then place-recognize against it and merge into it.
        Returns the handler id."""
        from .. import persistence

        hid = max(self.handlers) + 1 if self.handlers else 0
        m = persistence.load_map(path, self.config, device=self.device)
        # the loaded entities move into the handler's fresh client-id
        # namespace so they can never collide with a live agent's ids (the
        # reference reserves client slot 0 for the load and streams live
        # agents on other ids). A merged map holds several clients' ids,
        # which may repeat across clients: in one namespace they are
        # interleaved (id * n + the client's rank among the n), else the
        # host index would keep one entity of each repeated id (the JAX
        # package's add_loaded_map loses them so). One client keeps its ids.
        # The new ids keep every strict order of the old, breaking only ties
        # across clients; of the id-ordered rules only the descriptor
        # choice's recency bonus reads them on a server map (first_kf_id
        # feeds the client's culling alone, and mp_tick -2 below exempts
        # the mounted landmarks from the server's probation).
        kf, mp = m.kf, m.mp
        cids = torch.unique(torch.cat([kf.client_id[kf.valid], mp.client_id[mp.valid]]))
        n = max(int(cids.numel()), 1)
        kf_rank = torch.searchsorted(cids, kf.client_id).to(torch.int32)
        mp_rank = torch.searchsorted(cids, mp.client_id).to(torch.int32)
        m.kf = kf._replace(client_id=torch.where(kf.valid, hid, kf.client_id),
                           kf_id=torch.where(kf.valid, kf.kf_id * n + kf_rank, kf.kf_id))
        m.mp = mp._replace(
            client_id=torch.where(mp.valid, hid, mp.client_id),
            mp_id=torch.where(mp.valid, mp.mp_id * n + mp_rank, mp.mp_id),
            first_kf_id=torch.where(mp.valid & (mp.first_kf_id >= 0),
                                    mp.first_kf_id * n + mp_rank, mp.first_kf_id))
        m.sync_host_index()
        h = ServerClientHandler(config=self.config, client_id=hid, map=m,
                                channel=comm_mod.Channel(), vocab=self.vocab)
        # nothing will ever stream on this handler: mark it finished so it
        # doesn't block FINALBA, and its landmarks probation-exempt
        h.comm.agent_said_done = True
        h.mp_tick = np.where(m.mp.valid.cpu().numpy(), -2, -1).astype(np.int32)
        self.handlers[hid] = h
        self.channels[hid] = h.channel
        self.matcher.maps[hid] = m
        for (kf_id, cid), slot in sorted(m.kf_slot_by_id.items()):
            self.matcher.add_keyframe(hid, slot)
            h.loop_closer.database.add(slot, m.kf.desc[slot], m.kf.feat_valid[slot], map_id=hid)
        return hid

    # ------------------------------------------------------------------
    def trajectories_tum(self) -> Dict[int, str]:
        """Per-agent keyframe trajectories (reference WriteStateToCsv)."""
        out = {}
        for cid, h in self.handlers.items():
            kf = h.map.kf
            valid = kf.valid.cpu().numpy() & (kf.client_id.cpu().numpy() == cid)
            ts = kf.timestamp.cpu().numpy()[valid]
            Ts = kf.Tcw.cpu().numpy()[valid]
            order = np.argsort(ts)
            out[cid] = csv_io.trajectory_tum([(float(ts[i]), Ts[i]) for i in order], self.config)
        return out
