"""Port parity for the slice as a whole: two agents stream their keyframes
to the server, which matches and merges their maps and runs the final
GBA, on tests/test_multi_agent.py's scene and BASE configuration.

The reference is JAX's run of test_multi_agent (its clients, comm and
server), cut from 32 frames to 28 (then its three flush ticks): JAX's
merge comes at frame 27. Two port runs are held against it:

- **The server on JAX's stream.** Every message JAX's server received,
  tick by tick (numpy payloads, the schema a codec carries), is fed to
  the port's ``ServerSystem`` in the same ticks. Tracking is chaotic in
  float32 (PR 8: JAX against itself drifts ~2.5x a frame between
  keyframes; here the offset agent's frame-18 keyframe lands ~1 cm apart
  in two JAX runs whose keypoints differ by one float32 step, and then
  triangulates 37 or 170 landmarks), so a port client cannot reproduce
  JAX's stream; the server, given it, must make JAX's decisions. Must
  match: the number of merges and the merging keyframe pair (by
  ``(kf_id, client_id)``), the fused map's ``(kf_id, client_id)`` set and
  its landmark ids, the final GBA once; the fused keyframe centres within
  5 mm, or twice JAX's own scatter where that is larger (a JAX server fed
  the same stream with every keypoint one float32 step off).
- **The port end to end**: the port's ``ClientSystem`` + ``ClientComm`` for
  both agents into its ``ServerSystem``. Its trackers take JAX's ORB
  features of each frame (carried across with
  ``convert.orb_features_from_numpy``; the extractor's parity is held in
  test_torch_orb.py and test_torch_client.py, and its plain K1/K2 cost
  ~1.5 s a CPU frame) and every RANSAC draw (trackers, loop closers,
  matcher) replays JAX's draws from the same key sequences
  (``GeneratorDraws``, replacing ``ransac._sample_indices`` in this test
  only). It must meet test_multi_agent's bounds: both agents OK, one
  merge, both handlers on one map holding client ids {0, 1}, the final GBA
  once, the fused trajectories in one frame; and the fused map's
  structure clean.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioncheck_ccm_slam_tpu.config import SystemParams as JSystemParams
from motioncheck_ccm_slam_tpu.models import frame as jframe
from motioncheck_ccm_slam_tpu.ops import ransac as jransac
from motioncheck_ccm_slam_tpu.parallel import comm as jcomm
from motioncheck_ccm_slam_tpu.system.client import ClientSystem as JClient
from motioncheck_ccm_slam_tpu.system.server import ServerSystem as JServer
from motioncheck_ccm_slam_tpu_torch import convert
from motioncheck_ccm_slam_tpu_torch.config import SystemParams as TSystemParams
from motioncheck_ccm_slam_tpu_torch.models import frame as tframe
from motioncheck_ccm_slam_tpu_torch.models import map_state as tms
from motioncheck_ccm_slam_tpu_torch.ops import ransac as transac
from motioncheck_ccm_slam_tpu_torch.parallel import comm as tcomm
from motioncheck_ccm_slam_tpu_torch.system.client import ClientSystem as TClient
from motioncheck_ccm_slam_tpu_torch.system.server import ServerSystem as TServer

from synth_scene import SynthScene
from test_multi_agent import BASE, OffsetScene
from test_torch_gba_driver import port_config
import torch_one_thread  # noqa: F401 (torch on one thread)

N_FRAMES = 28
CENTRE_ATOL_M = 5e-3
SCATTER_FACTOR = 2.0


class GeneratorDraws:
    """Stands in for the port's ``_sample_indices``: each registered
    generator draws JAX's indices from its own JAX key sequence, split once
    a RANSAC call; a tracker's two-view initialization (8 points a
    hypothesis) draws with the first half of the split again, as the JAX
    Tracker does."""

    def __init__(self):
        self.keys = {}
        self.calls = []

    def register(self, generator, key, tracker: bool = False):
        self.keys[id(generator)] = [key, tracker, generator]

    def __call__(self, generator, n_hyp, set_size, n_pts, weights=None):
        entry = self.keys[id(generator)]
        entry[0], sub = jax.random.split(entry[0])
        if entry[1] and set_size == 8:
            sub = jax.random.split(sub)[0]
        self.calls.append(set_size)
        w = None if weights is None else jnp.asarray(weights.cpu().numpy())
        idx = jransac._sample_indices(sub, n_hyp, set_size, n_pts, weights=w)
        return torch.from_numpy(np.asarray(idx).astype(np.int64)).to(generator.device)


def _frames():
    scenes = [SynthScene(BASE, n_points=500, seed=3, speed=0.9),
              OffsetScene(BASE, offset_y=0.15, n_points=500, seed=3, speed=0.9)]
    return [list(s.sequence(N_FRAMES)) for s in scenes]


def _spy_merges(server):
    """The (kf_id, client_id) pairs of every hit the matcher returns."""
    merges = []
    check = server.matcher.check

    def spy(map_id, slot):
        hit = check(map_id, slot)
        if hit is not None:
            kf_c, kf_m = server.matcher.maps[hit.map_id_cur].kf, \
                server.matcher.maps[hit.map_id_match].kf
            merges.append(tuple(int(np.asarray(a)) for a in (
                kf_c.kf_id[hit.slot_cur], kf_c.client_id[hit.slot_cur],
                kf_m.kf_id[hit.slot_match], kf_m.client_id[hit.slot_match])))
        return hit

    server.matcher.check = spy
    return merges


def _final(server):
    """The agents go idle: FINALBA fires, and only once."""
    for h in server.handlers.values():
        h.comm.idle_cycles = 10**9
        h.comm.got_data = False
    return [server.maybe_final_gba(), server.maybe_final_gba()]


def _drive(server, clients, frames):
    """test_multi_agent's loop: a frame of each agent then a server spin;
    then three flush ticks. Records the merging hits and the final GBA."""
    merges = _spy_merges(server)
    for i in range(N_FRAMES):
        for cid, c in enumerate(clients):
            t, _, img = frames[cid][i]
            c.process_image(img, t)
        server.spin_once()
    for _ in range(3):
        for c in clients:
            c.comm.tick(c.map)
        server.spin_once()
    return dict(server=server, clients=clients, merges=merges, final=_final(server))


def _jax_run(frames, record=None):
    server = JServer(config=BASE, n_agents=2)
    for h in server.handlers.values():
        h.loop_closer.run_gba_after_loop = False
    if record is not None:
        _record_stream(server, record)
    clients = []
    for cid in range(2):
        cfg = BASE.replace(sys=JSystemParams(client_id=cid, n_agents=2))
        c = JClient(config=cfg)
        c.comm = jcomm.ClientComm(config=cfg, channel=server.channel_for(cid), client_id=cid)
        clients.append(c)
    return _drive(server, clients, frames)


def _record_stream(server, record):
    """Keep, for every server spin, the messages each handler's channel
    held at the spin's start."""
    spin = server.spin_once

    def recording():
        record.append({cid: list(ch.to_server.queue) for cid, ch in server.channels.items()})
        spin()

    server.spin_once = recording


def _replay(server, stream, nudge=None):
    """Feed a recorded stream to ``server``, spin by spin, then the final
    GBA as _drive does. ``nudge(msg)`` may alter each message."""
    merges = _spy_merges(server)
    for spin in stream:
        for cid, msgs in spin.items():
            for msg in msgs:
                server.channel_for(cid).client_send(msg if nudge is None else nudge(msg))
        server.spin_once()
    return dict(server=server, merges=merges, final=_final(server))


def _nudged_stream(rng):
    """Every keyframe's keypoints one float32 step off, both ways at random."""
    def nudge(msg):
        kfs = []
        for k in msg.keyframes:
            to = np.where(rng.random(k.xy.shape) < 0.5, np.inf, -np.inf).astype(np.float32)
            kfs.append(dataclasses.replace(k, xy=np.nextafter(k.xy, to)))
        return dataclasses.replace(msg, keyframes=kfs)
    return nudge


def _port_msg(msg):
    """A JAX MapMsg as the port's (the payload objects are shared)."""
    return tcomm.MapMsg(**{f.name: getattr(msg, f.name) for f in dataclasses.fields(msg)})


@functools.lru_cache(maxsize=1)
def _runs():
    frames = _frames()
    feats, stream = {}, []
    make_frame = jframe.make_frame

    def keep(cfg, frame_id, t, img):
        fr = make_frame(cfg, frame_id, t, img)
        feats[(cfg.sys.client_id, frame_id)] = jax.tree.map(np.asarray, fr.feats)
        return fr

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jframe, "make_frame", keep)
        out = {"jax": _jax_run(frames, record=stream)}
    witness = JServer(config=BASE, n_agents=2)
    for h in witness.handlers.values():
        h.loop_closer.run_gba_after_loop = False
    out["witness"] = _replay(witness, stream, _nudged_stream(np.random.default_rng(7)))

    cfg = port_config(BASE)
    server = TServer(config=cfg, n_agents=2, device="cpu")
    for h in server.handlers.values():
        h.loop_closer.run_gba_after_loop = False
    draws = GeneratorDraws()
    _register_server(draws, server)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transac, "_sample_indices", draws)
        out["server"] = _replay(server, stream, _port_msg)
    out["e2e"] = _port_end_to_end(cfg, frames, feats)
    return out


def _register_server(draws, server):
    draws.register(server.matcher.generator, jax.random.PRNGKey(7))
    for h in server.handlers.values():
        draws.register(h.loop_closer.generator, jax.random.PRNGKey(42))


def _port_end_to_end(cfg, frames, feats):
    def jax_features(cfg, frame_id, t, img, device):
        f = cfg.extractor.max_features
        return tframe.Frame(
            frame_id=frame_id, timestamp=t,
            feats=convert.orb_features_from_numpy(feats[(cfg.sys.client_id, frame_id)], device),
            Tcw=torch.eye(4, device=device),
            mp_idx=torch.full((f,), -1, dtype=torch.int64, device=device))

    draws = GeneratorDraws()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transac, "_sample_indices", draws)
        mp.setattr(tframe, "make_frame", jax_features)
        server = TServer(config=cfg, n_agents=2, device="cpu")
        for h in server.handlers.values():
            h.loop_closer.run_gba_after_loop = False
        _register_server(draws, server)
        clients = []
        for cid in range(2):
            c_cfg = cfg.replace(sys=TSystemParams(client_id=cid, n_agents=2))
            c = TClient(config=c_cfg, device="cpu")
            c.tracker.generator = torch.Generator()
            draws.register(c.tracker.generator, jax.random.PRNGKey(0), tracker=True)
            c.comm = tcomm.ClientComm(config=c_cfg, channel=server.channel_for(cid),
                                      client_id=cid)
            clients.append(c)
        return _drive(server, clients, frames)


@pytest.fixture(scope="module")
def runs():
    return _runs()


def _fused_centres(server):
    m = server.handlers[0].map
    kf_ids = np.asarray(m.kf.kf_id)
    cids = np.asarray(m.kf.client_id)
    valid = np.asarray(m.kf.valid)
    T = np.asarray(m.kf.Tcw)
    return {(int(kf_ids[s]), int(cids[s])): -T[s, :3, :3].T @ T[s, :3, 3]
            for s in np.flatnonzero(valid)}


def test_same_merge_as_jax(runs):
    j, t = runs["jax"], runs["server"]
    assert j["server"].n_merges == 1 and len(j["merges"]) == 1
    assert runs["witness"]["merges"] == j["merges"]
    assert t["server"].n_merges == j["server"].n_merges
    assert t["merges"] == j["merges"]


def test_fused_map_matches_jax(runs):
    mj = runs["jax"]["server"].handlers[0].map
    mt = runs["server"]["server"].handlers[0].map
    assert runs["server"]["server"].handlers[1].map is mt
    assert set(mt.kf_slot_by_id) == set(mj.kf_slot_by_id)
    assert {cid for (_, cid) in mt.kf_slot_by_id} == {0, 1}
    assert set(mt.mp_slot_by_id) == set(mj.mp_slot_by_id)


def test_final_gba_fires_once(runs):
    for name in ("jax", "witness", "server", "e2e"):
        assert runs[name]["final"] == [True, False], name
        assert runs[name]["server"].final_gba_done


def test_fused_centres_match_jax(runs):
    cj = _fused_centres(runs["jax"]["server"])
    cw = _fused_centres(runs["witness"]["server"])
    ct = _fused_centres(runs["server"]["server"])
    keys = sorted(set(cj) & set(cw) & set(ct))
    assert len(keys) == len(cj) >= 8
    gap = np.array([np.linalg.norm(ct[k] - cj[k]) for k in keys])
    scatter = np.array([np.linalg.norm(cw[k] - cj[k]) for k in keys])
    bound = np.maximum(CENTRE_ATOL_M, SCATTER_FACTOR * scatter)
    assert (gap <= bound).all(), list(zip(keys, np.round(gap * 1e3, 3),
                                          np.round(bound * 1e3, 3)))


def test_port_end_to_end_merges_the_agents(runs):
    """test_multi_agent's bounds on the port's own clients and server."""
    server, clients = runs["e2e"]["server"], runs["e2e"]["clients"]
    for c in clients:
        assert c.tracker.state.name == "OK"
    assert server.n_merges == 1
    m0, m1 = server.handlers[0].map, server.handlers[1].map
    assert m0 is m1 and server.matcher.maps[0] is server.matcher.maps[1] is m0
    assert {cid for (_, cid) in m0.kf_slot_by_id} == {0, 1}
    assert len(m0.kf_slot_by_id) >= clients[0].map.n_kfs + clients[1].map.n_kfs - 2
    assert not tms.check_structure(m0)
    # test_multi_agent's check: both trajectories move dominantly along x
    # in the fused frame
    kf = m0.kf
    valid, cid = kf.valid.numpy(), kf.client_id.numpy()
    for c in (0, 1):
        T = kf.Tcw.numpy()[valid & (cid == c)]
        C = -np.einsum("kji,kj->ki", T[:, :3, :3], T[:, :3, 3])
        span = C.max(0) - C.min(0)
        assert span[0] > 2 * span[1]
    tum = server.trajectories_tum()
    assert set(tum) == {0, 1} and all(len(v.strip().split("\n")) >= 4 for v in tum.values())
