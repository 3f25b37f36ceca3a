"""Port parity: parallel/comm.py (the in-process agent <-> server link)
against the JAX package.

- tests/test_comm_server.py's run (one agent, 14 frames, a server spin a
  frame, then four drain ticks) on both packages. The port's tracker takes
  JAX's ORB features of each frame and replays JAX's RANSAC draws (as in
  test_torch_server.py), so both stream the same keyframes. Must match:
  the mirrored KF and landmark id sets, the acked sets (nothing left
  unacked). The port alone meets test_comm_server's bounds: server poses
  within 0.05 of the client's, unique server uids, retransmission through
  message loss, the reduced stream budgeted and changed-only.
- The messages themselves, exactly: the port's ``ClientComm`` publishing
  the JAX client map (carried across) against JAX's publishing it — the
  same keyframe and landmark ids, relative poses within 1e-5, payloads
  equal; and one message stream fed to both packages' ``ServerComm``
  (descriptors and all payloads as numpy, the schema a codec carries),
  also after a scaled fusion Sim3: the reconstructed poses and landmark
  positions within 1e-5, associations, acks and deferrals equal.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from motioncheck_ccm_slam_tpu.models import frame as jframe
from motioncheck_ccm_slam_tpu.models import map_state as jms
from motioncheck_ccm_slam_tpu.parallel import comm as jcomm
from motioncheck_ccm_slam_tpu.system.client import ClientSystem as JClient
from motioncheck_ccm_slam_tpu.system.server import ServerSystem as JServer
from motioncheck_ccm_slam_tpu_torch import convert
from motioncheck_ccm_slam_tpu_torch.models import frame as tframe, map_state as tms
from motioncheck_ccm_slam_tpu_torch.ops import ransac as transac
from motioncheck_ccm_slam_tpu_torch.parallel import comm as tcomm
from motioncheck_ccm_slam_tpu_torch.system.client import ClientSystem as TClient
from motioncheck_ccm_slam_tpu_torch.system.server import ServerSystem as TServer

from synth_scene import SynthScene
from test_comm_server import TEST_CONFIG
from test_torch_gba_driver import port_config
from test_torch_server import GeneratorDraws
import torch_one_thread  # noqa: F401 (torch on one thread)

T_CONFIG = port_config(TEST_CONFIG)
N_FRAMES = 14
POSE_ATOL = 1e-5


def _drive(client, server, frames, drop_every_other=False, drain=4):
    ch = server.channel_for(0)
    drop = True
    for t, _, img in frames:
        client.process_image(img, t)
        if drop_every_other:
            if drop:
                ch.server_recv()      # the message just sent is lost
            drop = not drop
        server.spin_once()
    for _ in range(drain):
        client.comm.tick(client.map)
        server.spin_once()


def _port_pair(feats, draws, config=T_CONFIG):
    server = TServer(config=config, n_agents=1, device="cpu")
    h = server.handlers[0]
    h.loop_closer.run_gba_after_loop = False
    draws.register(h.loop_closer.generator, jax.random.PRNGKey(42))
    draws.register(server.matcher.generator, jax.random.PRNGKey(7))
    client = TClient(config=config, device="cpu")
    client.tracker.generator = torch.Generator()
    draws.register(client.tracker.generator, jax.random.PRNGKey(0), tracker=True)
    client.comm = tcomm.ClientComm(config=config, channel=server.channel_for(0), client_id=0)
    return client, server


def _jax_feature_frames(feats):
    def make(cfg, frame_id, t, img, device):
        return tframe.Frame(
            frame_id=frame_id, timestamp=t,
            feats=convert.orb_features_from_numpy(feats[frame_id], device),
            Tcw=torch.eye(4, device=device),
            mp_idx=torch.full((cfg.extractor.max_features,), -1, dtype=torch.int64,
                              device=device))
    return make


@functools.lru_cache(maxsize=1)
def _runs():
    frames = list(SynthScene(TEST_CONFIG, n_points=500, seed=3, speed=0.9).sequence(N_FRAMES))
    feats = {}
    make_frame = jframe.make_frame

    def keep(cfg, frame_id, t, img):
        fr = make_frame(cfg, frame_id, t, img)
        feats[frame_id] = jax.tree.map(np.asarray, fr.feats)
        return fr

    server = JServer(config=TEST_CONFIG, n_agents=1)
    server.handlers[0].loop_closer.run_gba_after_loop = False
    client = JClient(config=TEST_CONFIG)
    client.comm = jcomm.ClientComm(config=TEST_CONFIG, channel=server.channel_for(0), client_id=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jframe, "make_frame", keep)
        _drive(client, server, frames)
    out = dict(frames=frames, feats=feats, jax=(client, server))
    draws = GeneratorDraws()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transac, "_sample_indices", draws)
        mp.setattr(tframe, "make_frame", _jax_feature_frames(feats))
        out["port"] = _port_pair(feats, draws)
        _drive(*out["port"], frames)
        lossy = _port_pair(feats, draws)
        _drive(*lossy, frames[:12], drop_every_other=True, drain=6)
        out["lossy"] = lossy
    return out


@pytest.fixture(scope="module")
def runs():
    return _runs()


def test_mirrored_ids_match_jax(runs):
    (cj, sj), (ct, st) = runs["jax"], runs["port"]
    mj, mt = sj.handlers[0].map, st.handlers[0].map
    assert set(mt.kf_slot_by_id) == set(mj.kf_slot_by_id)
    assert set(mt.mp_slot_by_id) == set(mj.mp_slot_by_id)
    assert ct.comm.acked_kf == cj.comm.acked_kf and len(ct.comm.acked_kf) >= 3
    assert ct.comm.acked_mp == cj.comm.acked_mp
    assert not ct.comm.sent_unacked_kf and not ct.comm.sent_unacked_mp
    # test_comm_server's bounds on the port
    assert mt.n_kfs >= ct.map.n_kfs and mt.n_kfs >= 3 and mt.n_mps > 100


def test_server_poses_follow_the_client(runs):
    """test_comm_server.test_relative_pose_reconstruction on the port."""
    ct, st = runs["port"]
    sm, cm = st.handlers[0].map, ct.map
    matched = 0
    for key, cslot in cm.kf_slot_by_id.items():
        sslot = sm.kf_slot_by_id.get(key)
        if sslot is None:
            continue
        assert np.abs(cm.kf.Tcw[cslot].numpy() - sm.kf.Tcw[sslot].numpy()).max() < 0.05
        matched += 1
    assert matched >= 3


def test_server_assigns_unique_ids(runs):
    _, st = runs["port"]
    m = st.handlers[0].map
    uids = m.kf.unique_id.numpy()[m.kf.valid.numpy()]
    assert (uids > 0).all() and len(set(uids.tolist())) == len(uids)
    assert not st.watchdog.silent_modules() and "comm0" in st.watchdog.report()


def test_message_loss_tolerance(runs):
    ct, st = runs["lossy"]
    assert st.handlers[0].map.n_kfs >= ct.map.n_kfs


def test_reduced_stream_is_budgeted_and_changed_only(runs):
    """test_comm_server.test_reduced_stream_is_budgeted_and_changed_only on
    the port."""
    ct, st = runs["port"]
    cfg = T_CONFIG.comm
    ch = st.channel_for(0)
    ct.comm.tick(ct.map)
    msg = ch.server_recv()
    assert msg is not None and not msg.keyframes_red and not msg.map_points_red
    assert msg.closest_kf_id >= 0
    m = ct.map
    kf_id = max(ct.comm.acked_kf)
    slot = m.kf_slot_by_id[(kf_id, 0)]
    Tcw = m.kf.Tcw.clone()
    Tcw[slot, 0, 3] += 0.05
    m.kf = m.kf._replace(Tcw=Tcw)
    mp_id = max(ct.comm.acked_mp)
    mslot = m.mp_slot_by_id[(mp_id, 0)]
    Xw = m.mp.Xw.clone()
    Xw[mslot, 1] += 0.05
    m.mp = m.mp._replace(Xw=Xw)
    ct.comm.tick(m)
    msg = ch.server_recv()
    assert [r.kf_id for r in msg.keyframes_red] == [kf_id]
    assert [r.mp_id for r in msg.map_points_red] == [mp_id]
    assert len(msg.keyframes_red) <= cfg.client_kf_it_bound
    assert len(msg.map_points_red) <= cfg.client_mp_it_bound
    ch.client_send(msg)
    smap = st.handlers[0].map
    st.handlers[0].comm.tick()
    np.testing.assert_allclose(smap.kf.Tcw[smap.kf_slot_by_id[(kf_id, 0)]].numpy(),
                               m.kf.Tcw[slot].numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(smap.mp.Xw[smap.mp_slot_by_id[(mp_id, 0)]].numpy(),
                               m.mp.Xw[mslot].numpy(), rtol=0, atol=1e-4)


def _publish(comm_mod, config, m, slots):
    """One publish of ``slots`` by a fresh ClientComm; returns the message."""
    ch = comm_mod.Channel()
    cc = comm_mod.ClientComm(config=config, channel=ch, client_id=0)
    for s in slots:
        cc.on_new_keyframe(m, s)
    cc.tick(m)
    return ch.server_recv()


def _client_map(runs):
    cj, _ = runs["jax"]
    m = cj.map
    slots = [m.kf_slot_by_id[k] for k in sorted(m.kf_slot_by_id)]
    return m, slots


def test_client_messages_match_jax(runs):
    mj, slots = _client_map(runs)
    mt = convert.map_state_from_numpy(mj, T_CONFIG, "cpu")
    msg_j = _publish(jcomm, TEST_CONFIG, mj, slots)
    msg_t = _publish(tcomm, T_CONFIG, mt, slots)
    assert [k.kf_id for k in msg_t.keyframes] == [k.kf_id for k in msg_j.keyframes]
    for kt, kj in zip(msg_t.keyframes, msg_j.keyframes):
        assert (kt.pred_id, kt.parent_id, kt.client_id) == (kj.pred_id, kj.parent_id, kj.client_id)
        np.testing.assert_allclose(kt.Tcp, kj.Tcp, rtol=0, atol=POSE_ATOL)
        assert (kt.Tcpar is None) == (kj.Tcpar is None)
        if kj.Tcpar is not None:
            np.testing.assert_allclose(kt.Tcpar, kj.Tcpar, rtol=0, atol=POSE_ATOL)
        for name in ("xy", "angle", "octave", "desc", "feat_valid", "mp_ids"):
            a, b = getattr(kt, name), np.asarray(getattr(kj, name))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert kt.timestamp == kj.timestamp
    assert [p.mp_id for p in msg_t.map_points] == [p.mp_id for p in msg_j.map_points]
    for pt, pj in zip(msg_t.map_points, msg_j.map_points):
        assert pt.ref_kf_id == pj.ref_kf_id and pt.desc.dtype == pj.desc.dtype == np.uint32
        np.testing.assert_array_equal(pt.desc, pj.desc)
        np.testing.assert_allclose(pt.pos_ref, pj.pos_ref, rtol=0, atol=POSE_ATOL)
        np.testing.assert_allclose(pt.normal, pj.normal, rtol=0, atol=0)
        assert (pt.min_dist, pt.max_dist) == (pj.min_dist, pj.max_dist)
    assert msg_t.closest_kf_id == msg_j.closest_kf_id


def _serve(comm_mod, ms_mod, config, msgs, fusion=None, **map_kw):
    m = ms_mod.MapState.create(config, server=True, **map_kw)
    ch = comm_mod.Channel()
    sc = comm_mod.ServerComm(config=config, channel=ch, map=m, client_id=0)
    if fusion is not None:
        sc.compose_fusion_sim3(fusion)
    replies = []
    for msg in msgs:
        ch.client_send(msg)
        replies.append(sc.tick())
    return sc, replies


@pytest.mark.parametrize("scale", [None, 1.3])
def test_server_comm_matches_jax_on_one_stream(runs, scale):
    """One message stream, fed to both ServerComms: the keyframes arrive in
    two messages, newest first (the first defers), then a reduced update;
    with ``scale`` the stream crosses a fusion Sim3 of that scale."""
    mj, slots = _client_map(runs)
    msg = _publish(jcomm, TEST_CONFIG, mj, slots)
    first = dataclasses.replace(msg, keyframes=msg.keyframes[len(msg.keyframes) // 2:],
                                map_points=msg.map_points[: len(msg.map_points) // 2])
    second = dataclasses.replace(msg, keyframes=msg.keyframes[: len(msg.keyframes) // 2],
                                 map_points=msg.map_points[len(msg.map_points) // 2:])
    red = jcomm.MapMsg(sender_client_id=0, keyframes_red=[jcomm.KfRedMsg(
        kf_id=k.kf_id, client_id=0, Tcp=k.Tcp, pred_id=k.pred_id) for k in msg.keyframes[-2:]])
    fusion = None
    if scale is not None:
        fusion = np.eye(4)
        c, s_ = np.cos(0.2), np.sin(0.2)
        fusion[:3, :3] = scale * np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1]])
        fusion[:3, 3] = [0.4, -0.2, 0.1]
    msgs_t = [tcomm.MapMsg(**{f.name: getattr(m_, f.name) for f in dataclasses.fields(m_)})
              for m_ in (first, second, red)]
    sj, rj = _serve(jcomm, jms, TEST_CONFIG, (first, second, red), fusion)
    st, rt = _serve(tcomm, tms, T_CONFIG, msgs_t, fusion, device="cpu")
    for a, b in zip(rt, rj):
        assert (a.acks_kf, a.acks_mp, a.weak_ack_kf, a.weak_ack_mp) == \
            (b.acks_kf, b.acks_mp, b.weak_ack_kf, b.weak_ack_mp)
    # the newest half waits for its predecessors, then everything binds
    assert not rj[0].acks_kf and len(rj[1].acks_kf) == len(msg.keyframes)
    mj2, mt2 = sj.map, st.map
    assert mt2.kf_slot_by_id == mj2.kf_slot_by_id
    assert mt2.mp_slot_by_id == mj2.mp_slot_by_id
    np.testing.assert_allclose(mt2.kf.Tcw.numpy(), np.asarray(mj2.kf.Tcw), rtol=0,
                               atol=POSE_ATOL)
    np.testing.assert_allclose(mt2.mp.Xw.numpy(), np.asarray(mj2.mp.Xw), rtol=0,
                               atol=POSE_ATOL * 10)
    got = convert.map_state_to_numpy(mt2)
    for name in ("kf_id", "client_id", "mp_idx", "parent", "pred", "valid", "feat_valid",
                 "desc", "octave"):
        np.testing.assert_array_equal(getattr(got.kf, name), np.asarray(getattr(mj2.kf, name)),
                                      err_msg=name)
    for name in ("mp_id", "client_id", "ref_kf", "first_kf_id", "valid", "desc"):
        np.testing.assert_array_equal(getattr(got.mp, name), np.asarray(getattr(mj2.mp, name)),
                                      err_msg=name)
