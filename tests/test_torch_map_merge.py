"""Port parity: models/map_matching.py, models/map_merging.py and the
server's merge (``ServerSystem._merge``) against the JAX package.

- tests/test_map_matching.py's two cases on both packages, the JAX maps
  carried across with ``convert.map_state_from_numpy`` and the port's
  RANSAC replaying JAX's draws from ``PRNGKey(7)``: the single aliased
  hit merges on neither; the sustained overlap gives the same hits (at
  the same keyframes, Sim3 within 1e-4, the same fused landmark pairs and
  the same auxiliary hits).
- ``sim3_transform_map`` within 1e-5 and ``merge_maps``'s KF and MP slot
  maps equal, the merged blocks equal; ``seam_measurement`` and
  ``optimize_seam_essential_graph`` (test_sim3_guided's two-hit seam)
  within 1e-4.
- tests/test_merge_probation.py's probation ticks after a port
  ``ServerSystem._merge``: every handler's ``mp_tick`` equal to JAX's,
  and test_merge_probation's own rules hold on the port.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioncheck_ccm_slam_tpu.models import map_matching as jmm, map_merging as jmerge
from motioncheck_ccm_slam_tpu.models import map_state as jms
from motioncheck_ccm_slam_tpu.ops import lie as jlie
from motioncheck_ccm_slam_tpu.system.server import ServerSystem as JServer
from motioncheck_ccm_slam_tpu_torch import convert
from motioncheck_ccm_slam_tpu_torch.models import map_matching as tmm, map_merging as tmerge
from motioncheck_ccm_slam_tpu_torch.models.map_state import check_structure
from motioncheck_ccm_slam_tpu_torch.ops import ransac as transac
from motioncheck_ccm_slam_tpu_torch.system.server import ServerSystem as TServer

import test_merge_probation as tmp_
import test_sim3_guided as tsg
from synth_map import SynthWorld, add_pass, arc_poses
from test_map_matching import CONFIG, _build_map
from test_torch_gba_driver import port_config
from test_torch_server import GeneratorDraws
import torch_one_thread  # noqa: F401 (torch on one thread)

T_CONFIG = port_config(CONFIG)
S_ATOL = 1e-4


def _port(m, cfg=T_CONFIG):
    return convert.map_state_from_numpy(m, cfg, "cpu")


def _check_both(maps_j, query_slots, cfg=CONFIG, tcfg=T_CONFIG):
    """Run both matchers: map 0's KFs added, then map 1's checked in turn."""
    maps_t = {k: _port(m, tcfg) for k, m in maps_j.items()}
    jm = jmm.MapMatcher(config=cfg, maps=maps_j)
    tm = tmm.MapMatcher(config=tcfg, maps=maps_t)
    for s in np.flatnonzero(np.asarray(maps_j[0].kf.valid)):
        jm.add_keyframe(0, int(s))
        tm.add_keyframe(0, int(s))
    draws = GeneratorDraws()
    draws.register(tm.generator, jax.random.PRNGKey(7))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transac, "_sample_indices", draws)
        hits_t = [tm.check(1, s) for s in query_slots]
    hits_j = [jm.check(1, s) for s in query_slots]
    return hits_j, hits_t, maps_t


def _same_hit(ht, hj):
    assert (ht.map_id_cur, ht.map_id_match, ht.slot_cur, ht.slot_match) == \
        (hj.map_id_cur, hj.map_id_match, hj.slot_cur, hj.slot_match)
    np.testing.assert_allclose(ht.S_match_from_cur.numpy(), np.asarray(hj.S_match_from_cur),
                               rtol=0, atol=S_ATOL)
    np.testing.assert_array_equal(ht.mp_pairs, hj.mp_pairs)
    assert [(a, b) for a, b, _ in ht.aux] == [(a, b) for a, b, _ in hj.aux]
    for (_, _, St), (_, _, Sj) in zip(ht.aux, hj.aux):
        np.testing.assert_allclose(St.numpy(), np.asarray(Sj), rtol=0, atol=S_ATOL)


def test_single_aliased_hit_does_not_merge():
    """test_map_matching.test_single_aliased_hit_does_not_merge on both."""
    w1 = SynthWorld(CONFIG, n_points=400, seed=0)
    w2 = SynthWorld(CONFIG, n_points=400, seed=99)
    poses, ts = arc_poses(6, step=0.25)
    mA, _ = _build_map(w1, poses, ts, client_id=0, seed=1)
    mB = jms.MapState.create(CONFIG, server=False)
    slotsB = add_pass(mB, w2, poses[:3], ts[:3], client_id=1, kf_id_start=0, seed=2)
    alias = add_pass(mB, w1, poses[3:4], [ts[3] + 5.0], client_id=1, kf_id_start=10, seed=3,
                     chain_from=slotsB[-1])
    tail = add_pass(mB, w2, poses[4:], [t + 6.0 for t in ts[4:]], client_id=1,
                    kf_id_start=20, seed=4, chain_from=alias[-1])
    hits_j, hits_t, _ = _check_both({0: mA, 1: mB}, slotsB + alias + tail)
    assert all(h is None for h in hits_j)
    assert all(h is None for h in hits_t)


@functools.lru_cache(maxsize=1)
def _sustained():
    w1 = SynthWorld(CONFIG, n_points=400, seed=0)
    poses, ts = arc_poses(6, step=0.25)
    mA, _ = _build_map(w1, poses, ts, client_id=0, seed=1)
    mB, slotsB = _build_map(w1, poses, [t + 30.0 for t in ts], client_id=1, kf_id_start=0,
                            seed=5)
    maps_j = {0: mA, 1: mB}
    hits_j, hits_t, maps_t = _check_both(maps_j, slotsB)
    return maps_j, maps_t, hits_j, hits_t


def test_sustained_overlap_gives_the_same_hits():
    _, _, hits_j, hits_t = _sustained()
    assert [h is None for h in hits_t] == [h is None for h in hits_j]
    got = [(ht, hj) for ht, hj in zip(hits_t, hits_j) if hj is not None]
    assert got
    for ht, hj in got:
        _same_hit(ht, hj)
    hit = got[0][0]
    # test_map_matching's checks on the port's hit
    S = hit.S_match_from_cur.numpy()
    assert np.allclose(S[:3, :3], np.eye(3), atol=0.05) and np.linalg.norm(S[:3, 3]) < 0.1
    assert len(hit.mp_pairs) >= 15


def test_transform_and_merge_match_jax():
    """sim3_transform_map, then merge_maps of map 1 into map 0 with the
    hit's fused pairs, on both packages (a scaled, rotated alignment)."""
    maps_j, _, hits_j, _ = _sustained()
    hit = next(h for h in hits_j if h is not None)
    S = jlie.sim3_exp(jnp.asarray([[0.02, -0.05, 0.01, 0.3, -0.1, 0.2, 0.1]], jnp.float32))[0]
    S = S @ hit.S_match_from_cur
    mB_j, mA_j = jms.MapState(**{**maps_j[1].__dict__}), jms.MapState(**{**maps_j[0].__dict__})
    mB_j.kf_slot_by_id, mB_j.mp_slot_by_id = dict(mB_j.kf_slot_by_id), dict(mB_j.mp_slot_by_id)
    mA_j.kf_slot_by_id, mA_j.mp_slot_by_id = dict(mA_j.kf_slot_by_id), dict(mA_j.mp_slot_by_id)
    mB_t, mA_t = _port(mB_j), _port(mA_j)
    jmerge.sim3_transform_map(mB_j, S)
    tmerge.sim3_transform_map(mB_t, torch.from_numpy(np.asarray(S)))
    np.testing.assert_allclose(mB_t.kf.Tcw.numpy(), np.asarray(mB_j.kf.Tcw), rtol=0, atol=1e-5)
    np.testing.assert_allclose(mB_t.kf.Tcw_pre_gba.numpy(), np.asarray(mB_j.kf.Tcw_pre_gba),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(mB_t.mp.Xw.numpy(), np.asarray(mB_j.mp.Xw), rtol=0, atol=1e-5)
    _, kf_j, mp_j = jmerge.merge_maps(mB_j, mA_j, S, mp_fuse_pairs=hit.mp_pairs, config=CONFIG)
    _, kf_t, mp_t = tmerge.merge_maps(mB_t, mA_t, torch.from_numpy(np.asarray(S)),
                                      mp_fuse_pairs=hit.mp_pairs, config=T_CONFIG)
    assert kf_t == kf_j and mp_t == mp_j
    assert mA_t.kf_slot_by_id == mA_j.kf_slot_by_id
    assert mA_t.mp_slot_by_id == mA_j.mp_slot_by_id
    ref = convert.map_state_to_numpy(_port(mA_j))
    got = convert.map_state_to_numpy(mA_t)
    for block in ("kf", "mp"):
        for name, a in getattr(ref, block)._asdict().items():
            b = getattr(getattr(got, block), name)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-5, err_msg=f"{block}.{name}")
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"{block}.{name}")


def test_seam_graph_matches_jax():
    """test_sim3_guided's two-hit seam: the measurements and the solve."""
    cfg = tsg.CONFIG.replace(opt=tsg.OptParams(solver_iterations=15))
    tcfg = port_config(cfg)
    world = SynthWorld(cfg, n_points=400, seed=4)
    m = jms.MapState.create(cfg, server=False)
    poses, ts = arc_poses(6, step=0.4)
    slots_a = add_pass(m, world, poses, ts, client_id=0, kf_id_start=0, seed=5)
    th = np.deg2rad(2.0)
    E = np.eye(4, dtype=np.float32)
    E[:3, :3] = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]],
                         np.float32)
    E[:3, 3] = [0.15, 0.0, 0.10]
    slots_b = add_pass(m, world, poses, [t + 50.0 for t in ts], client_id=1, kf_id_start=100,
                       seed=6, lm_pose_error=E)
    E_sim3 = jlie.make_sim3(jnp.asarray(E[:3, :3]), jnp.asarray(E[:3, 3]), jnp.float32(1.0))
    mt = _port(m, tcfg)
    aligns = [(slots_b[0], slots_a[0], jnp.eye(4)), (slots_b[3], slots_a[3], jlie.sim3_inv(E_sim3))]
    edges_j, edges_t = [], []
    for b, a, A in aligns:
        meas_j = jmerge.seam_measurement(m.kf.Tcw[b], m.kf.Tcw[a], A)
        meas_t = tmerge.seam_measurement(mt.kf.Tcw[b], mt.kf.Tcw[a],
                                         torch.from_numpy(np.asarray(A, np.float32)))
        np.testing.assert_allclose(meas_t.numpy(), np.asarray(meas_j), rtol=0, atol=1e-5)
        edges_j.append((b, a, meas_j))
        edges_t.append((b, a, meas_t))
    jmerge.optimize_seam_essential_graph(m, edges_j, slots_a[0], cfg)
    tmerge.optimize_seam_essential_graph(mt, edges_t, slots_a[0], tcfg)
    np.testing.assert_allclose(mt.kf.Tcw.numpy(), np.asarray(m.kf.Tcw), rtol=0, atol=S_ATOL)
    np.testing.assert_allclose(mt.mp.Xw.numpy(), np.asarray(m.mp.Xw), rtol=0, atol=S_ATOL)


def _probation_server(cls, **kw):
    """test_merge_probation's setup up to the hit, on one package."""
    cfg = kw.pop("cfg")
    server = cls(config=cfg, n_agents=2, **kw)
    for h in server.handlers.values():
        h.loop_closer.run_gba_after_loop = False
    return server


def test_probation_ticks_survive_merge_as_in_jax():
    cfg = tmp_.CONFIG
    tcfg = port_config(cfg)
    w1 = SynthWorld(cfg, n_points=400, seed=0)
    poses, ts = arc_poses(6, step=0.25)
    js = _probation_server(JServer, cfg=cfg)
    h0, h1 = js.handlers[0], js.handlers[1]
    slotsA = add_pass(h0.map, w1, poses, ts, client_id=0, kf_id_start=0, seed=1)
    slotsB = add_pass(h1.map, w1, poses, [t + 30.0 for t in ts], client_id=1, kf_id_start=0,
                      seed=5)
    ts_ = _probation_server(TServer, cfg=tcfg, device="cpu")
    for cid, h in ts_.handlers.items():
        m = _port(js.handlers[cid].map, tcfg)
        h.map = h.comm.map = h.loop_closer.map = ts_.matcher.maps[cid] = m
    for srv in (js, ts_):
        for cid, h in srv.handlers.items():
            h.mp_tick = np.full(h.map.nm, -1, np.int32)
        b_valid = np.flatnonzero(np.asarray(srv.handlers[1].map.mp.valid))
        srv.handlers[1].mp_tick[b_valid[:60]] = 7
        srv.handlers[1].n_kfs_processed = 8
        a_valid = np.flatnonzero(np.asarray(srv.handlers[0].map.mp.valid))
        srv.handlers[0].mp_tick[a_valid[:5]] = 3
        srv.matcher.maps[0], srv.matcher.maps[1] = srv.handlers[0].map, srv.handlers[1].map
        for s in slotsA:
            srv.matcher.add_keyframe(0, s)
    draws = GeneratorDraws()
    draws.register(ts_.matcher.generator, jax.random.PRNGKey(7))
    hit_j = hit_t = None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transac, "_sample_indices", draws)
        for s in slotsB:
            hit_j, hit_t = js.matcher.check(1, s), ts_.matcher.check(1, s)
            assert (hit_j is None) == (hit_t is None)
            if hit_j is not None:
                break
        assert hit_j is not None
        _same_hit(hit_t, hit_j)
        js._merge(hit_j)
        ts_._merge(hit_t)
    assert js.n_merges == ts_.n_merges == 1
    fused = ts_.handlers[0].map
    assert ts_.handlers[1].map is fused and ts_.matcher.maps[1] is fused
    assert set(fused.kf_slot_by_id) == set(js.handlers[0].map.kf_slot_by_id)
    for cid in (0, 1):
        np.testing.assert_array_equal(ts_.handlers[cid].mp_tick, js.handlers[cid].mp_tick)
    # test_merge_probation's rules on the port: carried mid-probation ticks
    tick1 = ts_.handlers[1].mp_tick
    cids = fused.mp.client_id.numpy()
    valid = fused.mp.valid.numpy()
    assert int(((tick1 == 7) & (cids == 1) & valid).sum()) >= 2
    # the match side sees the merged-in landmarks as exempt, not fresh
    assert (ts_.handlers[0].mp_tick[(cids == 1) & valid] == -2).all()
    assert not check_structure(fused)
