"""Port parity: models/mapping.py and the map-state reductions it uses,
against the JAX package on the same maps.

- One ``LocalMapper.process_keyframe`` on the same tracked frame, from a
  JAX client map after its two-view initialization (the JAX run of
  test_torch_client.py, on test_client_e2e's configuration and scene: the
  map and frame of its first mapped keyframe, carried across with
  ``convert.map_state_from_numpy``), stage by stage: the covis neighbours,
  the cull count and survivors, the triangulated landmarks (count and
  association equal, Xw within 1e-4 m), the fuse's claims and
  replacements, the descriptor refresh (descriptors bitwise, normals and
  scale ranges within 1e-5), the trim count and survivors, and the local
  BA: which observations it drops, equal; poses within 1e-4; each landmark
  where every valid KF sees it within 2e-3 px (the BA's inlier gate is
  2.4 px), its depth within 1e-2 relative. The depth is the ill-posed
  direction: the KFs are consecutive frames ~4.5 cm apart at a median
  depth of 1 (after the scale normalization), so a landmark's depth is
  ~100x less determined than its image position (JAX and the port differ
  by up to 1.2e-3 px and 3.3e-3 in depth). Once with the default map size
  and once with a 2-KF window, so that the trim runs.
- Covisibility (full matrix, one row, rows) exactly; the structure checker
  and its repair.
- ``replace_map_points``, ``fuse_neighbors`` and the server's culls on the
  maps of tests/test_fuse_replace.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioncheck_ccm_slam_tpu.config import MappingParams
from motioncheck_ccm_slam_tpu.models import map_state as jms, mapping as jmapping
from motioncheck_ccm_slam_tpu.ops import orb as jorb
from motioncheck_ccm_slam_tpu_torch import convert
from motioncheck_ccm_slam_tpu_torch.models import map_state as tms, mapping as tmapping
from motioncheck_ccm_slam_tpu_torch.models.frame import Frame as TFrame

from synth_map import SynthWorld, add_pass, arc_poses
from test_client_e2e import TEST_CONFIG
from test_fuse_replace import CONFIG as FUSE_CONFIG
from test_torch_client import jax_run  # noqa: F401 (a fixture)
from test_torch_gba_driver import port_config
import torch_one_thread  # noqa: F401 (torch on one thread)

BA_POSE_ATOL = 1e-4
BA_PX_ATOL = 2e-3
BA_DEPTH_RTOL = 1e-2
NEW_XW_ATOL = 1e-4


def to_port(m, cfg):
    return convert.map_state_from_numpy(m, port_config(cfg), "cpu")


def frame_to_port(fr):
    return TFrame(frame_id=fr.frame_id, timestamp=fr.timestamp,
                  feats=convert.orb_features_from_numpy(jax.tree.map(np.asarray, fr.feats), "cpu"),
                  Tcw=convert.pose_from_numpy(fr.Tcw, "cpu"),
                  mp_idx=torch.from_numpy(np.asarray(fr.mp_idx).astype(np.int64)),
                  n_tracked=fr.n_tracked)


def snapshot(m):
    """The map's blocks as numpy, descriptors as uint32."""
    if isinstance(m.kf.Tcw, torch.Tensor):
        return convert.kf_block_to_numpy(m.kf), convert.mp_block_to_numpy(m.mp)
    return jax.tree.map(np.asarray, m.kf), jax.tree.map(np.asarray, m.mp)


STAGES = ("covis_neighbors_of", "cull_map_points", "create_new_map_points", "fuse_neighbors",
          "map_trimming", "run_local_ba")


def record_stages(mod, monkeypatch):
    """Wrap each stage of ``mod.LocalMapper.process_keyframe``: its value
    and the map after it (the map before the trim holds the refreshed
    descriptors)."""
    rec = {}
    for name in STAGES:
        fn = getattr(mod, name)

        def wrapped(m, *a, _fn=fn, _name=name, **kw):
            if _name == "map_trimming":
                rec["refreshed"] = snapshot(m)
            out = _fn(m, *a, **kw)
            rec[_name] = (None if _name == "run_local_ba" else out, snapshot(m))
            return out

        monkeypatch.setattr(mod, name, wrapped)
    return rec


@pytest.mark.parametrize("window", [None, 2], ids=["default", "trim"])
def test_process_keyframe_matches_jax(jax_run, monkeypatch, window):
    first = jax_run["jax_first_kf"]
    fr, ids, m0 = first["frame"], first["ids"], first["map"]
    assert m0.n_kfs == 2
    cfg = TEST_CONFIG if window is None else TEST_CONFIG.replace(
        mapping=MappingParams(local_map_size=window, local_map_buffer=0))
    m_t = to_port(m0, cfg)
    m_j = dataclasses.replace(m0, kf_slot_by_id=dict(m0.kf_slot_by_id),
                              mp_slot_by_id=dict(m0.mp_slot_by_id))
    rec_j = record_stages(jmapping, monkeypatch)
    rec_t = record_stages(tmapping, monkeypatch)
    slot_j = jmapping.LocalMapper(config=cfg, map=m_j, **ids).process_keyframe(fr)
    slot_t = tmapping.LocalMapper(config=port_config(cfg), map=m_t, **ids).process_keyframe(
        frame_to_port(fr))
    assert slot_t == slot_j

    nbs_t, nbs_j = rec_t["covis_neighbors_of"][0], rec_j["covis_neighbors_of"][0]
    assert nbs_t == nbs_j and len(nbs_j) >= 1
    for name in ("cull_map_points", "create_new_map_points", "fuse_neighbors", "map_trimming"):
        assert rec_t[name][0] == rec_j[name][0], name
        (kf_t, mp_t), (kf_j, mp_j) = rec_t[name][1], rec_j[name][1]
        np.testing.assert_array_equal(kf_t.mp_idx, kf_j.mp_idx, err_msg=name)
        np.testing.assert_array_equal(kf_t.valid, kf_j.valid, err_msg=name)
        np.testing.assert_array_equal(mp_t.valid, mp_j.valid, err_msg=name)
    n_created = rec_j["create_new_map_points"][0][0]
    assert n_created > 10
    if window == 2:
        assert rec_j["map_trimming"][0] == 1
    # the triangulated landmarks, before any BA touches them
    (_, mp_t), (_, mp_j) = rec_t["create_new_map_points"][1], rec_j["create_new_map_points"][1]
    new = mp_j.valid & (mp_j.first_kf_id == ids["next_kf_id"])
    assert new.sum() == n_created
    np.testing.assert_allclose(mp_t.Xw[new], mp_j.Xw[new], rtol=0, atol=NEW_XW_ATOL)
    np.testing.assert_array_equal(mp_t.desc[new], mp_j.desc[new])
    # the refreshed statistics
    (_, mp_t), (_, mp_j) = rec_t["refreshed"], rec_j["refreshed"]
    v = mp_j.valid
    np.testing.assert_array_equal(mp_t.desc[v], mp_j.desc[v])
    np.testing.assert_array_equal(mp_t.ref_kf[v], mp_j.ref_kf[v])
    for k in ("normal", "min_dist", "max_dist"):
        np.testing.assert_allclose(getattr(mp_t, k)[v], getattr(mp_j, k)[v], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    # the local BA
    (kf_t, mp_t), (kf_j, mp_j) = rec_t["run_local_ba"][1], rec_j["run_local_ba"][1]
    np.testing.assert_array_equal(kf_t.mp_idx, kf_j.mp_idx)
    np.testing.assert_allclose(kf_t.Tcw[kf_j.valid], kf_j.Tcw[kf_j.valid], rtol=0,
                               atol=BA_POSE_ATOL)
    v = mp_j.valid
    K = TEST_CONFIG.camera.K()
    for s in np.flatnonzero(kf_j.valid):
        pc_t = mp_t.Xw[v] @ kf_t.Tcw[s, :3, :3].T + kf_t.Tcw[s, :3, 3]
        pc_j = mp_j.Xw[v] @ kf_j.Tcw[s, :3, :3].T + kf_j.Tcw[s, :3, 3]
        np.testing.assert_allclose(pc_t[:, :2] / pc_t[:, 2:] * K[0, 0],
                                   pc_j[:, :2] / pc_j[:, 2:] * K[0, 0], rtol=0, atol=BA_PX_ATOL)
        np.testing.assert_allclose(pc_t[:, 2], pc_j[:, 2], rtol=BA_DEPTH_RTOL, atol=0)


def test_covisibility_and_structure_match_jax(jax_run):
    m_j = jax_run["jax_first_kf"]["map"]
    m_t = to_port(m_j, TEST_CONFIG)
    W_j = np.asarray(jms.covisibility(m_j.kf, m_j.nm))
    W_t = tms.covisibility(m_t.kf, m_t.nm).numpy()
    np.testing.assert_array_equal(W_t, W_j)
    assert W_j.max() > 100
    slots = sorted(m_j.kf_slot_by_id.values())
    for s in slots:
        np.testing.assert_array_equal(tms.covisibility_row(m_t.kf, m_t.nm, s).numpy(),
                                      np.asarray(jms.covisibility_row(m_j.kf, m_j.nm, s)))
    np.testing.assert_array_equal(tms.covisibility_rows(m_t.kf, m_t.nm, slots).numpy(),
                                  np.asarray(jms.covisibility_rows(m_j.kf, m_j.nm, slots)))
    np.testing.assert_array_equal(tms.observation_membership(m_t.kf, m_t.nm).numpy(),
                                  np.asarray(jms.observation_membership(m_j.kf, m_j.nm)))
    # the descriptor refresh on the initial map, with a landmark seen by
    # more than max_obs features (ties in the medoid go to the first)
    sf = jorb.scale_factors(TEST_CONFIG.extractor)
    mp_j = jax.tree.map(np.asarray, jms.update_mp_descriptors_and_normals(m_j.kf, m_j.mp, sf,
                                                                          max_obs=1))
    mp_t = convert.mp_block_to_numpy(tms.update_mp_descriptors_and_normals(m_t.kf, m_t.mp, sf,
                                                                          max_obs=1))
    np.testing.assert_array_equal(mp_t.desc, mp_j.desc)
    assert tms.check_structure(m_t) == jms.check_structure(m_j) == []
    # break it: a dead landmark still observed, a dead parent, a dead ref KF
    live = np.flatnonzero(np.asarray(m_j.mp.valid))[:3]
    dead_kf = slots[0]
    broken = dataclasses.replace(
        m_j,
        mp=m_j.mp._replace(valid=m_j.mp.valid.at[live[0]].set(False)),
        kf=m_j.kf._replace(valid=m_j.kf.valid.at[dead_kf].set(False),
                           mp_idx=m_j.kf.mp_idx.at[dead_kf].set(-1)))
    broken_t = to_port(broken, TEST_CONFIG)
    p_j = jms.check_structure(broken, repair=True)
    p_t = tms.check_structure(broken_t, repair=True)
    assert p_t == p_j and len(p_j) >= 3
    kf_j, mp_j = snapshot(broken)
    kf_t, mp_t = snapshot(broken_t)
    for a, b in ((kf_t.mp_idx, kf_j.mp_idx), (kf_t.parent, kf_j.parent),
                 (kf_t.pred, kf_j.pred), (mp_t.ref_kf, mp_j.ref_kf)):
        np.testing.assert_array_equal(a, b)


def _arc_map(n_kf, n_points, world_seed, pass_seed, step=0.2):
    m = jms.MapState.create(FUSE_CONFIG, server=False)
    world = SynthWorld(FUSE_CONFIG, n_points=n_points, seed=world_seed)
    poses, ts = arc_poses(n_kf, step=step)
    slots = add_pass(m, world, poses, ts, kf_id_start=0, seed=pass_seed)
    return m, world, poses, ts, slots


def _assert_maps_equal(m_t, m_j):
    (kf_t, mp_t), (kf_j, mp_j) = snapshot(m_t), snapshot(m_j)
    for k in ("mp_idx", "valid", "parent", "feat_valid"):
        np.testing.assert_array_equal(getattr(kf_t, k), getattr(kf_j, k), err_msg=k)
    for k in ("valid", "n_visible", "n_found"):
        np.testing.assert_array_equal(getattr(mp_t, k), getattr(mp_j, k), err_msg=k)
    assert m_t.mp_slot_by_id == m_j.mp_slot_by_id
    assert m_t.kf_slot_by_id == m_j.kf_slot_by_id


def test_replace_map_points_matches_jax():
    m_j, *_, slots = _arc_map(3, 60, 1, 2)
    m_t = to_port(m_j, FUSE_CONFIG)
    row = np.asarray(m_j.kf.mp_idx)[slots[0]]
    obs = row[row >= 0]
    pairs = [(int(obs[0]), int(obs[1])), (int(obs[2]), int(obs[3])), (int(obs[1]), int(obs[3]))]
    assert tmapping.replace_map_points(m_t, pairs) == jmapping.replace_map_points(m_j, pairs) == 3
    _assert_maps_equal(m_t, m_j)


def test_fuse_neighbors_matches_jax():
    """test_fuse_replace's loop duplicates: two passes over one world."""
    world = SynthWorld(FUSE_CONFIG, n_points=300, seed=0)
    m_j = jms.MapState.create(FUSE_CONFIG, server=False)
    poses, ts = arc_poses(4, step=0.2)
    s1 = add_pass(m_j, world, poses, ts, kf_id_start=0, seed=1)
    s2 = add_pass(m_j, world, poses, [t + 10 for t in ts], kf_id_start=50, seed=2,
                  chain_from=s1[-1])
    m_t = to_port(m_j, FUSE_CONFIG)
    out_j = jmapping.fuse_neighbors(m_j, s2, FUSE_CONFIG)
    out_t = tmapping.fuse_neighbors(m_t, s2, port_config(FUSE_CONFIG))
    assert out_t == out_j and out_j[1] >= 50
    _assert_maps_equal(m_t, m_j)


def test_server_culls_match_jax():
    """test_fuse_replace's landmark probation and redundancy culling."""
    m_j, *_ = _arc_map(5, 200, 3, 4)
    m_t = to_port(m_j, FUSE_CONFIG)
    mp_tick = np.where(np.asarray(m_j.mp.valid), 1, -1).astype(np.int32)
    n_j = jmapping.cull_recent_mps_server(m_j, mp_tick, tick=4, client_id=0)
    n_t = tmapping.cull_recent_mps_server(m_t, mp_tick, tick=4, client_id=0)
    assert n_t == n_j > 0
    _assert_maps_equal(m_t, m_j)

    m_j, world, poses, ts, slots = _arc_map(5, 150, 5, 6, step=0.05)
    octv = np.asarray(m_j.kf.octave).copy()
    octv[slots[0]] = 3
    for s in slots[1:]:
        octv[s] = 0
    m_j.kf = m_j.kf._replace(octave=jnp.asarray(octv))
    m_t = to_port(m_j, FUSE_CONFIG)
    n_levels = FUSE_CONFIG.extractor.n_levels
    np.testing.assert_array_equal(
        tmapping._redundancy_kernel(m_t.kf, nm=m_t.nm, n_levels=n_levels).numpy(),
        np.asarray(jmapping._redundancy_kernel(m_j.kf, nm=m_j.nm, n_levels=n_levels)))
    cfg = FUSE_CONFIG.replace(mapping=MappingParams(redundancy_thres=0.5))
    n_j = jmapping.cull_redundant_keyframes(m_j, cfg, protect={slots[1]})
    n_t = tmapping.cull_redundant_keyframes(m_t, port_config(cfg), protect={slots[1]})
    assert n_t == n_j > 0
    _assert_maps_equal(m_t, m_j)
