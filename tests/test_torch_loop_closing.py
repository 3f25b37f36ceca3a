"""Port parity: models/loop_closing.py against the JAX package on
tests/test_loop_closing.py's drifted revisit.

- The JAX map (tests/synth_map.add_pass, two passes of an arc, the second
  drifted by D) is carried across with ``convert.map_state_from_numpy``;
  both closers run over the keyframes of both passes with
  ``run_gba_after_loop=False``, the port's RANSAC replaying JAX's draws
  from ``PRNGKey(42)``. Must match: the detection slot and candidate of
  every keyframe, ``n_loops_closed`` and the loop edges exactly; every
  keyframe pose within 1e-3 and every landmark within 1e-3 m; and
  test_drift_removed's limits hold on the port.
- ``chip_smoke.drifted_revisit`` (the numpy builder of the card's phase
  16, which has no JAX) builds the same map as ``add_pass``.
- The port alone with ``run_gba_after_loop=True`` on that map at a
  capacity whose dense W exceeds ``DENSE_W_MAX_BYTES`` (lowered in this
  test only), so the loop GBA runs the tile-stream solver on a sparse map
  (12 of 48 keyframes valid, most landmark slots empty), as it does at
  server capacity on the card: its cost falls and stays finite, nothing
  is reverted, and test_organic_chain_with_gba's bound holds.
- Where parity ends: on the same revisit with the second pass also at
  scale 0.9, the essential graph's start (captured at
  ``optimize_pose_graph``) is the JAX package's outside the corrected
  group and the JAX package's times the loop's scale inside it (the port
  keeps CorrectedSim3's scale; the JAX package projects it away).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from motioncheck_ccm_slam_tpu.models import database as jdb, loop_closing as jlc
from motioncheck_ccm_slam_tpu.models import vocabulary as jvoc
from motioncheck_ccm_slam_tpu_torch import convert
from motioncheck_ccm_slam_tpu_torch.models import database as tdb, gba as tgba
from motioncheck_ccm_slam_tpu_torch.models import loop_closing as tlc
from motioncheck_ccm_slam_tpu_torch.models import vocabulary as tvoc
from motioncheck_ccm_slam_tpu_torch.ops import ransac as transac
from motioncheck_ccm_slam_tpu_torch.solvers import ba_core, local_ba

import chip_smoke
from synth_map import arc_poses
from test_loop_closing import CONFIG
from test_torch_gba_driver import port_config
from test_torch_server import GeneratorDraws
import torch_one_thread  # noqa: F401 (torch on one thread)

T_CONFIG = port_config(CONFIG)
POSE_ATOL = 1e-3
XW_ATOL = 1e-3


def _build_jax_map():
    """test_loop_closing.drifted_revisit's map (its fixture body)."""
    import jax.numpy as jnp
    from motioncheck_ccm_slam_tpu.models import map_state as jms
    from motioncheck_ccm_slam_tpu.ops import lie as jlie
    from synth_map import SynthWorld, add_pass

    world = SynthWorld(CONFIG, n_points=400, seed=0)
    m = jms.MapState.create(CONFIG, server=False)
    poses, ts = arc_poses(6, step=0.25)
    slots1 = add_pass(m, world, poses, ts, kf_id_start=0, seed=1)
    D = np.asarray(jlie.se3_exp(jnp.asarray(
        np.array([0.0, 0.026, 0.0, 0.15, 0.05, 0.0], np.float32))))
    slots2 = add_pass(m, world, poses, [t + 10.0 for t in ts], kf_id_start=50,
                      lm_pose_error=D, seed=2)
    return m, slots1, slots2


def _spy_detect(closer, log):
    detect = closer.detect

    def spy(slot):
        cand = detect(slot)
        log.append((slot, cand))
        return cand

    closer.detect = spy


@functools.lru_cache(maxsize=1)
def _runs():
    m_j, slots1, slots2 = _build_jax_map()
    m_t = convert.map_state_from_numpy(m_j, T_CONFIG, "cpu")
    before = convert.map_state_to_numpy(m_t)
    jc = jlc.LoopCloser(config=CONFIG, map=m_j, run_gba_after_loop=False,
                        database=jdb.KeyFrameDatabase(vocab=jvoc.default_vocabulary(),
                                                      capacity=m_j.nk))
    tc = tlc.LoopCloser(config=T_CONFIG, map=m_t, run_gba_after_loop=False,
                        database=tdb.KeyFrameDatabase(vocab=tvoc.default_vocabulary(),
                                                      capacity=m_t.nk, device="cpu"))
    log_j, log_t = [], []
    _spy_detect(jc, log_j)
    _spy_detect(tc, log_t)
    closed_j = [jc.process_keyframe(s) for s in slots1 + slots2]
    draws = GeneratorDraws()
    draws.register(tc.generator, jax.random.PRNGKey(42))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transac, "_sample_indices", draws)
        closed_t = [tc.process_keyframe(s) for s in slots1 + slots2]
    return dict(jax=jc, port=tc, log_j=log_j, log_t=log_t, closed_j=closed_j,
                closed_t=closed_t, slots1=slots1, slots2=slots2, before=before,
                draws=draws)


@pytest.fixture(scope="module")
def runs():
    return _runs()


def test_same_detections_and_closure(runs):
    assert runs["log_t"] == runs["log_j"]
    assert runs["closed_t"] == runs["closed_j"] and any(runs["closed_j"])
    assert runs["port"].n_loops_closed == runs["jax"].n_loops_closed >= 1
    assert runs["port"].last_loop_kf_id == runs["jax"].last_loop_kf_id
    assert len(runs["draws"].calls) >= 1
    le_j = np.asarray(runs["jax"].map.kf.loop_edge)
    le_t = runs["port"].map.kf.loop_edge.numpy()
    np.testing.assert_array_equal(le_t, le_j)
    assert (le_t >= 0).sum() >= 2


def test_corrected_map_matches_jax(runs):
    mj, mt = runs["jax"].map, runs["port"].map
    np.testing.assert_allclose(mt.kf.Tcw.numpy(), np.asarray(mj.kf.Tcw), rtol=0, atol=POSE_ATOL)
    valid = np.asarray(mj.mp.valid)
    np.testing.assert_array_equal(mt.mp.valid.numpy(), valid)
    np.testing.assert_allclose(mt.mp.Xw.numpy()[valid], np.asarray(mj.mp.Xw)[valid], rtol=0,
                               atol=XW_ATOL)
    np.testing.assert_array_equal(mt.kf.mp_idx.numpy(), np.asarray(mj.kf.mp_idx))
    # the correction moved the revisit pass
    moved = np.abs(mt.kf.Tcw.numpy() - runs["before"].kf.Tcw).max()
    assert moved > 0.05


def _centre_errors(m, slots):
    poses, _ = arc_poses(6, step=0.25)
    T = m.kf.Tcw.numpy()
    return [float(np.linalg.norm(np.linalg.inv(T[s])[:3, 3] - np.linalg.inv(poses[k])[:3, 3]))
            for k, s in enumerate(slots)]


def test_drift_removed_on_the_port(runs):
    errs = _centre_errors(runs["port"].map, runs["slots2"])
    assert min(errs) < 0.08, errs
    assert np.mean(errs) < 0.16, errs


def test_chip_smoke_builder_matches_add_pass():
    """The card's phase 16 builds this map with numpy (no JAX there)."""
    m_j, slots1, slots2 = _build_jax_map()
    m_c, s1, s2, poses = chip_smoke.drifted_revisit(T_CONFIG, "cpu", server=False)
    assert (s1, s2) == (slots1, slots2)
    ref = convert.map_state_to_numpy(convert.map_state_from_numpy(m_j, T_CONFIG, "cpu"))
    got = convert.map_state_to_numpy(m_c)
    for block in ("kf", "mp"):
        for name, a in getattr(ref, block)._asdict().items():
            b = getattr(getattr(got, block), name)
            if a.dtype.kind == "f":
                # poses from the port's se3_exp (an ulp from JAX's) move
                # the noisy keypoints by up to ~0.02 px
                np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=f"{block}.{name}")
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"{block}.{name}")
    assert m_c.kf_slot_by_id == m_j.kf_slot_by_id
    assert m_c.mp_slot_by_id == m_j.mp_slot_by_id
    np.testing.assert_allclose(np.stack(poses), np.stack(arc_poses(6)[0]), rtol=0, atol=1e-5)


def _scaled_revisit():
    """The drifted revisit with the second pass also at scale 0.9: its
    landmarks moved by the Sim3 D, its poses SE3 in D's frame (the
    depths scaled), as a monocular map holds a scale-drifted pass."""
    import jax.numpy as jnp
    from motioncheck_ccm_slam_tpu.models import map_state as jms
    from motioncheck_ccm_slam_tpu.ops import lie as jlie
    from synth_map import SynthWorld, add_pass

    world = SynthWorld(CONFIG, n_points=400, seed=0)
    m = jms.MapState.create(CONFIG, server=False)
    poses, ts = arc_poses(6, step=0.25)
    add_pass(m, world, poses, ts, kf_id_start=0, seed=1)
    D = np.array(jlie.se3_exp(jnp.asarray(
        np.array([0.0, 0.026, 0.0, 0.15, 0.05, 0.0], np.float32))))
    D[:3, :3] *= SCALE_DRIFT
    slots2 = add_pass(m, world, poses, [t + 10.0 for t in ts], kf_id_start=50,
                      lm_pose_error=D, seed=2)
    rows = jnp.asarray(slots2)
    m.kf = m.kf._replace(Tcw=m.kf.Tcw.at[rows, :3, :].multiply(SCALE_DRIFT))
    return m


SCALE_DRIFT = 0.9


def test_scaled_loop_start_differs_from_jax_in_the_group_scale_only():
    """On a loop with scale drift the port starts the essential graph's
    corrected group from its Sim3 poses (ORB-SLAM2's CorrectedSim3), where
    the JAX package starts it from their SE3 projections [R, t/s]: the two
    starts agree outside the group, and inside it the port's is the JAX
    package's times the loop's scale s."""
    m_j = _scaled_revisit()
    m_t = convert.map_state_from_numpy(m_j, T_CONFIG, "cpu")
    jc = jlc.LoopCloser(config=CONFIG, map=m_j, run_gba_after_loop=False,
                        database=jdb.KeyFrameDatabase(vocab=jvoc.default_vocabulary(),
                                                      capacity=m_j.nk))
    tc = tlc.LoopCloser(config=T_CONFIG, map=m_t, run_gba_after_loop=False,
                        database=tdb.KeyFrameDatabase(vocab=tvoc.default_vocabulary(),
                                                      capacity=m_t.nk, device="cpu"))
    starts = {}

    def spy(tag, solve):
        def call(S_iw_init, *a, **kw):
            starts[tag] = np.asarray(S_iw_init, np.float64)
            return solve(S_iw_init, *a, **kw)
        return call

    slots = np.flatnonzero(np.asarray(m_j.kf.valid)).tolist()
    draws = GeneratorDraws()
    draws.register(tc.generator, jax.random.PRNGKey(42))
    sim3 = {}
    compute = tc.compute_sim3

    def keep_sim3(cur, cand):
        got = compute(cur, cand)
        if got is not None:
            sim3["S12"] = got[0].numpy().astype(np.float64)
        return got

    tc.compute_sim3 = keep_sim3
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlc.pose_graph, "optimize_pose_graph",
                   spy("jax", jlc.pose_graph.optimize_pose_graph))
        mp.setattr(tlc.pose_graph, "optimize_pose_graph",
                   spy("port", tlc.pose_graph.optimize_pose_graph))
        closed_j = [jc.process_keyframe(s) for s in slots]
        mp.setattr(transac, "_sample_indices", draws)
        closed_t = [tc.process_keyframe(s) for s in slots]
    assert closed_t == closed_j and any(closed_t)
    assert set(starts) == {"jax", "port"} and starts["jax"].shape == starts["port"].shape
    s = float(np.cbrt(np.linalg.det(sim3["S12"][:3, :3])))
    assert abs(np.log(s)) > 0.05, s
    Sj, St = starts["jax"], starts["port"]
    group = np.abs(St - Sj).reshape(len(St), -1).max(-1) > POSE_ATOL
    assert 0 < group.sum() < len(St), group
    np.testing.assert_allclose(St[~group], Sj[~group], rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(St[group][:, :3, :], s * Sj[group][:, :3, :], rtol=0,
                               atol=POSE_ATOL)


def _robust_cost(Tcw, Xw, obs, K):
    r, _, depth_ok = ba_core.reproject_residuals(Tcw, Xw, obs, K)
    chi2 = torch.sum(r * r, -1) * obs.inv_sigma2
    return float(local_ba._robust_cost(chi2, obs.valid & depth_ok))


def test_loop_gba_on_the_tile_solver_over_a_sparse_map():
    """test_organic_chain_with_gba on the port, its loop GBA on the
    tile-stream solver (the route server capacity takes on the card) over
    the map's 48 KF x 6144 landmark slots, of which 12 and ~800 are live."""
    cfg = T_CONFIG
    m, slots1, slots2, _ = chip_smoke.drifted_revisit(cfg, "cpu", server=False)
    C, L = m.nk, m.nm
    costs, results = [], []
    pick, run_gba = tgba._pick_solver, tgba.run_gba

    def pick_spy(*a, **kw):
        solver = pick(*a, **kw)
        assert solver is not None and solver.__qualname__.startswith("make_tile_gba")

        def timed(Tcw, Xw, obs, K, fixed_cam, fixed_lm, n_it=None):
            res = solver(Tcw, Xw, obs, K, fixed_cam, fixed_lm, n_it)
            costs.append((_robust_cost(Tcw, Xw, obs, K), float(res.cost)))
            return res
        return timed

    def gba_spy(*a, **kw):
        res = run_gba(*a, **kw)
        results.append(res)
        return res

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgba, "DENSE_W_MAX_BYTES", 6 * C * 3 * L * 4 - 1)
        mp.setattr(tgba, "_pick_solver", pick_spy)
        mp.setattr(tlc.gba_mod, "run_gba", gba_spy)
        closer = tlc.LoopCloser(config=cfg, map=m, run_gba_after_loop=True,
                                database=tdb.KeyFrameDatabase(vocab=tvoc.default_vocabulary(),
                                                              capacity=m.nk, device="cpu"))
        closed = [closer.process_keyframe(s) for s in slots1 + slots2]
    assert any(closed) and closer.n_loops_closed >= 1
    assert results and not results[0].reverted and not results[0].interrupted
    # each chunk's LM lowers the robust cost, which stays finite
    assert costs and all(np.isfinite(c0) and np.isfinite(c1) and c1 < c0 for c0, c1 in costs), \
        costs
    assert bool(torch.isfinite(m.kf.Tcw).all()) and bool(torch.isfinite(m.mp.Xw).all())
    errs = _centre_errors(m, slots2)
    assert np.mean(errs) < 0.08, errs
