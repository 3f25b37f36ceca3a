"""Port parity: solvers/sim3_opt.py and solvers/pose_graph.py against the
JAX package on the same inputs.

- ``optimize_sim3`` on tests/test_sim3_guided.py's marginal revisit (the
  arguments JAX's loop closer hands it, captured): S within 1e-4, the
  inlier mask equal; with and without a fixed scale.
- ``optimize_pose_graph``: the dense and the CG route on test_pose_graph's
  drifted chain, and the CG route on a seeded ring of 240 vertices (above
  DENSE_MAX_V, so ``"auto"`` takes CG), each against JAX's dense route (the
  optimum: JAX's float32 block-Jacobi CG stops 0.077 short of it on the
  ring, where the port's float64 two-level PCG reaches it): S within 1e-4,
  the cost within 1e-4 relative (or 1e-9 absolute, where it ends near
  zero).
- ``make_edge_measurements``, ``correct_landmarks`` and ``se3_from_sim3``
  within 1e-5.

The port's Jacobians are forward-mode autodiff as JAX's ``jax.jacfwd``
(one jvp a coordinate); they agree with JAX's to float32 rounding.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioncheck_ccm_slam_tpu.models import database as jdb, loop_closing as jlc
from motioncheck_ccm_slam_tpu.models import vocabulary as jvoc
from motioncheck_ccm_slam_tpu.ops import lie as jlie
from motioncheck_ccm_slam_tpu.solvers import pose_graph as jpg, sim3_opt as jso
from motioncheck_ccm_slam_tpu_torch.solvers import pose_graph as tpg, sim3_opt as tso

from test_pose_graph import _chain_problem
from test_sim3_guided import CONFIG as SG_CONFIG, _marginal_revisit_map
import torch_one_thread  # noqa: F401 (torch on one thread)

S_ATOL = 1e-4
COST_RTOL = 1e-4


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module")
def sim3_args():
    """The arguments JAX's LoopCloser.compute_sim3 passes to optimize_sim3
    on the marginal revisit (the guided union of its matches)."""
    m, slots, rev = _marginal_revisit_map()
    lc = jlc.LoopCloser(config=SG_CONFIG, map=m,
                        database=jdb.KeyFrameDatabase(vocab=jvoc.default_vocabulary(),
                                                      capacity=m.nk))
    captured = {}
    real = jso.optimize_sim3

    def capture(*a, **kw):
        captured["args"], captured["kw"] = [np.asarray(x) for x in a], kw
        out = real(*a, **kw)
        captured["out"] = out
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlc.sim3_opt, "optimize_sim3", capture)
        got = lc.compute_sim3(rev, slots[1])
    assert got is not None and captured
    return captured


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3_matches_jax(sim3_args, fix_scale):
    a = sim3_args["args"]
    j = jso.optimize_sim3(*[jnp.asarray(x) for x in a], fix_scale=fix_scale)
    t = tso.optimize_sim3(*[_t(x) for x in a], fix_scale=fix_scale)
    np.testing.assert_allclose(t.S12.numpy(), np.asarray(j.S12), rtol=0, atol=S_ATOL)
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    assert int(t.n_inliers) == int(j.n_inliers) >= 20
    if not fix_scale:   # the loop closer's own call
        np.testing.assert_allclose(np.asarray(j.S12), np.asarray(sim3_args["out"].S12),
                                   rtol=0, atol=0)


def _edges_t(edges):
    return tpg.PoseGraphEdges(i=_t(edges.i, torch.int64), j=_t(edges.j, torch.int64),
                              S_ji_meas=_t(edges.S_ji_meas), weight=_t(edges.weight),
                              valid=_t(edges.valid))


def _ring_problem(V=240, seed=0):
    """A closed ring of V poses with seeded noise on each estimate; edges
    from each vertex to the three before it (odometry and covisibility, as
    an essential graph has), measured from the truth with seeded noise,
    Sim3 scale included; vertex 0 fixed."""
    rng = np.random.default_rng(seed)
    th = 2 * np.pi * np.arange(V) / V
    xi_true = np.zeros((V, 7), np.float32)
    xi_true[:, 1] = th
    xi_true[:, 3] = 10 * np.cos(th)
    xi_true[:, 5] = 10 * np.sin(th)
    S_true = jlie.sim3_exp(jnp.asarray(xi_true))
    noise = rng.normal(0, [0.01] * 3 + [0.05] * 3 + [0.01], (V, 7)).astype(np.float32)
    noise[0] = 0
    S_est = jlie.sim3_exp(jnp.asarray(noise)) @ S_true
    ei = np.tile(np.arange(V), 3).astype(np.int32)
    ej = np.concatenate([(np.arange(V) - k) % V for k in (1, 2, 3)]).astype(np.int32)
    E = len(ei)
    meas = jpg.make_edge_measurements(S_true, jnp.asarray(ei), jnp.asarray(ej))
    meas_noise = rng.normal(0, 0.002, (E, 7)).astype(np.float32)
    meas = jlie.sim3_exp(jnp.asarray(meas_noise)) @ meas
    weight = rng.uniform(0.5, 2.0, E).astype(np.float32)
    valid = np.ones(E, bool)
    valid[V // 3] = False
    edges = jpg.PoseGraphEdges(i=jnp.asarray(ei), j=jnp.asarray(ej), S_ji_meas=meas,
                               weight=jnp.asarray(weight), valid=jnp.asarray(valid))
    return S_est, edges, jnp.zeros(V, bool).at[0].set(True)


PROBLEMS = {
    "dense_chain": lambda: _chain_problem(V=40)[1:],
    "cg_ring": _ring_problem,
}


@pytest.mark.parametrize("name, method", [("dense_chain", "dense"), ("dense_chain", "cg"),
                                          ("cg_ring", "auto")])
def test_optimize_pose_graph_matches_jax(name, method):
    S0, edges, fixed = PROBLEMS[name]()
    V = S0.shape[0]
    if name == "cg_ring":
        assert V > tpg.DENSE_MAX_V == jpg.DENSE_MAX_V
    j = jpg.optimize_pose_graph(S0, edges, fixed, iterations=10, method="dense")
    t = tpg.optimize_pose_graph(_t(S0), _edges_t(edges), _t(fixed), iterations=10,
                                method=method)
    np.testing.assert_allclose(t.S_iw.numpy(), np.asarray(j.S_iw), rtol=0, atol=S_ATOL)
    cj, ct = float(j.cost), float(t.cost)
    assert abs(ct - cj) <= max(COST_RTOL * cj, 1e-9), (ct, cj)
    c0 = float(jpg._edge_cost(S0, edges, jlie.sim3_inv(edges.S_ji_meas)))
    assert cj < c0   # the solve did something


def test_edge_terms_match_jax():
    """Residuals within 1e-5 and the forward-mode Jacobians of every edge
    within 1e-4 of each array's max-abs (the derivative rules of the
    Sim3 log round differently in the two autodiffs: up to 2.1e-5 on a
    max-abs of 1.02 on the ring), on the chain, where many residuals are
    exactly zero, and on the ring."""
    for S0, edges, _ in (_chain_problem(V=40)[1:], _ring_problem(V=60)):
        mi = jlie.sim3_inv(edges.S_ji_meas)
        r, Ji, Jj, w, cost = jpg._edge_terms(S0, edges, mi)
        rt, Jit, Jjt, wt, cost_t = tpg._edge_terms(_t(S0), _edges_t(edges), _t(mi))
        for a, b, tol in ((rt, r, 1e-5), (Jit, Ji, 1e-4), (Jjt, Jj, 1e-4), (wt, w, 0)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=tol * np.abs(b).max())
        assert abs(float(cost_t) - float(cost)) <= 1e-5 * float(cost) + 1e-9


def test_landmark_correction_and_projection_match_jax():
    rng = np.random.default_rng(3)
    V, L = 12, 300
    xi0 = rng.normal(0, 0.3, (V, 7)).astype(np.float32)
    xi1 = xi0 + rng.normal(0, 0.05, (V, 7)).astype(np.float32)
    Sb, Sa = jlie.sim3_exp(jnp.asarray(xi0)), jlie.sim3_exp(jnp.asarray(xi1))
    Xw = rng.normal(0, 3, (L, 3)).astype(np.float32)
    ref = rng.integers(0, V, L).astype(np.int32)
    j = jpg.correct_landmarks(jnp.asarray(Xw), jnp.asarray(ref), Sb, Sa)
    t = tpg.correct_landmarks(_t(Xw), _t(ref, torch.int64), _t(Sb), _t(Sa))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tpg.se3_from_sim3(_t(Sa)).numpy(),
                               np.asarray(jpg.se3_from_sim3(Sa)), rtol=0, atol=1e-5)
    ei, ej = np.arange(1, V).astype(np.int32), np.arange(0, V - 1).astype(np.int32)
    np.testing.assert_allclose(
        tpg.make_edge_measurements(_t(Sb), _t(ei, torch.int64), _t(ej, torch.int64)).numpy(),
        np.asarray(jpg.make_edge_measurements(Sb, jnp.asarray(ei), jnp.asarray(ej))),
        rtol=0, atol=1e-5)
