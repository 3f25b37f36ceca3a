"""Port parity for the slice as a whole: the tile-stream GBA
(parallel/sharded_ba.make_tile_gba) and the dense-W solver
(solvers/local_ba.bundle_adjust) against the JAX package's, on the same
perturbed scenes (tests/test_tile_gba._perturbed), converted from numpy.

The JAX tile solver runs its Pallas kernels in interpret mode on the CPU;
the port's runs the kernels' plain versions (CPU tensors). Bounds for the
tile solver are those of the JAX package's own mesh-vs-single-device test
(tests/test_tile_gba.py:130-146): cost within 1e-3 relative, Tcw within
1e-3, Xw within 5e-3; the two sides differ in the JAX side's bf16 splits
(~2^-17) and in summation order, amplified over 5 LM iterations.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioncheck_ccm_slam_tpu.parallel import sharded_ba as jsb
from motioncheck_ccm_slam_tpu.solvers import local_ba as jlba
from motioncheck_ccm_slam_tpu_torch import convert
from motioncheck_ccm_slam_tpu_torch.parallel import sharded_ba as tsb
from motioncheck_ccm_slam_tpu_torch.solvers import local_ba as tlba

from test_ba import K
from test_tile_gba import _perturbed
import torch_one_thread  # noqa: F401 (torch on one thread)


def _scene(name):
    """(jax args, port args) of one perturbed scene."""
    if name == "full":
        rng = np.random.default_rng(5)
        Tcw, pts, obs, fc, fl, _, _ = _perturbed(rng, n_cams=6, n_pts=150)
    elif name == "reject":    # the scene of tests/test_tile_gba.py's reject test
        rng = np.random.default_rng(9)
        Tcw, pts, obs, fc, fl, _, _ = _perturbed(rng, n_cams=5, n_pts=100)
    else:   # invalid observations and a fixed landmark
        rng = np.random.default_rng(3)
        Tcw, pts, obs, fc, fl, _, _ = _perturbed(rng, n_cams=5, n_pts=90)
        valid = np.ones(obs.cam_idx.shape[0], bool)
        valid[rng.integers(0, valid.size, 40)] = False
        obs = obs._replace(valid=jnp.asarray(valid))
        fl = fl.at[7].set(True)
    jargs = (Tcw, pts, obs, K, fc, fl)
    Tcw_t, Xw_t, K_t, fc_t, fl_t = convert.gba_state_from_numpy(Tcw, pts, K, fc, fl, "cpu")
    targs = (Tcw_t, Xw_t, convert.ba_observations_from_numpy(obs, "cpu"), K_t, fc_t, fl_t)
    return jargs, targs


def _assert_close(rt, rj, cost_rtol=1e-3, t_atol=1e-3, x_atol=5e-3, inlier_agree=0.99):
    cj = float(rj.cost)
    assert abs(float(rt.cost) - cj) <= cost_rtol * max(cj, 1.0)
    assert float(np.abs(rt.Tcw.numpy() - np.asarray(rj.Tcw)).max()) < t_atol
    assert float(np.abs(rt.Xw.numpy() - np.asarray(rj.Xw)).max()) < x_atol
    assert np.mean(rt.obs_inlier.numpy() == np.asarray(rj.obs_inlier)) >= inlier_agree


@pytest.mark.parametrize("name", ["full", "invalid_fixed"])
def test_tile_gba_matches_jax(name):
    jargs, targs = _scene(name)
    rj = jsb.make_tile_gba(None, iterations=5, pcg_iters=20)(*jargs)
    rt = tsb.make_tile_gba(iterations=5, pcg_iters=20)(*targs)
    assert float(rt.cost) < float(tsb.make_tile_gba()(*targs, n_iterations=0).cost)
    _assert_close(rt, rj)


def test_tile_gba_zero_iterations_classifies_like_jax():
    """n_iterations=0 runs only the initial linearisation: its aux rows
    are the classification and the inlier cost."""
    jargs, targs = _scene("invalid_fixed")
    rj = jsb.make_tile_gba(None, pcg_iters=10)(*jargs, n_iterations=0)
    rt = tsb.make_tile_gba(pcg_iters=10)(*targs, n_iterations=0)
    np.testing.assert_array_equal(rt.obs_inlier.numpy(), np.asarray(rj.obs_inlier))
    np.testing.assert_array_equal(rt.Tcw.numpy(), np.asarray(jargs[0]))
    assert abs(float(rt.cost) - float(rj.cost)) <= 1e-4 * float(rj.cost)


def test_tile_gba_reject_branch_monotone():
    """From a converged optimum every further step is about rejected: the
    carried state and its classification stay consistent and the cost never
    rises (as tests/test_tile_gba.py's reject-branch test)."""
    _, (Tcw, Xw, obs, K_t, fc, fl) = _scene("reject")
    gba = tsb.make_tile_gba(pcg_iters=15)
    r0 = gba(Tcw, Xw, obs, K_t, fc, fl, n_iterations=8)
    r1 = gba(r0.Tcw, r0.Xw, obs, K_t, fc, fl, n_iterations=4)
    assert float(r1.cost) <= float(r0.cost) * (1.0 + 1e-5)
    assert float((r1.Tcw - r0.Tcw).abs().max()) < 5e-3
    r2 = gba(r1.Tcw, r1.Xw, obs, K_t, fc, fl, n_iterations=0)
    assert torch.equal(r1.obs_inlier, r2.obs_inlier)


def test_tile_gba_rejects_out_of_range_index():
    _, (Tcw, Xw, obs, K_t, fc, fl) = _scene("full")
    bad = obs._replace(lm_idx=obs.lm_idx.clone())
    bad.lm_idx[3] = Xw.shape[0]
    with pytest.raises(ValueError, match="out of range"):
        tsb.make_tile_gba()(Tcw, Xw, bad, K_t, fc, fl)


@pytest.mark.parametrize("outlier_pass_at", [None, 3])
def test_bundle_adjust_matches_jax(outlier_pass_at):
    """The dense-W solver, the tile solver's reference optimum: the same
    f32 arithmetic on both sides up to summation order and the Cholesky's.
    Near the optimum an LM step is accepted or rejected on cost differences
    at f32 noise, which can move the state by one small step (~5e-5 in Tcw
    on this scene), hence the bounds."""
    jargs, targs = _scene("full")
    Tcw, pts, obs, Kj, fc, fl = jargs
    rj = jlba.bundle_adjust(Tcw, pts, obs, Kj, fc, fixed_lm=fl, iterations=8,
                            outlier_pass_at=outlier_pass_at)
    Tcw_t, Xw_t, obs_t, K_t, fc_t, fl_t = targs
    rt = tlba.bundle_adjust(Tcw_t, Xw_t, obs_t, K_t, fc_t, fixed_lm=fl_t, iterations=8,
                            outlier_pass_at=outlier_pass_at)
    _assert_close(rt, rj, cost_rtol=1e-4, t_atol=2e-4, x_atol=1e-3, inlier_agree=1.0)


def test_tile_gba_reaches_dense_optimum():
    """The port's tile solver lands where the port's dense solver lands."""
    _, targs = _scene("full")
    rt = tsb.make_tile_gba(iterations=8, pcg_iters=30)(*targs)
    Tcw, Xw, obs, K_t, fc, fl = targs
    rd = tlba.bundle_adjust(Tcw, Xw, obs, K_t, fc, fixed_lm=fl, iterations=8)
    assert float(rt.cost) < float(rd.cost) * 1.10
    assert float((rt.Tcw - rd.Tcw).abs().max()) < 0.01


@pytest.mark.parametrize("n_cams", [100, 1024])
def test_ew_rtol_matches_jax(n_cams):
    cases = [(2.0, -1.0), (2.0, 8.0), (1e-9, 8.0), (8.0, 2.0)]
    for gnorm, g0 in cases:
        j = jsb._ew_rtol(jnp.float32(gnorm), jnp.float32(g0), n_cams)
        t = tsb._ew_rtol(torch.tensor(gnorm), torch.tensor(g0), n_cams)
        np.testing.assert_allclose(float(t), float(j), rtol=1e-6)
