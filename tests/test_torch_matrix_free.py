"""Port parity for the matrix-free GBA (parallel/sharded_ba.
make_matrix_free_gba) and its kernels' plain versions: K8 ``d0_cost``, K9
``expand_sorted_streams`` and the plan-form ``apply_a``, ``apply_b`` and
``schur_apply`` (ops/schur_cuda.py), against the JAX package's
(ops/schur_pallas.py in interpret mode on the CPU).

The kernel tests reuse tests/test_torch_schur.py's two scenes (C=5 and
C=130, invalid observations, fixed cameras and a fixed landmark) and its
plans and inputs. Tolerances:

- K9 within 1e-6 of each stream's max-abs: it moves data, and the JAX
  side's three-term bf16 split of the poses and points is exact to f32
  roundoff;
- K8 within 1e-5 relative: the same per-slot arithmetic, summed in another
  order; the port's K8 equals the sum of its K3's per-slot cost exactly;
- the plan-form products within 1e-4 of each output's max-abs (the JAX
  side gathers v and u through two-term bf16 splits, ~2^-17 relative, and
  sums in another order), as for K6/K7 in tests/test_torch_schur.py.

The solver is held against the JAX one with its fused Schur path forced
on (``sharded_ba.PALLAS_SCHUR = "1"``, as tests/test_schur_pallas.py does)
on that test's 8-camera scene, with its bounds: Tcw within 5e-3 and the
final cost within 2%.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioncheck_ccm_slam_tpu.ops import lie as jlie, schur_pallas
from motioncheck_ccm_slam_tpu.parallel import sharded_ba as jsb
from motioncheck_ccm_slam_tpu.solvers import ba_core as jba
from motioncheck_ccm_slam_tpu_torch import convert
from motioncheck_ccm_slam_tpu_torch.ops import schur_cuda
from motioncheck_ccm_slam_tpu_torch.parallel import sharded_ba as tsb
from motioncheck_ccm_slam_tpu_torch.solvers import ba_core as tba

from test_ba import K, synth_scene
from test_torch_gba import _scene as gba_scene
from test_torch_schur import SUM_TOL, _relerr, _t, scene  # noqa: F401  (fixture)
import torch_one_thread  # noqa: F401 (torch on one thread)

STREAM_TOL = 1e-6
COST_RTOL = 1e-5


def _jax_state(scene):
    Tcw = jnp.asarray(scene["Tcw"].numpy())
    Xw = jnp.asarray(scene["Xw_pad"][:scene["L"]].numpy())
    return Tcw, Xw


def test_expand_sorted_streams_matches_jax(scene):
    tp, sp = scene["tp_t"], scene["sp"]
    Tcw_j, Xw_j = _jax_state(scene)
    R, t, X = schur_cuda.expand_sorted_streams_ref(tp, scene["Tcw"],
                                                   scene["Xw_pad"][:scene["L"]])
    jR, jt, jX = schur_pallas.expand_sorted_streams(sp, Tcw_j, Xw_j)
    assert R.shape == (3, 3, tp.ntl * tp.TP)
    for a, b in ((R, jR), (t, jt), (X, jX)):
        assert _relerr(a, b) < STREAM_TOL


def test_d0_cost_matches_jax_and_k3(scene):
    tp, sp, st, C = scene["tp_t"], scene["sp"], scene["st"], scene["C"]
    pose = schur_cuda.pose_table(scene["Tcw"])
    args = (tp.camid, tp.lmloc, st.uv, st.is2, st.valid, st.kp, pose, scene["Xw_pad"])
    cost = schur_cuda.d0_cost_ref(*args, TP=tp.TP)
    Tcw_j, _ = _jax_state(scene)
    K4 = jnp.asarray(st.kp.numpy()).reshape(1, 4)
    t0, t1, t2 = schur_pallas.pose_tables(Tcw_j, sp.n_groups)
    X8 = schur_pallas.point_table(jnp.asarray(scene["Xw_pad"].numpy()).T, sp.L_pad)
    jcost = schur_pallas.d0_cost(sp.camid, sp.lmloc, jnp.asarray(st.uv.numpy()).T,
                                 jnp.asarray(st.is2.numpy())[None],
                                 jnp.asarray(st.valid.numpy())[None], K4, t0, t1, t2, X8,
                                 TP=sp.TP)
    assert abs(float(cost) - float(jcost)) <= COST_RTOL * float(jcost)
    aux = schur_cuda.d1_assemble_ref(tp.camid, tp.lmloc, st.uv, st.is2, st.valid, st.free,
                                     st.kp, pose, scene["Xw_pad"], TP=tp.TP)[1]
    assert float(cost) == float(torch.sum(aux[0]))
    # the wrapper routes a CPU tensor to the plain version
    assert float(schur_cuda.d0_cost(*args, TP=tp.TP)) == float(cost)


def test_plan_form_products_match_jax(scene):
    tp, sp, C = scene["tp_t"], scene["sp"], scene["C"]
    Wp, v, H9, u = (_t(scene[k]) for k in ("W18", "v", "H9", "u"))
    jW, jv, jH = (jnp.asarray(scene[k]) for k in ("W18", "v", "H9"))
    a = schur_cuda.apply_a_ref(tp, Wp, v, H9)
    assert a.shape == (3, sp.L_pad)
    assert _relerr(a, schur_pallas.apply_a(sp, jW, jv, jH)[0:3]) < SUM_TOL
    u8 = schur_pallas.point_table(jnp.asarray(scene["u"]), sp.L_pad)
    assert _relerr(schur_cuda.apply_b_ref(tp, Wp, u, C),
                   schur_pallas.apply_b(sp, jW, u8, C)) < SUM_TOL
    s = schur_cuda.schur_apply_ref(tp, Wp, v, H9)
    assert _relerr(s, schur_pallas.schur_apply(sp, jW, jv, jH)) < SUM_TOL
    # the wrappers route CPU tensors to the plain versions and count nothing
    n = (schur_cuda.apply_a.launches, schur_cuda.apply_b.launches,
         schur_cuda.schur_apply.launches)
    assert torch.equal(schur_cuda.schur_apply(tp, Wp, v, H9), s)
    assert torch.equal(schur_cuda.apply_a(tp, Wp, v, H9), a)
    assert n == (schur_cuda.apply_a.launches, schur_cuda.apply_b.launches,
                 schur_cuda.schur_apply.launches)


def test_sorted_segments_match_jax():
    idx = np.random.default_rng(0).integers(0, 40, 500)
    t, j = tba.build_sorted_segments(idx, 45), jba.build_sorted_segments(idx, 45)
    np.testing.assert_array_equal(t.order, np.asarray(j.order))
    np.testing.assert_array_equal(t.bounds, np.asarray(j.bounds))


def _eight_camera_scene():
    """tests/test_schur_pallas.py's scene: 8 cameras, 200 points, cameras
    1.. perturbed by 0.005 rad / 0.04 m, points by 0.05 m."""
    rng = np.random.default_rng(0)
    Tcw_true, pts_true, obs = synth_scene(rng, n_cams=8, n_pts=200, obs_noise=0.2)
    Tcw_init = np.asarray(Tcw_true).copy()
    for c in range(1, 8):
        xi = np.zeros(6, np.float32)
        xi[:3] = rng.normal(0, 0.005, 3)
        xi[3:] = rng.normal(0, 0.04, 3)
        Tcw_init[c] = np.asarray(jlie.se3_exp(jnp.asarray(xi))) @ Tcw_init[c]
    pts_init = np.asarray(pts_true) + rng.normal(0, 0.05, pts_true.shape).astype(np.float32)
    fixed_cam = np.zeros(8, bool)
    fixed_cam[0] = True
    return Tcw_init, pts_init, obs, fixed_cam, np.zeros(200, bool)


def test_matrix_free_gba_matches_jax(monkeypatch):
    Tcw, pts, obs, fc, fl = _eight_camera_scene()
    monkeypatch.setattr(jsb, "PALLAS_SCHUR", "1")
    rj = jsb.make_matrix_free_gba(iterations=8, pcg_iters=30)(
        jnp.asarray(Tcw), jnp.asarray(pts), obs, K, jnp.asarray(fc), jnp.asarray(fl))
    Tcw_t, Xw_t, K_t, fc_t, fl_t = convert.gba_state_from_numpy(Tcw, pts, K, fc, fl, "cpu")
    obs_t = convert.ba_observations_from_numpy(obs, "cpu")
    gba = tsb.make_matrix_free_gba(iterations=8, pcg_iters=30)
    rt = gba(Tcw_t, Xw_t, obs_t, K_t, fc_t, fl_t)
    assert np.abs(rt.Tcw.numpy() - np.asarray(rj.Tcw)).max() < 5e-3
    assert abs(float(rt.cost) - float(rj.cost)) / max(float(rj.cost), 1.0) < 0.02
    assert np.mean(rt.obs_inlier.numpy() == np.asarray(rj.obs_inlier)) > 0.99
    r0 = gba(Tcw_t, Xw_t, obs_t, K_t, fc_t, fl_t, n_iterations=0)
    assert float(r0.cost) > float(rt.cost)


@pytest.mark.parametrize("name", ["full", "invalid_fixed"])
def test_matrix_free_gba_lands_with_the_tile_gba(name):
    """On tests/test_torch_gba.py's perturbed scenes (one with invalid
    observations, which the plan leaves out, and a fixed landmark) the two
    port solvers land together, within the JAX package's mesh-vs-single
    bounds: cost 1e-3 relative, Tcw 1e-3, Xw 5e-3."""
    _, targs = gba_scene(name)
    rm = tsb.make_matrix_free_gba(iterations=6, pcg_iters=30)(*targs)
    rt = tsb.make_tile_gba(iterations=6, pcg_iters=30)(*targs)
    assert abs(float(rm.cost) - float(rt.cost)) <= 1e-3 * float(rt.cost)
    assert float((rm.Tcw - rt.Tcw).abs().max()) < 1e-3
    assert float((rm.Xw - rt.Xw).abs().max()) < 5e-3
    assert torch.equal(rm.obs_inlier, rt.obs_inlier)


def test_matrix_free_plan_rebuilt_for_a_new_mask():
    _, (Tcw, Xw, obs, K_t, fc, fl) = gba_scene("full")
    O, C = obs.cam_idx.shape[0], Tcw.shape[0]
    mp = tsb.build_matrix_free_plan(obs, C, Xw.shape[0])
    assert mp.seg * C == O and int(mp.bounds[-1]) == mp.sp.ntl * mp.sp.TP
    # every valid observation appears once in the tile stream
    real = mp.to_orig[mp.to_orig < O]
    assert torch.equal(torch.sort(real).values, torch.arange(O))
    fewer = obs._replace(valid=obs.valid.clone())
    fewer.valid[::3] = False
    mp2 = tsb.build_matrix_free_plan(fewer, C, Xw.shape[0])
    assert int((mp2.to_orig < O).sum()) == int(fewer.valid.sum())
    assert O % (C + 1)
    with pytest.raises(ValueError, match="camera-major"):
        tsb.build_matrix_free_plan(obs, C + 1, Xw.shape[0])
    shuffled = obs._replace(cam_idx=obs.cam_idx.flip(0))
    with pytest.raises(ValueError, match="camera-major"):
        tsb.build_matrix_free_plan(shuffled, C, Xw.shape[0])
