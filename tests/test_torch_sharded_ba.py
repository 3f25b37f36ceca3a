"""Port parity for the multi-device GBA: ``solvers/ba_core``'s segment
plans, ``parallel/sharded_ba``'s shards (``make_sharded_gba``, the gather
formulation; ``make_tile_gba(devices=..., group=...)``), ``models/gba.
_pick_solver``'s mesh route and ``utils/bigmap``, against the JAX package
on the same seeded numpy inputs.

The JAX side's meshes are ``tests/conftest.py``'s virtual CPU devices (1
and 8); its tile solver runs the Pallas kernels in interpret mode, the
port's the kernels' plain versions (CPU tensors). Shards of the port are
``devices=["cpu"] * n`` in one process, or one a rank of a gloo group of
two processes (``chip_smoke.gba_child``) joined through a FileStore.
Bounds for the solvers are those of the JAX package's
``test_tile_gba_mesh_matches_single_device``: cost within 1e-3 relative,
Tcw within 1e-3, Xw within 5e-3 (summation order amplified over the LM
iterations); segment sums within 1e-6 of each output's max-abs.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

import chip_smoke

from motioncheck_ccm_slam_tpu.parallel import sharded_ba as jsb
from motioncheck_ccm_slam_tpu.solvers import ba_core as jbc
from motioncheck_ccm_slam_tpu.utils import bigmap as jbigmap
from motioncheck_ccm_slam_tpu_torch import convert
from motioncheck_ccm_slam_tpu_torch.models import gba as tgba
from motioncheck_ccm_slam_tpu_torch.parallel import sharded_ba as tsb
from motioncheck_ccm_slam_tpu_torch.solvers import ba_core as tbc
from motioncheck_ccm_slam_tpu_torch.utils import bigmap as tbigmap

from test_ba import K, synth_scene
from test_tile_gba import _perturbed
import torch_one_thread  # noqa: F401 (torch on one thread)

SEG_RTOL = 1e-6


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


# ---------------------------------------------------------------------------
# Segment plans
# ---------------------------------------------------------------------------

def _segments(kind):
    """(ids, n, valid, x) of one case, from a numpy seed."""
    rng = np.random.default_rng(11)
    if kind == "contiguous":
        n = 40
        idx = np.repeat(np.arange(n), 7)
        valid = None
    else:
        n = 37
        idx = rng.integers(0, n, 500)
        idx[idx == 5] = 6                 # an empty segment
        valid = rng.random(500) < 0.8 if kind == "valid" else None
    x = rng.normal(0, 1, (idx.size, 6, 3)).astype(np.float32)
    if valid is not None:
        x[~valid] = 0.0                   # invalid observations carry zero weight
    return idx, n, valid, x


@pytest.mark.parametrize("kind", ["random", "valid", "contiguous"])
def test_segment_plan_matches_jax(kind):
    idx, n, valid, x = _segments(kind)
    jp = jbc.build_segment_plan(idx.astype(np.int32), n, valid=valid)
    tp = tbc.build_segment_plan(idx, n, valid=valid)
    assert tp.seg_size == jp.seg_size
    assert (tp.seg_size > 0) == (kind == "contiguous")
    if not tp.seg_size:
        np.testing.assert_array_equal(tp.table.numpy(), np.asarray(jp.table))
        np.testing.assert_array_equal(tp.mask.numpy(), np.asarray(jp.mask))
    xt = torch.from_numpy(x)
    got = tbc.seg_sum(tp, xt)
    want = torch.zeros((n, 6, 3)).index_add_(0, torch.from_numpy(idx), xt)
    assert _rel(got, want) <= SEG_RTOL
    assert _rel(got, jbc.seg_sum(jp, jnp.asarray(x))) <= SEG_RTOL
    # _seg_or_scatter: the plan's gather, else the scatter-add
    assert _rel(tbc._seg_or_scatter(None, torch.from_numpy(idx), xt, n), want) <= SEG_RTOL


@pytest.mark.parametrize("kind", ["random", "contiguous"])
def test_sorted_seg_sum_matches_jax(kind):
    idx, n, _, x = _segments(kind)
    ss = tbc.build_sorted_segments(idx, n)
    jss = jbc.build_sorted_segments(idx.astype(np.int32), n)
    np.testing.assert_array_equal(ss.order, np.asarray(jss.order))
    np.testing.assert_array_equal(ss.bounds, np.asarray(jss.bounds))
    xs = torch.from_numpy(x[ss.order])
    got = tbc.sorted_seg_sum(xs, torch.from_numpy(ss.bounds))
    want = torch.zeros((n, 6, 3)).index_add_(0, torch.from_numpy(idx), torch.from_numpy(x))
    assert _rel(got, want) <= SEG_RTOL
    assert _rel(got, jbc.sorted_seg_sum(jnp.asarray(x[ss.order]), jss.bounds)) <= SEG_RTOL


def test_assemble_blocks_with_plans_matches_jax():
    """``assemble_blocks`` with camera and landmark plans against the
    scatter-add form (1e-6) and JAX's planned form, on test_ba's scene with
    invalid observations: Hcc, Hll and W within 1e-6; bc and bl, which are
    computed from residuals (~1e3 times smaller than the projections they
    are taken from, so the two packages' float32 contractions differ
    there at ~2e-5), within 1e-4."""
    rng = np.random.default_rng(3)
    Tcw, pts, obs = synth_scene(rng, n_cams=5, n_pts=90, obs_noise=0.5)
    valid = np.ones(obs.cam_idx.shape[0], bool)
    valid[rng.integers(0, valid.size, 40)] = False
    obs = obs._replace(valid=jnp.asarray(valid))
    C, L = 5, 90
    cam_np, lm_np = np.asarray(obs.cam_idx), np.asarray(obs.lm_idx)

    def blocks(pkg, T, X, o, Kx, plans):
        r, pc, depth_ok = pkg.reproject_residuals(T, X, o, Kx)
        w, _ = pkg.robust_obs_weights(r, o, depth_ok)
        Jc, Jl = pkg.reproject_jacobians(pc, T[o.cam_idx][:, :3, :3], Kx)
        return pkg.assemble_blocks(Jc, Jl, r, w, o.cam_idx, o.lm_idx, C, L, *plans)

    Tt, Xt, Kt, _, _ = convert.gba_state_from_numpy(Tcw, pts, K, np.zeros(C, bool),
                                                   np.zeros(L, bool), "cpu")
    ot = convert.ba_observations_from_numpy(obs, "cpu")
    t_plans = (tbc.build_segment_plan(cam_np, C, valid=valid),
               tbc.build_segment_plan(lm_np, L, valid=valid))
    j_plans = (jbc.build_segment_plan(cam_np, C, valid=valid),
               jbc.build_segment_plan(lm_np, L, valid=valid))
    got = blocks(tbc, Tt, Xt, ot, Kt, t_plans)
    scatter = blocks(tbc, Tt, Xt, ot, Kt, (None, None))
    ref = blocks(jbc, Tcw, pts, obs, K, j_plans)
    for g, s, r, tol in zip(got, scatter, ref, (SEG_RTOL, 1e-4, SEG_RTOL, 1e-4, SEG_RTOL)):
        assert _rel(g, s) <= SEG_RTOL
        assert _rel(g, r) <= tol


# ---------------------------------------------------------------------------
# The gather formulation: make_sharded_gba
# ---------------------------------------------------------------------------

def _to_port(Tcw, pts, obs, fc, fl):
    Tcw_t, Xw_t, K_t, fc_t, fl_t = convert.gba_state_from_numpy(Tcw, pts, K, fc, fl, "cpu")
    return Tcw_t, Xw_t, convert.ba_observations_from_numpy(obs, "cpu"), K_t, fc_t, fl_t


def _sharded_scene(name):
    """(jax args, port args, iterations, sweeps): test_sharded_ba's scene
    (8 cameras, 200 points) or its padding case (3 cameras, 67 points)."""
    if name == "full":
        rng = np.random.default_rng(0)
        Tcw, pts, obs, fc, fl, _, _ = _perturbed(rng, n_cams=8, n_pts=200)
        its = (12, 30)
    else:
        rng = np.random.default_rng(1)
        Tcw_true, pts, obs = synth_scene(rng, n_cams=3, n_pts=67, obs_noise=0.1)
        Tcw = jnp.asarray(Tcw_true)
        fc, fl = jnp.zeros(3, bool).at[0].set(True), jnp.zeros(67, bool)
        assert obs.cam_idx.shape[0] % 8 != 0
        its = (4, 15)
    return (Tcw, pts, obs, K, fc, fl), _to_port(Tcw, pts, obs, fc, fl), *its


def _assert_close(rt, rj, cost_rtol=1e-3, t_atol=1e-3, x_atol=5e-3):
    cj = float(rj.cost)
    assert abs(float(rt.cost) - cj) <= cost_rtol * max(cj, 1.0), (float(rt.cost), cj)
    assert float(np.abs(np.asarray(rt.Tcw) - np.asarray(rj.Tcw)).max()) < t_atol
    assert float(np.abs(np.asarray(rt.Xw) - np.asarray(rj.Xw)).max()) < x_atol


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("name", ["full", "padding"])
def test_sharded_gba_matches_jax_mesh(name, n):
    jargs, targs, iters, pcg = _sharded_scene(name)
    mesh = Mesh(np.array(jax.devices()[:n]), (jsb.AXIS,))
    rj = jsb.make_sharded_gba(mesh, iterations=iters, pcg_iters=pcg)(*jargs)
    rt = tsb.make_sharded_gba(iterations=iters, pcg_iters=pcg, devices=["cpu"] * n)(*targs)
    _assert_close(rt, rj)
    O = targs[2].cam_idx.shape[0]
    assert rt.obs_inlier.shape == (O,)
    assert np.mean(rt.obs_inlier.numpy() == np.asarray(rj.obs_inlier)) >= 0.99
    assert np.isfinite(float(rt.cost))


# ---------------------------------------------------------------------------
# The tile GBA over shards
# ---------------------------------------------------------------------------

def _tile_scene():
    rng = np.random.default_rng(5)
    Tcw, pts, obs, fc, fl, _, _ = _perturbed(rng, n_cams=6, n_pts=150)
    return (Tcw, pts, obs, K, fc, fl), _to_port(Tcw, pts, obs, fc, fl)


def test_tile_gba_shards_match_one_shard_and_jax_mesh():
    """Eight shards in one process against the port's one shard and the
    JAX tile solver on the virtual 8-device mesh (5 iterations, 20
    sweeps). The plan's L_pad is a multiple of 128 x 8, so each shard holds
    whole tiles, some of pad slots only."""
    jargs, targs = _tile_scene()
    r1 = tsb.make_tile_gba(iterations=5, pcg_iters=20)(*targs)
    r8 = tsb.make_tile_gba(iterations=5, pcg_iters=20, devices=["cpu"] * 8)(*targs)
    _assert_close(r8, r1)
    np.testing.assert_array_equal(r8.obs_inlier.numpy(), r1.obs_inlier.numpy())
    tp = tsb.build_tile_plan(targs[2], 6, 150, n_shards=8)
    assert tp.L_pad == 1024 and tp.ntl == 8
    mesh = Mesh(np.array(jax.devices()), (jsb.AXIS,))
    rj = jsb.make_tile_gba(mesh, iterations=5, pcg_iters=20)(*jargs)
    _assert_close(r8, rj)


def test_tile_gba_one_shard_is_the_default_path():
    """``devices=["cpu"]`` is the default solver, bit for bit."""
    _, targs = _tile_scene()
    r0 = tsb.make_tile_gba(iterations=3, pcg_iters=20)(*targs)
    r1 = tsb.make_tile_gba(iterations=3, pcg_iters=20, devices=["cpu"])(*targs)
    for a, b in zip(r0, r1):
        assert torch.equal(a, b)


def test_plan_pads_landmarks_for_shards():
    lm = np.sort(np.random.default_rng(0).integers(0, 300, 900))
    cam = np.arange(900) % 7
    one = tsb.schur_cuda.build_schur_plan(lm, cam, 300)
    four = tsb.schur_cuda.build_schur_plan(lm, cam, 300, lpad_multiple=4)
    assert (one.L_pad, one.ntl) == (384, 3) and (four.L_pad, four.ntl) == (512, 4)
    n = one.ntl * one.TP
    for f in ("perm", "camid", "lmloc"):
        np.testing.assert_array_equal(getattr(four, f)[:n], getattr(one, f))
    assert (four.perm[n:] == 900).all() and (four.camid[n:] == 0).all()


@pytest.mark.parametrize("solver", ["tile", "gather"])
def test_two_gloo_processes_match_one_process(solver, tmp_path):
    """Two ranks of a gloo group, one shard each, against the one-process
    solve over two shards: every rank returns the full Tcw, Xw and inlier
    mask, and both ranks launch the same products."""
    _, targs = _tile_scene()
    path = str(tmp_path / "problem.npz")
    chip_smoke.save_gba_problem(path, *targs)
    make = tsb.make_tile_gba if solver == "tile" else tsb.make_sharded_gba
    ref = make(iterations=5, pcg_iters=20, devices=["cpu"] * 2)(*targs)
    recs = chip_smoke.run_gba_children(path, solver, "gloo", 2, "cpu", 5, 20,
                                       str(tmp_path), timeout_s=120)
    for rec in recs:
        res = rec["result"]
        assert abs(float(res["cost"]) - float(ref.cost)) <= 1e-3 * float(ref.cost)
        assert np.abs(res["Tcw"] - ref.Tcw.numpy()).max() < 1e-3
        assert res["Xw"].shape == tuple(ref.Xw.shape)
        assert np.abs(res["Xw"] - ref.Xw.numpy()).max() < 5e-3
        np.testing.assert_array_equal(res["obs_inlier"], ref.obs_inlier.numpy())
    for a, b in zip(recs[0]["result"].values(), recs[1]["result"].values()):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The route and the server-scale map
# ---------------------------------------------------------------------------

def test_pick_solver_mesh_route(monkeypatch):
    """A CPU map keeps the one-device route; a CUDA map with several cards
    visible keeps the dense-W route while W fits and above that takes the
    tile GBA over all of them (built lazily: nothing runs on a card here),
    cached by card count and sweeps."""
    monkeypatch.setattr(tgba, "_solver_cache", {})
    assert tgba._pick_solver(24, 8192, device="cpu") is None
    one = tgba._pick_solver(2048, 65536, device="cpu")
    assert one is tgba._solver_cache[25]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert tgba._pick_solver(2048, 65536, device="cpu") is one
    assert tgba._pick_solver(24, 8192, device="cuda") is None
    mesh = tgba._pick_solver(2048, 65536, device="cuda")
    assert mesh is not one and mesh is tgba._solver_cache[("mesh", 3, 25)]
    assert mesh.__qualname__.startswith("make_tile_gba")
    assert tgba._pick_solver(2048, 65536, device=torch.device("cuda", 0)) is mesh


def test_bigmap_matches_jax():
    n_kfs, n_mps, f = 64, 2048, 64
    mj, cfg_j, Tj = jbigmap.build_server_scale_map(n_kfs=n_kfs, n_mps=n_mps, obs_per_kf=f, seed=3)
    mt, cfg_t, Tt = tbigmap.build_server_scale_map(n_kfs=n_kfs, n_mps=n_mps, obs_per_kf=f, seed=3,
                                                   device="cpu")
    np.testing.assert_array_equal(Tt, Tj)
    assert cfg_t.capacity.server_max_kfs == cfg_j.capacity.server_max_kfs == n_kfs
    assert cfg_t.extractor.max_features == cfg_j.extractor.max_features == f
    for block in ("kf", "mp"):
        bt, bj = getattr(mt, block), getattr(mj, block)
        for name, v in bt._asdict().items():
            want = np.asarray(getattr(bj, name))
            got = convert.desc_to_numpy(v) if name == "desc" else v.numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{block}.{name}")
    assert mt.kf_slot_by_id == mj.kf_slot_by_id and mt.mp_slot_by_id == mj.mp_slot_by_id
