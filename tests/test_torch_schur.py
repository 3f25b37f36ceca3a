"""Port parity for the tile-stream GBA kernels K3-K7 (ops/schur_cuda.py).

Each kernel's plain torch version is held against the JAX Pallas kernel
(ops/schur_pallas.py, interpret mode on the CPU) on the same plan and the
same inputs, made with numpy from a seed. Two scenes:

- "c5": 5 cameras, 90 landmarks, 40 observations knocked out, camera 0
  and landmark 7 fixed (as tests/test_tile_gba.py's D1 test);
- "c130": 130 cameras 3 cm apart (every point in view), so that the JAX
  layout's two camera groups are crossed, each camera seeing a random 40%
  of the points, 30% of the observations invalid, cameras 0 and 64 and
  landmark 7 fixed.

Tolerances, relative to each output's max-abs: 1e-5 for the W stream (the
same f32 arithmetic; the JAX side's pose and point expansions are exact
three-term bf16 splits); 1e-3 for what is computed from residuals (rho,
chi2, bl, bc): a residual r = uv - proj is ~1e3 times smaller than the
projection it is taken from, so one ulp of the projection is ~1e-4 of r;
1e-4 for the other reductions (the JAX side reduces through two-term bf16
splits, ~2^-17 relative, and sums in another order).
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

from test_ba import CAM, K, synth_scene
import torch_one_thread  # noqa: F401 (torch on one thread)

SLOT_TOL = 1e-5
RESIDUAL_TOL = 1e-3
SUM_TOL = 1e-4
SCENES = {"c5": (3, 5, 90, 40), "c130": (4, 130, 90, None)}


def _short_baseline_scene(rng, C, L):
    """Cameras 3 cm apart with small rotations looking at a point cloud at
    ~8 m; each camera observes a random 40% of the points, sorted by
    camera."""
    pts = rng.uniform(-2, 2, size=(L, 3)).astype(np.float32)
    pts[:, 2] += 8.0
    Tcw, cam_idx, lm_idx, uvs = [], [], [], []
    for c in range(C):
        xi = np.zeros(6, np.float32)
        xi[:3] = rng.normal(0, 0.03, 3)
        xi[3] = c * 0.03
        xi[4:] = rng.normal(0, 0.05, 2)
        T = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
        Tcw.append(T)
        seen = np.flatnonzero(rng.uniform(size=L) < 0.4)
        pc = pts[seen] @ T[:3, :3].T + T[:3, 3]
        uv = np.stack([CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx,
                       CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy], -1)
        uvs.append(uv + rng.normal(0, 0.5, uv.shape))
        cam_idx.append(np.full(len(seen), c))
        lm_idx.append(seen)
    O = sum(len(x) for x in lm_idx)
    obs = jba.BAObservations(
        cam_idx=jnp.asarray(np.concatenate(cam_idx), jnp.int32),
        lm_idx=jnp.asarray(np.concatenate(lm_idx), jnp.int32),
        uv=jnp.asarray(np.concatenate(uvs), jnp.float32),
        inv_sigma2=jnp.asarray(rng.choice([1.0, 0.69, 0.48], O).astype(np.float32)),
        valid=jnp.ones(O, bool))
    return jnp.asarray(np.stack(Tcw)), jnp.asarray(pts), obs


def _relerr(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-6))


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    seed, C, L, n_bad = SCENES[request.param]
    rng = np.random.default_rng(seed)
    if n_bad is None:
        Tcw, pts, obs = _short_baseline_scene(rng, C, L)
    else:
        Tcw, pts, obs = synth_scene(rng, n_cams=C, n_pts=L, obs_noise=0.5)
    O = obs.cam_idx.shape[0]
    if n_bad is None:
        valid = rng.uniform(size=O) < 0.7
    else:
        valid = np.ones(O, bool)
        valid[rng.integers(0, O, n_bad)] = False
    obs = obs._replace(valid=jnp.asarray(valid))
    fixed_cam = np.zeros(C, bool)
    fixed_cam[[0, 64] if C > 64 else [0]] = True
    fixed_lm = np.zeros(L, bool)
    fixed_lm[7] = True
    tp_j = jsb.build_tile_plan(obs, C, L)
    sp = tp_j.sp
    fc, fl = jnp.asarray(fixed_cam), jnp.asarray(fixed_lm)

    # JAX side: the tile streams exactly as sharded_ba.make_tile_gba builds them
    K4 = jnp.reshape(jnp.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]), (1, 4))
    uv_s = jnp.concatenate([obs.uv, jnp.zeros((1, 2))], 0)[tp_j.to_orig].T
    is2_s = jnp.concatenate([obs.inv_sigma2, jnp.zeros(1)])[tp_j.to_orig][None, :]
    valid_s = jnp.concatenate([obs.valid, jnp.zeros(1, bool)])[
        tp_j.to_orig].astype(jnp.float32)[None, :]
    fl_pad = jnp.pad(fl, (0, sp.L_pad - L), constant_values=True)
    free_s = (~(fc[sp.camid[0]] | fl_pad[tp_j.lm_p])).astype(jnp.float32)[None, :]
    t0, t1, t2 = schur_pallas.pose_tables(Tcw, sp.n_groups)
    X8 = schur_pallas.point_table(pts.T, sp.L_pad)
    d1 = schur_pallas.d1_assemble(sp.camid, sp.lmloc, uv_s, is2_s, valid_s, free_s,
                                  K4, t0, t1, t2, X8, TP=sp.TP)

    # port side: plan and streams from the same numpy arrays
    tobs = convert.ba_observations_from_numpy(obs, "cpu")
    Tcw_t, Xw_t, K_t, fc_t, fl_t = convert.gba_state_from_numpy(
        Tcw, pts, K, fixed_cam, fixed_lm, "cpu")
    tp_t = tsb.build_tile_plan(tobs, C, L)
    fl_pad_t = torch.cat([fl_t, torch.ones(tp_t.L_pad - L, dtype=torch.bool)])
    st = tsb.tile_streams(tp_t, tobs, K_t, fc_t, fl_pad_t)
    Xw_pad = torch.cat([Xw_t, torch.zeros(tp_t.L_pad - L, 3)])

    # shared inputs of K4-K7: JAX's W stream, an SPD Hll^-1, a v and a u
    W18 = np.asarray(d1[0])
    Hinv = np.stack([np.eye(3, dtype=np.float32) * s
                     for s in rng.uniform(0.2, 2.0, sp.L_pad)])
    Q = rng.normal(0, 0.05, (sp.L_pad, 3, 3)).astype(np.float32)
    H9 = np.ascontiguousarray(
        (Hinv + Q @ Q.transpose(0, 2, 1)).reshape(-1, 9).T.astype(np.float32))
    v = rng.normal(0, 1.0, (C, 6)).astype(np.float32)
    u = rng.normal(0, 1.0, (3, sp.L_pad)).astype(np.float32)
    return dict(lm=np.asarray(obs.lm_idx), cam=np.asarray(obs.cam_idx), valid=valid,
                C=C, L=L, sp=sp, tp_j=tp_j, tp_t=tp_t, d1=d1, st=st, Tcw=Tcw_t,
                Xw_pad=Xw_pad, W18=W18, H9=H9, v=v, u=u)


def test_plan_matches_jax(scene):
    sp, tp_j, tp_t = scene["sp"], scene["tp_j"], scene["tp_t"]
    assert (tp_t.TP, tp_t.L_pad, tp_t.ntl) == (sp.TP, sp.L_pad, sp.ntl)
    np.testing.assert_array_equal(tp_t.camid.numpy(), np.asarray(sp.camid)[0])
    np.testing.assert_array_equal(tp_t.lmloc.numpy(), np.asarray(sp.lmloc)[0])
    np.testing.assert_array_equal(tp_t.to_orig.numpy(), np.asarray(tp_j.to_orig))
    np.testing.assert_array_equal(tp_t.slot_of.numpy(), np.asarray(tp_j.slot_of))
    np.testing.assert_array_equal(tp_t.lm_p.numpy(), np.asarray(tp_j.lm_p))


def test_build_schur_plan_matches_jax_perm(scene):
    """The numpy builder gives the JAX builder's perm / camid / lmloc /
    TP / L_pad on the scene's landmark-sorted stream, invalid observations
    left out."""
    C, L = scene["C"], scene["L"]
    lm, cam, valid = scene["lm"], scene["cam"], scene["valid"]
    order = np.argsort(lm, kind="stable")
    vs = valid[order]
    j = schur_pallas.build_schur_plan(lm[order], cam[order], C, L, valid_sorted=vs)
    t = schur_cuda.build_schur_plan(lm[order], cam[order], L, valid_sorted=vs)
    assert (t.TP, t.L_pad, t.ntl) == (j.TP, j.L_pad, j.ntl)
    np.testing.assert_array_equal(t.perm, np.asarray(j.perm))
    np.testing.assert_array_equal(t.camid, np.asarray(j.camid)[0])
    np.testing.assert_array_equal(t.lmloc, np.asarray(j.lmloc)[0])


def test_d1_assemble_matches_jax(scene):
    tp, st, C = scene["tp_t"], scene["st"], scene["C"]
    W18, aux, hllbl, cam27 = schur_cuda.d1_assemble_ref(
        tp.camid, tp.lmloc, st.uv, st.is2, st.valid, st.free, st.kp,
        schur_cuda.pose_table(scene["Tcw"]), scene["Xw_pad"], TP=tp.TP)
    jW, jaux, jhll, jacc = scene["d1"]
    assert _relerr(W18, jW) < SLOT_TOL
    assert _relerr(aux[0], jaux[0]) < RESIDUAL_TOL
    np.testing.assert_array_equal(aux[1].numpy(), np.asarray(jaux[1]))
    assert _relerr(aux[2], jaux[2]) < RESIDUAL_TOL
    assert _relerr(hllbl[:9], jhll[:9]) < SUM_TOL
    assert _relerr(hllbl[9:], jhll[9:]) < RESIDUAL_TOL
    jcam = schur_pallas.unpack_cam(jacc, C, schur_pallas.D1_CAM_ROWS)
    assert _relerr(cam27[:, :21], jcam[:, :21]) < SUM_TOL
    assert _relerr(cam27[:, 21:], jcam[:, 21:]) < RESIDUAL_TOL
    # the robust cost, the LM gate's input
    assert abs(float(aux[0].sum()) - float(jaux[0].sum())) <= 1e-5 * float(jaux[0].sum())


def _t(a):
    return torch.from_numpy(np.array(a))


def test_d2_precond_matches_jax(scene):
    tp, sp, C = scene["tp_t"], scene["sp"], scene["C"]
    out = schur_cuda.d2_precond_ref(tp.camid, tp.lmloc, _t(scene["W18"]), _t(scene["H9"]),
                                    C, TP=tp.TP)
    acc = schur_pallas.d2_precond(sp.camid, sp.lmloc, jnp.asarray(scene["W18"]),
                                  jnp.asarray(scene["H9"]), TP=sp.TP, ng=sp.n_groups)
    assert _relerr(out, schur_pallas.unpack_cam(acc, C, schur_pallas.D2_CAM_ROWS)) < SUM_TOL


def test_s_apply_matches_jax(scene):
    tp, sp = scene["tp_t"], scene["sp"]
    out = schur_cuda.s_apply_ref(tp.camid, tp.lmloc, _t(scene["W18"]), _t(scene["v"]),
                                 _t(scene["H9"]), TP=tp.TP)
    ref = schur_pallas.s_apply(sp.camid, sp.lmloc, jnp.asarray(scene["W18"]),
                               jnp.asarray(scene["v"]), jnp.asarray(scene["H9"]), TP=sp.TP)
    assert _relerr(out, ref) < SUM_TOL


def test_apply_a_matches_jax(scene):
    tp, sp = scene["tp_t"], scene["sp"]
    out = schur_cuda.apply_a_raw_ref(tp.camid, tp.lmloc, _t(scene["W18"]), _t(scene["v"]),
                                     _t(scene["H9"]), TP=tp.TP)
    ref = schur_pallas.apply_a_raw(sp.camid, sp.lmloc, jnp.asarray(scene["W18"]),
                                   jnp.asarray(scene["v"]), jnp.asarray(scene["H9"]),
                                   TP=sp.TP)
    assert out.shape == (3, sp.L_pad)
    assert _relerr(out, ref[0:3]) < SUM_TOL


def test_apply_b_matches_jax(scene):
    tp, sp, C = scene["tp_t"], scene["sp"], scene["C"]
    out = schur_cuda.apply_b_raw_ref(tp.camid, tp.lmloc, _t(scene["W18"]), _t(scene["u"]),
                                     C, TP=tp.TP)
    u8 = schur_pallas.point_table(jnp.asarray(scene["u"]), sp.L_pad)
    ref = schur_pallas.apply_b_raw(sp.camid, sp.lmloc, jnp.asarray(scene["W18"]), u8, C,
                                   TP=sp.TP)
    assert _relerr(out, ref) < SUM_TOL


def test_sym6_from_tri_matches_jax():
    tri = np.random.default_rng(0).normal(size=(7, 21)).astype(np.float32)
    np.testing.assert_array_equal(schur_cuda.sym6_from_tri(_t(tri)).numpy(),
                                  np.asarray(schur_pallas.sym6_from_tri(jnp.asarray(tri))))


# K3's, K4's, K5's and K7's launch geometry (csrc/schur.cu's persistent
# grids): C from 1 to 100,000 cameras, tiles from 128 to 25,600 slots, 1 to
# 512 tiles
@pytest.mark.parametrize("C,TP,ntl", [
    (1, 128, 1), (5, 128, 3), (130, 128, 1), (2048, 4224, 512), (12000, 4224, 2),
    (2048, 19200, 40), (2048, 25600, 2), (5, 25600, 2), (100_000, 256, 7),
])
@pytest.mark.parametrize("kernel", ["s_apply", "apply_b", "d1_assemble", "d2_precond"])
def test_camera_reduction_geometry_covers_everything_once(kernel, C, TP, ntl):
    geo = schur_cuda.camera_reduction_geometry(kernel, C, TP, ntl, 132)
    # none of these kernels has static shared memory: shared_bytes is all
    assert geo.shared_bytes <= schur_cuda.SHARED_BYTES_MAX == 232_448
    assert 1 <= geo.cluster <= 8 and geo.grid % geo.cluster == 0
    assert geo.row_bytes == {"s_apply": 24, "apply_b": 24, "d1_assemble": 108,
                             "d2_precond": 84}[kernel]
    assert geo.cam_range * geo.row_bytes <= geo.shared_bytes
    # every camera in exactly one range
    cams = [geo.cameras(y) for y in range(geo.ranges)]
    assert cams[0].start == 0 and cams[-1].stop == C
    assert all(a.stop == b.start and len(a) > 0 for a, b in zip(cams, cams[1:] + [range(C, C)]))
    # every tile (K4) or slot (K7) in exactly one cluster's range; a
    # cluster's blocks share their range
    parts = [geo.work_range(x) for x in range(0, geo.grid, geo.cluster)]
    assert all(geo.work_range(x) == parts[x // geo.cluster] for x in range(geo.grid))
    assert parts[0].start == 0 and parts[-1].stop == geo.work
    assert all(a.stop == b.start for a, b in zip(parts, parts[1:]))
    if kernel in ("apply_b", "d2_precond"):
        assert geo.work == ntl * TP and geo.cluster == 1
        assert geo.shared_bytes == geo.cam_range * geo.row_bytes
        return
    if kernel == "d1_assemble":
        # a tile whole in one block, and no block without one
        assert geo.work == ntl and geo.cluster == 1 and geo.grid <= ntl
        assert all(len(geo.work_range(x)) > 0 for x in range(geo.grid))
        assert geo.shared_bytes == geo.cam_range * 108 + schur_cuda.D1_FIXED_BYTES == \
            geo.cam_range * 108 + 2 * 9 * 128 * 4
        return
    assert geo.work == ntl
    # every slot of a tile in exactly one rank's share; staging fits
    slots = [geo.slots(r) for r in range(geo.cluster)]
    assert slots[0].start == 0 and slots[-1].stop == TP
    assert all(a.stop == b.start for a, b in zip(slots, slots[1:]))
    assert 0 < geo.staged <= geo.share and geo.staged % 32 == 0
    table, v_bytes = geo.cam_range * schur_cuda.CAM_ROW_BYTES, C * schur_cuda.CAM_ROW_BYTES
    assert geo.shared_bytes == (schur_cuda.K4_FIXED_BYTES + table + geo.v_shared * v_bytes
                                + geo.staged * schur_cuda.STAGE_SLOT_BYTES
                                + schur_cuda.STAGE_TILE_BYTES)
    # the smallest cluster whose share fits, v in shared memory where it
    # fits too; else 8 blocks each staging what fits
    room = schur_cuda.SHARED_BYTES_MAX - schur_cuda.K4_FIXED_BYTES - table
    fits = [(v, k) for v in (True, False) for k in range(1, 9)
            if schur_cuda._round_up(-(-TP // k), 32) * schur_cuda.STAGE_SLOT_BYTES
            + schur_cuda.STAGE_TILE_BYTES <= room - v * v_bytes]
    if fits:
        assert (geo.v_shared, geo.cluster) == fits[0] and geo.staged == geo.share
    else:
        assert (geo.v_shared, geo.cluster) == (False, schur_cuda.MAX_CLUSTER)
        assert geo.staged < geo.share


def test_camera_reduction_geometry_at_bench_gba_shapes():
    k4 = schur_cuda.camera_reduction_geometry("s_apply", 2048, 4224, 512, 132)
    assert (k4.cluster, k4.grid, k4.share, k4.staged, k4.v_shared, k4.ranges,
            k4.shared_bytes) == (3, 132, 1408, 1408, True, 1, 220_168)
    # as many clusters as the card holds at once, at most one a tile
    assert schur_cuda.camera_reduction_geometry("s_apply", 2048, 4224, 512, 132, 39).grid == 117
    assert schur_cuda.camera_reduction_geometry("s_apply", 2048, 4224, 5, 132).grid == 15
    k7 = schur_cuda.camera_reduction_geometry("apply_b", 2048, 4224, 512, 132)
    assert (k7.grid, k7.ranges, k7.shared_bytes) == (132, 1, 2048 * 24)
    # K3 and K5: one block an SM, one camera range, the whole (C, 27) or
    # (C, 21) table in each block (K3's beside its two landmark tables)
    k3 = schur_cuda.camera_reduction_geometry("d1_assemble", 2048, 4224, 512, 132)
    assert (k3.grid, k3.work, k3.ranges, k3.cam_range, k3.shared_bytes) == \
        (132, 512, 1, 2048, 221_184 + 9_216)
    k5 = schur_cuda.camera_reduction_geometry("d2_precond", 2048, 4224, 512, 132)
    assert (k5.grid, k5.work, k5.ranges, k5.cam_range, k5.shared_bytes) == \
        (132, 2_162_688, 1, 2048, 172_032)
    # the edge shape C = 12,000 splits both tables into even ranges
    k3 = schur_cuda.camera_reduction_geometry("d1_assemble", 12000, 4224, 2, 132)
    k5 = schur_cuda.camera_reduction_geometry("d2_precond", 12000, 4224, 2, 132)
    assert (k3.ranges, k3.cam_range, k3.grid) == (6, 2000, 2)
    assert (k5.ranges, k5.cam_range, k5.grid) == (5, 2400, 26)
    with pytest.raises(ValueError):
        schur_cuda.camera_reduction_geometry("apply_a", 2048, 4224, 512, 132)
