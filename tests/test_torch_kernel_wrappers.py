"""The kernel wrappers of the torch port (ops/fast_cuda.py: K1/K2,
ops/schur_cuda.py: K3-K9 and the plan-form apply_a / apply_b /
schur_apply): routing, argument checks and launch counting.

A CPU tensor runs the plain version and counts no launch; a malformed
argument raises. The tests marked ``cuda`` need an NVIDIA GPU and skip
elsewhere; on the card (``python -m pytest --noconftest -m cuda
tests/test_torch_kernel_wrappers.py``) they hold each kernel against its
plain version: K1 bitwise, K2 within blur 1e-3 / moments 1.0 (FMA
contraction); K3-K7 relative to each output's max-abs within 1e-4 (sums
of ~30 terms taken by atomics in no fixed order, FMA contraction), and
within 1e-3 for what is computed from residuals (rho, chi2, bl, bc: a
residual is ~1e3 times smaller than the projection it is taken from, so
one ulp there is ~1e-4 of it); K8 within 1e-5 relative (the same per-slot
cost summed in another order); K9 bitwise (it moves data); the plan-form
products within 1e-4 of each output's max-abs, as K6/K7. K3, K4, K5, K7
and the plan-form apply_b and schur_apply are also held, at 1e-4, at the
edge shapes of ``chip_smoke.EDGE_CASES`` (C = 5 to 12,000, TP = 128 to
25,600, a tile of pad slots only), and two calls on one input to each
other; there K3 runs on a seeded state whose residuals are pixels, not
the bench state's fractions of one, so its residual-derived outputs too
are held at 1e-4, part by part, its inlier flags may differ from the
plain version's on one slot or 1e-4 of them (a chi2 within rounding of
the gate), and its per-slot outputs are bitwise equal between two calls.
"""
import types

import numpy as np
import pytest
import torch

import chip_smoke

from motioncheck_ccm_slam_tpu_torch import convert
from motioncheck_ccm_slam_tpu_torch.ops import fast_cuda, schur_cuda
from motioncheck_ccm_slam_tpu_torch.parallel import sharded_ba

K1_ARGS = dict(th_hi=20.0, th_lo=7.0, border=19)


def _img(h=70, w=90, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(40, 120, (h, w)).astype(np.float32)
    for y, x in rng.integers(20, (h - 23, w - 23), (12, 2)):
        img[y:y + 3, x:x + 3] = 250.0
    return torch.from_numpy(img)


def test_cpu_tensor_runs_plain_version_and_counts_no_launch():
    img = _img()
    n1, n2 = fast_cuda.masked_corner_score.launches, fast_cuda.blur_and_moments.launches
    out = fast_cuda.masked_corner_score(img, **K1_ARGS)
    assert torch.equal(out, fast_cuda.masked_corner_score_ref(img, **K1_ARGS))
    assert tuple(out.shape) == fast_cuda.padded_shape(70, 90) == (128, 96)
    for a, b in zip(fast_cuda.blur_and_moments(img), fast_cuda.blur_and_moments_ref(img)):
        assert torch.equal(a, b)
    assert fast_cuda.masked_corner_score.launches == n1
    assert fast_cuda.blur_and_moments.launches == n2


@pytest.mark.parametrize("bad", ["float64", "int32", "3d", "1d", "strided", "numpy"])
@pytest.mark.parametrize("kernel", ["masked_corner_score", "blur_and_moments"])
def test_wrapper_rejects_malformed_input(kernel, bad):
    img = _img()
    arg = {
        "float64": img.double(),
        "int32": img.to(torch.int32),
        "3d": img[None],
        "1d": img[0],
        "strided": img[:, ::2],
        "numpy": img.numpy(),
    }[bad]
    fn = getattr(fast_cuda, kernel)
    kw = K1_ARGS if kernel == "masked_corner_score" else {}
    with pytest.raises((TypeError, ValueError)):
        fn(arg, **kw)


def test_corner_score_rejects_border_inside_halo():
    with pytest.raises(ValueError, match="HALO"):
        fast_cuda.masked_corner_score(_img(), th_hi=20.0, th_lo=7.0, border=3)


def test_library_path_tracks_source():
    p = fast_cuda.library_path()
    assert p.startswith(fast_cuda.BUILD_DIR) and p.endswith(".so")
    assert "sm_90a" in " ".join(fast_cuda.NVCC_FLAGS)
    assert "--use_fast_math" not in fast_cuda.NVCC_FLAGS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(480, 752), (161, 252), (70, 90)])
def test_kernels_match_plain_versions_on_card(cuda_device, shape):
    img = _img(*shape, seed=1).to(cuda_device)
    n1, n2 = fast_cuda.masked_corner_score.launches, fast_cuda.blur_and_moments.launches
    out = fast_cuda.masked_corner_score(img, **K1_ARGS)
    maps = fast_cuda.blur_and_moments(img)
    torch.cuda.synchronize()
    assert fast_cuda.masked_corner_score.launches == n1 + 1
    assert fast_cuda.blur_and_moments.launches == n2 + 1
    assert torch.equal(out, fast_cuda.masked_corner_score_ref(img, **K1_ARGS))
    for m, r, atol in zip(maps, fast_cuda.blur_and_moments_ref(img), (1e-3, 1.0, 1.0)):
        torch.testing.assert_close(m, r, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# K3-K7
# ---------------------------------------------------------------------------

GBA_KERNELS = ("d1_assemble", "s_apply", "d2_precond", "apply_a_raw", "apply_b_raw")


def _gba_inputs(device, seed=0, C=130, L=300, O=4000):
    """A small tile-stream problem built in numpy: random cameras and
    landmarks, 10% of the observations invalid, camera 0 and landmark 5
    fixed; the kernel inputs of K3 and, for K4-K7, a W stream from K3's
    plain version, an SPD Hll^-1, a v and a u."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, (L, 3)).astype(np.float32)
    pts[:, 2] += 8.0
    Tcw = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    Tcw[:, :3, 3] = rng.normal(0, 0.3, (C, 3))
    cam = rng.integers(0, C, O)
    lm = rng.integers(0, L, O)
    pc = pts[lm] + Tcw[cam, :3, 3]
    uv = 458.0 * pc[:, :2] / pc[:, 2:] + np.array([376.0, 240.0])
    uv = (uv + rng.normal(0, 2.0, uv.shape)).astype(np.float32)
    obs = convert.ba_observations_from_numpy(types.SimpleNamespace(
        cam_idx=cam, lm_idx=lm, uv=uv, inv_sigma2=np.ones(O, np.float32),
        valid=rng.uniform(size=O) < 0.9), device)
    fixed_cam, fixed_lm = np.zeros(C, bool), np.zeros(L, bool)
    fixed_cam[0], fixed_lm[5] = True, True
    K = np.array([[458.0, 0, 376.0], [0, 458.0, 240.0], [0, 0, 1]], np.float32)
    Tcw_t, Xw_t, K_t, fc, fl = convert.gba_state_from_numpy(Tcw, pts, K, fixed_cam,
                                                            fixed_lm, device)
    tp = sharded_ba.build_tile_plan(obs, C, L)
    fl_pad = torch.cat([fl, torch.ones(tp.L_pad - L, dtype=torch.bool, device=device)])
    st = sharded_ba.tile_streams(tp, obs, K_t, fc, fl_pad)
    X = torch.cat([Xw_t, torch.zeros((tp.L_pad - L, 3), device=device)])
    d1_args = (tp.camid, tp.lmloc, st.uv, st.is2, st.valid, st.free, st.kp,
               schur_cuda.pose_table(Tcw_t), X)
    W18 = schur_cuda.d1_assemble_ref(*d1_args, TP=tp.TP)[0]
    Q = rng.normal(0, 0.05, (tp.L_pad, 3, 3)).astype(np.float32)
    H = np.eye(3, dtype=np.float32) * rng.uniform(0.2, 2.0, (tp.L_pad, 1, 1)) \
        + Q @ Q.transpose(0, 2, 1)
    H9 = torch.from_numpy(np.ascontiguousarray(H.reshape(-1, 9).T.astype(np.float32)))
    v = torch.from_numpy(rng.normal(0, 1, (C, 6)).astype(np.float32))
    u = torch.from_numpy(rng.normal(0, 1, (3, tp.L_pad)).astype(np.float32))
    return dict(tp=tp, C=C, d1_args=d1_args, W18=W18, H9=H9.to(device), v=v.to(device),
                u=u.to(device))


def _gba_calls(g):
    """name -> (wrapper args, keyword args) for each of K3-K7."""
    tp = g["tp"]
    ids = (tp.camid, tp.lmloc, g["W18"])
    return {
        "d1_assemble": (g["d1_args"], {}),
        "s_apply": (ids + (g["v"], g["H9"]), {}),
        "d2_precond": (ids + (g["H9"], g["C"]), {}),
        "apply_a_raw": (ids + (g["v"], g["H9"]), {}),
        "apply_b_raw": (ids + (g["u"], g["C"]), {}),
    }


def test_gba_wrappers_route_cpu_tensors_to_plain_versions():
    g = _gba_inputs("cpu")
    for name, (args, kw) in _gba_calls(g).items():
        fn, ref = getattr(schur_cuda, name), getattr(schur_cuda, name + "_ref")
        n = fn.launches
        out, want = fn(*args, TP=g["tp"].TP, **kw), ref(*args, TP=g["tp"].TP, **kw)
        for a, b in zip(out if isinstance(out, tuple) else (out,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a, b), name
        assert fn.launches == n, name


@pytest.mark.parametrize("bad", ["camid_int64", "W18_strided", "H9_shape", "TP"])
def test_gba_wrappers_reject_malformed_input(bad):
    g = _gba_inputs("cpu", C=8, L=40, O=300)
    tp = g["tp"]
    camid, W18, H9, TP = tp.camid, g["W18"], g["H9"], tp.TP
    if bad == "camid_int64":
        camid = camid.long()
    elif bad == "W18_strided":
        W18 = torch.cat([W18, W18], 1)[:, ::2]
    elif bad == "H9_shape":
        H9 = H9[:, :-1].contiguous()
    else:
        TP = TP + 1
    with pytest.raises((TypeError, ValueError)):
        schur_cuda.s_apply(camid, tp.lmloc, W18, g["v"], H9, TP=TP)


def _relmax(a, b):
    return float((a - b).abs().max() / (b.abs().max() + 1e-6))


@pytest.mark.cuda
def test_gba_kernels_match_plain_versions_on_card(cuda_device):
    g = _gba_inputs(cuda_device)
    TP = g["tp"].TP
    for name, (args, kw) in _gba_calls(g).items():
        fn, ref = getattr(schur_cuda, name), getattr(schur_cuda, name + "_ref")
        n = fn.launches
        out = fn(*args, TP=TP, **kw)
        torch.cuda.synchronize()
        assert fn.launches == n + 1, name
        want = ref(*args, TP=TP, **kw)
        if name != "d1_assemble":
            assert _relmax(out, want) < 1e-4, name
            continue
        W18, aux, hllbl, cam27 = out
        rW, raux, rh, rc = want
        assert _relmax(W18, rW) < 1e-4
        assert _relmax(aux[0], raux[0]) < 1e-3 and _relmax(aux[2], raux[2]) < 1e-3
        assert (aux[1] != raux[1]).float().mean() < 1e-3
        assert _relmax(hllbl[:9], rh[:9]) < 1e-4 and _relmax(hllbl[9:], rh[9:]) < 1e-3
        assert _relmax(cam27[:, :21], rc[:, :21]) < 1e-4
        assert _relmax(cam27[:, 21:], rc[:, 21:]) < 1e-3


# ---------------------------------------------------------------------------
# K8, K9 and the plan-form products of the matrix-free GBA
# ---------------------------------------------------------------------------

PLAN_KERNELS = ("d0_cost", "expand_sorted_streams", "apply_a", "apply_b", "schur_apply")


def _plan_calls(g):
    """name -> args of each of K8, K9 and the plan-form products; the tile
    plan serves as the Schur plan (it carries camid, lmloc, TP, ntl,
    L_pad on the device)."""
    tp, C = g["tp"], g["C"]
    camid, lmloc, uv, is2, valid, _free, kp, pose, X = g["d1_args"]
    Tcw = torch.eye(4, device=pose.device).repeat(C, 1, 1)
    Tcw[:, :3, :3] = pose[:, :9].reshape(C, 3, 3)
    Tcw[:, :3, 3] = pose[:, 9:]
    return {
        "d0_cost": ((camid, lmloc, uv, is2, valid, kp, pose, X), {"TP": tp.TP}),
        "expand_sorted_streams": ((tp, Tcw, X[:g["L"]].contiguous()), {}),
        "apply_a": ((tp, g["W18"], g["v"], g["H9"]), {}),
        "apply_b": ((tp, g["W18"], g["u"], C), {}),
        "schur_apply": ((tp, g["W18"], g["v"], g["H9"]), {}),
    }


def test_plan_wrappers_route_cpu_tensors_to_plain_versions():
    g = _gba_inputs("cpu")
    g["L"] = 300
    for name, (args, kw) in _plan_calls(g).items():
        fn, ref = getattr(schur_cuda, name), getattr(schur_cuda, name + "_ref")
        n = fn.launches
        out, want = fn(*args, **kw), ref(*args, **kw)
        for a, b in zip(out if isinstance(out, tuple) else (out,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a, b), name
        assert fn.launches == n, name
    # K8 is the sum of K3's per-slot robust cost
    aux = schur_cuda.d1_assemble_ref(*g["d1_args"], TP=g["tp"].TP)[1]
    assert float(schur_cuda.d0_cost(*_plan_calls(g)["d0_cost"][0], TP=g["tp"].TP)) \
        == float(aux[0].sum())


@pytest.mark.parametrize("bad", ["numpy_plan", "short_Xw", "Wp_shape", "kp_int"])
def test_plan_wrappers_reject_malformed_input(bad):
    g = _gba_inputs("cpu", C=8, L=40, O=300)
    g["L"] = 40
    calls = _plan_calls(g)
    tp = g["tp"]
    with pytest.raises((TypeError, ValueError)):
        if bad == "numpy_plan":
            plan = tp._replace(camid=tp.camid.numpy(), lmloc=tp.lmloc.numpy())
            schur_cuda.schur_apply(plan, g["W18"], g["v"], g["H9"])
        elif bad == "short_Xw":
            _, Tcw, X = calls["expand_sorted_streams"][0]
            schur_cuda.expand_sorted_streams(tp, Tcw, X[:-schur_cuda.LM_BLOCK].contiguous())
        elif bad == "Wp_shape":
            schur_cuda.apply_a(tp, g["W18"][:, :-128].contiguous(), g["v"], g["H9"])
        else:
            args = list(calls["d0_cost"][0])
            args[5] = args[5].to(torch.int32)
            schur_cuda.d0_cost(*args, TP=tp.TP)


@pytest.mark.cuda
def test_plan_kernels_match_plain_versions_on_card(cuda_device):
    g = _gba_inputs(cuda_device)
    g["L"] = 300
    for name, (args, kw) in _plan_calls(g).items():
        fn, ref = getattr(schur_cuda, name), getattr(schur_cuda, name + "_ref")
        n = fn.launches
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        assert fn.launches == n + 1, name
        want = ref(*args, **kw)
        if name == "expand_sorted_streams":
            for a, b in zip(out, want):
                assert torch.equal(a, b)
        elif name == "d0_cost":
            assert abs(float(out) - float(want)) <= 1e-5 * float(want)
        else:
            assert _relmax(out, want) < 1e-4, name


# ---------------------------------------------------------------------------
# K4 and K7 (and the plan-form products that launch K7) at edge shapes
# ---------------------------------------------------------------------------

EDGE_NAMES = [c[0] for c in chip_smoke.EDGE_CASES]


def _edge(name, device):
    _, C, L, per_lm, tiles = next(c for c in chip_smoke.EDGE_CASES if c[0] == name)
    return (C,) + chip_smoke.edge_case(C, L, per_lm, tiles, device)


def test_edge_cases_have_their_shapes():
    """The edge problems are what chip_smoke.EDGE_CASES says: TP = 128 per
    landmark's observations, a tile of pad slots only, zero pad W rows."""
    want_TP = {"c5_tp128": 128, "c130_tp128_pad_tile": 128, "c2048_tp4224": 4224,
               "c12000_tp4224": 4224, "c2048_tp25600": 25600}
    for name, _, L, per_lm, tiles in chip_smoke.EDGE_CASES:
        C, plan, W, H9, v, u = _edge(name, "cpu")
        n_lms = L if tiles is None else sum(min(L, t * 128 + 128) - t * 128 for t in tiles)
        pad = plan.perm == n_lms * per_lm          # a pad slot's perm is O
        assert plan.TP == want_TP[name], name
        assert int(plan.camid.max()) < C and tuple(v.shape) == (C, 6)
        assert tuple(H9.shape) == (9, plan.L_pad) == (9, plan.ntl * 128)
        assert int((~pad).sum()) == n_lms * per_lm and not W[:, pad].any()
        if name == "c130_tp128_pad_tile":
            assert pad.reshape(plan.ntl, plan.TP)[1].all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", EDGE_NAMES)
def test_k4_k7_match_plain_versions_at_edge_shapes_on_card(cuda_device, name):
    C, plan, W, H9, v, u = _edge(name, cuda_device)
    ids = (plan.camid, plan.lmloc, W)
    calls = {
        "s_apply": ((*ids, v, H9), {"TP": plan.TP}),
        "apply_b_raw": ((*ids, u, C), {"TP": plan.TP}),
        "apply_b": ((plan, W, u, C), {}),
        "schur_apply": ((plan, W, v, H9), {}),
    }
    for fn_name, (args, kw) in calls.items():
        fn, ref = getattr(schur_cuda, fn_name), getattr(schur_cuda, fn_name + "_ref")
        n = fn.launches
        a, b = fn(*args, **kw), fn(*args, **kw)
        torch.cuda.synchronize()
        assert fn.launches == n + 2, fn_name
        want = ref(*args, **kw)
        assert bool(a.isfinite().all()), fn_name
        assert _relmax(a, want) < 1e-4 and _relmax(b, want) < 1e-4, fn_name
        assert _relmax(a, b) < 1e-4, fn_name


@pytest.mark.cuda
@pytest.mark.parametrize("name", EDGE_NAMES)
def test_k3_k5_match_plain_versions_at_edge_shapes_on_card(cuda_device, name):
    _, C, L, per_lm, tiles = next(c for c in chip_smoke.EDGE_CASES if c[0] == name)
    plan, W, H9, _, _, state = chip_smoke.edge_case(C, L, per_lm, tiles, cuda_device,
                                                    state=True)
    d1 = (plan.camid, plan.lmloc) + state
    n3, n5 = schur_cuda.d1_assemble.launches, schur_cuda.d2_precond.launches
    a, b = (schur_cuda.d1_assemble(*d1, TP=plan.TP) for _ in range(2))
    k5 = [schur_cuda.d2_precond(plan.camid, plan.lmloc, W, H9, C, TP=plan.TP) for _ in range(2)]
    torch.cuda.synchronize()
    assert schur_cuda.d1_assemble.launches == n3 + 2 and schur_cuda.d2_precond.launches == n5 + 2
    ref = schur_cuda.d1_assemble_ref(*d1, TP=plan.TP)
    # per-slot outputs take no atomics: the same bits on every call, also
    # where the camera table is split into ranges (written by range 0 only)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for x, y in ((a, ref), (b, ref), (a, b)):
        errs = chip_smoke.d1_errors(x, y)
        assert errs.pop("inlier_flips") <= max(1e-4, 1.0 / (plan.ntl * plan.TP))
        assert all(e < 1e-4 for e in errs.values()), errs
    r5 = schur_cuda.d2_precond_ref(plan.camid, plan.lmloc, W, H9, C, TP=plan.TP)
    assert bool(k5[0].isfinite().all())
    assert _relmax(k5[0], r5) < 1e-4 and _relmax(k5[1], r5) < 1e-4
    assert _relmax(k5[0], k5[1]) < 1e-4
    if name == "c12000_tp4224":
        assert all(schur_cuda.launch_geometry(k, C, plan.TP, plan.ntl, cuda_device).ranges > 1
                   for k in ("d1_assemble", "d2_precond"))
