"""Port parity for the slice as a whole: one client tracking step (extract +
undistort + two-pass projection tracking) against the JAX step.

The frames come from tests/synth_scene.SynthScene under the small preset
(512 features, 4 levels, 2048 landmarks) at the EuRoC camera. The JAX
extractor runs its Pallas front-end in interpret mode. The map is built in
numpy from JAX's frame-0 features back-projected at their known depth, so
both packages track the same map.

Bounds: n_inliers within 2%; pose within 1e-3 m and 1e-4 rad; the
per-feature association agrees on >= 98% of the slots (pyramid levels 1-3
differ by ~3e-5 from jax.image.resize, which can move a few features).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioncheck_ccm_slam_tpu.cli import _small_preset
from motioncheck_ccm_slam_tpu.config import DEFAULT_CONFIG
from motioncheck_ccm_slam_tpu.models import map_state as jmap
from motioncheck_ccm_slam_tpu.models import tracking as jtrack
from motioncheck_ccm_slam_tpu.ops import fast_pallas, geometry as jgeo, orb as jorb
from motioncheck_ccm_slam_tpu_torch import convert
from motioncheck_ccm_slam_tpu_torch.models import frame as tframe
from motioncheck_ccm_slam_tpu_torch.models import tracking as ttrack

from synth_scene import SynthScene
import torch_one_thread  # noqa: F401 (torch on one thread)

CFG = _small_preset(DEFAULT_CONFIG)


def _build_map(scene, feats, Tcw0, nm):
    """Landmarks at frame-0 features' known depth: the depth of the blob
    the feature sits on (within 6 px), else the wall plane at 7.5 m."""
    cam, ex = CFG.camera, CFG.extractor
    R, t = Tcw0[:3, :3], Tcw0[:3, 3]
    pc_blob = scene.pts @ R.T + t
    uv_blob = pc_blob[:, :2] / pc_blob[:, 2:3] * [cam.fx, cam.fy] + [cam.cx, cam.cy]
    v = np.flatnonzero(feats.valid)
    uv = feats.xy[v]
    d2 = ((uv[:, None, :] - uv_blob[None, :, :]) ** 2).sum(-1)
    near = d2.argmin(1)
    depth = np.where(d2[np.arange(len(v)), near] < 36.0, pc_blob[near, 2], 7.5)
    ray = np.stack([(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy,
                    np.ones(len(v))], -1)
    Xw = ((ray * depth[:, None] - t) @ R).astype(np.float32)
    center = -R.T @ t
    dist = np.linalg.norm(Xw - center, axis=-1)
    sf = jorb.scale_factors(ex)
    level = sf[feats.octave[v]]
    n = len(v)
    mp = jax.tree.map(np.array, jmap.empty_mp_block(nm))
    mp.Xw[:n] = Xw
    mp.desc[:n] = feats.desc[v]
    mp.normal[:n] = (Xw - center) / dist[:, None]
    mp.max_dist[:n] = dist * level * 1.2
    mp.min_dist[:n] = dist * level / sf[-1] * 0.8
    mp.mp_id[:n] = np.arange(n)
    mp.valid[:n] = True
    return mp


@pytest.fixture(scope="module")
def scene_step():
    scene = SynthScene(CFG, seed=0)
    T0, T1 = scene.pose(0.0), scene.pose(1.0 / CFG.camera.fps)
    img0, img1 = scene.render(T0), scene.render(T1)
    cam = CFG.camera
    K, dist = jnp.asarray(cam.K()), jnp.asarray(cam.dist_coeffs())

    def extract(img):
        feats = jorb.extract_orb(img, CFG.extractor)
        return feats._replace(xy=jgeo.undistort_points(feats.xy, K, dist))

    prev = jorb.FAST_BACKEND, fast_pallas.FORCE_INTERPRET
    try:
        jorb.FAST_BACKEND, fast_pallas.FORCE_INTERPRET = "pallas", True
        extract = jax.jit(extract)   # fresh trace, with the Pallas front-end
        f0 = jax.tree.map(np.asarray, extract(jnp.asarray(img0)))
        f1 = extract(jnp.asarray(img1))
    finally:
        jorb.FAST_BACKEND, fast_pallas.FORCE_INTERPRET = prev
    mp = _build_map(scene, f0, T0, CFG.capacity.client_max_mps)
    sf = jnp.asarray(jorb.scale_factors(CFG.extractor))
    inv_s2 = jnp.asarray(jorb.inv_level_sigma2(CFG.extractor))
    out = jtrack._track_two_pass(
        f1.xy, f1.desc, f1.octave, f1.angle, f1.valid,
        jnp.asarray(T0), jnp.asarray(T0),
        *(jnp.asarray(getattr(mp, k)) for k in
          ("Xw", "desc", "normal", "min_dist", "max_dist", "valid")),
        K, cam.width, cam.height, sf, inv_s2, CFG.extractor.n_levels,
    )
    ref = tuple(np.asarray(a) for a in out)
    return dict(T0=T0, T1=T1, img1=img1, mp=mp, ref=ref)


def _pose_err(Ta, Tb):
    dR = Ta[:3, :3] @ Tb[:3, :3].T
    ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1.0, 1.0))
    Ca = -Ta[:3, :3].T @ Ta[:3, 3]
    Cb = -Tb[:3, :3].T @ Tb[:3, 3]
    return np.linalg.norm(Ca - Cb), ang


def _check_against_ref(ref, Tcw, assoc, n_inl, T_true):
    Tr, assoc_r, n_r = ref[0], ref[1], int(ref[2])
    assert n_r >= 100, "the JAX step itself tracked badly"
    assert abs(n_inl - n_r) <= 0.02 * n_r, (n_inl, n_r)
    dt, dr = _pose_err(Tcw, Tr)
    assert dt < 1e-3 and dr < 1e-4, (dt, dr)
    assert (assoc == assoc_r).mean() >= 0.98
    # the map's depths are approximate (blob depth or wall), so the step
    # lands a few cm from the truth; this only checks that it tracked
    assert _pose_err(Tcw, T_true)[0] < 0.10


def test_tracking_step_matches_jax(scene_step):
    s = scene_step
    cfg, cam = CFG, CFG.camera
    extract = tframe.make_extractor(cfg, "cpu")
    feats = extract(torch.from_numpy(s["img1"]))
    mp = convert.mp_block_from_numpy(s["mp"], "cpu")
    T0 = convert.pose_from_numpy(s["T0"], "cpu")
    sf = torch.from_numpy(jorb.scale_factors(cfg.extractor))
    inv_s2 = torch.from_numpy(jorb.inv_level_sigma2(cfg.extractor))
    Tcw, assoc, n_inl, vis, found = ttrack._track_two_pass(
        feats.xy, feats.desc, feats.octave, feats.angle, feats.valid, T0, T0,
        mp.Xw, mp.desc, mp.normal, mp.min_dist, mp.max_dist, mp.valid,
        torch.from_numpy(cam.K()), cam.width, cam.height, sf, inv_s2,
        cfg.extractor.n_levels,
    )
    _check_against_ref(s["ref"], Tcw.numpy(), assoc.numpy(), int(n_inl), s["T1"])
    ref_vis, ref_found = s["ref"][3], s["ref"][4]
    assert (vis.numpy() == ref_vis).mean() >= 0.999
    assert abs(int(found.sum()) - int(ref_found.sum())) <= 0.02 * ref_found.sum()


def test_tracker_process_ok_state(scene_step):
    """Tracker.process in state OK runs the same step and updates the
    landmark statistics and the motion model."""
    s = scene_step
    mp = convert.mp_block_from_numpy(s["mp"], "cpu")
    tracker = ttrack.Tracker(config=CFG, map=types.SimpleNamespace(mp=mp),
                             device=torch.device("cpu"))
    fr0 = tframe.make_frame(CFG, 0, 0.0, np.zeros((CFG.camera.height, CFG.camera.width),
                                                  np.float32), "cpu")
    fr0.Tcw = convert.pose_from_numpy(s["T0"], "cpu")
    tracker.state, tracker.last_frame, tracker.n_frames = ttrack.TrackState.OK, fr0, 1
    fr = tracker.process(s["img1"], 0.05)
    assert tracker.state == ttrack.TrackState.OK
    _check_against_ref(s["ref"], fr.Tcw.numpy(), fr.mp_idx.numpy(), fr.n_tracked, s["T1"])
    n_vis = tracker.map.mp.n_visible.numpy()
    assert ((n_vis - 1) == s["ref"][3]).mean() >= 0.999
    assert tracker.velocity is not None and len(tracker.trajectory) == 1
    np.testing.assert_allclose(tracker.velocity.numpy(), fr.Tcw.numpy(), atol=1e-6)


def test_tracker_unported_states_raise():
    """The states that raised before two-view initialization and
    relocalization were ported (the name is kept) now run: on blank frames
    initialization finds too few matches and re-seats its reference frame,
    and relocalization against an empty map fails and stays LOST."""
    mp = convert.mp_block_from_numpy(jax.tree.map(np.array, jmap.empty_mp_block(64)), "cpu")
    tracker = ttrack.Tracker(config=CFG, map=types.SimpleNamespace(mp=mp),
                             device=torch.device("cpu"))
    img = np.zeros((CFG.camera.height, CFG.camera.width), np.float32)
    tracker.process(img, 0.0)
    assert tracker.state == ttrack.TrackState.NOT_INITIALIZED
    first_ref = tracker.init_ref_frame
    fr = tracker.process(img, 0.05)
    assert tracker.state == ttrack.TrackState.NOT_INITIALIZED
    assert tracker.init_ref_frame is fr and fr is not first_ref
    assert tracker.init_result is None
    tracker.state = ttrack.TrackState.LOST
    tracker.process(img, 0.1)
    assert tracker.state == ttrack.TrackState.LOST and tracker.n_relocs == 0


def test_convert_roundtrips_state():
    """numpy <-> torch: uint32 descriptors keep their bits as int32, every
    MPBlock / OrbFeatures field and a pose survive the round trip."""
    rng = np.random.default_rng(5)
    mp = jax.tree.map(np.array, jmap.empty_mp_block(64))
    mp.desc[:] = rng.integers(0, 2**32, mp.desc.shape, dtype=np.uint32)
    mp.Xw[:] = rng.normal(size=mp.Xw.shape)
    mp.valid[::3] = True
    t = convert.mp_block_from_numpy(mp, "cpu")
    assert t.desc.dtype == torch.int32 and t.valid.dtype == torch.bool
    back = convert.mp_block_to_numpy(t)
    for k in mp._fields:
        np.testing.assert_array_equal(getattr(back, k), np.asarray(getattr(mp, k)), err_msg=k)
    assert back.desc.dtype == np.uint32
    feats = jorb.OrbFeatures(
        xy=rng.uniform(0, 700, (32, 2)).astype(np.float32),
        response=rng.uniform(0, 9, 32).astype(np.float32),
        angle=rng.uniform(-3, 3, 32).astype(np.float32),
        octave=rng.integers(0, 8, 32).astype(np.int32),
        desc=rng.integers(0, 2**32, (32, 8), dtype=np.uint32),
        valid=rng.random(32) < 0.5)
    back = convert.orb_features_to_numpy(convert.orb_features_from_numpy(feats, "cpu"))
    for a, b in zip(back, feats):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    T = rng.normal(size=(4, 4)).astype(np.float32)
    np.testing.assert_array_equal(convert.pose_to_numpy(convert.pose_from_numpy(T, "cpu")), T)
