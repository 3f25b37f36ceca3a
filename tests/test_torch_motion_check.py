"""Port parity for Motion Check (models/motion_check.py) and the map-state
pieces it reads (models/map_state.py, convert.py).

The verdicts must be identical to the JAX package's, not close: revert
flag, violate mask, doubt counts, longest violating run and reverse-pass
failures, on the scenes of tests/test_motion_check.py (clean GBA, one
corrupted KF, garbage GBA, corrupted edge KFs, a global scale change) and
on two scenes with invalid slots; on the same scenes the array passes
equal the per-step loop they replaced. ``apply_verdict`` must give identical
blocks (poses within 1e-6, the rest equal), and the map-state reductions
(observation counts, gathered observations) equal arrays.

One known difference: the per-KF test's float32 angles round differently
from the JAX side's (numpy's arccos and its order of operations against
XLA's). Near cos = +-1 one float32 step of the cosine is 0.0198 degrees of
angle, so two angles of (anti)parallel steps may differ by up to two such
steps, ``ANGLE_GAP_DEG``; elsewhere they agree within 1e-3 degrees. A
check whose value lies within that gap of its limit (a tracking turn of
~0 makes the limit ~0) may flip; ``motion_violates`` agrees with the JAX
side on every other step quadruple.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioncheck_ccm_slam_tpu.config import MotionCheckParams as JParams
from motioncheck_ccm_slam_tpu.models import map_state as jms
from motioncheck_ccm_slam_tpu.models import motion_check as jmc
from motioncheck_ccm_slam_tpu_torch import convert
from motioncheck_ccm_slam_tpu_torch.config import MotionCheckParams as TParams
from motioncheck_ccm_slam_tpu_torch.models import map_state as tms
from motioncheck_ccm_slam_tpu_torch.models import motion_check as tmc

from test_motion_check import smooth_trajectory
from test_torch_motion_check_array import assert_passes_equal_the_loop
import torch_one_thread  # noqa: F401 (torch on one thread)

JP, TP_ = JParams(skip_edge_kfs=3), TParams(skip_edge_kfs=3)
# the JAX reference, compiled once per shape (its scans otherwise compile
# anew on every call)
_JIT_MC = jax.jit(jmc.run_motion_check, static_argnums=(3,))


@pytest.fixture(autouse=True)
def _jitted_jax_motion_check(monkeypatch):
    monkeypatch.setattr(jmc, "run_motion_check", _JIT_MC)


# two float32 steps of the cosine below 1, as an angle in the reference's
# degrees (180/3.14 a radian)
ANGLE_GAP_DEG = float(np.arccos(np.float64(1.0) - 2.0 ** -22) * 180.0 / 3.14)


def _step_quads(n, seed):
    """(step_post, prev_step_post, step_pre, prev_step_pre), (n, 3) each:
    tracking steps of 0.05-0.3 m turning by 0-20 degrees (a quarter of them
    turning ~0 in the xy plane, where the per-plane limit is ~0), and
    post-GBA steps off them by 0.1 mm to 5 cm."""
    rng = np.random.default_rng(seed)
    prev = rng.normal(size=(n, 3)) * rng.uniform(0.05, 0.3, (n, 1))
    turn = np.deg2rad(rng.uniform(0, 20, n))
    turn[: n // 4] = 0.0
    c, s = np.cos(turn), np.sin(turn)
    step = np.stack([c * prev[:, 0] - s * prev[:, 1], s * prev[:, 0] + c * prev[:, 1],
                     prev[:, 2] + rng.normal(0, 0.02, n)], -1)
    step *= rng.uniform(0.7, 1.4, (n, 1))
    noise = 10.0 ** rng.uniform(-4, np.log10(0.05), (4, n, 1))
    quads = [step + noise[0] * rng.normal(size=(n, 3)), prev + noise[1] * rng.normal(size=(n, 3)),
             step, prev]
    return [q.astype(np.float32) for q in quads]


def test_angles_match_jax_within_the_rounding_gap():
    """The float32 angle of the port and of the JAX side, on the steps of
    ``_step_quads``, their planes, and exactly (anti)parallel pairs: within
    ``ANGLE_GAP_DEG`` everywhere and 1e-3 degrees between 1 and 170."""
    sp, pp, st, pt = _step_quads(2048, 7)
    angle_j = jax.jit(jmc._angle_deg)
    pairs = [(sp, pp), (st, pt), (st, -2.5 * st), (pt, 0.7 * pt)]
    for a, b in pairs:
        for dims in ([0, 1, 2], [0, 1], [1, 2], [2, 0]):
            A, B = a[:, dims], b[:, dims]
            aj = np.asarray(angle_j(A, B))
            at = np.array([tmc._angle_deg(x, y) for x, y in zip(A, B)])
            gap = np.abs(at - aj)
            assert gap.max() <= ANGLE_GAP_DEG, (dims, gap.max())
            inner = (aj > 1.0) & (aj < 170.0)
            assert not inner.any() or gap[inner].max() <= 1e-3, dims


@pytest.mark.parametrize("margin", [1.0, 1.5])
def test_motion_violates_matches_jax_off_the_limits(margin):
    """``motion_violates`` gives the JAX side's answer on every quadruple
    whose checks all clear their limits by more than the angle rounding
    can move them (two angles and the limit's multiple of one, each by
    ``ANGLE_GAP_DEG``; the step ratios by 1e-5 relative), and flips only
    inside that band."""
    P = TP_
    quads = _step_quads(2048, 11)
    fj = jax.jit(jax.vmap(lambda a, b, c, d: jmc.motion_violates(
        a, b, c, d, jnp.float32(margin), jnp.float32(margin), JP)))
    vj = np.asarray(fj(*quads))
    vt = np.array([tmc.motion_violates(*q, np.float32(margin), np.float32(margin), P)
                   for q in zip(*quads)])
    sp, pp, st, pt = (q.astype(np.float64) for q in quads)

    def ang(a, b):
        cos = (a * b).sum(-1) / np.maximum(np.linalg.norm(a, axis=-1)
                                           * np.linalg.norm(b, axis=-1), 1e-12)
        return np.arccos(np.clip(cos, -1.0, 1.0)) * 180.0 / 3.14

    g = ANGLE_GAP_DEG
    deg, tdeg = ang(sp, pp), ang(st, pt)
    near = np.abs(np.abs(deg - tdeg) - np.minimum(tdeg * P.dir3d_track_mult, P.dir3d_cap_deg)
                  * margin) <= (2 + P.dir3d_track_mult * margin) * g
    txy = ang(st[:, [0, 1]], pt[:, [0, 1]])
    lim = np.minimum(txy * P.plane_track_mult, P.plane_cap_deg) * margin
    for d in ([0, 1], [1, 2], [2, 0]):
        near |= np.abs(np.abs(ang(sp[:, d], pp[:, d]) - ang(st[:, d], pt[:, d])) - lim) <= \
            (2 + P.plane_track_mult * margin) * g
    n = np.linalg.norm
    r = (n(sp, axis=-1) / n(pp, axis=-1)) / (n(st, axis=-1) / n(pt, axis=-1))
    rfac = P.ratio_mult * margin
    near |= (np.abs(r - rfac) <= 1e-5 * rfac) | (np.abs(1.0 / r - rfac) <= 1e-5 * rfac)
    assert 0 < vj.sum() < len(vj) and near.mean() < 0.2
    np.testing.assert_array_equal(vt[~near], vj[~near])


def _scene(name):
    """(post, pre, valid) of one scene, as tests/test_motion_check.py builds
    them (same seeds, same corruptions)."""
    n = 30 if name == "edge" else 40
    pre = smooth_trajectory(n)
    post = pre.copy()
    valid = np.ones(n, bool)
    if name == "clean":
        post = pre + 0.0005 * np.sin(np.arange(n))[:, None].astype(np.float32)
    elif name == "single":
        post[20] += np.array([0.5, -0.4, 0.3], np.float32)
    elif name == "garbage":
        rng = np.random.default_rng(1)
        post[10:30] += rng.uniform(-0.5, 0.5, (20, 3)).astype(np.float32)
    elif name == "edge":
        post[0] += 2.0
        post[-1] += 2.0
    elif name == "scale":
        post = pre * 1.5
    elif name == "single_with_holes":   # invalid slots inside the window
        post[20] += np.array([0.5, -0.4, 0.3], np.float32)
        valid[[5, 17, 33]] = False
    elif name == "two_bands":           # two corrupted bands: doubt relaxation
        post[12:14] += np.array([0.4, 0.3, -0.2], np.float32)
        post[25] += np.array([-0.6, 0.2, 0.1], np.float32)
        valid[8] = False
    return post.astype(np.float32), pre, valid


SCENES = ["clean", "single", "garbage", "edge", "scale", "single_with_holes", "two_bands"]


def _assert_same_verdict(vt, vj):
    assert vt.revert == bool(vj.revert)
    np.testing.assert_array_equal(vt.violate, np.asarray(vj.violate))
    np.testing.assert_array_equal(vt.doubt, np.asarray(vj.doubt))
    assert vt.longest_run == int(vj.longest_run)
    assert vt.n_rev_failures == int(vj.n_rev_failures)


@pytest.mark.parametrize("name", SCENES)
def test_run_motion_check_verdict_identical(name):
    post, pre, valid = _scene(name)
    vj = jmc.run_motion_check(jnp.asarray(post), jnp.asarray(pre), jnp.asarray(valid), JP)
    vt = tmc.run_motion_check(torch.from_numpy(post), torch.from_numpy(pre),
                              torch.from_numpy(valid), TP_)
    _assert_same_verdict(vt, vj)


@pytest.mark.parametrize("name", SCENES)
def test_array_pass_equals_the_loop_on_the_scenes(name):
    """The array passes against the per-step loop they replaced
    (tests/test_torch_motion_check_array.py), bitwise, on each scene."""
    assert_passes_equal_the_loop(*_scene(name), TP_)


def test_verdicts_are_the_scenes_expected_ones():
    """The port reaches tests/test_motion_check.py's verdicts itself."""
    v = {n: tmc.run_motion_check(*_scene(n), TP_) for n in SCENES[:5]}
    assert not v["clean"].revert and not v["clean"].violate.any()
    assert v["single"].violate[19:22].any() and not v["single"].revert
    assert v["garbage"].revert
    assert not v["edge"].violate.any() and not v["scale"].violate.any()


def _kf_block(n=24, seed=0):
    """A JAX KF block on a smooth trajectory (R = I) with a second client's
    KFs interleaved and invalid slots (as tests/test_motion_check.py's
    apply_verdict test)."""
    kf = jms.empty_kf_block(n, 8)
    pre = smooth_trajectory(n, seed=seed)
    Tcw = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    Tcw[:, :3, 3] = -pre
    valid = np.ones(n, bool)
    valid[[3, 20]] = False
    client = np.zeros(n, np.int32)
    client[1::5] = 1
    mp_idx = np.tile(np.arange(8, dtype=np.int32), (n, 1)) + np.arange(n)[:, None] // 2
    kf = kf._replace(valid=jnp.asarray(valid), timestamp=jnp.arange(n, dtype=jnp.float32),
                     Tcw=jnp.asarray(Tcw), client_id=jnp.asarray(client),
                     feat_valid=jnp.ones((n, 8), bool), mp_idx=jnp.asarray(mp_idx))
    return kf


@pytest.mark.parametrize("verdict", ["delete", "revert"])
def test_snapshot_check_and_apply_verdict_identical(verdict):
    """After the snapshot, two poses are thrown off (a delete verdict) or a
    band of eight alternately (a revert verdict)."""
    kf_j = _kf_block()
    T_SC = np.array([[0, -1, 0, 0.1], [1, 0, 0, -0.05], [0, 0, 1, 0.02], [0, 0, 0, 1]],
                    np.float32)
    T_SC_inv = np.linalg.inv(T_SC).astype(np.float32)
    kf_j = jmc.snapshot_pre_gba(kf_j, jnp.asarray(T_SC_inv))
    T = np.array(kf_j.Tcw)
    kick = np.array([0.7, -0.6, 0.5], np.float32)
    band = [12, 13] if verdict == "delete" else range(6, 14)
    for i, s in enumerate(band):
        T[s, :3, 3] += kick * (1 if i % 2 == 0 else -1)
    kf_j = kf_j._replace(Tcw=jnp.asarray(T))
    kf_t = convert.kf_block_from_numpy(kf_j, "cpu")
    mp_j = jms.empty_mp_block(40)._replace(valid=jnp.ones(40, bool))
    mp_t = convert.mp_block_from_numpy(mp_j, "cpu")
    for cid in (None, 0):
        vj, oj = jmc.check_after_gba(kf_j, jnp.asarray(T_SC_inv), JP, client_id=cid)
        vt, ot = tmc.check_after_gba(kf_t, torch.from_numpy(T_SC_inv), TP_, client_id=cid)
        np.testing.assert_array_equal(ot, oj)
        _assert_same_verdict(vt, vj)
        kj, mj, rj = jmc.apply_verdict(kf_j, mp_j, vj, oj)
        kt, mt, rt = tmc.apply_verdict(kf_t, mp_t, vt, ot)
        assert rt == rj == (verdict == "revert")
        kt, mt = convert.kf_block_to_numpy(kt), convert.mp_block_to_numpy(mt)
        np.testing.assert_allclose(kt.Tcw, np.asarray(kj.Tcw), atol=1e-6)
        for f in ("valid", "mp_idx", "feat_valid"):
            np.testing.assert_array_equal(getattr(kt, f), np.asarray(getattr(kj, f)))
        np.testing.assert_array_equal(mt.valid, np.asarray(mj.valid))
    np.testing.assert_allclose(kf_t.tracking_tws.numpy(), np.asarray(kf_j.tracking_tws),
                               atol=1e-6)


def test_map_state_reductions_match_jax():
    """Per-landmark observation counts (one KF holding a
    landmark at two features counts once) and the gathered observation
    stream."""
    rng = np.random.default_rng(4)
    nk, f, nm = 12, 16, 50
    kf = jms.empty_kf_block(nk, f)
    mp_idx = rng.integers(-1, nm, (nk, f)).astype(np.int32)
    mp_idx[2, :4] = 7                                    # duplicates in one KF
    kf = kf._replace(mp_idx=jnp.asarray(mp_idx),
                     feat_valid=jnp.asarray(rng.uniform(size=(nk, f)) < 0.8),
                     valid=jnp.asarray(rng.uniform(size=nk) < 0.8),
                     xy=jnp.asarray(rng.uniform(0, 700, (nk, f, 2)).astype(np.float32)),
                     octave=jnp.asarray(rng.integers(0, 8, (nk, f)).astype(np.int32)))
    kt = convert.kf_block_from_numpy(kf, "cpu")
    np.testing.assert_array_equal(tms.mp_observation_counts(kt, nm).numpy(),
                                  np.asarray(jms.mp_observation_counts(kf, nm)))
    for a, b in zip(tms.gather_observations(kt), jms.gather_observations(kf, 0)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_server_trajectories_pass_motion_check_under_pose_error():
    """The server map of ``entry.server_scene`` (chip_smoke.py's driver
    phase) is built so that an honest GBA passes Motion Check: every step's
    xy projection turns by at least 4.5 degrees (MC's per-plane limits are
    5x that turn), and with 1 cm of random error on every pose, about five
    times what an honest GBA moves the cameras there, no keyframe of any
    client is flagged."""
    from motioncheck_ccm_slam_tpu_torch import entry
    from motioncheck_ccm_slam_tpu_torch.ops import lie as tlie

    cfg = entry.SERVER_CONFIG
    nk = cfg.capacity.server_max_kfs
    T = torch.from_numpy(entry.server_poses(nk))
    per = nk // entry.N_CLIENTS
    kf = tms.empty_kf_block(nk, 1, "cpu")._replace(
        Tcw=T, valid=torch.ones(nk, dtype=torch.bool),
        client_id=torch.arange(nk, dtype=torch.int32) // per,
        timestamp=(torch.arange(nk) % per).float() * 0.25)
    T_SC_inv = torch.from_numpy(np.linalg.inv(cfg.camera.T_SC()).astype(np.float32))
    kf = tmc.snapshot_pre_gba(kf, T_SC_inv)
    pos = kf.tracking_tws.numpy().reshape(entry.N_CLIENTS, per, 3)
    steps = pos[:, 1:] - pos[:, :-1]
    turn = [tmc._plane_angle_deg(a, b, 0, 1)
            for c in range(entry.N_CLIENTS) for a, b in zip(steps[c, 1:], steps[c, :-1])]
    assert min(turn) > 4.5
    rng = np.random.default_rng(0)
    xi = np.zeros((nk, 6), np.float32)
    xi[:, :3] = rng.normal(0, 1e-3, (nk, 3))
    xi[:, 3:] = rng.normal(0, 1e-2, (nk, 3))
    kf = kf._replace(Tcw=tlie.se3_exp(torch.from_numpy(xi)) @ T)
    for c in range(entry.N_CLIENTS):
        verdict, _ = tmc.check_after_gba(kf, T_SC_inv, cfg.motion_check, client_id=c)
        assert not verdict.revert and not verdict.violate.any(), c
