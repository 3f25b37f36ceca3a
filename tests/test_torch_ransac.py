"""Port parity: ops/ransac.py against the JAX package on test_ransac.py's
scenes, with the JAX hypotheses replayed.

The two packages cannot draw the same hypotheses from their own
generators, so the port's ``_sample_indices`` is replaced, in these tests
only, by one that returns what JAX's ``_sample_indices`` draws from the
key the JAX solver uses. With the draws equal:

- success, the model choice and the good / inlier masks must be equal;
- poses (4x4 entries), rotations, translations and scale within 1e-4;
- triangulated points within 1e-4 relative to their distance;
- the homography and fundamental hypotheses, each normalised to unit
  Frobenius norm and a positive largest entry (singular vectors have no
  sign), within 1e-3 on samples of 8 distinct points (a repeated point
  leaves F's null space two-dimensional, any vector in it is a solution).

The JAX solvers run jitted (one compile instead of hundreds of eager op
compiles); jax.random draws the same under jit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioncheck_ccm_slam_tpu.config import CameraParams
from motioncheck_ccm_slam_tpu.ops import lie as jlie, ransac as jr
from motioncheck_ccm_slam_tpu_torch.ops import ransac as tr

from test_ransac import make_two_view
import torch_one_thread  # noqa: F401 (torch on one thread)

CAM = CameraParams()
K = CAM.K()
POSE_ATOL = 1e-4
PTS_RTOL = 1e-4
J_INIT = jax.jit(jr.initialize_two_view)
J_PNP = jax.jit(jr.pnp_ransac)
J_SIM3 = jax.jit(jr.sim3_ransac, static_argnames=("fix_scale",))


class JaxDraws:
    """Stands in for the port's _sample_indices: JAX's draws from ``key``."""

    def __init__(self, key):
        self.key = key
        self.calls = 0

    def __call__(self, generator, n_hyp, set_size, n_pts, weights=None):
        self.calls += 1
        w = None if weights is None else jnp.asarray(weights.numpy())
        return torch.from_numpy(np.asarray(
            jr._sample_indices(self.key, n_hyp, set_size, n_pts, weights=w)).astype(np.int64))


def _gen():
    return torch.Generator().manual_seed(0)


def _two_view_case(seed, planar, outlier_frac):
    rng = np.random.default_rng(seed)
    _, T2, uv1, uv2, _ = make_two_view(rng, planar=planar, outlier_frac=outlier_frac)
    uv1, uv2 = np.asarray(uv1), np.asarray(uv2)
    mask = np.ones(len(uv1), bool)
    mask[::17] = False      # unmatched slots: drawn never, counted never
    return uv1, uv2, mask


@pytest.mark.parametrize("seed,planar,outlier_frac", [(0, False, 0.1), (1, True, 0.05)],
                         ids=["general", "planar"])
def test_initialize_two_view_matches_jax(monkeypatch, seed, planar, outlier_frac):
    uv1, uv2, mask = _two_view_case(seed, planar, outlier_frac)
    key = jax.random.PRNGKey(seed)
    ref = J_INIT(key, jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(mask),
                                 jnp.asarray(K))
    draws = JaxDraws(jax.random.split(key)[0])   # initialize_two_view draws with k1
    monkeypatch.setattr(tr, "_sample_indices", draws)
    out = tr.initialize_two_view(_gen(), torch.from_numpy(uv1), torch.from_numpy(uv2),
                                 torch.from_numpy(mask), torch.from_numpy(K))
    assert draws.calls == 1
    assert bool(ref.success) and bool(out.success)
    assert bool(out.used_homography) == bool(ref.used_homography) == planar
    np.testing.assert_array_equal(out.good.numpy(), np.asarray(ref.good))
    np.testing.assert_allclose(out.Tcw2.numpy(), np.asarray(ref.Tcw2), rtol=0, atol=POSE_ATOL)
    good = np.asarray(ref.good)
    p_t, p_j = out.pts3d.numpy()[good], np.asarray(ref.pts3d)[good]
    err = np.linalg.norm(p_t - p_j, axis=-1) / np.linalg.norm(p_j, axis=-1)
    assert err.max() <= PTS_RTOL, err.max()


def _normalized(M):
    M = M / np.linalg.norm(M, axis=(-2, -1), keepdims=True)
    flat = M.reshape(len(M), -1)
    sign = np.sign(flat[np.arange(len(M)), np.abs(flat).argmax(-1)])
    return M * sign[:, None, None]


def test_h_and_f_hypotheses_match_jax():
    uv1, uv2, mask = _two_view_case(0, False, 0.1)
    idx = np.asarray(jr._sample_indices(jax.random.PRNGKey(5), 256, 8, len(uv1),
                                        weights=jnp.asarray(mask, jnp.float32)))
    distinct = np.array([len(set(r)) == 8 for r in idx])
    assert distinct.sum() > 150
    n1, _ = jr._normalize_points(jnp.asarray(uv1), jnp.asarray(mask))
    n2, _ = jr._normalize_points(jnp.asarray(uv2), jnp.asarray(mask))
    s1, s2 = np.asarray(n1)[idx], np.asarray(n2)[idx]
    for name in ("_solve_h_dlt", "_solve_f_8pt"):
        out_j = np.asarray(getattr(jr, name)(jnp.asarray(s1), jnp.asarray(s2)))
        out_t = getattr(tr, name)(torch.from_numpy(s1), torch.from_numpy(s2)).numpy()
        np.testing.assert_allclose(_normalized(out_t)[distinct], _normalized(out_j)[distinct],
                                   rtol=0, atol=1e-3, err_msg=name)
    # the normalisation itself
    for a, b in zip(tr._normalize_points(torch.from_numpy(uv1), torch.from_numpy(mask)),
                    jr._normalize_points(jnp.asarray(uv1), jnp.asarray(mask))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_two_view_refuses_a_tiny_baseline(monkeypatch):
    """test_ransac's near-zero baseline: both refuse, on the same draws
    (the 150 matches padded to 200 slots with unmatched ones, the shape of
    the other cases)."""
    rng = np.random.default_rng(2)
    pts = (rng.uniform(-2, 2, size=(150, 3)) + [0, 0, 6]).astype(np.float32)
    T2 = np.asarray(jlie.se3_exp(jnp.asarray(np.array([0, 0, 0, 1e-4, 0, 0], np.float32))))
    uv1 = pts[:, :2] / pts[:, 2:] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    pc2 = pts @ T2[:3, :3].T + T2[:3, 3]
    uv2 = pc2[:, :2] / pc2[:, 2:] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    pad = np.zeros((50, 2))
    uv1 = np.concatenate([uv1, pad]).astype(np.float32)
    uv2 = np.concatenate([uv2, pad]).astype(np.float32)
    mask = np.arange(200) < 150
    key = jax.random.PRNGKey(2)
    ref = J_INIT(key, jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(mask),
                                 jnp.asarray(K))
    monkeypatch.setattr(tr, "_sample_indices", JaxDraws(jax.random.split(key)[0]))
    out = tr.initialize_two_view(_gen(), torch.from_numpy(uv1), torch.from_numpy(uv2),
                                 torch.from_numpy(mask), torch.from_numpy(K))
    assert not bool(ref.success) and not bool(out.success)
    assert not out.good.any()


def test_pnp_ransac_matches_jax(monkeypatch):
    rng = np.random.default_rng(3)
    n = 120
    pts = (rng.uniform(-2, 2, size=(n, 3)) + [0, 0, 6]).astype(np.float32)
    Tcw = np.asarray(jlie.se3_exp(jnp.asarray(np.array([0.1, -0.2, 0.05, 0.3, 0.1, -0.2],
                                                       np.float32))))
    pc = pts @ Tcw[:3, :3].T + Tcw[:3, 3]
    uv = pc[:, :2] / pc[:, 2:] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    uv = (uv + rng.normal(0, 0.3, uv.shape)).astype(np.float32)
    uv[:30] += rng.uniform(30, 80, (30, 2)).astype(np.float32)
    mask = rng.random(n) < 0.9
    key = jax.random.PRNGKey(3)
    ref = J_PNP(key, jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(mask),
                        jnp.asarray(K))
    draws = JaxDraws(key)                        # pnp_ransac draws with its key
    monkeypatch.setattr(tr, "_sample_indices", draws)
    out = tr.pnp_ransac(_gen(), torch.from_numpy(pts), torch.from_numpy(uv),
                        torch.from_numpy(mask), torch.from_numpy(K))
    assert draws.calls == 1
    assert bool(ref.success) and bool(out.success)
    np.testing.assert_array_equal(out.inliers.numpy(), np.asarray(ref.inliers))
    np.testing.assert_allclose(out.Tcw.numpy(), np.asarray(ref.Tcw), rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(out.Tcw.numpy(), Tcw, rtol=0, atol=5e-3)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_ransac_matches_jax(monkeypatch, fix_scale):
    rng = np.random.default_rng(4)
    n = 80
    p1 = (rng.uniform(-2, 2, size=(n, 3)) + [0, 0, 6]).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(np.array([0.1, -0.2, 0.3], np.float32))))
    s_true = 1.0 if fix_scale else 1.6
    p2 = (s_true * p1 @ R.T + np.array([0.5, -0.3, 1.0], np.float32)).astype(np.float32)
    p2n = p2.copy()
    p2n[:20] += rng.uniform(1.0, 3.0, (20, 3)).astype(np.float32)
    T1 = np.eye(4, dtype=np.float32)

    def uv_of(p):
        return (p[:, :2] / p[:, 2:] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]).astype(np.float32)

    mask = rng.random(n) < 0.95
    args = (p1, p2n, uv_of(p1), uv_of(p2), T1, T1, K, mask)
    key = jax.random.PRNGKey(4)
    ref = J_SIM3(key, *(jnp.asarray(a) for a in args), fix_scale=fix_scale)
    draws = JaxDraws(key)
    monkeypatch.setattr(tr, "_sample_indices", draws)
    out = tr.sim3_ransac(_gen(), *(torch.from_numpy(a) for a in args), fix_scale=fix_scale)
    assert draws.calls == 1
    assert bool(ref.success) and bool(out.success)
    np.testing.assert_array_equal(out.inliers.numpy(), np.asarray(ref.inliers))
    for name in ("R", "t", "s"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=POSE_ATOL, err_msg=name)


def test_own_draws_follow_the_mask():
    """The port's own draws: only masked points, every index in range, and
    uniform draws without weights."""
    g = _gen()
    w = torch.zeros(50)
    w[[3, 7, 41]] = 1.0
    idx = tr._sample_indices(g, 256, 8, 50, weights=w)
    assert idx.shape == (256, 8) and idx.dtype == torch.int64
    assert set(idx.unique().tolist()) == {3, 7, 41}
    idx = tr._sample_indices(g, 256, 8, 50)
    assert int(idx.min()) >= 0 and int(idx.max()) < 50 and len(idx.unique()) > 40
    # an all-zero mask still draws (JAX's log(max(w, 1e-20)) logits do)
    assert tr._sample_indices(g, 4, 3, 50, weights=torch.zeros(50)).shape == (4, 3)
