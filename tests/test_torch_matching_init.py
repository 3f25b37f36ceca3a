"""Port parity: the matching modes of ops/matching.py that bootstrap and
grow the map (two-view initialization, relocalization's mutual match,
triangulation's epipolar search, the Sim3-guided search) and their parts,
against the JAX package on seeded descriptors and keypoints.

Indices, distances and ok flags must be equal exactly: the distances are
integers, and every comparison before them is the same f32 arithmetic.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioncheck_ccm_slam_tpu.config import DEFAULT_CONFIG
from motioncheck_ccm_slam_tpu.ops import lie as jlie, matching as jm
from motioncheck_ccm_slam_tpu_torch import convert
from motioncheck_ccm_slam_tpu_torch.ops import matching as tm

import torch_one_thread  # noqa: F401 (torch on one thread)

CAM = DEFAULT_CONFIG.camera


def _desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


def _flip_bits(rng, d, n_bits):
    """Copies of descriptors with n_bits (per row) random bits flipped."""
    d = d.copy()
    for r in range(len(d)):
        for b in rng.choice(256, n_bits[r], replace=False):
            d[r, b // 32] ^= np.uint32(1 << (b % 32))
    return d


def _t(a, dtype=None):
    if isinstance(a, np.ndarray) and a.dtype == np.uint32:
        return convert.desc_from_numpy(a, "cpu")
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _assert_same(out_t, out_j):
    np.testing.assert_array_equal(out_t.ok.numpy(), np.asarray(out_j.ok))
    np.testing.assert_array_equal(out_t.idx.numpy(), np.asarray(out_j.idx))
    np.testing.assert_array_equal(out_t.dist.numpy(), np.asarray(out_j.dist))
    assert np.asarray(out_j.ok).sum() > 20, "the case matches too little to test"


@pytest.fixture(scope="module")
def two_views():
    """Two feature sets: 300 of view 2's features are view 1's moved a few
    pixels, with 0-60 bits flipped and their angle turned by ~0.4 rad,
    plus 212 unrelated ones; the order shuffled; some slots invalid."""
    rng = np.random.default_rng(0)
    n = 512
    d1 = _desc(rng, n)
    uv1 = rng.uniform([20, 20], [CAM.width - 20, CAM.height - 20], (n, 2)).astype(np.float32)
    ang1 = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    perm = rng.permutation(n)
    shared = perm[:300]
    d2 = _desc(rng, n)
    d2[:300] = _flip_bits(rng, d1[shared], rng.integers(0, 60, 300))
    uv2 = rng.uniform([20, 20], [CAM.width - 20, CAM.height - 20], (n, 2)).astype(np.float32)
    uv2[:300] = uv1[shared] + rng.normal(0, 15, (300, 2)).astype(np.float32)
    ang2 = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    ang2[:300] = ang1[shared] + 0.4 + rng.normal(0, 0.15, 300).astype(np.float32)
    # a fifth of the shared ones turned the other way: the rotation filter's prey
    ang2[:60] -= 2.0
    order = rng.permutation(n)
    d2, uv2, ang2 = d2[order], uv2[order], ang2[order]
    v1 = rng.random(n) < 0.95
    v2 = rng.random(n) < 0.95
    return dict(d1=d1, uv1=uv1, ang1=ang1, v1=v1, d2=d2, uv2=uv2, ang2=ang2, v2=v2)


def test_popcount_and_hamming_rows():
    rng = np.random.default_rng(1)
    a, b = _desc(rng, 200), _desc(rng, 200)
    a[0], b[0] = 0, 0xFFFFFFFF
    np.testing.assert_array_equal(tm.popcount_u32(_t(a)).numpy(),
                                  np.asarray(jm.popcount_u32(jnp.asarray(a))))
    out = tm.hamming_rows(_t(a), _t(b))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(jm.hamming_rows(jnp.asarray(a),
                                                                          jnp.asarray(b))))


@pytest.mark.parametrize("n_keep", [1, 3])
def test_rotation_consistency(n_keep):
    rng = np.random.default_rng(2)
    aq = rng.uniform(-np.pi, np.pi, 400).astype(np.float32)
    # three popular offsets (one with an equal count to another), the rest scattered
    off = np.concatenate([np.full(120, 0.5), np.full(80, 2.0), np.full(80, -1.0),
                          rng.uniform(0, 2 * np.pi, 120)]).astype(np.float32)
    at = (aq - off + rng.normal(0, 0.02, 400)).astype(np.float32)
    ok = rng.random(400) < 0.9
    out_t = tm.rotation_consistency(_t(aq), _t(at), _t(ok), n_keep=n_keep)
    out_j = jm.rotation_consistency(jnp.asarray(aq), jnp.asarray(at), jnp.asarray(ok),
                                    n_keep=n_keep)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    assert 0 < out_t.sum() < ok.sum()


@pytest.mark.parametrize("check_rotation", [True, False])
def test_search_for_initialization(two_views, check_rotation):
    s = two_views
    args = (s["d1"], s["uv1"], s["v1"], s["d2"], s["uv2"], s["v2"])
    kw = dict(window=50.0, angle1=s["ang1"], angle2=s["ang2"], check_rotation=check_rotation)
    out_t = tm.search_for_initialization(*(_t(a) for a in args), window=50.0,
                                         angle1=_t(s["ang1"]), angle2=_t(s["ang2"]),
                                         check_rotation=check_rotation)
    out_j = jm.search_for_initialization(*(jnp.asarray(a) for a in args),
                                         **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                                            else v for k, v in kw.items()})
    _assert_same(out_t, out_j)


@pytest.mark.parametrize("nn_ratio", [1.0, 0.85])
def test_mutual_match(two_views, nn_ratio):
    s = two_views
    args = (s["d1"], s["v1"], s["d2"], s["v2"])
    out_t = tm.mutual_match(*(_t(a) for a in args), max_dist=tm.TH_LOW, nn_ratio=nn_ratio)
    out_j = jm.mutual_match(*(jnp.asarray(a) for a in args), max_dist=jm.TH_LOW,
                            nn_ratio=nn_ratio)
    _assert_same(out_t, out_j)


def _scene(rng, n):
    """Points seen from two cameras; each camera's feature order shuffled."""
    pts = (rng.uniform(-3, 3, (n, 3)) + [0, 0, 7]).astype(np.float32)
    T2 = np.array(jlie.se3_exp(jnp.asarray(np.array([0.01, -0.03, 0.0, 0.5, 0.02, -0.05],
                                                    np.float32))))
    K = CAM.K()

    def proj(T):
        pc = pts @ T[:3, :3].T + T[:3, 3]
        return (pc[:, :2] / pc[:, 2:3] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]).astype(np.float32)

    return pts, T2, proj(np.eye(4, dtype=np.float32)), proj(T2)


def test_epipolar_search_for_triangulation():
    rng = np.random.default_rng(3)
    n = 400
    pts, T2, uv1, uv2 = _scene(rng, n)
    uv1 = uv1 + rng.normal(0, 0.7, uv1.shape).astype(np.float32)
    uv2 = uv2 + rng.normal(0, 0.7, uv2.shape).astype(np.float32)
    d1 = _desc(rng, n)
    d2 = _flip_bits(rng, d1, rng.integers(0, 40, n))
    order = rng.permutation(n)
    uv2, d2 = uv2[order], d2[order]
    oct2 = rng.integers(0, 4, n).astype(np.int32)
    inv_s2 = (1.0 / (1.2 ** np.arange(8)) ** 2).astype(np.float32)
    K = CAM.K()
    Kinv = np.linalg.inv(K).astype(np.float32)
    R, t = T2[:3, :3], T2[:3, 3]
    F12 = (Kinv.T @ np.asarray(jlie.hat(jnp.asarray(t))) @ R @ Kinv).astype(np.float32)
    v1, v2 = rng.random(n) < 0.95, rng.random(n) < 0.95
    args = (d1, uv1, v1, d2, uv2, v2, F12, inv_s2, oct2)
    out_t = tm.search_for_triangulation(*(_t(a) for a in args))
    out_j = jm.search_for_triangulation(*(jnp.asarray(a) for a in args))
    _assert_same(out_t, out_j)
    lines = (np.concatenate([uv1, np.ones((n, 1), np.float32)], -1) @ F12.T).astype(np.float32)
    np.testing.assert_allclose(
        tm.epipolar_line_distance(_t(uv2), _t(lines)).numpy(),
        np.asarray(jm.epipolar_line_distance(jnp.asarray(uv2), jnp.asarray(lines))),
        rtol=1e-5, atol=1e-5)


def test_search_by_sim3():
    rng = np.random.default_rng(4)
    n = 300
    Xc1 = (rng.uniform(-3, 3, (n, 3)) + [0, 0, 7]).astype(np.float32)
    S12 = np.array(jlie.sim3_exp(jnp.asarray(np.array(
        [0.02, -0.01, 0.03, 0.2, -0.1, 0.1, 0.3], np.float32))))
    Xc2 = np.array(jlie.sim3_apply(jlie.sim3_inv(jnp.asarray(S12)), jnp.asarray(Xc1)[None]))[0]
    Xc2 = Xc2 + rng.normal(0, 0.005, Xc2.shape).astype(np.float32)
    d1 = _desc(rng, n)
    d2 = _flip_bits(rng, d1, rng.integers(0, 80, n))
    order = rng.permutation(n)
    Xc2, d2 = Xc2[order], d2[order]
    v1, v2 = rng.random(n) < 0.95, rng.random(n) < 0.95
    args = (d1, Xc1, v1, d2, Xc2, v2, S12, CAM.K())
    out_t = tm.search_by_sim3(*(_t(a) for a in args))
    out_j = jm.search_by_sim3(*(jnp.asarray(a) for a in args))
    _assert_same(out_t, out_j)
