"""Port parity: ops/matching.py and solvers/pose_opt.py of the torch port
against the JAX package on seeded arrays.

Matching is integer work on identical inputs, so it is held exactly. Pose
optimization is f32 with sums in another order: pose atol 1e-4, inlier set
identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioncheck_ccm_slam_tpu.config import DEFAULT_CONFIG
from motioncheck_ccm_slam_tpu.ops import lie as jlie, matching as jm
from motioncheck_ccm_slam_tpu.solvers import ba_core as jba, pose_opt as jpo
from motioncheck_ccm_slam_tpu_torch import convert
from motioncheck_ccm_slam_tpu_torch.ops import matching as tm
from motioncheck_ccm_slam_tpu_torch.solvers import ba_core as tba, pose_opt as tpo

import torch_one_thread  # noqa: F401 (torch on one thread)


def _desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


def _flip(rng, d, n_bits):
    d = d.copy()
    for row in d:
        for b in rng.integers(0, 256, n_bits):
            row[b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return d


def test_popcount_and_hamming_exact():
    rng = np.random.default_rng(0)
    x = np.array([0, 1, 3, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF], np.uint32)
    np.testing.assert_array_equal(
        tm.popcount_u32(convert.desc_from_numpy(x[None], "cpu"))[0].numpy(),
        np.asarray(jm.popcount_u32(jnp.asarray(x))))
    d1, d2 = _desc(rng, 300), _desc(rng, 200)
    d2[:50] = _flip(rng, d1[:50], 7)
    ref = np.asarray(jm.hamming_matrix(jnp.asarray(d1), jnp.asarray(d2)))
    out = tm.hamming_matrix(convert.desc_from_numpy(d1, "cpu"),
                            convert.desc_from_numpy(d2, "cpu"))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("nn_ratio", [1.0, 0.9, 0.6])
def test_masked_best_match_and_duplicates_exact(nn_ratio):
    rng = np.random.default_rng(1)
    # small integer range: many ties, which must break the same way
    dist = rng.integers(0, 12, (400, 150)).astype(np.int32)
    mask = rng.random((400, 150)) < 0.3
    ref = jm.masked_best_match(jnp.asarray(dist), jnp.asarray(mask), 8, nn_ratio)
    out = tm.masked_best_match(torch.from_numpy(dist), torch.from_numpy(mask), 8, nn_ratio)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ref = jm.resolve_duplicates(ref, 150)
    out = tm.resolve_duplicates(out, 150)
    assert out.ok.sum() > 20
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_search_by_projection_exact():
    rng = np.random.default_rng(2)
    nq, nt = 600, 300
    desc_t = _desc(rng, nt)
    src = rng.integers(0, nt, nq)
    desc_q = _flip(rng, desc_t[src], 20)
    desc_q[::3] = _desc(rng, len(desc_q[::3]))           # distractors
    uv_t = rng.uniform(0, 700, (nt, 2)).astype(np.float32)
    uv_q = (uv_t[src] + rng.uniform(-6, 6, (nq, 2))).astype(np.float32)
    oct_t = rng.integers(0, 8, nt).astype(np.int32)
    oct_q = np.clip(oct_t[src] + rng.integers(-2, 3, nq), 0, 7).astype(np.int32)
    valid_q, valid_t = rng.random(nq) < 0.9, rng.random(nt) < 0.9
    radius = (4.0 * 1.2 ** oct_q).astype(np.float32)
    args = (desc_q, uv_q, oct_q, valid_q, desc_t, uv_t, oct_t, valid_t, radius)
    for ratio in (0.9, 1.0):
        ref = jm.search_by_projection(*map(jnp.asarray, args), max_dist=jm.TH_HIGH,
                                      nn_ratio=ratio)
        t_args = [torch.from_numpy(a) for a in args]
        t_args[0] = convert.desc_from_numpy(desc_q, "cpu")
        t_args[4] = convert.desc_from_numpy(desc_t, "cpu")
        out = tm.search_by_projection(*t_args, max_dist=tm.TH_HIGH, nn_ratio=ratio)
        assert out.ok.sum() > 100
        np.testing.assert_array_equal(out.ok.numpy(), np.asarray(ref.ok))
        ok = np.asarray(ref.ok)
        np.testing.assert_array_equal(out.idx.numpy()[ok], np.asarray(ref.idx)[ok])
        np.testing.assert_array_equal(out.dist.numpy(), np.asarray(ref.dist))


def test_reproject_jacobians_and_huber():
    rng = np.random.default_rng(3)
    pc = (rng.normal(0, 1, (100, 3)) + [0, 0, 5]).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.3, (100, 3)).astype(np.float32))))
    K = DEFAULT_CONFIG.camera.K()
    ref = jba.reproject_jacobians(jnp.asarray(pc), jnp.asarray(R), jnp.asarray(K))
    out = tba.reproject_jacobians(torch.from_numpy(pc), torch.from_numpy(np.array(R)),
                                  torch.from_numpy(K))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-3)
    chi2 = rng.uniform(0, 30, 100).astype(np.float32)
    np.testing.assert_allclose(tba.huber_weights(torch.from_numpy(chi2)).numpy(),
                               np.asarray(jba.huber_weights(jnp.asarray(chi2))), rtol=1e-6)


@pytest.mark.parametrize("n_rounds,iters", [(2, 8), (2, 10), (4, 10)])
def test_optimize_pose_matches(n_rounds, iters):
    rng = np.random.default_rng(4 + n_rounds + iters)
    n = 400
    K = DEFAULT_CONFIG.camera.K()
    xi_true = np.array([0.02, -0.03, 0.01, 0.1, -0.05, 0.2], np.float32)
    T_true = np.array(jlie.se3_exp(jnp.asarray(xi_true)))
    Xw = (rng.normal(0, 1.5, (n, 3)) + [0, 0, 6]).astype(np.float32)
    pc = Xw @ T_true[:3, :3].T + T_true[:3, 3]
    uv = (pc[:, :2] / pc[:, 2:3] * [K[0, 0], K[1, 1]] + K[:2, 2]).astype(np.float32)
    uv += rng.normal(0, 0.7, uv.shape).astype(np.float32)
    uv[:40] += rng.uniform(-40, 40, (40, 2)).astype(np.float32)   # outliers
    octave = rng.integers(0, 4, n)
    inv_s2 = (1.0 / 1.44 ** octave).astype(np.float32)
    valid = rng.random(n) < 0.95
    T0 = np.array(jlie.se3_exp(jnp.asarray(xi_true + rng.normal(0, 0.02, 6).astype(np.float32))))
    args = (T0, Xw, uv, inv_s2, valid, K)
    ref = jpo.optimize_pose(*map(jnp.asarray, args), n_rounds=n_rounds,
                            iters_per_round=iters)
    out = tpo.optimize_pose(*(torch.from_numpy(a) for a in args), n_rounds=n_rounds,
                            iters_per_round=iters)
    np.testing.assert_allclose(out.Tcw.numpy(), np.asarray(ref.Tcw), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(out.inliers.numpy(), np.asarray(ref.inliers))
    assert int(out.n_inliers) == int(ref.n_inliers) > 300
    assert np.abs(out.Tcw.numpy() - T_true).max() < 0.05
