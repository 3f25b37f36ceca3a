"""Port parity: ops/lie.py, ops/geometry.py and ops/image.py of the torch
port against the JAX package on seeded inputs.

Tolerance rtol 1e-5, atol 1e-5: the same f32 formulas, reassociated. Near
theta = pi, so3_log's axis comes from R + I, whose columns carry the f32
rounding of R: 1e-4 there. Results that come out of an SVD or an
eigendecomposition (triangulate_dlt, horn_align) are compared as points
and rotations, whose singular-vector signs cancel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioncheck_ccm_slam_tpu.config import DEFAULT_CONFIG
from motioncheck_ccm_slam_tpu.ops import geometry as jgeo, image as jimg, lie as jlie
from motioncheck_ccm_slam_tpu_torch.ops import geometry as tgeo, image as timg, lie as tlie

import torch_one_thread  # noqa: F401 (torch on one thread)

TOL = dict(rtol=1e-5, atol=1e-5)
NEAR_PI_TOL = dict(rtol=1e-4, atol=1e-4)


def _xi(seed, n, scale):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (n, 6)) * scale).astype(np.float32)


@pytest.mark.parametrize("scale", [1e-5, 1e-2, 0.5], ids=["tiny", "small", "large"])
def test_se3_exp_and_inverse(scale):
    xi = _xi(0, 64, scale)
    T_j = np.array(jlie.se3_exp(jnp.asarray(xi)))
    T_t = tlie.se3_exp(torch.from_numpy(xi)).numpy()
    np.testing.assert_allclose(T_t, T_j, **TOL)
    np.testing.assert_allclose(tlie.inv_T(torch.from_numpy(T_j)).numpy(),
                               np.asarray(jlie.inv_T(jnp.asarray(T_j))), **TOL)
    np.testing.assert_allclose(tlie.so3_exp(torch.from_numpy(xi[:, :3])).numpy(),
                               np.asarray(jlie.so3_exp(jnp.asarray(xi[:, :3]))), **TOL)


def test_transform_points_and_make_T():
    rng = np.random.default_rng(1)
    T = np.array(jlie.se3_exp(jnp.asarray(_xi(1, 3, 0.3))))
    pts = rng.normal(0, 2, (3, 50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tlie.transform_points(torch.from_numpy(T), torch.from_numpy(pts)).numpy(),
        np.asarray(jlie.transform_points(jnp.asarray(T), jnp.asarray(pts))), **TOL)
    R, t = tlie.split_T(torch.from_numpy(T))
    np.testing.assert_array_equal(tlie.make_T(R, t).numpy(), T)


def test_project_and_in_image():
    rng = np.random.default_rng(2)
    cam = DEFAULT_CONFIG.camera
    pc = rng.normal(0, 1, (200, 3)).astype(np.float32) + np.array([0, 0, 4], np.float32)
    uv_j = np.array(jgeo.project(jnp.asarray(pc)[None], jnp.asarray(cam.K()))[0])
    uv_t = tgeo.project(torch.from_numpy(pc)[None], torch.from_numpy(cam.K()))[0].numpy()
    np.testing.assert_allclose(uv_t, uv_j, **TOL)
    np.testing.assert_array_equal(
        tgeo.in_image(torch.from_numpy(uv_j), cam.width, cam.height).numpy(),
        np.asarray(jgeo.in_image(jnp.asarray(uv_j), cam.width, cam.height)))


def test_undistort_points_euroc():
    rng = np.random.default_rng(3)
    cam = DEFAULT_CONFIG.camera
    uv = rng.uniform([0, 0], [cam.width, cam.height], (500, 2)).astype(np.float32)
    K, dist = cam.K(), cam.dist_coeffs()
    ref = np.asarray(jgeo.undistort_points(jnp.asarray(uv), jnp.asarray(K), jnp.asarray(dist)))
    out = tgeo.undistort_points(torch.from_numpy(uv), torch.from_numpy(K),
                                torch.from_numpy(dist)).numpy()
    # pixels: the 1e-5 bound is on normalized coordinates times fx ~ 458
    np.testing.assert_allclose(out / cam.fx, ref / cam.fx, **TOL)
    np.testing.assert_allclose(
        tgeo.distort_normalized(torch.from_numpy(uv / 500.0), torch.from_numpy(dist)).numpy(),
        np.asarray(jgeo.distort_normalized(jnp.asarray(uv / 500.0), jnp.asarray(dist))), **TOL)


def test_pyramid_and_blur():
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 255, (120, 188)).astype(np.float32)
    assert timg.pyramid_shapes(480, 752, 8, 1.2) == jimg.pyramid_shapes(480, 752, 8, 1.2)
    lv_j = jimg.build_pyramid(jnp.asarray(img), 4, 1.2)
    lv_t = timg.build_pyramid(torch.from_numpy(img), 4, 1.2)
    np.testing.assert_array_equal(lv_t[0].numpy(), img)
    for a, b in zip(lv_t, lv_j):
        assert tuple(a.shape) == b.shape
        # bilinear resize: F.interpolate vs jax.image.resize, ~3e-5 on 0..255
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-3)
    np.testing.assert_allclose(timg.gaussian_blur(torch.from_numpy(img)).numpy(),
                               np.asarray(jimg.gaussian_blur(jnp.asarray(img))),
                               rtol=1e-5, atol=1e-4)
    xy = rng.uniform(-5, 200, (300, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        timg.nearest_sample(torch.from_numpy(img), torch.from_numpy(xy)).numpy(),
        np.asarray(jimg.nearest_sample(jnp.asarray(img), jnp.asarray(xy))))


def _rotvecs(seed, n, lo, hi):
    """n rotation vectors with angles in [lo, hi)."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    return (axis * rng.uniform(lo, hi, (n, 1))).astype(np.float32)


def _both(fn_t, fn_j, *args):
    """(port, JAX) results of one function on the same numpy inputs."""
    out_t = fn_t(*(torch.from_numpy(a) for a in args))
    out_j = fn_j(*(jnp.asarray(a) for a in args))
    return out_t, out_j


@pytest.mark.parametrize("lo,hi", [(0.0, 1e-4), (1e-3, 3.0)], ids=["tiny", "generic"])
def test_so3_log_se3_log_vee(lo, hi):
    w = _rotvecs(10, 64, lo, hi)
    R = np.array(jlie.so3_exp(jnp.asarray(w)))
    out_t, out_j = _both(tlie.so3_log, jlie.so3_log, R)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    xi = np.concatenate([w, _xi(11, 64, 1.0)[:, 3:]], -1)
    T = np.array(jlie.se3_exp(jnp.asarray(xi)))
    out_t, out_j = _both(tlie.se3_log, jlie.se3_log, T)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    W = np.array(jlie.hat(jnp.asarray(w)))
    np.testing.assert_array_equal(tlie.vee(torch.from_numpy(W)).numpy(),
                                  np.asarray(jlie.vee(jnp.asarray(W))))


def test_so3_log_near_pi():
    w = _rotvecs(12, 32, np.pi - 1e-2, np.pi - 1e-4)
    R = np.array(jlie.so3_exp(jnp.asarray(w)))
    out_t, out_j = _both(tlie.so3_log, jlie.so3_log, R)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **NEAR_PI_TOL)


def test_quaternions():
    w = np.concatenate([_rotvecs(13, 60, 0.0, 3.1),
                        _rotvecs(14, 4, np.pi - 1e-3, np.pi - 1e-4)])
    R = np.array(jlie.so3_exp(jnp.asarray(w)))
    q_t, q_j = _both(tlie.rot_to_quat, jlie.rot_to_quat, R)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), **TOL)
    rng = np.random.default_rng(15)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    R_t, R_j = _both(tlie.quat_to_rot, jlie.quat_to_rot, q)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), **TOL)


@pytest.mark.parametrize("scale", [1e-6, 1e-2, 0.4], ids=["tiny", "small", "large"])
def test_sim3(scale):
    rng = np.random.default_rng(16)
    xi = (rng.normal(size=(48, 7)) * scale).astype(np.float32)
    S_t, S_j = _both(tlie.sim3_exp, jlie.sim3_exp, xi)
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), **TOL)
    S = np.array(S_j)
    for name in ("sim3_log", "sim3_inv"):
        out_t, out_j = _both(getattr(tlie, name), getattr(jlie, name), S)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL, err_msg=name)
    for a, b in zip(*_both(tlie.split_sim3, jlie.split_sim3, S)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    pts = rng.normal(0, 2, (48, 30, 3)).astype(np.float32)
    out_t, out_j = _both(tlie.sim3_apply, jlie.sim3_apply, S, pts)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    R, t, s = (np.asarray(a) for a in jlie.split_sim3(jnp.asarray(S)))
    out_t, out_j = _both(tlie.make_sim3, jlie.make_sim3, R, t, s)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_align(fix_scale):
    rng = np.random.default_rng(17)
    p1 = rng.uniform(-2, 2, (8, 40, 3)).astype(np.float32)
    S = np.array(jlie.sim3_exp(jnp.asarray((rng.normal(size=(8, 7)) * 0.4).astype(np.float32))))
    p2 = np.array(jlie.sim3_apply(jnp.asarray(S), jnp.asarray(p1)))
    p2 += rng.normal(0, 0.01, p2.shape).astype(np.float32)
    w = (rng.random((8, 40)) < 0.8).astype(np.float32)
    for weights in (None, w):
        args = (p1, p2) if weights is None else (p1, p2, weights)
        out_t = tlie.horn_align(*(torch.from_numpy(a) for a in args), fix_scale=fix_scale)
        out_j = jlie.horn_align(*(jnp.asarray(a) for a in args), fix_scale=fix_scale)
        for a, b in zip(out_t, out_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=2e-5)


def test_backproject_projection_and_camera_center():
    rng = np.random.default_rng(18)
    cam = DEFAULT_CONFIG.camera
    K = cam.K()
    uv = rng.uniform([0, 0], [cam.width, cam.height], (100, 2)).astype(np.float32)
    out_t, out_j = _both(tgeo.backproject, jgeo.backproject, uv, K)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    T = np.array(jlie.se3_exp(jnp.asarray(_xi(19, 5, 0.5))))
    out_t, out_j = _both(tgeo.projection_matrix, jgeo.projection_matrix, K, T)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    out_t, out_j = _both(tgeo.camera_center, jgeo.camera_center, T)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


def test_triangulation_reprojection_and_parallax():
    rng = np.random.default_rng(20)
    cam = DEFAULT_CONFIG.camera
    K = cam.K()
    pts = (rng.uniform(-2, 2, (200, 3)) + [0, 0, 6]).astype(np.float32)
    T1 = np.eye(4, dtype=np.float32)
    T2 = np.array(jlie.se3_exp(jnp.asarray(np.array([0.02, -0.05, 0.01, 0.8, 0.05, -0.1],
                                                    np.float32))))
    uv = [np.asarray(jgeo.project(jlie.transform_points(jnp.asarray(T), jnp.asarray(pts)[None]),
                                  jnp.asarray(K)))[0] + rng.normal(0, 0.5, (200, 2)).astype(np.float32)
          for T in (T1, T2)]
    P = [np.asarray(jgeo.projection_matrix(jnp.asarray(K), jnp.asarray(T))) for T in (T1, T2)]
    (X_t, s_t), (X_j, s_j) = _both(tgeo.triangulate_dlt, jgeo.triangulate_dlt,
                                   P[0], P[1], uv[0][None], uv[1][None])
    np.testing.assert_allclose(X_t.numpy(), np.asarray(X_j), rtol=1e-4, atol=1e-4)
    # the smallest singular value carries the f32 rounding of the largest
    # (~1e3: the systems' entries are pixels times K): absolute 2e-4
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=0, atol=2e-4)
    inv_s2 = rng.uniform(0.3, 1.0, 200).astype(np.float32)
    (c_t, d_t), (c_j, d_j) = _both(tgeo.reprojection_chi2, jgeo.reprojection_chi2,
                                   pts, T2, K, uv[1], inv_s2)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), **TOL)
    C = [np.asarray(jgeo.camera_center(jnp.asarray(T))) for T in (T1, T2)]
    out_t, out_j = _both(tgeo.parallax_cos, jgeo.parallax_cos, C[0], C[1], pts)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
