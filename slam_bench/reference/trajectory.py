"""A trajectory against the scene's truth, in float64 numpy.

A monocular map has its own frame and scale, so each comparison is free of
both. ``step_errors`` compares each step between consecutive poses: the
angle between the estimated and the true direction of the camera's move,
both in the first pose's camera frame, and the angle of the rotation
between the estimated and the true relative rotation. A map's slow drift
of scale does not change them; a wrong step does. ``ate`` is the
root-mean-square camera-centre error after one similarity alignment
(Umeyama) of the whole trajectory, which also counts drift.
"""
from __future__ import annotations

import numpy as np


def centres(T: np.ndarray) -> np.ndarray:
    """Camera centres of (N, 4, 4) world-to-camera poses."""
    T = np.asarray(T, np.float64)
    return -np.einsum("kji,kj->ki", T[:, :3, :3], T[:, :3, 3])


def _rotations(T: np.ndarray) -> np.ndarray:
    """The nearest rotation of each pose's 3x3 block."""
    U, _, Vt = np.linalg.svd(np.asarray(T, np.float64)[:, :3, :3])
    D = np.ones((len(U), 3))
    D[:, 2] = np.sign(np.linalg.det(U @ Vt))
    return np.einsum("kij,kj,kjl->kil", U, D, Vt)


def step_errors(T_est: np.ndarray, T_true: np.ndarray) -> tuple:
    """(direction error, rotation error), degrees, of each step i -> i+1."""
    R_e, R_t = _rotations(T_est), _rotations(T_true)
    C_e, C_t = centres(T_est), centres(T_true)

    def moves(R, C):
        d = np.einsum("kij,kj->ki", R[:-1], C[1:] - C[:-1])
        return d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-300)

    cos = np.clip((moves(R_e, C_e) * moves(R_t, C_t)).sum(1), -1.0, 1.0)
    rel_e = np.einsum("kij,klj->kil", R_e[1:], R_e[:-1])
    rel_t = np.einsum("kij,klj->kil", R_t[1:], R_t[:-1])
    dR = np.einsum("kij,klj->kil", rel_e, rel_t)
    c = np.clip((np.trace(dR, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return np.degrees(np.arccos(cos)), np.degrees(np.arccos(c))


def ate(T_est: np.ndarray, T_true: np.ndarray) -> float:
    """RMS camera-centre error after a similarity alignment to the truth."""
    est, gt = centres(T_est), centres(T_true)
    if len(est) < 3:
        return float("nan")
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    U, S, Vt = np.linalg.svd(G.T @ E / len(est))
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / max((E ** 2).sum(1).mean(), 1e-300)
    aligned = s * E @ R.T + mu_g
    return float(np.sqrt(((aligned - gt) ** 2).sum(1).mean()))
