"""Trajectory export in EuRoC / TUM formats and the ATE.

Counterpart of ``motioncheck_ccm_slam_tpu/utils/csv_io.py`` (the reference's
``Map::WriteStateToCsv`` src/Map.cpp:4093-4434 and ``Stats.trajectory_format``
cslam/conf/config.yaml:10-12): poses are exported as Tws = Tcw^-1 T_SC^-1,
the body frame in the world, with quaternion orientation. Rows are built on
the host: the quaternion and the ATE's Sim3 alignment run in float32 on CPU
tensors, as the JAX package runs them in float32.
"""
from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from ..config import Config
from ..ops import lie


def _tws_from_tcw(Tcw: np.ndarray, T_SC: np.ndarray) -> np.ndarray:
    """World-from-body: Tws = Twc @ T_SC^-1 (T_SC maps camera -> body)."""
    return np.linalg.inv(Tcw) @ np.linalg.inv(T_SC)


def trajectory_rows(traj: Iterable[Tuple[float, np.ndarray]], config: Config):
    """(timestamp, Tcw) pairs -> (stamp, t (3,), q (4,) wxyz) body-frame rows."""
    T_SC = config.camera.T_SC()
    rows = []
    for ts, Tcw in traj:
        Tws = _tws_from_tcw(np.asarray(Tcw), T_SC)
        q = lie.rot_to_quat(torch.from_numpy(Tws[:3, :3].astype(np.float32))).numpy()
        rows.append((ts, Tws[:3, 3], q))
    return rows


def trajectory_tum(traj, config: Config) -> str:
    """TUM format: stamp[s] tx ty tz qx qy qz qw."""
    lines = [f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
             f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}"
             for ts, t, q in trajectory_rows(traj, config)]
    return "\n".join(lines) + "\n"


def trajectory_euroc(traj, config: Config) -> str:
    """EuRoC format: stamp[ns], tx, ty, tz, qw, qx, qy, qz."""
    lines = [f"{int(ts * 1e9)},{t[0]:.6f},{t[1]:.6f},{t[2]:.6f},"
             f"{q[0]:.6f},{q[1]:.6f},{q[2]:.6f},{q[3]:.6f}"
             for ts, t, q in trajectory_rows(traj, config)]
    return "\n".join(lines) + "\n"


def ate_rmse(traj_est, traj_gt, align_sim3: bool = True):
    """Absolute trajectory error after an optional Sim3 alignment (the
    standard mono-SLAM evaluation). traj_est/traj_gt: (N, 3) associated
    positions. Returns (rmse, max_err)."""
    est = np.asarray(traj_est, np.float64)
    gt = np.asarray(traj_gt, np.float64)
    if align_sim3:
        R, t, s = lie.horn_align(torch.from_numpy(est.astype(np.float32))[None],
                                 torch.from_numpy(gt.astype(np.float32))[None])
        est = float(s[0]) * est @ R[0].numpy().astype(np.float64).T + t[0].numpy()
    err = np.linalg.norm(est - gt, axis=-1)
    return float(np.sqrt(np.mean(err ** 2))), float(err.max())
