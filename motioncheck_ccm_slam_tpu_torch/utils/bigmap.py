"""Server-scale synthetic map construction for benchmarks and dry runs.

Counterpart of ``motioncheck_ccm_slam_tpu/utils/bigmap.py``. Builds a
fully populated ``MapState`` at the reference server operating point (~1-2k
keyframes, tens of thousands of landmarks, millions of observations) as
device blocks, without replaying a sequence: cameras on a ring facing a
cylindrical landmark band (local covisibility, like a corridor loop),
projection-consistent observations, and pose / landmark noise so that a
GBA has real work to do. The numpy draws are the JAX package's, in the same
order, so one seed gives the same map in both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import CameraParams, CapacityParams, Config, ExtractorParams, MotionCheckParams
from ..models import map_state as ms


def bench_config(n_kfs: int, n_mps: int, obs_per_kf: int,
                 motion_check: bool = False) -> Config:
    return Config().replace(
        capacity=CapacityParams(server_max_kfs=n_kfs, server_max_mps=n_mps,
                                client_max_kfs=n_kfs, client_max_mps=n_mps),
        extractor=ExtractorParams(max_features=obs_per_kf),
        camera=CameraParams(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0),
        motion_check=MotionCheckParams(enabled=motion_check),
    )


def build_server_scale_map(n_kfs: int = 1024, n_mps: int = 32768,
                           obs_per_kf: int = 1024, seed: int = 0,
                           pose_noise: float = 0.03,
                           lm_noise: float = 0.02,
                           px_noise: float = 0.4,
                           config: Config = None,
                           device="cuda"):
    """Returns (MapState on ``device``, config, Tcw_true (NK, 4, 4) numpy).

    Cameras sit on an inner ring (radius 5) facing outward at a landmark
    band (radius ~11): each KF sees only its angular neighbourhood, giving
    the banded camera-landmark structure of a real corridor or loop map
    rather than an all-sees-all block.
    """
    device = torch.device(device)
    if config is None:
        config = bench_config(n_kfs, n_mps, obs_per_kf)
    rng = np.random.default_rng(seed)
    K = config.camera.K()
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    w, h = config.camera.width, config.camera.height

    # landmarks on a cylindrical band, sorted by angle for windowed access
    th_l = np.sort(rng.uniform(0, 2 * np.pi, n_mps)).astype(np.float32)
    r_l = 11.0 + rng.uniform(-1.0, 1.0, n_mps)
    y_l = rng.uniform(-2.5, 2.5, n_mps)
    X_true = np.stack([r_l * np.cos(th_l), y_l, r_l * np.sin(th_l)], -1).astype(np.float32)

    # cameras on the inner ring facing outward
    th_c = np.linspace(0, 2 * np.pi, n_kfs, endpoint=False).astype(np.float32)
    C_pos = np.stack([5.0 * np.cos(th_c), 0.3 * np.sin(3 * th_c), 5.0 * np.sin(th_c)],
                     -1).astype(np.float32)
    fwd = np.stack([np.cos(th_c), np.zeros(n_kfs, np.float32), np.sin(th_c)], -1)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    x_ax = np.cross(np.broadcast_to(up, fwd.shape), fwd)
    x_ax /= np.linalg.norm(x_ax, axis=-1, keepdims=True)
    y_ax = np.cross(fwd, x_ax)
    R_wc = np.stack([x_ax, y_ax, fwd], -1)         # (NK, 3, 3)
    Tcw_true = np.tile(np.eye(4, dtype=np.float32), (n_kfs, 1, 1))
    Tcw_true[:, :3, :3] = np.swapaxes(R_wc, 1, 2)
    Tcw_true[:, :3, 3] = -np.einsum("kij,kj->ki", Tcw_true[:, :3, :3], C_pos)

    # each KF samples obs_per_kf landmarks from its angular window
    half_arc = np.pi * 1.2 * obs_per_kf / n_mps + 0.15
    lo = np.searchsorted(th_l, (th_c - half_arc) % (2 * np.pi))
    hi = np.searchsorted(th_l, (th_c + half_arc) % (2 * np.pi))
    span = (hi - lo) % n_mps
    span = np.maximum(span, obs_per_kf)
    offs = rng.integers(0, 1 << 30, (n_kfs, obs_per_kf)) % span[:, None]
    mp_idx = ((lo[:, None] + offs) % n_mps).astype(np.int32)   # (NK, F)

    # project through the true geometry
    Xo = X_true[mp_idx]                                        # (NK, F, 3)
    pc = np.einsum("kij,kfj->kfi", Tcw_true[:, :3, :3], Xo) + Tcw_true[:, None, :3, 3]
    z = pc[..., 2]
    u = fx * pc[..., 0] / np.maximum(z, 1e-6) + cx
    v = fy * pc[..., 1] / np.maximum(z, 1e-6) + cy
    vis = (z > 0.2) & (u >= 2) & (u < w - 2) & (v >= 2) & (v < h - 2)
    uv = np.stack([u, v], -1).astype(np.float32)
    uv += rng.normal(0, px_noise, uv.shape).astype(np.float32)

    # noisy initial state (what the GBA corrects)
    Tcw = Tcw_true.copy()
    Tcw[:, :3, 3] += rng.normal(0, pose_noise, (n_kfs, 3)).astype(np.float32)
    Xw = X_true + rng.normal(0, lm_noise, X_true.shape).astype(np.float32)

    m = ms.MapState.create(config, server=True, device=device)
    F = config.extractor.max_features
    if F < obs_per_kf or m.nk < n_kfs or m.nm < n_mps:
        raise ValueError(f"config capacity (F={F}, {m.nk} KFs, {m.nm} MPs) below the map's "
                         f"({obs_per_kf}, {n_kfs}, {n_mps})")
    pad_f = F - obs_per_kf
    if pad_f:
        mp_idx = np.pad(mp_idx, ((0, 0), (0, pad_f)), constant_values=-1)
        uv = np.pad(uv, ((0, 0), (0, pad_f), (0, 0)))
        vis = np.pad(vis, ((0, 0), (0, pad_f)))

    def put(block, values):
        """``block`` with rows [0, n) of each named field set from numpy."""
        out = {}
        for name, a in values.items():
            t = getattr(block, name).clone()
            t[:len(a)] = torch.as_tensor(np.asarray(a), dtype=t.dtype)
            out[name] = t
        return block._replace(**out)

    ar = np.arange(n_kfs, dtype=np.int32)
    m.kf = put(m.kf, dict(
        kf_id=ar, client_id=np.zeros(n_kfs, np.int32), timestamp=0.25 * ar, Tcw=Tcw, xy=uv,
        feat_valid=vis, mp_idx=mp_idx, parent=ar - 1, pred=ar - 1,
        valid=np.ones(n_kfs, bool)))
    arm = np.arange(n_mps, dtype=np.int32)
    # reference KF: one that actually observes the landmark; approximated by
    # the angularly nearest camera
    ref = np.clip(np.round(th_l / (2 * np.pi) * n_kfs).astype(np.int32), 0, n_kfs - 1)
    m.mp = put(m.mp, dict(
        mp_id=arm, client_id=np.zeros(n_mps, np.int32), Xw=Xw,
        min_dist=np.full(n_mps, 0.1, np.float32), max_dist=np.full(n_mps, 100.0, np.float32),
        ref_kf=ref, first_kf_id=np.zeros(n_mps, np.int32), valid=np.ones(n_mps, bool)))
    m.sync_host_index()
    return m, config, Tcw_true
