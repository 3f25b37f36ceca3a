"""The main path as (fn, example_args), like ``__graft_entry__.entry()``.

- ``entry``: one full tracking step at the EuRoC operating point: ORB
  pyramid extraction (K1 and K2), undistortion, two-pass projection
  tracking with motion-only pose optimization against an 8192-landmark map.
- ``gba_entry``: the server's tile-stream GBA (K3-K7) at the operating
  point of ``bench.py:bench_gba``: 2048 keyframes, 65,536 landmarks,
  2,048,000 observations.

Both run on the card unless the caller asks for another device.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from . import convert
from .config import DEFAULT_CONFIG
from .models.tracking import _track_two_pass
from .ops import geometry, orb
from .parallel import sharded_ba


def entry(device="cuda"):
    """(fn, example_args) on ``device``. The example arguments are those of
    ``__graft_entry__.entry()``: the same numpy seed and draws."""
    device = torch.device(device)
    cfg = DEFAULT_CONFIG
    cam = cfg.camera
    K = torch.from_numpy(cam.K()).to(device)
    dist = torch.from_numpy(cam.dist_coeffs()).to(device)
    sf = torch.from_numpy(orb.scale_factors(cfg.extractor)).to(device)
    inv_s2 = torch.from_numpy(orb.inv_level_sigma2(cfg.extractor)).to(device)
    NM = cfg.capacity.client_max_mps

    def fn(img, Tcw_pred, Tcw_last, mp_Xw, mp_desc, mp_normal, mp_min_dist,
           mp_max_dist, mp_valid):
        feats = orb.extract_orb(img, cfg.extractor)
        feats = feats._replace(xy=geometry.undistort_points(feats.xy, K, dist))
        return _track_two_pass(
            feats.xy, feats.desc, feats.octave, feats.angle, feats.valid,
            Tcw_pred, Tcw_last,
            mp_Xw, mp_desc, mp_normal, mp_min_dist, mp_max_dist, mp_valid,
            K, cam.width, cam.height, sf, inv_s2, cfg.extractor.n_levels,
        )

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (cam.height, cam.width)).astype(np.float32)
    Tcw_last = np.eye(4, dtype=np.float32)
    Tcw_pred = np.eye(4, dtype=np.float32)
    Tcw_pred[0, 3] = 0.05  # distinct candidates: the real hot-path shape
    Xw = rng.normal(0, 1, (NM, 3)).astype(np.float32) + np.array([0, 0, 5], np.float32)
    desc = rng.integers(0, 2**32, (NM, 8), dtype=np.uint32)

    def t(a):
        return torch.from_numpy(a).to(device)

    example_args = (
        t(img),
        t(Tcw_pred),
        t(Tcw_last),
        t(Xw),
        convert.desc_from_numpy(desc, device),
        t(np.tile(np.array([0, 0, -1], np.float32), (NM, 1))),
        torch.full((NM,), 0.5, dtype=torch.float32, device=device),
        torch.full((NM,), 50.0, dtype=torch.float32, device=device),
        torch.ones((NM,), dtype=torch.bool, device=device),
    )
    return fn, example_args


def gba_entry(device="cuda"):
    """(fn, example_args) of the server GBA: ``fn`` is
    ``make_tile_gba(pcg_iters=25)``; the arguments (Tcw, Xw, obs, K,
    fixed_cam, fixed_lm), camera 0 fixed, are ``bench_gba``'s problem from
    the same ``np.random.default_rng(7)`` draws in the same order."""
    device = torch.device(device)
    rng = np.random.default_rng(7)
    C, L = 2048, 65536
    obs_per_cam = 1000
    O = C * obs_per_cam
    pts = rng.uniform(-8, 8, (L, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 4.0
    Tcw = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    Tcw[:, 0, 3] = rng.uniform(-0.5, 0.5, C)
    Tcw[:, 1, 3] = rng.uniform(-0.5, 0.5, C)
    fx = fy = 458.0
    cx, cy = 376.0, 240.0
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    cam_idx = np.repeat(np.arange(C), obs_per_cam).astype(np.int32)
    lm_idx = rng.integers(0, L, O).astype(np.int32)
    pc = np.einsum("oij,oj->oi", Tcw[cam_idx][:, :3, :3], pts[lm_idx]) \
        + Tcw[cam_idx][:, :3, 3]
    z = np.maximum(pc[:, 2], 1e-3)
    uv = np.stack([fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy], -1)
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    obs = convert.ba_observations_from_numpy(types.SimpleNamespace(
        cam_idx=cam_idx, lm_idx=lm_idx, uv=uv, inv_sigma2=np.ones(O, np.float32),
        valid=np.ones(O, bool)), device)
    fixed_cam = np.zeros(C, bool)
    fixed_cam[0] = True
    Tcw_t, Xw_t, K_t, fc_t, fl_t = convert.gba_state_from_numpy(
        Tcw, pts, K, fixed_cam, np.zeros(L, bool), device)
    return sharded_ba.make_tile_gba(pcg_iters=25), (Tcw_t, Xw_t, obs, K_t, fc_t, fl_t)
