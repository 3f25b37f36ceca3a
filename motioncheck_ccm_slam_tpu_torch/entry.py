"""The main path as (fn, example_args), like ``__graft_entry__.entry()``.

- ``entry``: one full tracking step at the EuRoC operating point: ORB
  pyramid extraction (K1 and K2), undistortion, two-pass projection
  tracking with motion-only pose optimization against an 8192-landmark map.
- ``gba_entry``: the server's tile-stream GBA (K3-K7) at the operating
  point of ``bench.py:bench_gba``: 2048 keyframes, 65,536 landmarks,
  2,048,000 observations.
- ``matrix_free_gba_entry``: the dual-layout matrix-free GBA (K9 and the
  plan-form Schur products) on the same problem.
- ``server_gba_entry``: the Motion-Check-gated GBA driver (``run_gba``) on
  a server map at capacity: 4 clients x 512 keyframes x 1024 features,
  65,536 landmarks.
- ``dryrun_multichip``: the product GBA path (``GBAJob``) with its solver
  sharded over a list of devices, on ``utils/bigmap``'s server-scale maps,
  as ``__graft_entry__.dryrun_multichip``.

All run on the card unless the caller asks for another device.
"""
from __future__ import annotations

import functools
import time
import types
from typing import NamedTuple

import numpy as np
import torch

from . import convert
from .config import DEFAULT_CONFIG
from .models import gba, map_state
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


def gba_problem(device="cuda", C: int = 2048, L: int = 65536, obs_per_cam: int = 1000):
    """``bench_gba``'s problem (Tcw, Xw, obs, K, fixed_cam, fixed_lm),
    camera 0 fixed, from the same ``np.random.default_rng(7)`` draws in the
    same order; observations are camera-major (``obs_per_cam`` a camera).
    The defaults are bench_gba's sizes; other sizes draw the same way."""
    device = torch.device(device)
    rng = np.random.default_rng(7)
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
    return Tcw_t, Xw_t, obs, K_t, fc_t, fl_t


def gba_entry(device="cuda"):
    """(fn, example_args) of the server GBA: ``fn`` is
    ``make_tile_gba(pcg_iters=25)``; the arguments are ``gba_problem``'s."""
    return sharded_ba.make_tile_gba(pcg_iters=25), gba_problem(device)


def matrix_free_gba_entry(device="cuda"):
    """(fn, example_args) of the dual-layout matrix-free GBA: ``fn`` is
    ``make_matrix_free_gba(pcg_iters=25)``; the arguments are
    ``gba_problem``'s."""
    return sharded_ba.make_matrix_free_gba(pcg_iters=25), gba_problem(device)


# ---------------------------------------------------------------------------
# A server map at capacity for the Motion-Check-gated GBA driver
# ---------------------------------------------------------------------------

# The server operating point: 2048 keyframe slots of 1024 features and
# 65,536 landmark slots (config.CapacityParams), the reference's 20-iteration
# GBA (config.yaml:129) and Motion Check's default thresholds.
SERVER_CONFIG = DEFAULT_CONFIG
N_CLIENTS = 4
KF_STEP_DEG = 11.25
OBS_NOISE_PX = 0.5
LM_NOISE_M = 0.02


class ServerScene(NamedTuple):
    """A server map made with numpy: the KF and MP blocks' live fields and
    the true poses."""

    Tcw: np.ndarray        # (NK, 4, 4) keyframe poses (the truth)
    client_id: np.ndarray  # (NK,) i32
    kf_id: np.ndarray      # (NK,) i32 client-local id
    timestamp: np.ndarray  # (NK,) f32
    xy: np.ndarray         # (NK, F, 2) noisy projections
    mp_idx: np.ndarray     # (NK, F) i32 landmark slot per feature
    Xw: np.ndarray         # (NM, 3) landmark positions (perturbed)
    Xw_true: np.ndarray    # (NM, 3)
    ref_kf: np.ndarray     # (NM,) i32 first observing keyframe slot


def _ring_pose(theta: float, radius: float, y: float) -> np.ndarray:
    """A camera at (r cos th, y, r sin th) looking radially outward."""
    C = np.array([radius * np.cos(theta), y, radius * np.sin(theta)])
    fwd = np.array([np.cos(theta), 0.0, np.sin(theta)])
    x = np.cross([0.0, 1.0, 0.0], fwd)
    x /= np.linalg.norm(x)
    R_wc = np.stack([x, np.cross(fwd, x), fwd], -1)
    T = np.eye(4)
    T[:3, :3] = R_wc.T
    T[:3, 3] = -R_wc.T @ C
    return T


def _tilt() -> np.ndarray:
    """The rotation taking the y axis to (1, 1, 1)/sqrt(3)."""
    n = np.ones(3) / np.sqrt(3.0)
    x = np.cross([0.0, 1.0, 0.0], n)
    x /= np.linalg.norm(x)
    return np.stack([x, n, np.cross(x, n)], -1)


def server_poses(n_kfs: int) -> np.ndarray:
    """(n_kfs, 4, 4) true poses of the server map's N_CLIENTS trajectories
    (n_kfs / N_CLIENTS keyframes each): cameras on rings of 5-6.4 m radius
    looking outward, 11.25 degrees a keyframe (16 laps of 512 keyframes, each
    at another radius and height), bobbing along the ring's axis.

    The scene is built about its own y axis, then tilted so that this axis
    is (1, 1, 1)/sqrt(3) in the world: every step's projection onto the
    world's xy, yz and zx planes then turns each keyframe. Motion Check's
    per-plane limits are 5x the xy turn (a reference quirk), so a projection
    with an inflection, where that turn passes through 0, would flag
    mm-level honest refinements; the bob (0.1 m, 3 cycles a lap) is small
    enough that the xy projection has none (tests/test_torch_motion_check.py
    holds the turn and the verdict under pose error)."""
    per = n_kfs // N_CLIENTS
    T0_inv = np.eye(4)
    T0_inv[:3, :3] = _tilt().T
    Tcw = np.zeros((n_kfs, 4, 4), np.float32)
    for s in range(n_kfs):
        c, k = divmod(s, per)
        theta = np.deg2rad(90.0 * c + KF_STEP_DEG * k)
        lap = k * KF_STEP_DEG / 360.0
        radius = 5.0 + 0.3 * c + 0.4 * np.sin(1.3 * lap + c)
        y = 0.1 * np.sin(3.0 * theta) + 0.3 * np.sin(0.7 * lap + 2.0 * c)
        Tcw[s] = _ring_pose(theta, radius, y) @ T0_inv
    return Tcw


@functools.lru_cache(maxsize=2)
def server_scene(seed: int = 0) -> ServerScene:
    """The server map at capacity: ``server_poses``' 4 x 512 keyframes
    inside a cylindrical band of 65,536 landmarks (radius 10-12 m, 4 m
    tall, tilted with the rings). Each keyframe observes 1024 landmarks
    drawn from those in its view, with 0.5 px noise; landmark positions
    carry 2 cm of triangulation error, the poses are the truth."""
    cfg = SERVER_CONFIG
    cam = cfg.camera
    NK, NM = cfg.capacity.server_max_kfs, cfg.capacity.server_max_mps
    F = cfg.extractor.max_features
    per = NK // N_CLIENTS
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 2 * np.pi, NM)
    r = 11.0 + rng.uniform(-1.0, 1.0, NM)
    pts = np.stack([r * np.cos(th), rng.uniform(-2.0, 2.0, NM), r * np.sin(th)], -1) \
        @ _tilt().T
    Kmat = cam.K().astype(np.float64)
    Tcw = server_poses(NK)
    xy = np.zeros((NK, F, 2), np.float32)
    mp_idx = np.full((NK, F), -1, np.int32)
    client_id = np.repeat(np.arange(N_CLIENTS), per).astype(np.int32)
    kf_id = np.tile(np.arange(per), N_CLIENTS).astype(np.int32)
    timestamp = (kf_id * 0.25).astype(np.float32)
    for s in range(NK):
        T = Tcw[s].astype(np.float64)
        pc = pts @ T[:3, :3].T + T[:3, 3]
        z = np.maximum(pc[:, 2], 1e-6)
        u = Kmat[0, 0] * pc[:, 0] / z + Kmat[0, 2]
        v = Kmat[1, 1] * pc[:, 1] / z + Kmat[1, 2]
        vis = np.flatnonzero((pc[:, 2] > 0.2) & (u >= 10) & (u < cam.width - 10)
                             & (v >= 10) & (v < cam.height - 10))
        sel = np.sort(rng.choice(vis, min(F, vis.size), replace=False))
        n = sel.size
        xy[s, :n] = np.stack([u[sel], v[sel]], -1) + rng.normal(0, OBS_NOISE_PX, (n, 2))
        mp_idx[s, :n] = sel
    first = np.full(NM, NK, np.int64)
    seen = mp_idx >= 0
    np.minimum.at(first, mp_idx[seen], np.nonzero(seen)[0])
    ref_kf = np.where(first < NK, first, -1).astype(np.int32)
    Xw = pts + rng.normal(0, LM_NOISE_M, pts.shape)
    return ServerScene(Tcw=Tcw, client_id=client_id, kf_id=kf_id, timestamp=timestamp,
                       xy=xy, mp_idx=mp_idx, Xw=Xw.astype(np.float32),
                       Xw_true=pts.astype(np.float32), ref_kf=ref_kf)


def server_map(scene: ServerScene, device="cuda") -> map_state.MapState:
    """A fresh server MapState holding ``scene``: every keyframe and
    landmark slot valid, each client's keyframes chained by parent/pred."""
    device = torch.device(device)
    cfg = SERVER_CONFIG
    m = map_state.MapState.create(cfg, server=True, device=device)
    NK, NM = m.nk, m.nm
    per = NK // N_CLIENTS
    chain = np.arange(NK, dtype=np.int32) - 1
    chain[::per] = -1

    def t(a, dtype):     # a copy: the scene's arrays are shared by its cache
        return torch.tensor(a, dtype=dtype, device=device)

    feat_valid = scene.mp_idx >= 0
    m.kf = m.kf._replace(
        kf_id=t(scene.kf_id, torch.int32), client_id=t(scene.client_id, torch.int32),
        timestamp=t(scene.timestamp, torch.float32), Tcw=t(scene.Tcw, torch.float32),
        xy=t(scene.xy, torch.float32), feat_valid=t(feat_valid, torch.bool),
        mp_idx=t(scene.mp_idx, torch.int32), parent=t(chain, torch.int32),
        pred=t(chain, torch.int32), valid=torch.ones(NK, dtype=torch.bool, device=device))
    mp_client = scene.client_id[np.maximum(scene.ref_kf, 0)]
    m.mp = m.mp._replace(
        mp_id=torch.arange(NM, dtype=torch.int32, device=device),
        client_id=t(mp_client, torch.int32), Xw=t(scene.Xw, torch.float32),
        min_dist=torch.full((NM,), 0.1, device=device),
        max_dist=torch.full((NM,), 100.0, device=device),
        ref_kf=t(scene.ref_kf, torch.int32),
        valid=torch.ones(NM, dtype=torch.bool, device=device))
    m.sync_host_index()
    m.next_kf_slot = 0
    return m


def server_gba_entry(device="cuda", seed: int = 0):
    """(fn, example_args) of the Motion-Check-gated GBA driver: ``fn`` is
    ``models.gba.run_gba``; the arguments are a server map at capacity made
    from ``server_scene(seed)`` and ``SERVER_CONFIG``. ``_pick_solver``
    routes a map of this size to the tile-stream GBA."""
    return gba.run_gba, (server_map(server_scene(seed), device), SERVER_CONFIG)


# ---------------------------------------------------------------------------
# The multi-device dry run
# ---------------------------------------------------------------------------

DRYRUN_ITERS = 20      # the reference's GBA iterations (config.yaml:129)
DRYRUN_SMALL = dict(n_kfs=256, n_mps=8192, obs_per_kf=256)
DRYRUN_FULL = dict(n_kfs=1024, n_mps=32768, obs_per_kf=1024)


def dryrun_multichip(devices) -> dict:
    """The product full-map GBA path (``GBAJob``, as ``ServerSystem``'s
    final GBA runs it: 20 LM iterations in chunks of 5, Motion Check off)
    on ``utils/bigmap`` maps, with the solver sharded over ``devices``
    (the map on the first). Three legs, as ``__graft_entry__.
    dryrun_multichip``'s: the tile GBA over ``devices`` and on one device
    at ``DRYRUN_SMALL``'s scale, and the gather formulation over
    ``devices`` at ``DRYRUN_FULL``'s. Prints each leg's LM iterations/s (after the first
    chunk), final cost and mean pose error; raises on a non-finite cost.
    Returns label -> {"lm_iters_per_s", "cost", "mean_pose_err",
    "mean_pose_err_start"}."""
    from .utils import bigmap

    devices = [torch.device(d) for d in devices]
    dev = devices[0]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(solver, label, n_kfs, n_mps, obs_per_kf):
        m, cfg, Tcw_true = bigmap.build_server_scale_map(
            n_kfs=n_kfs, n_mps=n_mps, obs_per_kf=obs_per_kf, seed=0, device=dev)

        def pose_err():
            C = m.kf.Tcw[:n_kfs].cpu().numpy()
            return float(np.mean(np.linalg.norm(C[:, :3, 3] - Tcw_true[:, :3, 3], axis=-1)))

        err0 = pose_err()
        job = gba.GBAJob(m=m, config=cfg, iterations=DRYRUN_ITERS, enable_motion_check=False,
                         chunk=5, solver=solver)
        job.step()          # the first chunk: the host plan and 5 iterations
        sync()
        t0 = time.perf_counter()
        while not job.step():
            pass
        sync()
        dt = time.perf_counter() - t0
        job.finalize()
        out = {"lm_iters_per_s": (DRYRUN_ITERS - 5) / dt, "cost": job._cost,
               "mean_pose_err": pose_err(), "mean_pose_err_start": err0}
        if not np.isfinite(job._cost):
            raise RuntimeError(f"dryrun_multichip {label}: non-finite GBA cost")
        print(f"dryrun_multichip {label}: C={n_kfs} L={n_mps} O={n_kfs * obs_per_kf} "
              f"iters={DRYRUN_ITERS} lm_iters_per_s={out['lm_iters_per_s']:.3f} "
              f"cost={job._cost:.1f} mean_pose_err={out['mean_pose_err']:.4f} "
              f"(start {err0:.4f})")
        return out

    n = len(devices)
    return {
        f"tile[{n}]": run(sharded_ba.make_tile_gba(pcg_iters=25, devices=devices),
                          f"tile over {n} devices", **DRYRUN_SMALL),
        "tile[1]": run(sharded_ba.make_tile_gba(pcg_iters=25), "tile on one device",
                       **DRYRUN_SMALL),
        f"gather[{n}]": run(sharded_ba.make_sharded_gba(pcg_iters=25, devices=devices),
                            f"gather formulation over {n} devices", **DRYRUN_FULL),
    }
