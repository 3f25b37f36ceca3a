"""The server cells' map: a server map at capacity, made on the device.

A copy of the construction of ``motioncheck_ccm_slam_tpu_torch/entry.py``'s
``server_scene`` (kept here so that a change to the port cannot move the
yardstick), with its numbers read from the traffic file's ``map`` and its
draws made by a ``torch.Generator`` on the device in a few large calls
(the port's numpy loop over keyframes takes ~4 s on the host): the
clients' cameras on rings of ``ring_radius_m`` + ``ring_step_m`` a client
(+- ``ring_wobble_m``), ``kf_step_deg`` a keyframe, bobbing by ``bob_m``,
looking outward at a cylindrical band of landmarks (radius
``band_radius_m``, ``band_height_m`` tall), the whole scene tilted so that
its axis is (1, 1, 1)/sqrt(3) (Motion Check's per-plane tests then see a
turn in every plane). Each keyframe observes as many of the landmarks in
its view (``border_px`` inside the image) as it has feature slots, drawn
at random, with ``obs_noise_px`` of Gaussian noise; the landmarks carry
``landmark_noise_m`` of error, the poses are the truth.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

CHUNK_KFS = 128


class ServerScene(NamedTuple):
    Tcw: torch.Tensor        # (NK, 4, 4) f32 true poses
    client_id: torch.Tensor  # (NK,) i32
    kf_id: torch.Tensor      # (NK,) i32
    timestamp: torch.Tensor  # (NK,) f32
    xy: torch.Tensor         # (NK, F, 2) f32 noisy projections
    mp_idx: torch.Tensor     # (NK, F) i32 landmark per feature slot or -1
    Xw: torch.Tensor         # (NM, 3) f32 perturbed landmarks
    ref_kf: torch.Tensor     # (NM,) i32 first observing keyframe or -1


def _tilt() -> np.ndarray:
    n = np.ones(3) / np.sqrt(3.0)
    x = np.cross([0.0, 1.0, 0.0], n)
    x /= np.linalg.norm(x)
    return np.stack([x, n, np.cross(x, n)], -1)


def _ring_pose(theta: float, radius: float, y: float) -> np.ndarray:
    C = np.array([radius * np.cos(theta), y, radius * np.sin(theta)])
    fwd = np.array([np.cos(theta), 0.0, np.sin(theta)])
    x = np.cross([0.0, 1.0, 0.0], fwd)
    x /= np.linalg.norm(x)
    R_wc = np.stack([x, np.cross(fwd, x), fwd], -1)
    T = np.eye(4)
    T[:3, :3] = R_wc.T
    T[:3, 3] = -R_wc.T @ C
    return T


def poses(n_kfs: int, m: dict) -> np.ndarray:
    """(n_kfs, 4, 4) true poses, n_kfs / clients keyframes a client."""
    nc = m["clients"]
    per = n_kfs // nc
    T0_inv = np.eye(4)
    T0_inv[:3, :3] = _tilt().T
    out = np.zeros((n_kfs, 4, 4), np.float32)
    for s in range(n_kfs):
        c, k = divmod(s, per)
        theta = np.deg2rad(360.0 / nc * c + m["kf_step_deg"] * k)
        lap = k * m["kf_step_deg"] / 360.0
        radius = m["ring_radius_m"] + m["ring_step_m"] * c + m["ring_wobble_m"] * np.sin(1.3 * lap + c)
        y = m["bob_m"] * np.sin(3.0 * theta) + m["lift_m"] * np.sin(0.7 * lap + 2.0 * c)
        out[s] = _ring_pose(theta, radius, y) @ T0_inv
    return out


@torch.no_grad()
def build(m: dict, camera: dict, n_kfs: int, n_mps: int, n_feat: int, seed: int,
          device) -> ServerScene:
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    f64 = torch.float64

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev, dtype=f64)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=f64)

    r_lo, r_hi = m["band_radius_m"]
    th = rand(n_mps) * (2 * np.pi)
    r = r_lo + (r_hi - r_lo) * rand(n_mps)
    hgt = (rand(n_mps) - 0.5) * m["band_height_m"]
    pts = torch.stack([r * torch.cos(th), hgt, r * torch.sin(th)], -1) \
        @ torch.from_numpy(_tilt().T).to(dev)
    Tcw_np = poses(n_kfs, m)
    Tcw = torch.from_numpy(Tcw_np).to(dev)
    T64 = Tcw.to(f64)
    fx, fy, cx, cy = camera["fx"], camera["fy"], camera["cx"], camera["cy"]
    w, h, b = camera["width"], camera["height"], m["border_px"]
    xy = torch.zeros((n_kfs, n_feat, 2), dtype=torch.float32, device=dev)
    mp_idx = torch.full((n_kfs, n_feat), -1, dtype=torch.int32, device=dev)
    for a in range(0, n_kfs, CHUNK_KFS):
        T = T64[a:a + CHUNK_KFS]
        pc = torch.einsum("kij,lj->kli", T[:, :3, :3], pts) + T[:, None, :3, 3]
        z = torch.clamp_min(pc[..., 2], 1e-6)
        u = fx * pc[..., 0] / z + cx
        v = fy * pc[..., 1] / z + cy
        vis = (pc[..., 2] > 0.2) & (u >= b) & (u < w - b) & (v >= b) & (v < h - b)
        key = torch.where(vis, rand(*vis.shape), torch.full_like(u, -1.0))
        top, sel = torch.topk(key, n_feat, dim=1)
        chosen = top >= 0
        sel = torch.where(chosen, sel, torch.full_like(sel, n_mps))
        sel, _ = torch.sort(sel, dim=1)                  # landmark order, as the port's scene
        chosen = sel < n_mps
        sel_c = torch.clamp_max(sel, n_mps - 1)
        uv = torch.stack([torch.gather(u, 1, sel_c), torch.gather(v, 1, sel_c)], -1)
        uv = uv + m["obs_noise_px"] * randn(*uv.shape)
        xy[a:a + CHUNK_KFS] = torch.where(chosen[..., None], uv, torch.zeros_like(uv)).float()
        mp_idx[a:a + CHUNK_KFS] = torch.where(chosen, sel, torch.full_like(sel, -1)).int()
    seen = mp_idx >= 0
    kf_of = torch.arange(n_kfs, device=dev)[:, None].expand_as(mp_idx)
    first = torch.full((n_mps,), n_kfs, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, mp_idx[seen].long(), kf_of[seen], reduce="amin")
    ref_kf = torch.where(first < n_kfs, first, torch.full_like(first, -1)).int()
    Xw = (pts + m["landmark_noise_m"] * randn(*pts.shape)).float()
    per = n_kfs // m["clients"]
    client_id = torch.arange(m["clients"], device=dev, dtype=torch.int32).repeat_interleave(per)
    kf_id = torch.arange(per, device=dev, dtype=torch.int32).repeat(m["clients"])
    return ServerScene(Tcw=Tcw, client_id=client_id, kf_id=kf_id,
                       timestamp=kf_id.float() * m["seconds_per_kf"], xy=xy, mp_idx=mp_idx,
                       Xw=Xw, ref_kf=ref_kf)
