"""The agent cells' camera stream: a textured wall rendered on the device.

One general renderer reads a traffic file's ``scene`` and ``path``:

- ``surface``: a textured plane, its ``origin``, two in-plane unit axes
  ``axis_u`` and ``axis_v``, the ``normal`` pointing away from the camera,
  its ``extent_u`` and ``extent_v`` in metres, a relief of ``relief_m``
  along the normal (a product of sines of ``relief_pitch_m``), a
  low-frequency background of ``bg_cell_m`` cells and anti-aliased blobs on
  a jittered grid of ``blob_pitch_m`` (a cell holds one with probability
  ``blob_fill``, its centre moved by up to ``blob_jitter_m``, its radius in
  ``blob_radius_m``, dark or bright). Rays that miss it see ``sky``.
- ``path``: the camera starts at ``start`` and moves along ``direction`` at
  ``speed_mps``, swaying by ``amplitude_m`` along each ``sway`` axis with
  a period of ``period_m`` along the path. It looks along the world's +z
  (x right, y down).

The world, every texture, is drawn from the traffic's ``world_seed`` with
a ``torch.Generator`` on the device, so that every run sees the same
world and does the same work; the run's seed moves the start along the
path by a fraction of one frame's step, drawn uniformly (each seed sees
the same stream from other points). The frames are rendered on the device
in chunks, through the configuration's camera with its lens distortion
(each pixel's ray is the undistorted direction of that distorted pixel),
before the measured window. The truth is each frame's world-to-camera
pose.
"""
from __future__ import annotations

import math

import numpy as np
import torch

CHUNK_PIXELS = 1 << 23


def pixel_rays(camera: dict, device) -> torch.Tensor:
    """(H, W, 2) normalised undistorted coordinates of each pixel centre of
    the distorted image (the radial-tangential model inverted by 20
    fixed-point steps, in float64)."""
    h, w = camera["height"], camera["width"]
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                            torch.arange(w, dtype=torch.float64, device=device), indexing="ij")
    xd, yd = (xx - camera["cx"]) / camera["fx"], (yy - camera["cy"]) / camera["fy"]
    x, y = xd.clone(), yd.clone()
    k1, k2, p1, p2, k3 = (camera[k] for k in ("k1", "k2", "p1", "p2", "k3"))
    for _ in range(20):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x, y = x + (xd - dx), y + (yd - dy)
    return torch.stack([x, y], -1).float()


class Surface:
    def __init__(self, spec: dict, gen: torch.Generator, device):
        t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
        self.o, self.a, self.b, self.n = (t(spec[k]) for k in ("origin", "axis_u", "axis_v", "normal"))
        self.eu, self.ev = spec["extent_u"], spec["extent_v"]
        self.relief, self.pitch = spec["relief_m"], spec["relief_pitch_m"]
        self.bg_cell, self.g = spec["bg_cell_m"], spec["blob_pitch_m"]
        nbu, nbv = int(self.eu / self.bg_cell) + 3, int(self.ev / self.bg_cell) + 3
        ngu, ngv = int(self.eu / self.g) + 2, int(self.ev / self.g) + 2

        def u(*shape, lo=0.0, hi=1.0):
            return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

        self.bg = u(nbv, nbu, lo=70.0, hi=150.0)
        self.has = u(ngv, ngu) < spec["blob_fill"]
        jit = spec["blob_jitter_m"]
        self.off = u(ngv, ngu, 2, lo=-jit, hi=jit)
        self.rad = u(ngv, ngu, lo=spec["blob_radius_m"][0], hi=spec["blob_radius_m"][1])
        dark = u(ngv, ngu) < 0.4
        self.val = torch.where(dark, u(ngv, ngu, lo=20.0, hi=90.0), u(ngv, ngu, lo=150.0, hi=250.0))

    def height(self, su, sv):
        if not self.relief:
            return torch.zeros_like(su)
        k = 2 * math.pi / self.pitch
        return self.relief * torch.sin(k * su) * torch.cos(k * sv)

    def hit(self, C, d):
        """(distance along each ray, u, v) of rays C + s d, s = inf where
        the ray misses."""
        dn = (d * self.n).sum(-1)
        off = ((self.o - C) * self.n).sum(-1)
        s = off / torch.where(dn > 1e-6, dn, torch.ones_like(dn))
        rel = C - self.o
        for _ in range(16):
            p = rel + s[..., None] * d
            su, sv = (p * self.a).sum(-1), (p * self.b).sum(-1)
            s = (off + self.height(su, sv)) / torch.where(dn > 1e-6, dn, torch.ones_like(dn))
        p = rel + s[..., None] * d
        su, sv = (p * self.a).sum(-1), (p * self.b).sum(-1)
        ok = (dn > 1e-6) & (s > 0.05) & (su >= 0) & (su < self.eu) & (sv >= 0) & (sv < self.ev)
        zero = torch.zeros_like(s)
        return (torch.where(ok, s, torch.full_like(s, float("inf"))),
                torch.where(ok, su, zero), torch.where(ok, sv, zero))

    def shade(self, su, sv, m_per_px):
        cu = torch.clamp(su / self.bg_cell, 0, self.bg.shape[1] - 2.001)
        cv = torch.clamp(sv / self.bg_cell, 0, self.bg.shape[0] - 2.001)
        u0, v0 = cu.long(), cv.long()
        fu, fv = cu - u0, cv - v0
        b = self.bg
        img = (b[v0, u0] * (1 - fu) * (1 - fv) + b[v0, u0 + 1] * fu * (1 - fv)
               + b[v0 + 1, u0] * (1 - fu) * fv + b[v0 + 1, u0 + 1] * fu * fv)
        i = torch.clamp((su / self.g).long(), 0, self.has.shape[1] - 1)
        j = torch.clamp((sv / self.g).long(), 0, self.has.shape[0] - 1)
        cx = (i + 0.5) * self.g + self.off[j, i, 0]
        cy = (j + 0.5) * self.g + self.off[j, i, 1]
        dist = torch.hypot(su - cx, sv - cy)
        alpha = torch.clamp((self.rad[j, i] - dist) / m_per_px + 0.5, 0.0, 1.0) * self.has[j, i]
        return img * (1 - alpha) + self.val[j, i] * alpha


class Scene:
    def __init__(self, traffic: dict, camera: dict, seed: int, device):
        self.camera, self.device = camera, torch.device(device)
        spec, self.path = traffic["scene"], traffic["path"]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(spec["world_seed"]))
        rng = np.random.default_rng([int(seed) % (1 << 63), 3])
        self.s0 = float(rng.uniform(0.0, 1.0)) * self.path["speed_mps"] / camera["fps"]
        self.surface = Surface(spec["surface"], gen, self.device)
        self.sky = float(spec["sky"])
        self.rays = pixel_rays(camera, self.device)
        self.fps = camera["fps"]

    def pose(self, k: int) -> np.ndarray:
        """Frame k's world-to-camera pose (4, 4) float32."""
        p = self.path
        s = self.s0 + p["speed_mps"] * k / self.fps
        d = np.asarray(p["direction"], np.float64)
        C = np.asarray(p["start"], np.float64) + s * d
        for sw in p.get("sway", []):
            w = 2 * np.pi / sw["period_m"]
            C = C + sw["amplitude_m"] * np.sin(w * s) * np.asarray(sw["axis"], np.float64)
        T = np.eye(4)
        T[:3, 3] = -C
        return T.astype(np.float32)

    @torch.no_grad()
    def render(self, poses: np.ndarray) -> torch.Tensor:
        """(N, H, W) float32 frames in [0, 255] for (N, 4, 4) poses."""
        h, w = self.rays.shape[:2]
        per = max(1, CHUNK_PIXELS // (h * w))
        out = torch.empty((len(poses), h, w), dtype=torch.float32, device=self.device)
        ray_c = torch.cat([self.rays, torch.ones_like(self.rays[..., :1])], -1)   # (H, W, 3)
        fx = self.camera["fx"]
        for a in range(0, len(poses), per):
            T = torch.from_numpy(poses[a:a + per]).to(self.device)
            R_wc = T[:, :3, :3].transpose(1, 2)
            C = -(R_wc @ T[:, :3, 3:])[:, :, 0]                                  # (B, 3)
            d = torch.einsum("bij,hwj->bhwi", R_wc, ray_c)
            s, su, sv = self.surface.hit(C[:, None, None, :].expand_as(d), d)
            hit = torch.isfinite(s)
            m_per_px = torch.where(hit, s, torch.ones_like(s)) / fx
            out[a:a + per] = torch.where(hit, self.surface.shade(su, sv, m_per_px),
                                         torch.full_like(s, self.sky))
        return out
