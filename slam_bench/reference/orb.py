"""Plain ORB extraction: the reference for the agent cells' extractor.

A frozen copy of the arithmetic of ``motioncheck_ccm_slam_tpu_torch``'s
extractor as plain torch operations: the bilinear pyramid, the FAST-9 arc
test with the 32x32-cell threshold retry (K1's plain formulation), the
7-tap Gaussian blur and the intensity-centroid moment maps (K2's), the 3x3
non-maximum suppression with per-cell and global top-k, the angle, steered
BRIEF-256 and the radial-tangential undistortion. It imports nothing of
the port, so a later change to the port cannot move it.

``dtype`` is the precision the whole extraction runs in: float32 for the
reference, bfloat16 for the precision control.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

FAST_RING = np.array(
    [(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
     (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3)],
    dtype=np.int32)
FAST_ARC = 9
HALO = 4
ROW_PAD, CELL = 64, 32


class Features(NamedTuple):
    xy: torch.Tensor      # (K, 2) undistorted level-0 pixels
    octave: torch.Tensor  # (K,) i64
    desc: torch.Tensor    # (K, 8) i32, 256 bits
    valid: torch.Tensor   # (K,) bool


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def pyramid_shapes(h: int, w: int, n_levels: int, scale: float):
    return [(int(round(h / scale ** l)), int(round(w / scale ** l))) for l in range(n_levels)]


def level_budgets(max_features: int, n_levels: int, scale: float):
    f = 1.0 / scale
    total = (1.0 - f) / (1.0 - f ** n_levels)
    budgets = [int(round(max_features * total * (f ** l))) for l in range(n_levels)]
    budgets[-1] += max_features - sum(budgets)
    return budgets


@functools.lru_cache(maxsize=None)
def _gauss(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    x = np.arange(-(ksize // 2), ksize // 2 + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _moment_factors(half_patch: int, rel_err: float = 0.01):
    """Low-rank separable factors of the m10 kernel dx * disc (truncated SVD)."""
    r = half_patch
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    mask = ((dx * dx + dy * dy) <= r * r).astype(np.float32)
    U, S, Vt = np.linalg.svd((dx.astype(np.float32) * mask).astype(np.float64))
    tail = np.sqrt(np.cumsum((S ** 2)[::-1])[::-1])
    ok = tail / tail[0] < rel_err
    rank = max(int(np.argmax(ok)) if ok.any() else len(S), 1)
    return (U[:, :rank] * S[:rank]).astype(np.float32), Vt[:rank].astype(np.float32)


@functools.lru_cache(maxsize=None)
def _brief_pattern(n_bits: int = 256, patch: int = 31, seed: int = 1234) -> np.ndarray:
    rng = np.random.default_rng(seed)
    lim = patch // 2 - 2
    return np.clip(np.round(rng.normal(0.0, patch / 5.0, size=(n_bits, 4))),
                   -lim, lim).astype(np.float32)


def _has_arc(m: torch.Tensor) -> torch.Tensor:
    dup = m | (m << 16)
    run = dup
    for k in range(1, FAST_ARC):
        run = run & (dup >> k)
    return (run & 0xFFFF) != 0


def corner_score(img: torch.Tensor, th_hi: float, th_lo: float, border: int) -> torch.Tensor:
    """FAST-9 score with the high threshold where a 32x32 cell has a corner
    at it, else the low one; (H, W) -> (round_up(H, 64), round_up(W, 32))."""
    h, w = img.shape
    hp, wc = _round_up(h, ROW_PAD), _round_up(w, CELL)
    p = F.pad(img, (HALO, wc - w + HALO, HALO, hp - h + HALO))
    center = p[HALO:HALO + hp, HALO:HALO + wc]
    masks = [torch.zeros(center.shape, dtype=torch.int32, device=img.device) for _ in range(4)]
    zero = torch.zeros_like(center)
    sums = [zero] * 4
    for k, (dx, dy) in enumerate(FAST_RING.tolist()):
        d = p[HALO + dy:HALO + dy + hp, HALO + dx:HALO + dx + wc] - center
        tests = (d > th_hi, d < -th_hi, d > th_lo, d < -th_lo)
        excess = (d - th_hi, -d - th_hi, d - th_lo, -d - th_lo)
        for i in range(4):
            masks[i] = masks[i] | (tests[i].to(torch.int32) << k)
            sums[i] = sums[i] + torch.clamp_min(excess[i], 0.0)
    rows = torch.arange(hp, device=img.device)[:, None]
    cols = torch.arange(wc, device=img.device)[None, :]
    inside = (rows >= border) & (rows < h - border) & (cols >= border) & (cols < w - border)
    hi = (_has_arc(masks[0]) | _has_arc(masks[1])) & inside
    lo = (_has_arc(masks[2]) | _has_arc(masks[3])) & inside
    cells = hi.reshape(hp // CELL, CELL, wc // CELL, CELL).any(3).any(1)
    use_hi = cells.repeat_interleave(CELL, 0).repeat_interleave(CELL, 1)
    return torch.where(use_hi, torch.where(hi, torch.maximum(sums[0], sums[1]), zero),
                       torch.where(lo, torch.maximum(sums[2], sums[3]), zero))


def blur_and_moments(img: torch.Tensor, half_patch: int):
    """The 7-tap Gaussian blur and the moment maps m10, m01 of the image
    edge-extended to (round_up(H, 64), round_up(W, 32))."""
    h, w = img.shape
    hp, wc = _round_up(h, ROW_PAD), _round_up(w, CELL)
    x = F.pad(img[None, None], (0, wc - w, 0, hp - h), mode="replicate")[0, 0]
    uy, vx = _moment_factors(half_patch)
    r, p = vx.shape[0], half_patch
    ksz = 2 * p + 1
    xp = F.pad(x[None, None], (p, p, p, p), mode="replicate")[0, 0]
    kh = np.concatenate([vx, uy.T], 0)
    kv = np.concatenate([uy.T, vx], 0)
    mid = []
    for c in range(2 * r):
        acc = float(kh[c, 0]) * xp[:, 0:wc]
        for i in range(1, ksz):
            acc = acc + float(kh[c, i]) * xp[:, i:i + wc]
        mid.append(acc)
    m10 = torch.zeros((hp, wc), dtype=x.dtype, device=x.device)
    m01 = torch.zeros_like(m10)
    for c in range(r):
        for j in range(ksz):
            m10 = m10 + float(kv[c, j]) * mid[c][j:j + hp, :]
    for c in range(r):
        for j in range(ksz):
            m01 = m01 + float(kv[r + c, j]) * mid[r + c][j:j + hp, :]
    k = _gauss()
    half = len(k) // 2
    xb = F.pad(x[None, None], (half, half, half, half), mode="replicate")[0, 0]
    b = float(k[0]) * xb[:, 0:wc]
    for i in range(1, len(k)):
        b = b + float(k[i]) * xb[:, i:i + wc]
    blur = float(k[0]) * b[0:hp, :]
    for i in range(1, len(k)):
        blur = blur + float(k[i]) * b[i:i + hp, :]
    return blur, m10, m01


def _nms3(score: torch.Tensor) -> torch.Tensor:
    h, w = score.shape
    p = F.pad(score, (1, 1, 1, 1), value=float("-inf"))
    best = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                n = p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                best = n if best is None else torch.maximum(best, n)
    return score > best


def _top_k(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_keypoints(score: torch.Tensor, k_level: int, cell: int = 32, k_cell: int = 8):
    hp, wp = score.shape
    keep = _nms3(score) & (score > 0.0)
    final = torch.where(keep, score, torch.zeros_like(score))
    ny, nx = hp // cell, wp // cell
    cells = final.reshape(ny, cell, nx, cell).permute(0, 2, 1, 3).reshape(-1, cell * cell)
    vals, idx = _top_k(cells, k_cell)
    cid = torch.arange(ny * nx, device=score.device)
    py = (cid // nx)[:, None] * cell + idx // cell
    px = (cid % nx)[:, None] * cell + idx % cell
    top_vals, top_i = _top_k(vals.reshape(-1), k_level)
    xy = torch.stack([px.reshape(-1)[top_i], py.reshape(-1)[top_i]], -1).to(score.dtype)
    return xy, top_vals > 0.0


def _sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    h, w = img.shape
    x = torch.clamp(torch.round(xy[..., 0]), 0, w - 1).long()
    y = torch.clamp(torch.round(xy[..., 1]), 0, h - 1).long()
    return img[y, x]


def brief(blur: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    pat = torch.from_numpy(_brief_pattern()).to(device=xy.device, dtype=xy.dtype)
    c, s = torch.cos(angle)[:, None], torch.sin(angle)[:, None]

    def rotate(px, py):
        return px[None, :] * c - py[None, :] * s, px[None, :] * s + py[None, :] * c

    r1x, r1y = rotate(pat[:, 0], pat[:, 1])
    r2x, r2y = rotate(pat[:, 2], pat[:, 3])
    p1 = torch.stack([xy[:, 0:1] + r1x, xy[:, 1:2] + r1y], -1)
    p2 = torch.stack([xy[:, 0:1] + r2x, xy[:, 1:2] + r2y], -1)
    bits = _sample(blur, p1) < _sample(blur, p2)
    weights = torch.tensor([1 << i for i in range(32)], dtype=torch.int64, device=xy.device)
    words = (bits.reshape(bits.shape[0], 8, 32).to(torch.int64) * weights).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def undistort(uv: torch.Tensor, camera: dict, iters: int = 8) -> torch.Tensor:
    """cv::undistortPoints' fixed-point scheme on pixel keypoints."""
    fx, fy, cx, cy = camera["fx"], camera["fy"], camera["cx"], camera["cy"]
    k1, k2, p1, p2, k3 = (camera[k] for k in ("k1", "k2", "p1", "p2", "k3"))
    target = torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], -1)
    xy = target
    for _ in range(iters):
        x, y = xy[:, 0], xy[:, 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dist = torch.stack([x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x),
                            y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y], -1)
        xy = xy + (target - dist)
    return torch.stack([xy[:, 0] * fx + cx, xy[:, 1] * fy + cy], -1)


def pyramid(img: torch.Tensor, extractor: dict):
    """The bilinear pyramid (half-pixel centres, no antialiasing), each
    level resized from the one before."""
    n_levels, scale = extractor["n_levels"], extractor["scale_factor"]
    shapes = pyramid_shapes(*img.shape, n_levels, scale)
    levels = [img]
    for l in range(1, n_levels):
        levels.append(F.interpolate(levels[-1][None, None], size=shapes[l], mode="bilinear",
                                    align_corners=False, antialias=False)[0, 0].contiguous())
    return levels


def extract(img: torch.Tensor, extractor: dict, camera: dict,
            dtype: torch.dtype = torch.float32) -> Features:
    """ORB features of a grayscale (H, W) image in [0, 255], computed in
    ``dtype``; positions undistorted to level-0 pixels."""
    n_levels, scale = extractor["n_levels"], extractor["scale_factor"]
    levels = pyramid(img.to(dtype), extractor)
    budgets = level_budgets(extractor["max_features"], n_levels, scale)
    out_xy, out_oct, out_desc, out_valid = [], [], [], []
    for l, (lv, k_level) in enumerate(zip(levels, budgets)):
        score = corner_score(lv, float(extractor["ini_th_fast"]), float(extractor["min_th_fast"]),
                             extractor["edge_threshold"])
        blur, m10, m01 = blur_and_moments(lv, extractor["half_patch_size"])
        xy, valid = select_keypoints(score, k_level)
        x0 = torch.clamp(torch.round(xy[:, 0]), 0, lv.shape[1] - 1).long()
        y0 = torch.clamp(torch.round(xy[:, 1]), 0, lv.shape[0] - 1).long()
        angle = torch.atan2(m01[y0, x0], m10[y0, x0])
        out_xy.append(xy * scale ** l)
        out_oct.append(torch.full((k_level,), l, dtype=torch.int64, device=img.device))
        out_desc.append(brief(blur, xy, angle))
        out_valid.append(valid)
    xy = undistort(torch.cat(out_xy), camera)
    return Features(xy=xy.float(), octave=torch.cat(out_oct), desc=torch.cat(out_desc),
                    valid=torch.cat(out_valid))



def hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bits that differ between (K, 8) i32 descriptor rows."""
    x = (a ^ b).to(torch.int64) & 0xFFFFFFFF
    bits = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for i in range(32):
        bits = bits + ((x >> i) & 1).sum(-1)
    return bits
