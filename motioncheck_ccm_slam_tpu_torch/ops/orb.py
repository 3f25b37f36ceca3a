"""ORB feature extraction on torch tensors.

Counterpart of ``motioncheck_ccm_slam_tpu/ops/orb.py``, always in the
kernel configuration: the dense corner stage is K1 and the blur/moment maps
are K2 (``ops/fast_cuda.py``), as the JAX extractor runs with its Pallas
front-end. Before the level loop, K1 gives the per-cell-retried masked
FAST score maps of all levels in one launch, and K2 their blur and IC
moment maps in another. Per level:

- 3x3 NMS on the score map, then per-cell and global top-k. Top-k is a
  stable descending sort, which puts the lower index first among equal
  scores as ``jax.lax.top_k`` does (``torch.topk`` does not);
- the angle is two lookups in the moment maps, steered BRIEF-256 a
  batched gather on the blur.

Descriptors are 256 bits packed into (K, 8) int32 words: the bits of the
JAX package's uint32 words, viewed as int32 (``convert.py`` reinterprets them
at the numpy boundary).
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ExtractorParams
from . import fast_cuda
from . import image as image_ops

# ---------------------------------------------------------------------------
# Static tables (the same numpy code, seed and SVD as the JAX package)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ic_angle_mask(half_patch: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Circular patch mask + coordinate grids for the intensity-centroid
    angle (reference IC_Angle with the umax row table)."""
    r = half_patch
    dy, dx = np.mgrid[-r : r + 1, -r : r + 1]
    mask = (dx * dx + dy * dy) <= r * r
    return mask.astype(np.float32), dx.astype(np.float32), dy.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _brief_pattern(n_bits: int = 256, patch: int = 31, seed: int = 1234) -> np.ndarray:
    """(n_bits, 4) table of (x1, y1, x2, y2) BRIEF test offsets: Gaussian
    sampling (sigma = patch/5, clamped) per the BRIEF paper's G-II variant."""
    rng = np.random.default_rng(seed)
    sigma = patch / 5.0
    lim = patch // 2 - 2  # keep rotated samples inside the 31x31 disc
    pts = np.clip(np.round(rng.normal(0.0, sigma, size=(n_bits, 4))), -lim, lim)
    return pts.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ic_moment_factors(half_patch: int, rel_err: float = 0.01):
    """Low-rank separable factors of the m10 moment kernel dx * disc(dy, dx).

    Truncated SVD at Frobenius error < rel_err. m01's kernel is the
    transpose, so it shares the factors with the roles swapped. Returns
    (uy (31, r) vertical factors scaled by the singular values, vx (r, 31)).
    """
    mask, dxg, dyg = _ic_angle_mask(half_patch)
    k = (dxg * mask).astype(np.float64)
    U, S, Vt = np.linalg.svd(k)
    tail = np.sqrt(np.cumsum((S ** 2)[::-1])[::-1])  # tail[r] = err of rank r
    ok = tail / tail[0] < rel_err
    r = int(np.argmax(ok)) if ok.any() else len(S)
    r = max(r, 1)
    uy = (U[:, :r] * S[:r]).astype(np.float32)
    vx = Vt[:r].astype(np.float32)
    return uy, vx


def level_feature_budgets(max_features: int, n_levels: int, scale: float) -> List[int]:
    """Per-level feature counts, geometric in 1/scale like the reference
    (ORBextractor ctor: mnFeaturesPerLevel)."""
    f = 1.0 / scale
    total = (1.0 - f) / (1.0 - f ** n_levels)
    budgets = [int(round(max_features * total * (f ** l))) for l in range(n_levels)]
    budgets[-1] += max_features - sum(budgets)
    return budgets


# ---------------------------------------------------------------------------
# Per-level keypoint selection
# ---------------------------------------------------------------------------

def _nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression: True where score is the strict local max."""
    h, w = score.shape
    p = F.pad(score, (1, 1, 1, 1), value=float("-inf"))
    m = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            n = p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            m = n if m is None else torch.maximum(m, n)
    return score > m


def _top_k(x: torch.Tensor, k: int):
    """Top-k along the last axis, lower index first among ties."""
    if x.shape[-1] < k:
        raise ValueError(f"top-k pool {x.shape[-1]} < k={k}")
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def corner_score_kwargs(params: ExtractorParams) -> dict:
    """K1's thresholds and border for the extractor's parameters."""
    return dict(th_hi=float(params.ini_th_fast), th_lo=float(params.min_th_fast),
                border=params.edge_threshold)


def _select_level_keypoints(masked_score: torch.Tensor, k_level: int, cell: int = 32,
                            k_cell: int = 8):
    """Spatially distribute up to k_level keypoints on one level from its
    K1 score map (Hp, Wc).

    Returns xy (k_level, 2) f32 (level coords), score (k_level,), valid.
    """
    hp, wp = masked_score.shape
    corner_map = masked_score > 0.0
    keep = _nms3(masked_score) & corner_map
    final_score = torch.where(keep, masked_score, torch.zeros_like(masked_score))

    ny, nx = hp // cell, wp // cell
    cells = (
        final_score.reshape(ny, cell, nx, cell).permute(0, 2, 1, 3)
        .reshape(-1, cell * cell)
    )
    vals, idx = _top_k(cells, k_cell)                       # (ncells, k_cell)
    cid = torch.arange(ny * nx, device=masked_score.device)
    py = (cid // nx)[:, None] * cell + idx // cell
    px = (cid % nx)[:, None] * cell + idx % cell

    top_vals, top_i = _top_k(vals.reshape(-1), k_level)
    sel_y = py.reshape(-1)[top_i].to(torch.float32)
    sel_x = px.reshape(-1)[top_i].to(torch.float32)
    return torch.stack([sel_x, sel_y], -1), top_vals, top_vals > 0.0


# ---------------------------------------------------------------------------
# Orientation + descriptors (batched over keypoints)
# ---------------------------------------------------------------------------

def ic_moment_maps(img: torch.Tensor, half_patch: int):
    """Dense IC moment maps m10(x, y) = sum_patch dx * I, m01 likewise, as
    two separable low-rank shift-and-add passes (edge-replicated border) in
    the jnp path's accumulation order. K2's plain version uses this."""
    uy, vx = _ic_moment_factors(half_patch)
    r = vx.shape[0]
    p = half_patch
    ksz = 2 * p + 1
    h, w = img.shape
    x = F.pad(img[None, None], (p, p, p, p), mode="replicate")[0, 0]
    kh = np.concatenate([vx, uy.T], 0)          # (2r, ksz)
    mid = []
    for c in range(2 * r):
        acc = float(kh[c, 0]) * x[:, 0:w]
        for i in range(1, ksz):
            acc = acc + float(kh[c, i]) * x[:, i:i + w]
        mid.append(acc)
    kv = np.concatenate([uy.T, vx], 0)           # (2r, ksz)
    m10 = torch.zeros((h, w), dtype=img.dtype, device=img.device)
    m01 = torch.zeros_like(m10)
    for c in range(r):
        for j in range(ksz):
            m10 = m10 + float(kv[c, j]) * mid[c][j:j + h, :]
    for c in range(r):
        for j in range(ksz):
            m01 = m01 + float(kv[r + c, j]) * mid[r + c][j:j + h, :]
    return m10, m01


def ic_angles(img: torch.Tensor, xy: torch.Tensor, moment_maps) -> torch.Tensor:
    """Intensity-centroid angles (radians) for keypoints xy (K, 2) on img,
    read from K2's moment maps."""
    m10_map, m01_map = moment_maps
    h, w = img.shape
    x0 = torch.clamp(torch.round(xy[:, 0]), 0, w - 1).long()
    y0 = torch.clamp(torch.round(xy[:, 1]), 0, h - 1).long()
    return torch.atan2(m01_map[y0, x0], m10_map[y0, x0])


@functools.lru_cache(maxsize=None)
def _device_pattern(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_brief_pattern()).to(device)


@functools.lru_cache(maxsize=None)
def _bit_weights(device: torch.device) -> torch.Tensor:
    return torch.tensor([1 << i for i in range(32)], dtype=torch.int64, device=device)


def brief_descriptors(img_blur: torch.Tensor, xy: torch.Tensor,
                      angles: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF-256 for keypoints (K, 2) with orientations (K,).

    Returns (K, 8) int32: 256 bits packed little-endian into 8 words.
    """
    pat = _device_pattern(xy.device)        # (256, 4) x1 y1 x2 y2
    c = torch.cos(angles)[:, None]
    s = torch.sin(angles)[:, None]

    def rotate(px, py):
        return px[None, :] * c - py[None, :] * s, px[None, :] * s + py[None, :] * c

    r1x, r1y = rotate(pat[:, 0], pat[:, 1])  # (K, 256)
    r2x, r2y = rotate(pat[:, 2], pat[:, 3])
    p1 = torch.stack([xy[:, 0:1] + r1x, xy[:, 1:2] + r1y], -1)
    p2 = torch.stack([xy[:, 0:1] + r2x, xy[:, 1:2] + r2y], -1)
    bits = image_ops.nearest_sample(img_blur, p1) < image_ops.nearest_sample(img_blur, p2)
    k = bits.shape[0]
    words = (bits.reshape(k, 8, 32).to(torch.int64) * _bit_weights(xy.device)).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


# ---------------------------------------------------------------------------
# Full extractor
# ---------------------------------------------------------------------------

class OrbFeatures(NamedTuple):
    """SoA feature block for one frame, fixed capacity K = max_features.

    xy is in level-0 pixel coordinates; octave the pyramid level; response
    the FAST score; angle radians; desc (K, 8) int32 words; valid marks live
    slots.
    """

    xy: torch.Tensor        # (K, 2) f32
    response: torch.Tensor  # (K,) f32
    angle: torch.Tensor     # (K,) f32
    octave: torch.Tensor    # (K,) i64
    desc: torch.Tensor      # (K, 8) i32
    valid: torch.Tensor     # (K,) bool


def extract_orb(img: torch.Tensor, params: ExtractorParams) -> OrbFeatures:
    """Extract ORB features from a grayscale (H, W) f32 image in [0, 255]."""
    levels = image_ops.build_pyramid(img, params.n_levels, params.scale_factor)
    budgets = level_feature_budgets(
        params.max_features, params.n_levels, params.scale_factor
    )
    levels = [lvl_img.contiguous() for lvl_img in levels]
    # K1 and K2 for all levels in one launch each; the padded tail of K2's
    # maps is never sampled: keypoints lie >= edge_threshold inside the level
    scores = fast_cuda.masked_corner_score_levels(levels, **corner_score_kwargs(params))
    maps = fast_cuda.blur_and_moments_levels(levels, half_patch=params.half_patch_size)
    out_xy, out_resp, out_ang, out_oct, out_desc, out_valid = [], [], [], [], [], []
    for l, (lvl_img, k_level, score_map, (blur, m10, m01)) in enumerate(
            zip(levels, budgets, scores, maps)):
        xy, score, valid = _select_level_keypoints(score_map, k_level)
        ang = ic_angles(lvl_img, xy, (m10, m01))
        out_xy.append(xy * params.scale_factor ** l)
        out_resp.append(score)
        out_ang.append(ang)
        out_oct.append(torch.full((k_level,), l, dtype=torch.int64, device=img.device))
        out_desc.append(brief_descriptors(blur, xy, ang))
        out_valid.append(valid)
    return OrbFeatures(
        xy=torch.cat(out_xy),
        response=torch.cat(out_resp),
        angle=torch.cat(out_ang),
        octave=torch.cat(out_oct),
        desc=torch.cat(out_desc),
        valid=torch.cat(out_valid),
    )


def scale_factors(params: ExtractorParams) -> np.ndarray:
    return np.array(
        [params.scale_factor ** l for l in range(params.n_levels)], np.float32
    )


def inv_level_sigma2(params: ExtractorParams) -> np.ndarray:
    """Per-octave information weights 1/sigma^2 (reference Frame
    mvInvLevelSigma2)."""
    s = scale_factors(params)
    return (1.0 / (s * s)).astype(np.float32)
