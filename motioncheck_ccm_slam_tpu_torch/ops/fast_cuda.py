"""Dense FAST front-end: kernels K1 and K2 as CUDA C++ for Hopper.

Counterpart of ``motioncheck_ccm_slam_tpu/ops/fast_pallas.py``. The kernels
live in ``csrc/fast.cu`` (plain C interface), are built with ``nvcc`` for
``sm_90a`` into ``build/torch_kernels/`` at first use and loaded with
``ctypes``.

- ``masked_corner_score`` (K1): two-threshold FAST-9/16 with the per-cell
  retry, bit-identical to ``masked_corner_score_ref``.
- ``blur_and_moments`` (K2): 7-tap Gaussian blur plus the IC moment maps
  m10/m01 from one image read, within f32 rounding (FMA contraction) of
  ``blur_and_moments_ref``.

Each wrapper takes a 2-D contiguous float32 tensor. A CPU tensor goes to the
plain version; a CUDA tensor launches the kernel or raises. ``launches``
on each wrapper counts kernel launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build

# FAST ring: 16 contiguous (dx, dy) offsets of the radius-3 Bresenham circle
# (shared with ops.orb; the same order is compiled into csrc/fast.cu).
FAST_RING = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2),
        (-1, -3),
    ],
    dtype=np.int32,
)
FAST_ARC = 9  # FAST-9: >= 9 contiguous ring pixels all brighter/darker

HALO = 4      # ring radius 3, +1 slack
TH = 64       # output rows are padded to a multiple of this
CELL = 32     # threshold-retry cell; output columns pad to a multiple

SOURCE = os.path.join(cuda_build.CSRC_DIR, "fast.cu")
BUILD_DIR = cuda_build.BUILD_DIR
NVCC_FLAGS = cuda_build.NVCC_FLAGS


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def padded_shape(h: int, w: int) -> Tuple[int, int]:
    """(Hp, Wc) of both kernels' outputs for an (h, w) level image."""
    return _round_up(h, TH), _round_up(w, CELL)


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def library_path() -> str:
    """Path of the built library; the name carries the source and flag hash,
    so an edited source builds anew."""
    return cuda_build.library_path(SOURCE)


def build() -> str:
    """Compile csrc/fast.cu with nvcc unless already built. Returns the
    compiler's output (ptxas register and shared-memory report), or "" if
    the library was already there."""
    return cuda_build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return cuda_build.load(SOURCE, {
        "mcs_masked_corner_score": [p, i, i, p, i, i, f, f, i, p],
        "mcs_blur_and_moments": [p, i, i, p, i, p, p, p, i, i, p],
    })


def _check_image(img: torch.Tensor) -> None:
    if not isinstance(img, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(img).__name__}")
    if img.dtype != torch.float32:
        raise TypeError(f"expected float32, got {img.dtype}")
    if img.dim() != 2:
        raise ValueError(f"expected a 2-D (H, W) image, got shape {tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("expected a contiguous image")
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {img.device}")


# ---------------------------------------------------------------------------
# K1: masked two-threshold FAST score
# ---------------------------------------------------------------------------

def _has_arc(m: torch.Tensor) -> torch.Tensor:
    """Wraparound >= FAST_ARC run over the 16 ring bits of an int32 map."""
    dup = m | (m << 16)
    run = dup
    for k in range(1, FAST_ARC):
        run = run & (dup >> k)
    return (run & 0xFFFF) != 0


def masked_corner_score_ref(img: torch.Tensor, *, th_hi: float, th_lo: float,
                            border: int) -> torch.Tensor:
    """Plain torch version of K1: the jnp formulation of
    ``orb.fast_response_two_thresholds`` plus the 32x32-cell retry, same
    f32 adds in the same ring order (so bit-identical to the kernel).
    (H, W) -> (round_up(H, 64), round_up(W, 32)), pad region zero."""
    h, w = img.shape
    hp, wc = padded_shape(h, w)
    p = F.pad(img, (HALO, wc - w + HALO, HALO, hp - h + HALO))
    center = p[HALO:HALO + hp, HALO:HALO + wc]
    m_hb = torch.zeros(center.shape, dtype=torch.int32, device=img.device)
    m_hd, m_lb, m_ld = m_hb.clone(), m_hb.clone(), m_hb.clone()
    zero = torch.zeros_like(center)
    s_hb, s_hd, s_lb, s_ld = zero, zero, zero, zero
    for k, (dx, dy) in enumerate(FAST_RING.tolist()):
        d = p[HALO + dy:HALO + dy + hp, HALO + dx:HALO + dx + wc] - center
        m_hb = m_hb | ((d > th_hi).to(torch.int32) << k)
        m_hd = m_hd | ((d < -th_hi).to(torch.int32) << k)
        m_lb = m_lb | ((d > th_lo).to(torch.int32) << k)
        m_ld = m_ld | ((d < -th_lo).to(torch.int32) << k)
        s_hb = s_hb + torch.clamp_min(d - th_hi, 0.0)
        s_hd = s_hd + torch.clamp_min(-d - th_hi, 0.0)
        s_lb = s_lb + torch.clamp_min(d - th_lo, 0.0)
        s_ld = s_ld + torch.clamp_min(-d - th_lo, 0.0)
    rows = torch.arange(hp, device=img.device)[:, None]
    cols = torch.arange(wc, device=img.device)[None, :]
    ok = (rows >= border) & (rows < h - border) & (cols >= border) & (cols < w - border)
    corner_hi = (_has_arc(m_hb) | _has_arc(m_hd)) & ok
    corner_lo = (_has_arc(m_lb) | _has_arc(m_ld)) & ok
    cells = corner_hi.reshape(hp // CELL, CELL, wc // CELL, CELL).any(3).any(1)
    use_hi = cells.repeat_interleave(CELL, 0).repeat_interleave(CELL, 1)
    return torch.where(
        use_hi,
        torch.where(corner_hi, torch.maximum(s_hb, s_hd), zero),
        torch.where(corner_lo, torch.maximum(s_lb, s_ld), zero),
    )


def masked_corner_score(img: torch.Tensor, *, th_hi: float, th_lo: float,
                        border: int) -> torch.Tensor:
    """(H, W) f32 level image -> (Hp, Wc) masked two-threshold FAST score.

    Hp = round_up(H, 64), Wc = round_up(W, 32); the pad area is zero (no
    candidates). Requires border >= HALO so that no pixel that can score
    reads outside the image.
    """
    _check_image(img)
    if border < HALO:
        raise ValueError(f"border {border} < HALO {HALO}")
    if img.device.type == "cpu":
        return masked_corner_score_ref(img, th_hi=th_hi, th_lo=th_lo, border=border)
    h, w = img.shape
    hp, wc = padded_shape(h, w)
    lib = _library()
    with torch.cuda.device(img.device):
        out = torch.empty((hp, wc), dtype=torch.float32, device=img.device)
        err = lib.mcs_masked_corner_score(
            img.data_ptr(), h, w, out.data_ptr(), hp, wc, float(th_hi),
            float(th_lo), int(border), torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(err, "masked_corner_score")
    masked_corner_score.launches += 1
    return out


masked_corner_score.launches = 0


# ---------------------------------------------------------------------------
# K2: blur + IC moment maps
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _device_taps(device: torch.device, half_patch: int) -> Tuple[torch.Tensor, int]:
    """K2's taps [kb (7), kh (2r, 31), kv (2r, 31)] on ``device`` and the
    rank r, ordered as the jnp path and the Pallas kernel order them:
    channels [0, r) build m10, [r, 2r) m01."""
    from .image import _gaussian_kernel_1d
    from .orb import _ic_moment_factors

    uy, vx = _ic_moment_factors(half_patch)
    kh = np.concatenate([vx, uy.T], 0)
    kv = np.concatenate([uy.T, vx], 0)
    flat = np.concatenate([_gaussian_kernel_1d(7, 2.0), kh.reshape(-1), kv.reshape(-1)])
    return torch.from_numpy(flat.astype(np.float32)).to(device), vx.shape[0]


def blur_and_moments_ref(img: torch.Tensor, *, half_patch: int = 15,
                         ksize: int = 7, sigma: float = 2.0):
    """Plain torch version of K2: ``image.gaussian_blur`` plus
    ``orb.ic_moment_maps`` on the image edge-extended to (Hp, Wc). Inside
    (H, W) that equals the two on the image itself."""
    from .image import gaussian_blur
    from .orb import ic_moment_maps

    h, w = img.shape
    hp, wc = padded_shape(h, w)
    x = F.pad(img[None, None], (0, wc - w, 0, hp - h), mode="replicate")[0, 0]
    m10, m01 = ic_moment_maps(x, half_patch)
    return gaussian_blur(x, ksize, sigma), m10, m01


def blur_and_moments(img: torch.Tensor, *, half_patch: int = 15):
    """(H, W) f32 -> (blur, m10, m01), each (Hp, Wc), from one image read.

    The 7-tap sigma=2 blur and the radius-``half_patch`` IC moments. The
    pad region holds the edge-extended image's maps, which keypoints (>=
    edge_threshold inside the image) never sample.
    """
    _check_image(img)
    if img.device.type == "cpu":
        return blur_and_moments_ref(img, half_patch=half_patch)
    if half_patch != 15:
        raise ValueError("the kernel is compiled for half_patch=15 (31 taps)")
    h, w = img.shape
    hp, wc = padded_shape(h, w)
    lib = _library()
    taps, rank = _device_taps(img.device, half_patch)
    with torch.cuda.device(img.device):
        blur = torch.empty((hp, wc), dtype=torch.float32, device=img.device)
        m10 = torch.empty_like(blur)
        m01 = torch.empty_like(blur)
        err = lib.mcs_blur_and_moments(
            img.data_ptr(), h, w, taps.data_ptr(), rank, blur.data_ptr(),
            m10.data_ptr(), m01.data_ptr(), hp, wc,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check_launch(err, "blur_and_moments")
    blur_and_moments.launches += 1
    return blur, m10, m01


blur_and_moments.launches = 0
