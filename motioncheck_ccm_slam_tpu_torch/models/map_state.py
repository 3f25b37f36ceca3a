"""Device-resident SoA map state (the landmark block the tracker reads).

Counterpart of ``motioncheck_ccm_slam_tpu/models/map_state.py``: the
landmark structure-of-arrays with a validity mask, at fixed capacity.
Descriptors are (NM, 8) int32 words (see ops/orb.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

INVALID = -1


class MPBlock(NamedTuple):
    """Landmark SoA, capacity NM."""

    mp_id: torch.Tensor        # (NM,) i32
    client_id: torch.Tensor    # (NM,) i32
    unique_id: torch.Tensor    # (NM,) i32
    Xw: torch.Tensor           # (NM, 3) world position
    desc: torch.Tensor         # (NM, 8) i32 distinctive descriptor
    normal: torch.Tensor       # (NM, 3) mean viewing direction
    min_dist: torch.Tensor     # (NM,) scale-invariance range
    max_dist: torch.Tensor     # (NM,)
    ref_kf: torch.Tensor       # (NM,) i32 reference keyframe slot
    first_kf_id: torch.Tensor  # (NM,) i32 kf_id at creation (culling rules)
    n_visible: torch.Tensor    # (NM,) i32 — frames it was in frustum
    n_found: torch.Tensor      # (NM,) i32 — frames it was matched
    valid: torch.Tensor        # (NM,) bool


def empty_mp_block(nm: int, device: torch.device | str = "cuda") -> MPBlock:
    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    i32, f32 = torch.int32, torch.float32
    return MPBlock(
        mp_id=full((nm,), INVALID, i32),
        client_id=full((nm,), INVALID, i32),
        unique_id=full((nm,), 0, i32),
        Xw=full((nm, 3), 0.0, f32),
        desc=full((nm, 8), 0, i32),
        normal=full((nm, 3), 0.0, f32),
        min_dist=full((nm,), 0.0, f32),
        max_dist=full((nm,), 1e9, f32),
        ref_kf=full((nm,), INVALID, i32),
        first_kf_id=full((nm,), INVALID, i32),
        n_visible=full((nm,), 1, i32),
        n_found=full((nm,), 1, i32),
        valid=full((nm,), False, torch.bool),
    )
