"""Batched ORB descriptor matching on torch tensors.

Counterpart of ``motioncheck_ccm_slam_tpu/ops/matching.py``: every search
mode is a dense Hamming distance matrix, a candidate mask from the mode's
spatial / octave / epipolar constraints, a masked best + second-best
reduction with the ratio test, duplicate resolution by scatter-min and,
where the mode asks, the rotation-histogram filter. Thresholds mirror the
reference: TH_LOW=50, TH_HIGH=100, HISTO_LENGTH=30.

Descriptors are (N, 8) int32 words holding the 256 bits (see ops/orb.py).
torch has no bit shifts on uint32, so popcounts widen to int64.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import math

import torch

from . import lie

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30

_BIG = 1 << 20


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of the low 32 bits of an int32/int64 tensor
    (SWAR bit-twiddle in int64). Returns int32."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def unpack_descriptor_bits(d: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 packed descriptors -> (N, 256) float32 0/1 bits."""
    shifts = torch.arange(32, dtype=torch.int64, device=d.device)
    bits = ((d.to(torch.int64)[:, :, None] & 0xFFFFFFFF) >> shifts) & 1
    return bits.reshape(d.shape[0], 256).to(torch.float32)


def hamming_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(N, 8) x (M, 8) -> (N, M) int32 Hamming distances (0..256).

    ham(x, y) = pop(x) + pop(y) - 2 <b_x, b_y> with b the 0/1 bit vectors:
    one float32 matmul, exact because every partial sum is an integer
    <= 256.
    """
    b1 = unpack_descriptor_bits(d1)
    b2 = unpack_descriptor_bits(d2)
    dot = b1 @ b2.T
    ham = b1.sum(-1)[:, None] + b2.sum(-1)[None, :] - 2.0 * dot
    return ham.to(torch.int32)


def hamming_rows(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Row-wise Hamming distance of aligned descriptor blocks (N, 8)."""
    return torch.sum(popcount_u32(d1 ^ d2), dim=-1, dtype=torch.int32)


class MatchResult(NamedTuple):
    """For each query row: best target index, distance, validity."""

    idx: torch.Tensor    # (Q,) i64 — index into target block (undefined if !ok)
    dist: torch.Tensor   # (Q,) i32
    ok: torch.Tensor     # (Q,) bool


def masked_best_match(dist: torch.Tensor, mask: torch.Tensor, max_dist: int,
                      nn_ratio: float = 1.0) -> MatchResult:
    """Best match per query row under a candidate mask + ratio test.

    A match passes if best <= max_dist and best < nn_ratio * second_best
    (ratio skipped when nn_ratio >= 1). Ties go to the lowest target index
    (``torch.argmin`` returns the first minimum).
    """
    d = torch.where(mask, dist, torch.full_like(dist, _BIG))
    best = torch.amin(d, dim=1)
    best_idx = torch.argmin(d, dim=1)
    d2 = d.clone()
    d2[torch.arange(d.shape[0], device=d.device), best_idx] = _BIG
    second = torch.min(d2, dim=1).values
    ok = best <= max_dist
    if nn_ratio < 1.0:
        ok = ok & (best.to(torch.float32) < nn_ratio * second.to(torch.float32))
    return MatchResult(idx=best_idx, dist=best, ok=ok)


def resolve_duplicates(match: MatchResult, n_targets: int) -> MatchResult:
    """Keep only the lowest-distance query per target feature; among equal
    distances the lowest query index. Invalid queries are parked in an
    extra slot ``n_targets``."""
    dev = match.dist.device
    tgt = torch.where(match.ok, match.idx, torch.full_like(match.idx, n_targets))
    big = torch.full((n_targets + 1,), _BIG, dtype=torch.int32, device=dev)
    best_per_tgt = big.scatter_reduce(0, tgt, match.dist, reduce="amin")
    keep = match.ok & (match.dist <= best_per_tgt[tgt])
    qidx = torch.arange(match.idx.shape[0], dtype=torch.int32, device=dev)
    first_q = big.scatter_reduce(
        0, tgt, torch.where(keep, qidx, torch.full_like(qidx, _BIG)), reduce="amin")
    keep = keep & (first_q[tgt] == qidx)
    return MatchResult(idx=match.idx, dist=match.dist, ok=keep)


def rotation_consistency(angle_q: torch.Tensor, angle_t: torch.Tensor, ok: torch.Tensor,
                         n_keep: int = 3) -> torch.Tensor:
    """Rotation-histogram filter (reference ComputeThreeMaxima + HISTO
    check): keep only matches whose angle offset falls in one of the n_keep
    most popular of HISTO_LENGTH bins, each at >= 10% of the top bin. Equal
    counts rank by bin index (a stable sort, as ``lax.top_k``)."""
    two_pi = 2.0 * math.pi
    rot = torch.remainder(angle_q - angle_t, two_pi)
    bins = torch.clamp((rot * (HISTO_LENGTH / two_pi)).to(torch.int64), 0, HISTO_LENGTH - 1)
    counts = torch.zeros((HISTO_LENGTH,), dtype=torch.int32, device=ok.device)
    counts = counts.index_add(0, torch.where(ok, bins, HISTO_LENGTH - 1), ok.to(torch.int32))
    top_counts, top_bins = torch.sort(counts, descending=True, stable=True)
    thres = torch.clamp_min((0.1 * top_counts[0].to(torch.float32)).to(torch.int32), 1)
    keep_bin = torch.zeros((HISTO_LENGTH,), dtype=torch.bool, device=ok.device)
    keep_bin[top_bins[:n_keep]] = top_counts[:n_keep] >= thres
    return ok & keep_bin[bins]


def window_mask(uv_q: torch.Tensor, uv_t: torch.Tensor, radius) -> torch.Tensor:
    """(Q, 2) x (T, 2) -> (Q, T) bool: |du| and |dv| within radius
    (scalar or per-query (Q,))."""
    du = torch.abs(uv_q[:, None, 0] - uv_t[None, :, 0])
    dv = torch.abs(uv_q[:, None, 1] - uv_t[None, :, 1])
    r = torch.as_tensor(radius, device=uv_q.device)
    if r.dim() == 1:
        r = r[:, None]
    return (du <= r) & (dv <= r)


def octave_mask(oct_pred: torch.Tensor, oct_t: torch.Tensor, lo_delta: int = 1,
                hi_delta: int = 1) -> torch.Tensor:
    """(Q,) x (T,) -> (Q, T) bool: target octave within [pred-lo, pred+hi]."""
    d = oct_t[None, :] - oct_pred[:, None]
    return (d >= -lo_delta) & (d <= hi_delta)


def search_by_projection(
    desc_q, uv_proj, octave_pred, valid_q,
    desc_t, uv_t, octave_t, valid_t,
    radius, max_dist: int = TH_HIGH, nn_ratio: float = 1.0,
    use_octave: bool = True, dist: Optional[torch.Tensor] = None,
) -> MatchResult:
    """Projection-guided search (reference SearchByProjection family).

    Query = map points projected into the frame; target = the frame's
    features. ``dist`` may pass a precomputed ``hamming_matrix(desc_q,
    desc_t)`` (the tracking step reuses one per frame). Returns per-query
    matches into the feature block with duplicates resolved.
    """
    if dist is None:
        dist = hamming_matrix(desc_q, desc_t)
    mask = window_mask(uv_proj, uv_t, radius)
    if use_octave:
        mask = mask & octave_mask(octave_pred, octave_t)
    mask = mask & valid_q[:, None] & valid_t[None, :]
    m = masked_best_match(dist, mask, max_dist, nn_ratio)
    return resolve_duplicates(MatchResult(m.idx, m.dist, m.ok & valid_q), desc_t.shape[0])


def search_for_initialization(
    desc1, uv1, valid1, desc2, uv2, valid2,
    window: float = 100.0, max_dist: int = TH_LOW, nn_ratio: float = 0.9,
    angle1=None, angle2=None, check_rotation: bool = True,
) -> MatchResult:
    """Two-view bootstrap matching (reference SearchForInitialization):
    windowed search + ratio test + rotation consistency, duplicates
    resolved."""
    dist = hamming_matrix(desc1, desc2)
    mask = window_mask(uv1, uv2, window) & valid1[:, None] & valid2[None, :]
    m = masked_best_match(dist, mask, max_dist, nn_ratio)
    m = resolve_duplicates(MatchResult(m.idx, m.dist, m.ok & valid1), desc2.shape[0])
    if check_rotation and angle1 is not None:
        m = MatchResult(m.idx, m.dist, rotation_consistency(angle1, angle2[m.idx], m.ok))
    return m


def _mutual(fwd: MatchResult, bwd: MatchResult, valid1: torch.Tensor) -> MatchResult:
    """Forward matches that the backward search sends back to the same
    query."""
    q = torch.arange(fwd.idx.shape[0], device=fwd.idx.device)
    mutual = bwd.idx[fwd.idx] == q
    return MatchResult(fwd.idx, fwd.dist, fwd.ok & bwd.ok[fwd.idx] & mutual & valid1)


def mutual_match(desc1, valid1, desc2, valid2, max_dist: int = TH_LOW,
                 nn_ratio: float = 1.0) -> MatchResult:
    """Unconstrained mutual best match (where the reference does a
    BoW-node-constrained brute force, SearchByBoW; the node constraint is a
    speed trick, the mutual consistency it implied is kept)."""
    dist = hamming_matrix(desc1, desc2)
    mask = valid1[:, None] & valid2[None, :]
    fwd = masked_best_match(dist, mask, max_dist, nn_ratio)
    bwd = masked_best_match(dist.T, mask.T, max_dist, nn_ratio)
    return _mutual(fwd, bwd, valid1)


def epipolar_line_distance(uv: torch.Tensor, F_line: torch.Tensor) -> torch.Tensor:
    """Distance of points (N, 2) to epipolar lines (N, 3) (a, b, c)."""
    a, b, c = F_line[:, 0], F_line[:, 1], F_line[:, 2]
    num = torch.abs(a * uv[:, 0] + b * uv[:, 1] + c)
    return num / torch.clamp_min(torch.sqrt(a * a + b * b), 1e-9)


def search_for_triangulation(
    desc1, uv1, valid1, desc2, uv2, valid2, F12,
    inv_sigma2_t, octave2,
    max_dist: int = TH_LOW, epi_chi2: float = 3.84, nn_ratio: float = 0.8,
) -> MatchResult:
    """Epipolar-constrained matching for new landmarks (reference
    SearchForTriangulation): a KF2 candidate must lie near the epipolar
    line F12 x1 of the KF1 feature (x2^T F12 x1 = 0), within a chi2 gate at
    its octave; mutual best matches, duplicates resolved."""
    dist = hamming_matrix(desc1, desc2)
    ones = torch.ones((uv1.shape[0], 1), dtype=uv1.dtype, device=uv1.device)
    lines2 = torch.cat([uv1, ones], -1) @ F12.T  # (N1, 3)
    d_num = torch.abs(lines2[:, 0:1] * uv2[None, :, 0] + lines2[:, 1:2] * uv2[None, :, 1]
                      + lines2[:, 2:3])
    d_den = torch.sqrt(lines2[:, 0:1] ** 2 + lines2[:, 1:2] ** 2)
    epi_d2 = (d_num / torch.clamp_min(d_den, 1e-9)) ** 2
    gate = epi_chi2 / inv_sigma2_t[octave2.long()][None, :]
    mask = (epi_d2 < gate) & valid1[:, None] & valid2[None, :]
    # mutual best guards against repeated texture along the epipolar line
    # (a ratio test would starve matches: the second-best candidate on the
    # line is always close in appearance)
    fwd = masked_best_match(dist, mask, max_dist)
    bwd = masked_best_match(dist.T, mask.T, max_dist)
    return resolve_duplicates(_mutual(fwd, bwd, valid1), desc2.shape[0])


def search_by_sim3(
    desc1, Xc1, valid1, desc2, Xc2, valid2, S12, K,
    radius: float = 7.5, max_dist: int = TH_HIGH,
) -> MatchResult:
    """Sim3-guided mutual landmark matching (reference
    ORBmatcher::SearchBySim3): project each keyframe's landmarks into the
    other camera through S12 (camera-2 frame -> camera-1 frame), match near
    the projections in both directions, keep mutual agreements.

    Xc1/Xc2 (N1, 3)/(N2, 3): landmarks in camera-1 / camera-2 frames,
    aligned with desc1/desc2. Returns per-landmark-1 matches into block 2.
    """
    S21 = lie.sim3_inv(S12)
    p2_in_1 = lie.sim3_apply(S12, Xc2[None])[0]
    p1_in_2 = lie.sim3_apply(S21, Xc1[None])[0]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def proj(p):
        z = torch.clamp_min(p[:, 2], 1e-6)
        return torch.stack([fx * p[:, 0] / z + cx, fy * p[:, 1] / z + cy], -1), p[:, 2] > 0

    uv1_of_1, _ = proj(Xc1)
    uv2_of_2, _ = proj(Xc2)
    uv1_of_2, ok2in1 = proj(p2_in_1)
    uv2_of_1, ok1in2 = proj(p1_in_2)
    dist = hamming_matrix(desc1, desc2)
    mask_fwd = (window_mask(uv1_of_1, uv1_of_2, radius) & valid1[:, None]
                & (valid2 & ok2in1)[None, :])
    fwd = masked_best_match(dist, mask_fwd, max_dist)
    mask_bwd = (window_mask(uv2_of_2, uv2_of_1, radius) & valid2[:, None]
                & (valid1 & ok1in2)[None, :])
    bwd = masked_best_match(dist.T, mask_bwd, max_dist)
    return _mutual(fwd, bwd, valid1)
