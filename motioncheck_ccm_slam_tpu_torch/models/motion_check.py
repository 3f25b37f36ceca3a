"""Motion Check: trajectory-shape gating of Global Bundle Adjustment.

Counterpart of ``motioncheck_ccm_slam_tpu/models/motion_check.py``, the
fork's headline safeguard (reference src/Map.cpp:1754-4090, survey §5.9):
compare each keyframe's post-GBA step vector against its pre-GBA
("tracking") step vector in the IMU/body frame; keyframes whose motion
changed shape implausibly accumulate "doubt"; doubted keyframes become
violators; the verdict either reverts the whole GBA or surgically deletes
the violators.

The anchor bookkeeping of ``CorrectKF_V3`` (:3647-3840) is sequential:
each KF's step is measured from the previous non-doubted anchor. The
reference runs it on the CPU, and so does this port: the two passes
(forward, then reversed with margin relaxation near doubted anchors) and
the longest-violating-run count are float32 numpy array operations over
one host copy of a client's (N, 3) pre- and post-GBA body positions
(N <= 2048 keyframes), every step of a pass tested in one
``motion_violates`` call. The body positions, the pre-GBA snapshot and the
verdict's application stay on the map's device.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import MotionCheckParams
from ..ops import lie
from ..utils import trace
from . import map_state as ms

_F32 = np.float32


def body_positions(Tcw: torch.Tensor, T_SC_inv: torch.Tensor) -> torch.Tensor:
    """Tws translation per KF: (Tcw^-1 . T_SC^-1)[0:3, 3] (reference
    ComputeTws src/Map.cpp:3632 / SetTcwCurrent :4027)."""
    Tws = lie.inv_T(Tcw) @ T_SC_inv
    return Tws[..., :3, 3]


def _angle_deg(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Angle (deg) between the vectors of the last axis; the reference uses
    180/3.14 (not pi) — reproduced for parity (src/Map.cpp:2878)."""
    na = np.linalg.norm(a, axis=-1)
    nb = np.linalg.norm(b, axis=-1)
    cos = np.sum(a * b, -1) / np.maximum(na * nb, _F32(1e-12))
    return np.arccos(np.clip(cos, _F32(-1.0), _F32(1.0))) * _F32(180.0 / 3.14)


def _plane_angle_deg(a, b, i: int, j: int):
    return _angle_deg(a[..., [i, j]], b[..., [i, j]])


def _length(v: np.ndarray) -> np.ndarray:
    """Length of each (..., 3) step as ``np.linalg.norm`` gives it for one
    (3,) vector: the root of numpy's BLAS dot product, which rounds
    otherwise than the float32 sum of an ``axis=-1`` norm (on ~10% of
    steps). numpy's matmul takes the same dot for each stacked
    (1, 3) @ (3, 1) product."""
    return np.sqrt(np.matmul(v[..., None, :], v[..., :, None])[..., 0, 0])


def motion_violates(step_post, prev_step_post, step_pre, prev_step_pre,
                    degree_margin, movement_margin, params: MotionCheckParams):
    """The three checks of reference Map::MotionCheck (:2894-2907) on
    float32 step vectors of shape (..., 3), with margins that broadcast
    against the leading shape. Returns, for each step, True if the KF
    violates motion (any check fails): a bool for (3,) steps, else a bool
    array.

    Quirk preserved: all three per-plane limits use the *xy* tracking angle
    (reference :2902 uses tracking_xy_degree for xy, yz and zx).

    Each step tested counts as one ``mc_steps`` (``utils/trace``)."""
    trace.count("mc_steps", int(np.prod(np.shape(step_post)[:-1])))
    deg = _angle_deg(step_post, prev_step_post)
    tdeg = _angle_deg(step_pre, prev_step_pre)
    fail_dir = np.abs(deg - tdeg) > (
        np.minimum(tdeg * _F32(params.dir3d_track_mult), _F32(params.dir3d_cap_deg))
        * degree_margin)

    eps = _F32(1e-12)
    mr = _length(step_post) / np.maximum(_length(prev_step_post), eps)
    tmr = _length(step_pre) / np.maximum(_length(prev_step_pre), eps)
    rfac = _F32(params.ratio_mult) * movement_margin
    fail_ratio = ((mr / np.maximum(tmr, eps)) > rfac) | ((tmr / np.maximum(mr, eps)) > rfac)

    planes = ((0, 1), (1, 2), (2, 0))
    post = [_plane_angle_deg(step_post, prev_step_post, i, j) for i, j in planes]
    pre = [_plane_angle_deg(step_pre, prev_step_pre, i, j) for i, j in planes]
    lim_pl = (np.minimum(pre[0] * _F32(params.plane_track_mult), _F32(params.plane_cap_deg))
              * degree_margin)
    fail = fail_dir | fail_ratio
    for a, b in zip(post, pre):
        fail = fail | (np.abs(a - b) > lim_pl)
    return bool(fail) if np.ndim(fail) == 0 else fail


def _run_before(flag: np.ndarray) -> np.ndarray:
    """For each slot, the length of the run of True in ``flag`` that ends
    just before it (0 where ``flag`` is False one slot before)."""
    at = np.arange(flag.shape[0])
    last_false = np.maximum.accumulate(np.where(flag, -1, at))
    run = np.zeros(flag.shape[0], np.int64)
    run[1:] = (at - last_false)[:-1]
    return run


def _relaxed_margins(run: np.ndarray, params: MotionCheckParams) -> np.ndarray:
    """The reverse pass's margin after ``run`` relaxations from 1: each one
    ``min(m * margin_relax, margin_cap)`` in float32, as the reference
    updates it a KF at a time (:3716-3729)."""
    relax, cap = _F32(params.margin_relax), _F32(params.margin_cap)
    table = [_F32(1.0)]
    while len(table) <= run.max(initial=0):
        m = np.minimum(table[-1] * relax, cap)
        if m == table[-1]:           # a fixed point: every later entry equals it
            break
        table.append(m)
    return np.asarray(table, _F32)[np.minimum(run, len(table) - 1)]


def motion_check_pass(pos_post: np.ndarray, pos_pre: np.ndarray, valid: np.ndarray,
                      doubt0: np.ndarray, params: MotionCheckParams, reverse: bool):
    """One CorrectKF_V3 pass over a time-ordered (or reversed) sequence, on
    the host.

    pos_post/pos_pre: (N, 3) float32; valid: (N,) live slots in scan
    order; doubt0: (N,) doubt at pass start (doubted KFs are skipped
    entirely, reference :3698-3703). Returns (doubt (N,) i32, n_failures).

    The reference walks the KFs one at a time, but nothing a step decides
    feeds a later step of the pass: which KFs become anchors and the
    reverse pass's margins read only ``valid`` and ``doubt0``. So every
    step's two anchors (the last two processed KFs before it, slot 0 until
    there are two) and its margin are worked out first, and all steps are
    tested in one ``motion_violates`` call.
    """
    n_valid = int(valid.sum())
    rank = np.cumsum(valid.astype(np.int64))      # 1-based KF_check_count
    in_window = (rank > params.skip_edge_kfs) & (rank < n_valid - params.skip_edge_kfs)
    thres = params.violate_doubt_thres
    # anchors advance on every processed KF, edge KFs included (:3752-3778)
    process = valid & ~(in_window & (doubt0 >= thres))
    anchors = np.concatenate([np.zeros(2, np.int64), np.flatnonzero(process)])
    before = np.cumsum(process) - process         # processed KFs before each slot
    last, last2 = anchors[before + 1], anchors[before]
    tested = process & in_window & (before >= 2)
    if reverse:
        # margin relaxation when recent anchors carry doubt, else reset
        # (:3716-3729), updated after every slot and read by the next
        doubted = (doubt0[last] >= thres) | (doubt0[last2] >= thres)
        margin = _relaxed_margins(_run_before(doubted), params)[tested]
    else:
        margin = _F32(1.0)
    k = np.flatnonzero(tested)
    lk, l2k = last[k], last2[k]
    fail = motion_violates(
        pos_post[k] - pos_post[lk], pos_post[lk] - pos_post[l2k],
        pos_pre[k] - pos_pre[lk], pos_pre[lk] - pos_pre[l2k],
        margin, margin, params)
    doubt = doubt0.astype(np.int32).copy()
    np.add.at(doubt, k[fail], 1)
    np.add.at(doubt, lk[fail], 1)      # one anchor may take doubt from two steps
    return doubt, int(fail.sum())


class MotionCheckVerdict(NamedTuple):
    revert: bool             # roll the whole map back
    violate: np.ndarray      # (N,) bool in scan order
    doubt: np.ndarray        # (N,) i32
    longest_run: int
    n_rev_failures: int      # failures during the reverse pass


def run_motion_check(pos_post, pos_pre, valid, params: MotionCheckParams
                     ) -> MotionCheckVerdict:
    """Forward + reverse CorrectKF_V3 passes + verdict over one client's
    time-ordered KF sequence. Inputs are (N, 3), (N, 3), (N,) arrays or
    tensors; they are read once to the host. What follows the reads is span
    ``mc_passes`` (``utils/trace``)."""
    pos_post = _host(pos_post).astype(_F32)
    pos_pre = _host(pos_pre).astype(_F32)
    valid = _host(valid).astype(bool)
    with trace.span("mc_passes"):
        doubt_f, _ = motion_check_pass(pos_post, pos_pre, valid,
                                       np.zeros(pos_post.shape[0], np.int32),
                                       params, reverse=False)
        doubt_r, nfail_rev = motion_check_pass(pos_post[::-1], pos_pre[::-1], valid[::-1],
                                               doubt_f[::-1], params, reverse=True)
        doubt = doubt_r[::-1].copy()
        violate = valid & (doubt >= params.violate_doubt_thres)
        # longest consecutive violating run (CheckMVKF :3932)
        longest = int(_run_before(np.append(violate, False)).max())
        # revert if long run OR >= 10% of KFs failed the reverse pass
        # (reference :3805: badKF_counter >= foundKFs.size()/10)
        revert = (longest >= params.revert_run_thres) or (
            _F32(nfail_rev) >= _F32(params.revert_frac_thres) * _F32(valid.sum()))
    return MotionCheckVerdict(revert=bool(revert), violate=violate, doubt=doubt,
                              longest_run=longest, n_rev_failures=nfail_rev)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        trace.count("host_syncs")
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Map-level integration
# ---------------------------------------------------------------------------

def snapshot_pre_gba(kf: ms.KFBlock, T_SC_inv: torch.Tensor) -> ms.KFBlock:
    """SetTcwCurrent (reference src/Map.cpp:4027): record pre-GBA poses and
    body positions for every valid KF (new tensors; the block passed in is
    unchanged)."""
    tws = body_positions(kf.Tcw, T_SC_inv)
    return kf._replace(
        Tcw_pre_gba=torch.where(kf.valid[:, None, None], kf.Tcw, kf.Tcw_pre_gba),
        tracking_tws=torch.where(kf.valid[:, None], tws, kf.tracking_tws),
    )


def check_after_gba(kf: ms.KFBlock, T_SC_inv: torch.Tensor, params: MotionCheckParams,
                    client_id=None):
    """Run the double-pass check on the current (post-GBA) poses vs the
    snapshot. Returns (verdict, order) where order maps scan position ->
    KF slot."""
    ts = kf.timestamp.cpu().numpy()
    valid = kf.valid.cpu().numpy()
    trace.count("host_syncs", 2)
    if client_id is not None:
        valid = valid & (kf.client_id.cpu().numpy() == client_id)
        trace.count("host_syncs")
    order = np.argsort(np.where(valid, ts, np.inf), kind="stable")
    order_t = torch.from_numpy(order).to(kf.Tcw.device)
    trace.count("host_syncs")        # an upload from pageable memory
    pos_post = body_positions(kf.Tcw, T_SC_inv)[order_t]
    pos_pre = kf.tracking_tws[order_t]
    verdict = run_motion_check(pos_post, pos_pre, valid[order], params)
    return verdict, order


def apply_verdict(kf: ms.KFBlock, mp: ms.MPBlock, verdict: MotionCheckVerdict,
                  order: np.ndarray) -> Tuple[ms.KFBlock, ms.MPBlock, bool]:
    """Apply the Motion Check verdict (reference CorrectKF_V3 :3807-3820):

    - revert: every KF pose resets to the pre-GBA snapshot (``SetPose(
      Tcw_current)``); the GBA driver restores its own landmark snapshot;
    - else: violating KFs are deleted (``DeleteMotionViolateKF`` :3920) and
      their observations dropped; landmarks left with no observations die.
    Returns (kf, mp, reverted).
    """
    if verdict.revert:
        kf2 = kf._replace(Tcw=torch.where(kf.valid[:, None, None], kf.Tcw_pre_gba, kf.Tcw))
        return kf2, mp, True
    dev = kf.valid.device
    violate_slots = torch.zeros(kf.valid.shape[0], dtype=torch.bool, device=dev)
    violate_slots[torch.from_numpy(np.asarray(order)).to(dev)] = \
        torch.from_numpy(np.asarray(verdict.violate, bool)).to(dev)
    trace.count("host_syncs", 2)
    new_valid = kf.valid & ~violate_slots
    kf2 = kf._replace(
        valid=new_valid,
        mp_idx=torch.where(new_valid[:, None], kf.mp_idx, ms.INVALID),
        feat_valid=kf.feat_valid & new_valid[:, None],
    )
    n_obs = ms.mp_observation_counts(kf2, mp.valid.shape[0])
    # two boolean-mask indexings, unique's size, bincount's min and max
    trace.count("host_syncs", 5)
    mp2 = mp._replace(valid=mp.valid & (n_obs > 0))
    return kf2, mp2, False
