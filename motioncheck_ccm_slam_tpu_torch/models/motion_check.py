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
the longest-violating-run count are Python loops over one host copy of a
client's (N, 3) pre- and post-GBA body positions (N <= 2048 keyframes),
with the per-KF test (``motion_violates``) in float32 numpy. The body
positions, the pre-GBA snapshot and the verdict's application stay on the
map's device.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import MotionCheckParams
from ..ops import lie
from . import map_state as ms

_F32 = np.float32


def body_positions(Tcw: torch.Tensor, T_SC_inv: torch.Tensor) -> torch.Tensor:
    """Tws translation per KF: (Tcw^-1 . T_SC^-1)[0:3, 3] (reference
    ComputeTws src/Map.cpp:3632 / SetTcwCurrent :4027)."""
    Tws = lie.inv_T(Tcw) @ T_SC_inv
    return Tws[..., :3, 3]


def _angle_deg(a: np.ndarray, b: np.ndarray) -> _F32:
    """Angle (deg) between vectors; the reference uses 180/3.14 (not pi) —
    reproduced for parity (src/Map.cpp:2878)."""
    na = np.linalg.norm(a, axis=-1)
    nb = np.linalg.norm(b, axis=-1)
    cos = np.sum(a * b, -1) / np.maximum(na * nb, _F32(1e-12))
    return np.arccos(np.clip(cos, _F32(-1.0), _F32(1.0))) * _F32(180.0 / 3.14)


def _plane_angle_deg(a, b, i: int, j: int):
    return _angle_deg(a[[i, j]], b[[i, j]])


def motion_violates(step_post, prev_step_post, step_pre, prev_step_pre,
                    degree_margin, movement_margin,
                    params: MotionCheckParams) -> bool:
    """The three checks of reference Map::MotionCheck (:2894-2907) on (3,)
    float32 step vectors. Returns True if the KF violates motion (any check
    fails).

    Quirk preserved: all three per-plane limits use the *xy* tracking angle
    (reference :2902 uses tracking_xy_degree for xy, yz and zx)."""
    deg = _angle_deg(step_post, prev_step_post)
    tdeg = _angle_deg(step_pre, prev_step_pre)
    fail_dir = np.abs(deg - tdeg) > (
        np.minimum(tdeg * _F32(params.dir3d_track_mult), _F32(params.dir3d_cap_deg))
        * degree_margin)

    eps = _F32(1e-12)
    mr = np.linalg.norm(step_post) / np.maximum(np.linalg.norm(prev_step_post), eps)
    tmr = np.linalg.norm(step_pre) / np.maximum(np.linalg.norm(prev_step_pre), eps)
    rfac = _F32(params.ratio_mult) * movement_margin
    fail_ratio = ((mr / np.maximum(tmr, eps)) > rfac) | ((tmr / np.maximum(mr, eps)) > rfac)

    planes = ((0, 1), (1, 2), (2, 0))
    post = [_plane_angle_deg(step_post, prev_step_post, i, j) for i, j in planes]
    pre = [_plane_angle_deg(step_pre, prev_step_pre, i, j) for i, j in planes]
    lim_pl = (np.minimum(pre[0] * _F32(params.plane_track_mult), _F32(params.plane_cap_deg))
              * degree_margin)
    fail_plane = any(np.abs(a - b) > lim_pl for a, b in zip(post, pre))
    return bool(fail_dir | fail_ratio | fail_plane)


def motion_check_pass(pos_post: np.ndarray, pos_pre: np.ndarray, valid: np.ndarray,
                      doubt0: np.ndarray, params: MotionCheckParams, reverse: bool):
    """One CorrectKF_V3 pass over a time-ordered (or reversed) sequence, on
    the host.

    pos_post/pos_pre: (N, 3) float32; valid: (N,) live slots in scan
    order; doubt0: (N,) doubt at pass start (doubted KFs are skipped
    entirely, reference :3698-3703). Returns (doubt (N,) i32, n_failures).
    """
    n_valid = int(valid.sum())
    rank = np.cumsum(valid.astype(np.int64))      # 1-based KF_check_count
    in_window = (rank > params.skip_edge_kfs) & (rank < n_valid - params.skip_edge_kfs)
    thres = params.violate_doubt_thres
    one, relax_f, cap = _F32(1.0), _F32(params.margin_relax), _F32(params.margin_cap)
    last = last2 = nanchors = 0
    deg_m = mov_m = one
    doubt = doubt0.astype(np.int32).copy()
    nfail = 0
    for k in range(pos_post.shape[0]):
        act = bool(valid[k])
        skipped = act and bool(in_window[k]) and doubt0[k] >= thres
        process = act and not skipped
        if process and in_window[k] and nanchors >= 2:
            fail = motion_violates(
                pos_post[k] - pos_post[last], pos_post[last] - pos_post[last2],
                pos_pre[k] - pos_pre[last], pos_pre[last] - pos_pre[last2],
                deg_m, mov_m, params)
            if fail:
                doubt[k] += 1
                doubt[last] += 1        # nanchors >= 2 here
                nfail += 1
        # margin update for the NEXT iteration (reference :3716-3729):
        # the reverse pass relaxes when recent anchors carry doubt; else reset
        if reverse:
            if doubt0[last] >= thres or doubt0[last2] >= thres:
                deg_m = np.minimum(deg_m * relax_f, cap)
                mov_m = np.minimum(mov_m * relax_f, cap)
            else:
                deg_m = mov_m = one
        # anchor update for every processed KF (edge KFs included, :3752-3778)
        if process:
            last2, last = last, k
            nanchors = min(nanchors + 1, 2)
    return doubt, nfail


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
    tensors; they are read once to the host."""
    pos_post = _host(pos_post).astype(_F32)
    pos_pre = _host(pos_pre).astype(_F32)
    valid = _host(valid).astype(bool)
    doubt_f, _ = motion_check_pass(pos_post, pos_pre, valid,
                                   np.zeros(pos_post.shape[0], np.int32),
                                   params, reverse=False)
    doubt_r, nfail_rev = motion_check_pass(pos_post[::-1], pos_pre[::-1], valid[::-1],
                                           doubt_f[::-1], params, reverse=True)
    doubt = doubt_r[::-1].copy()
    violate = valid & (doubt >= params.violate_doubt_thres)
    # longest consecutive violating run (CheckMVKF :3932)
    longest = cur = 0
    for v in violate:
        cur = cur + 1 if v else 0
        longest = max(longest, cur)
    # revert if long run OR >= 10% of KFs failed the reverse pass (reference
    # :3805: badKF_counter >= foundKFs.size()/10)
    revert = (longest >= params.revert_run_thres) or (
        _F32(nfail_rev) >= _F32(params.revert_frac_thres) * _F32(valid.sum()))
    return MotionCheckVerdict(revert=bool(revert), violate=violate, doubt=doubt,
                              longest_run=longest, n_rev_failures=nfail_rev)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
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
    if client_id is not None:
        valid = valid & (kf.client_id.cpu().numpy() == client_id)
    order = np.argsort(np.where(valid, ts, np.inf), kind="stable")
    order_t = torch.from_numpy(order).to(kf.Tcw.device)
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
    new_valid = kf.valid & ~violate_slots
    kf2 = kf._replace(
        valid=new_valid,
        mp_idx=torch.where(new_valid[:, None], kf.mp_idx, ms.INVALID),
        feat_valid=kf.feat_valid & new_valid[:, None],
    )
    n_obs = ms.mp_observation_counts(kf2, mp.valid.shape[0])
    mp2 = mp._replace(valid=mp.valid & (n_obs > 0))
    return kf2, mp2, False
