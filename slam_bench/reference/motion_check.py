"""Motion Check's verdict worked out again: the reference for the server
cells' Motion Check.

A frozen copy of the fork's CorrectKF_V3 arithmetic (reference
src/Map.cpp:2853-2909 and :3647-3840) as the port states it: per client,
the keyframes in time order, each one's body-frame step against the step
to the previous anchor before and after the GBA; the 3D direction, step
ratio and per-plane tests (the per-plane limits all use the xy tracking
angle, a reference quirk kept); a forward pass, then a reverse pass that
relaxes its margins beside doubted anchors; violators at doubt >= 2; a
revert when the longest run of violators reaches 5 or when the reverse
pass failed at >= 10% of the client's keyframes, else the violators are
deleted. It imports nothing of the port.

The body positions are (Tcw^-1 T_SC^-1)[:3, 3], computed with the same
tensor operations as the port, so that a keyframe at a threshold is
judged on the same float32 numbers. ``dtype`` is the precision of the
positions and of every test: float32 for the reference, bfloat16 for the
precision control.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Verdict(NamedTuple):
    revert: bool
    deleted: np.ndarray   # slots deleted (by the clients judged before a revert)


def body_positions(Tcw: torch.Tensor, T_SC_inv: torch.Tensor) -> torch.Tensor:
    """(N, 3) body positions of (N, 4, 4) world-to-camera poses."""
    R, t = Tcw[..., :3, :3], Tcw[..., :3, 3]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, (-torch.einsum("...ij,...j->...i", Rt, t))[..., None]], -1)
    bottom = torch.zeros(Tcw.shape[:-2] + (1, 4), dtype=Tcw.dtype, device=Tcw.device)
    bottom[..., 0, 3] = 1.0
    Twc = torch.cat([top, bottom], -2)
    return (Twc @ T_SC_inv)[..., :3, 3]


def _angle(a, b, f):
    na = np.linalg.norm(a, axis=-1)
    nb = np.linalg.norm(b, axis=-1)
    cos = np.sum(a * b, -1) / np.maximum(na * nb, f(1e-12))
    return np.arccos(np.clip(cos, f(-1.0), f(1.0))) * f(180.0 / 3.14)


def violates(post, prev_post, pre, prev_pre, deg_m, mov_m, prm: dict, f) -> bool:
    deg, tdeg = _angle(post, prev_post, f), _angle(pre, prev_pre, f)
    fail_dir = np.abs(deg - tdeg) > (
        np.minimum(tdeg * f(prm["dir3d_track_mult"]), f(prm["dir3d_cap_deg"])) * deg_m)
    eps = f(1e-12)
    mr = np.linalg.norm(post) / np.maximum(np.linalg.norm(prev_post), eps)
    tmr = np.linalg.norm(pre) / np.maximum(np.linalg.norm(prev_pre), eps)
    rfac = f(prm["ratio_mult"]) * mov_m
    fail_ratio = ((mr / np.maximum(tmr, eps)) > rfac) | ((tmr / np.maximum(mr, eps)) > rfac)
    planes = ((0, 1), (1, 2), (2, 0))
    a_post = [_angle(post[[i, j]], prev_post[[i, j]], f) for i, j in planes]
    a_pre = [_angle(pre[[i, j]], prev_pre[[i, j]], f) for i, j in planes]
    lim = np.minimum(a_pre[0] * f(prm["plane_track_mult"]), f(prm["plane_cap_deg"])) * deg_m
    fail_plane = any(np.abs(x - y) > lim for x, y in zip(a_post, a_pre))
    return bool(fail_dir | fail_ratio | fail_plane)


def one_pass(post, pre, valid, doubt0, prm: dict, reverse: bool, f):
    n_valid = int(valid.sum())
    rank = np.cumsum(valid.astype(np.int64))
    in_window = (rank > prm["skip_edge_kfs"]) & (rank < n_valid - prm["skip_edge_kfs"])
    thres = prm["violate_doubt_thres"]
    one, relax, cap = f(1.0), f(prm["margin_relax"]), f(prm["margin_cap"])
    last = last2 = nanchors = 0
    deg_m = mov_m = one
    doubt = doubt0.astype(np.int32).copy()
    nfail = 0
    for k in range(post.shape[0]):
        act = bool(valid[k])
        skipped = act and bool(in_window[k]) and doubt0[k] >= thres
        process = act and not skipped
        if process and in_window[k] and nanchors >= 2:
            if violates(post[k] - post[last], post[last] - post[last2],
                        pre[k] - pre[last], pre[last] - pre[last2], deg_m, mov_m, prm, f):
                doubt[k] += 1
                doubt[last] += 1
                nfail += 1
        if reverse:
            if doubt0[last] >= thres or doubt0[last2] >= thres:
                deg_m = np.minimum(deg_m * relax, cap)
                mov_m = np.minimum(mov_m * relax, cap)
            else:
                deg_m = mov_m = one
        if process:
            last2, last = last, k
            nanchors = min(nanchors + 1, 2)
    return doubt, nfail


def client_verdict(post, pre, valid, prm: dict, f):
    """(revert, violate mask in scan order) of one client's sequence."""
    doubt_f, _ = one_pass(post, pre, valid, np.zeros(post.shape[0], np.int32), prm, False, f)
    doubt_r, nfail_rev = one_pass(post[::-1], pre[::-1], valid[::-1], doubt_f[::-1], prm,
                                  True, f)
    violate = valid & (doubt_r[::-1] >= prm["violate_doubt_thres"])
    longest = cur = 0
    for v in violate:
        cur = cur + 1 if v else 0
        longest = max(longest, cur)
    revert = (longest >= prm["revert_run_thres"]) or (
        f(nfail_rev) >= f(prm["revert_frac_thres"]) * f(valid.sum()))
    return bool(revert), violate


def verdict(Tcw_pre, Tcw_post, valid, client_id, timestamp, T_SC, prm: dict,
            dtype=torch.float32) -> Verdict:
    """The map's verdict: clients in ascending id, each client's violators
    deleted, until one reverts the GBA (the deletions before it stand)."""
    dev = Tcw_pre.device
    T_SC_inv = torch.from_numpy(np.linalg.inv(np.asarray(T_SC, np.float32))
                                .astype(np.float32)).to(dev)
    f = np.float32
    pos_pre = body_positions(Tcw_pre.to(dtype), T_SC_inv.to(dtype)).float().cpu().numpy()
    pos_post = body_positions(Tcw_post.to(dtype), T_SC_inv.to(dtype)).float().cpu().numpy()
    valid = np.asarray(valid, bool)
    client_id = np.asarray(client_id)
    ts = np.asarray(timestamp)
    deleted = []
    for cid in np.unique(client_id[valid]):
        if cid < 0:
            continue
        mine = valid & (client_id == cid)
        order = np.argsort(np.where(mine, ts, np.inf), kind="stable")
        revert, violate = client_verdict(pos_post[order], pos_pre[order], mine[order], prm, f)
        if revert:
            break
        deleted.append(order[violate])
    else:
        revert = False
    return Verdict(bool(revert), np.sort(np.concatenate(deleted)) if deleted
                   else np.zeros(0, np.int64))
