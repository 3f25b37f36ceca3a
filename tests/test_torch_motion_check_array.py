"""Motion Check's passes as array operations (models/motion_check.py) held
bitwise to the per-step loop they replaced.

``_loop_pass`` and ``_loop_violates`` are the port's former
``motion_check_pass`` and ``motion_violates``, kept here as the oracle: a
Python loop over the KFs that tests one (3,) step a call. The array pass
must give the same doubts, the same failure count and the same number of
steps tested (the ``mc_steps`` counter against the oracle's calls), not
close ones: the verdict is exact, and the benchmark's plain Motion Check
is this loop. Both passes are checked, the reverse one fed the forward
doubts, on random 512-KF clients with invalid slots, corrupted runs of
1-60 KFs and offsets from 0.1 mm to a metre; the reverse pass also on
drawn doubts, which relax its margin (its own forward doubts never do);
and on three edge cases: too few KFs for more than one step, no live KF,
and doubted anchors that take the reverse margin to its cap.
tests/test_torch_motion_check.py holds the array pass to the oracle on
its recorded scenes too.

This module imports no JAX.
"""
import numpy as np
import pytest

from motioncheck_ccm_slam_tpu_torch.config import MotionCheckParams
from motioncheck_ccm_slam_tpu_torch.models import motion_check as tmc
from motioncheck_ccm_slam_tpu_torch.utils import trace

import torch_one_thread  # noqa: F401 (torch on one thread)

_F32 = np.float32
P = MotionCheckParams()


def _loop_violates(step_post, prev_step_post, step_pre, prev_step_pre,
                   degree_margin, movement_margin, params):
    deg = tmc._angle_deg(step_post, prev_step_post)
    tdeg = tmc._angle_deg(step_pre, prev_step_pre)
    fail_dir = np.abs(deg - tdeg) > (
        np.minimum(tdeg * _F32(params.dir3d_track_mult), _F32(params.dir3d_cap_deg))
        * degree_margin)
    eps = _F32(1e-12)
    mr = np.linalg.norm(step_post) / np.maximum(np.linalg.norm(prev_step_post), eps)
    tmr = np.linalg.norm(step_pre) / np.maximum(np.linalg.norm(prev_step_pre), eps)
    rfac = _F32(params.ratio_mult) * movement_margin
    fail_ratio = ((mr / np.maximum(tmr, eps)) > rfac) | ((tmr / np.maximum(mr, eps)) > rfac)
    planes = ((0, 1), (1, 2), (2, 0))
    post = [tmc._angle_deg(step_post[[i, j]], prev_step_post[[i, j]]) for i, j in planes]
    pre = [tmc._angle_deg(step_pre[[i, j]], prev_step_pre[[i, j]]) for i, j in planes]
    lim_pl = (np.minimum(pre[0] * _F32(params.plane_track_mult), _F32(params.plane_cap_deg))
              * degree_margin)
    fail_plane = any(np.abs(a - b) > lim_pl for a, b in zip(post, pre))
    return bool(fail_dir | fail_ratio | fail_plane)


def _loop_pass(pos_post, pos_pre, valid, doubt0, params, reverse):
    """Returns (doubt, n_failures, steps tested, the largest margin a step
    was tested at)."""
    n_valid = int(valid.sum())
    rank = np.cumsum(valid.astype(np.int64))
    in_window = (rank > params.skip_edge_kfs) & (rank < n_valid - params.skip_edge_kfs)
    thres = params.violate_doubt_thres
    one, relax_f, cap = _F32(1.0), _F32(params.margin_relax), _F32(params.margin_cap)
    last = last2 = nanchors = 0
    deg_m = mov_m = one
    doubt = doubt0.astype(np.int32).copy()
    nfail = steps = 0
    top_margin = one
    for k in range(pos_post.shape[0]):
        act = bool(valid[k])
        skipped = act and bool(in_window[k]) and doubt0[k] >= thres
        process = act and not skipped
        if process and in_window[k] and nanchors >= 2:
            steps += 1
            top_margin = max(top_margin, deg_m)
            fail = _loop_violates(
                pos_post[k] - pos_post[last], pos_post[last] - pos_post[last2],
                pos_pre[k] - pos_pre[last], pos_pre[last] - pos_pre[last2],
                deg_m, mov_m, params)
            if fail:
                doubt[k] += 1
                doubt[last] += 1
                nfail += 1
        if reverse:
            if doubt0[last] >= thres or doubt0[last2] >= thres:
                deg_m = np.minimum(deg_m * relax_f, cap)
                mov_m = np.minimum(mov_m * relax_f, cap)
            else:
                deg_m = mov_m = one
        if process:
            last2, last = last, k
            nanchors = min(nanchors + 1, 2)
    return doubt, nfail, steps, top_margin


def _loop_longest_run(violate):
    longest = cur = 0
    for v in violate:
        cur = cur + 1 if v else 0
        longest = max(longest, cur)
    return longest


def _array_pass(post, pre, valid, doubt0, params, reverse):
    before = trace.counts.mc_steps
    doubt, nfail = tmc.motion_check_pass(post, pre, valid, doubt0, params, reverse)
    return doubt, nfail, trace.counts.mc_steps - before


def assert_passes_equal_the_loop(post, pre, valid, params=P):
    """Both passes, and the verdict built on them, bitwise against the
    oracle. Returns the oracle's reverse pass (doubt, n_failures, steps,
    largest margin)."""
    zeros = np.zeros(post.shape[0], np.int32)
    fwd = _loop_pass(post, pre, valid, zeros, params, False)
    doubt, nfail, steps = _array_pass(post, pre, valid, zeros, params, False)
    np.testing.assert_array_equal(doubt, fwd[0])
    assert doubt.dtype == np.int32 and (nfail, steps) == fwd[1:3]
    rev_in = (post[::-1], pre[::-1], valid[::-1], fwd[0][::-1], params, True)
    rev = _loop_pass(*rev_in)
    doubt, nfail, steps = _array_pass(*rev_in)
    np.testing.assert_array_equal(doubt, rev[0])
    assert doubt.dtype == np.int32 and (nfail, steps) == rev[1:3]
    verdict = tmc.run_motion_check(post, pre, valid, params)
    np.testing.assert_array_equal(verdict.doubt, rev[0][::-1])
    assert verdict.n_rev_failures == rev[1]
    assert verdict.longest_run == _loop_longest_run(verdict.violate)
    return rev


def _client(seed, n=512):
    """(post, pre, valid) of one client: a smooth tracked path with 1 cm
    of jitter, the GBA's result off it by 0.1 mm to 3 cm everywhere, 0-4
    runs of 1-60 KFs moved by 1 cm to 1 m, and 0-30% of slots invalid."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    pre = np.stack([5.0 * np.cos(0.05 * t), 4.0 * np.sin(0.07 * t),
                    0.3 * np.sin(0.03 * t)], -1) * rng.uniform(0.2, 3.0)
    pre += rng.normal(0, 0.01, pre.shape)
    post = pre + rng.normal(0, 10.0 ** rng.uniform(-4, -1.5), pre.shape)
    for _ in range(rng.integers(0, 5)):
        a, length = rng.integers(0, n), rng.integers(1, 61)
        run = post[a:a + length]
        run += rng.normal(0, 10.0 ** rng.uniform(-2, 0), run.shape)
    valid = rng.uniform(size=n) >= rng.uniform(0, 0.3)
    return post.astype(np.float32), pre.astype(np.float32), valid


@pytest.mark.parametrize("seed", range(48))
def test_array_pass_equals_the_loop_on_random_clients(seed):
    assert_passes_equal_the_loop(*_client(seed))


@pytest.mark.parametrize("n_valid", [2 * P.skip_edge_kfs + 1, 2 * P.skip_edge_kfs + 2])
def test_too_few_kfs(n_valid):
    """KFs within ``skip_edge_kfs`` of either end are never tested, so 21
    live KFs give no step and 22 give one."""
    post, pre, valid = _client(3, n=64)
    valid[:] = False
    valid[5:5 + n_valid] = True
    assert_passes_equal_the_loop(post, pre, valid)
    zeros = np.zeros(64, np.int32)
    assert _array_pass(post, pre, valid, zeros, P, False)[2] == n_valid - 2 * P.skip_edge_kfs - 1


def test_no_live_kf():
    post, pre, valid = _client(4, n=64)
    rev = assert_passes_equal_the_loop(post, pre, np.zeros(64, bool))
    assert rev[1:3] == (0, 0)


def _reverse_against_the_loop(post, pre, valid, doubt0):
    """The reverse pass fed ``doubt0`` against the oracle; returns the
    largest margin a step was tested at."""
    args = (post[::-1], pre[::-1], valid[::-1], doubt0[::-1], P, True)
    want = _loop_pass(*args)
    doubt, nfail, steps = _array_pass(*args)
    np.testing.assert_array_equal(doubt, want[0])
    assert (nfail, steps) == want[1:3] and steps > 0
    return want[3]


def test_doubted_anchors_cap_the_reverse_margin():
    """The reverse pass relaxes its margin on every slot after an anchor
    with doubt, invalid slots included. Anchors are processed KFs, and a
    doubted one is an edge KF, since doubted KFs inside the window are
    skipped; the forward pass gives at most one doubt to an edge KF, so fed
    its own forward doubts the reverse pass tests every step at margin 1.
    Fed here: the ten newest KFs (the reverse scan's first edge KFs) at the
    doubt threshold, then six invalid slots, so the first steps in the
    window are tested at ``margin_cap``."""
    post, pre, valid = _client(5)
    valid[:] = True
    valid[-17:-11] = False
    doubt0 = np.zeros(512, np.int32)
    doubt0[-P.skip_edge_kfs:] = P.violate_doubt_thres
    post[-40:-17] += np.random.default_rng(0).normal(0, 0.05, (23, 3)).astype(np.float32)
    assert _reverse_against_the_loop(post, pre, valid, doubt0) == _F32(P.margin_cap)


@pytest.mark.parametrize("seed", range(12))
def test_reverse_pass_equals_the_loop_on_drawn_doubts(seed):
    """The reverse pass fed doubts drawn at random, most of them on the
    edge KFs, where they relax the margin of the steps that follow."""
    post, pre, valid = _client(100 + seed)
    rng = np.random.default_rng(seed)
    doubt0 = np.where(rng.uniform(size=512) < 0.1, rng.integers(0, 4, 512), 0).astype(np.int32)
    live = np.flatnonzero(valid)
    edges = np.concatenate([live[:P.skip_edge_kfs], live[-P.skip_edge_kfs:]])
    doubt0[edges] = rng.integers(0, 4, edges.shape[0])
    _reverse_against_the_loop(post, pre, valid, doubt0)
