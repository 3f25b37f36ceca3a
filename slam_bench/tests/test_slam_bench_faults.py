"""A run with the timed path broken underneath comes out not correct, and
the precision control fails the comparison.

Each fault test drives a small CPU run of a cell (everything but the look
for a card) with one fault planted in the port, of the kinds a cell can
have: a step that returns its state unchanged, half of a batch left out
(the tracker's matches), and an answer altered where it is produced. (The
cells take no mean over a batch and exchange nothing between chips, so
that fault has no place here.) The control test runs the plain reference
in bfloat16 in the program's place."""
import pytest
import torch

import bench_cells


def _numbers(out):
    return {c["name"]: (c["value"], c["limit"]) for c in out["checks"]}


def _failed(out):
    return [n for n, (v, lim) in _numbers(out).items() if v > lim]


def test_gba_state_unchanged(monkeypatch):
    from motioncheck_ccm_slam_tpu_torch.models import gba
    from motioncheck_ccm_slam_tpu_torch.solvers.local_ba import BAResult

    def unchanged(C, L, pcg_iters=25, device=None):
        def solver(Tcw, Xw, obs, K, fixed_cam, fixed_lm, n_iterations=None):
            return BAResult(Tcw=Tcw, Xw=Xw, obs_inlier=obs.valid, cost=torch.tensor(0.0))
        return solver

    monkeypatch.setattr(gba, "_pick_solver", unchanged)
    out = bench_cells.run("euroc-server-gba", 2.0, monkeypatch)
    assert out["correct"] is False and "gba_cost_gap" in _failed(out)


def test_gba_writeback_altered(monkeypatch):
    from motioncheck_ccm_slam_tpu_torch.models import gba

    finalize = gba.GBAJob.finalize

    def altered(job):
        res = finalize(job)
        slot = int(torch.nonzero(job.m.kf.valid)[-1])
        Tcw = job.m.kf.Tcw.clone()
        Tcw[slot, 0, 3] += 1e-3
        job.m.kf = job.m.kf._replace(Tcw=Tcw)
        return res

    monkeypatch.setattr(gba.GBAJob, "finalize", altered)
    out = bench_cells.run("euroc-server-gba", 2.0, monkeypatch)
    assert out["correct"] is False and "writeback_max_abs" in _failed(out)


def test_motion_check_verdict_altered(monkeypatch):
    from motioncheck_ccm_slam_tpu_torch.models import motion_check

    monkeypatch.setattr(motion_check, "apply_verdict", lambda kf, mp, verdict, order: (kf, mp, False))
    out = bench_cells.run("euroc-server-gba-revert", 2.0, monkeypatch)
    assert out["correct"] is False and "mc_verdict_diff" in _failed(out)


def test_local_ba_state_unchanged(monkeypatch):
    from motioncheck_ccm_slam_tpu_torch.solvers import local_ba

    def unchanged(Tcw0, Xw0, obs, K, fixed_cam, **kw):
        return local_ba.BAResult(Tcw=Tcw0, Xw=Xw0, obs_inlier=obs.valid, cost=torch.tensor(0.0))

    monkeypatch.setattr(local_ba, "bundle_adjust", unchanged)
    out = bench_cells.run("euroc-agent-corridor", 15.0, monkeypatch, frames=70)
    assert out["correct"] is False
    assert "local_ba_cost_gap" in _failed(out) or not out["checked"]


def test_tracking_pose_altered(monkeypatch):
    from motioncheck_ccm_slam_tpu_torch.models import tracking

    track = tracking._track_two_pass

    def altered(*a, **kw):
        Tcw, assoc, n_inl, vis, found = track(*a, **kw)
        Tcw = Tcw.clone()
        Tcw[0, 3] += 0.01
        return Tcw, assoc, n_inl, vis, found

    monkeypatch.setattr(tracking, "_track_two_pass", altered)
    out = bench_cells.run("euroc-agent-corridor", 15.0, monkeypatch, frames=70)
    assert out["correct"] is False
    assert "pose_cost_gap_p50" in _failed(out) or not out["checked"]


def test_tracking_matches_halved(monkeypatch):
    from slam_bench import faults

    with faults.halve_matches():
        out = bench_cells.run("euroc-agent-corridor", 10.0, monkeypatch, frames=70)
    assert out["correct"] is False
    assert "track_match_miss" in _failed(out) or not out["checked"]


def test_orb_descriptors_altered(monkeypatch):
    from motioncheck_ccm_slam_tpu_torch.ops import orb

    extract = orb.extract_orb

    def altered(img, params):
        f = extract(img, params)
        return f._replace(desc=f.desc ^ torch.tensor([-1, 0, 0, 0, 0, 0, 0, 0], dtype=torch.int32))

    monkeypatch.setattr(orb, "extract_orb", altered)
    out = bench_cells.run("euroc-agent-corridor", 10.0, monkeypatch, frames=70)
    assert out["correct"] is False and "orb_desc_bits" in _failed(out)


@pytest.mark.parametrize("cell", ["euroc-server-gba", "euroc-agent-corridor"])
def test_precision_control_fails(cell, monkeypatch):
    out = bench_cells.run(cell, 3.0 if "server" in cell else 10.0, monkeypatch,
                          with_control=True, frames=70)
    control = out["info"]["control"]
    numbers = _numbers(out)
    assert out["checked"] and any(control[n] > lim for n, (_, lim) in numbers.items()), control
    assert all(control[n] >= v for n, (v, _) in numbers.items()), (control, numbers)
