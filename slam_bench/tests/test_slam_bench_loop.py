"""The loop cell at a CPU size: it runs and reads correct, a traced run
reads every metric of the loop path, faults planted in the port read not
correct, and the precision control fails a limit.

The cell's configuration and traffic at 256 keyframes of 256 features
over 8192 landmarks, on a shorter grid of the same shape (37 m blocks, a
keyframe every 4 m). As on the card at capacity, the loop GBA takes the
tile GBA (``DENSE_W_MAX_BYTES`` lowered) and the essential graph, above
``DENSE_MAX_V`` vertices, the CG route.
"""
import copy
import time

import torch

from slam_bench import bench

CELL = "kitti00-server-loop"
SMALL_LEGS = [["E", 3], ["N", 1], ["E", 2], ["N", 1], ["W", 1], ["S", 1], ["E", 2], ["S", 2],
              ["W", 2], ["S", 1], ["E", 1], ["N", 1], ["W", 6], ["N", 1], ["E", 5]]
NEW_METRICS = ("loop_detect_s", "loop_sim3_s", "loop_correct_s", "ess_graph_s",
               "ess_graph_jac_s", "ess_graph_edges")


def spec() -> dict:
    s = copy.deepcopy(bench.cell_spec(CELL))
    s["config"]["capacity"].update(server_max_kfs=256, server_max_mps=8192)
    s["config"]["extractor"].update(max_features=256)
    s["traffic"]["map"].update(legs=SMALL_LEGS, block_m=37.0, kf_step_m=4.0, turn_radius_m=8.0)
    return s


def run(monkeypatch, seconds: float = 2.0, trace: bool = False, with_control: bool = False,
        seed: int = 4400000003) -> dict:
    from motioncheck_ccm_slam_tpu_torch.models import gba

    monkeypatch.setattr(gba, "DENSE_W_MAX_BYTES", 1024)
    return bench.run_cell(CELL, seed, seconds, trace, "cpu", time.perf_counter(), spec=spec(),
                          with_control=with_control)


def _failed(out):
    return [c["name"] for c in out["checks"] if c["value"] > c["limit"]]


def test_cell_runs_and_reads_correct(monkeypatch):
    out = run(monkeypatch)
    line = bench.result_line(out, False, {"platform": "gpu", "kind": "x", "count": 1,
                                          "memory_peak_bytes": 0})
    assert line["correct"] is True, line["compared"]
    assert line["attempted"] >= 1 and out["info"]["closed"] == line["attempted"], out["info"]
    assert set(line["metrics"]) == {"server_gba_s", "setup_s"}
    assert out["info"]["ess_graph_route"] == ["cg"]


def test_traced_run_reads_the_loop_metrics(monkeypatch):
    out = run(monkeypatch, trace=True)
    for name in NEW_METRICS + ("mc_passes_s", "mc_steps_per_gba", "gba_host_syncs",
                               "gba_plan_host_s", "pcg_host_s", "pcg_wait_s", "mc_s",
                               "gba_plan_s", "gba_lm_iters_per_s"):
        assert name in out["metrics"] and out["metrics"][name]["value"] > 0, name
    # K4 runs on the card only; its launch counter reads 0 here
    assert out["metrics"]["pcg_sweeps_per_gba"]["value"] >= 0
    assert out["metrics"]["ess_graph_edges"]["value"] == out["info"]["ess_graph_edges"]


def test_essential_graph_returns_its_input(monkeypatch):
    from motioncheck_ccm_slam_tpu_torch.solvers import pose_graph

    def unchanged(S_iw_init, edges, fixed, *a, **kw):
        return pose_graph.PoseGraphResult(S_iw=S_iw_init, cost=torch.tensor(0.0))

    monkeypatch.setattr(pose_graph, "optimize_pose_graph", unchanged)
    out = run(monkeypatch)
    assert out["correct"] is False and "ess_graph_cost_gap" in _failed(out)


def test_loop_sim3_scale_off(monkeypatch):
    from motioncheck_ccm_slam_tpu_torch.models import loop_closing

    compute = loop_closing.LoopCloser.compute_sim3

    def scaled(self, cur, cand):
        got = compute(self, cur, cand)
        if got is None:
            return None
        S12 = got[0].clone()
        S12[:3, :3] *= 1.05
        return S12, got[1]

    monkeypatch.setattr(loop_closing.LoopCloser, "compute_sim3", scaled)
    out = run(monkeypatch)
    assert out["correct"] is False and "loop_sim3_err" in _failed(out)


def test_loop_sim3_translation_off(monkeypatch):
    """The loop Sim3's translation 0.3 m off (at the true scale) along the
    camera's x axis, its rotation and scale right."""
    from motioncheck_ccm_slam_tpu_torch.models import loop_closing

    compute = loop_closing.LoopCloser.compute_sim3

    def shifted(self, cur, cand):
        got = compute(self, cur, cand)
        if got is None:
            return None
        S12 = got[0].clone()
        S12[0, 3] += 0.3 * torch.linalg.norm(S12[:3, 0])
        return S12, got[1]

    monkeypatch.setattr(loop_closing.LoopCloser, "compute_sim3", shifted)
    out = run(monkeypatch)
    assert out["correct"] is False and "loop_sim3_t_err" in _failed(out)


def test_graph_edges_lost(monkeypatch):
    """The loop closer's graph loses its last tenth of edges as it is put
    together (the closed loops' own edges cannot show here: each of their
    pairs is strongly covisible too, so the graph holds it either way)."""
    from motioncheck_ccm_slam_tpu_torch.solvers import pose_graph

    Edges = pose_graph.PoseGraphEdges

    def lost(**fields):
        n = fields["i"].shape[0]
        return Edges(**{k: v[:n - n // 10] for k, v in fields.items()})

    monkeypatch.setattr(pose_graph, "PoseGraphEdges", lost)
    out = run(monkeypatch)
    assert out["correct"] is False and "ess_graph_edge_diff" in _failed(out)


def test_gating_verdict_altered(monkeypatch):
    from motioncheck_ccm_slam_tpu_torch.models import motion_check

    check = motion_check.check_after_gba

    def flipped(*a, **kw):
        verdict, order = check(*a, **kw)
        return verdict._replace(revert=not bool(verdict.revert)), order

    monkeypatch.setattr(motion_check, "check_after_gba", flipped)
    out = run(monkeypatch)
    assert out["correct"] is False and "mc_verdict_diff" in _failed(out)


def test_detection_rejects_every_candidate(monkeypatch):
    from motioncheck_ccm_slam_tpu_torch.models import loop_closing

    monkeypatch.setattr(loop_closing.LoopCloser, "detect", lambda self, slot: None)
    out = run(monkeypatch)
    assert out["correct"] is False and "loop_pair_miss" in _failed(out)


def test_control_fails_a_limit(monkeypatch):
    out = run(monkeypatch, with_control=True)
    ctrl = out["info"]["control"]
    limits = {c["name"]: c["limit"] for c in out["checks"]}
    assert any(ctrl[n] > limits[n] for n in ctrl), ctrl
