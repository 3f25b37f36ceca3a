"""The port's loop closer on a street drive at a CPU size, against the plain
loop reference (``tests/plain_loop.py``).

The benchmark's street map (``slam_bench/street_map.py``) cut to 256
keyframes of 256 features over 8192 landmarks: two closed loops, then a
drifted stretch that ends by re-driving the first street. The server's own
handler (``ServerSystem``, one agent) holds it; the last revisit's six
keyframes arrive through ``LoopCloser.process_keyframe``, with the loop
GBA left out (the benchmark's tests run it). 256 vertices lie above
``DENSE_MAX_V``, so the essential graph takes the CG route, as at capacity.
"""
import copy
import filecmp
import os

import numpy as np
import pytest
import torch

from motioncheck_ccm_slam_tpu_torch.models import loop_closing
from motioncheck_ccm_slam_tpu_torch.solvers import pose_graph
from slam_bench import bench, spans, street_map
from slam_bench.drivers import server_loop

import plain_loop
import torch_one_thread  # noqa: F401 (torch on one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 4300000017
SMALL_LEGS = [["E", 3], ["N", 1], ["E", 2], ["N", 1], ["W", 1], ["S", 1], ["E", 2], ["S", 2],
              ["W", 2], ["S", 1], ["E", 1], ["N", 1], ["W", 6], ["N", 1], ["E", 5]]


def small_spec() -> dict:
    """The loop cell's configuration and traffic at 256 x 8192 x 256, on a
    shorter grid of the same shape (37 m blocks, a keyframe every 4 m)."""
    s = copy.deepcopy(bench.cell_spec("kitti00-server-loop"))
    s["config"]["capacity"].update(server_max_kfs=256, server_max_mps=8192)
    s["config"]["extractor"].update(max_features=256)
    s["traffic"]["map"].update(legs=SMALL_LEGS, block_m=37.0, kf_step_m=4.0, turn_radius_m=8.0)
    return s


@pytest.fixture(scope="module")
def closed():
    """One loop closed on the small street map: the scene, the recorded
    unit and the handler."""
    s = small_spec()
    cfg = bench.port_config(s["config"])
    scene = street_map.build(s["traffic"]["map"], s["config"]["camera"], s["config"]["extractor"],
                             256, 8192, 256, SEED, "cpu")
    _, h = server_loop.to_server(scene, cfg, "cpu")
    lc = h.loop_closer
    lc.run_gba_after_loop = False
    restore = server_loop.Restorer(h, scene, s["traffic"]["arrivals"])
    rec = server_loop.Recorder(lc)
    restore(0)
    rec.start()
    with spans.swapped(lc, "correct_loop", rec.correct_loop), \
            spans.swapped(lc, "_optimize_essential_graph", rec.essential_graph), \
            spans.swapped(pose_graph, "optimize_pose_graph", rec.optimize):
        closed = [lc.process_keyframe(int(slot), interrupt_check=h._interrupt_check())
                  for slot in restore.slots(0)]
    return {"spec": s, "cfg": cfg, "scene": scene, "unit": rec.unit, "h": h, "closed": closed}


def test_cg_route_against_plain_dense_lm(closed):
    g, loop = closed["unit"]["graphs"][0], closed["unit"]["loops"][0]
    cfg = closed["cfg"]
    V = g["S_init"].shape[0]
    assert V > pose_graph.DENSE_MAX_V and g["route"] == "cg"
    diff, gap, c_cg, c_ref, c_start, _ = server_loop.graph_check(g, loop, cfg, 8192)
    assert diff == 0
    # the CG route, like the dense one, lands on the plain LM's optimum
    assert c_cg - c_ref < 1e-3 * c_ref, (c_cg, c_ref, c_start)
    edges = pose_graph.PoseGraphEdges(
        i=torch.from_numpy(g["i"]), j=torch.from_numpy(g["j"]), S_ji_meas=g["meas"],
        weight=torch.ones(len(g["i"])), valid=torch.ones(len(g["i"]), dtype=torch.bool))
    dense = pose_graph.optimize_pose_graph(g["S_init"], edges, torch.from_numpy(g["fixed"]),
                                           iterations=cfg.opt.ess_graph_iterations,
                                           method="dense")
    i, j = torch.from_numpy(g["i"]), torch.from_numpy(g["j"])
    S_ref = plain_loop.pose_graph_lm(g["S_init"], g["i"], g["j"], g["meas"], g["fixed"],
                                     cfg.opt.ess_graph_iterations)
    c_dense, c_ref = (plain_loop.cost(S, i, j, g["meas"]) for S in (dense.S_iw, S_ref))
    assert c_dense - c_ref < 1e-3 * c_ref, (c_dense, c_ref)


def test_loop_closes_planted_pair_and_drift_falls(closed):
    unit, scene = closed["unit"], closed["scene"]
    assert sum(closed["closed"]) == 1 and closed["closed"][2]
    loop = unit["loops"][0]
    assert server_loop.planted_pair(scene.route, loop["cur"], loop["cand"],
                                    closed["spec"]["traffic"]["pair_radius_m"])
    S_true = plain_loop.planted_sim3(scene.Tcw_true[loop["cur"]], scene.Tcw_true[loop["cand"]],
                                     float(scene.route["drift_scale"][-1]))
    rot, sc, t_m = plain_loop.sim3_terms(loop["S12"], S_true)
    assert max(rot, sc) < 0.01 and t_m < 0.15, (rot, sc, t_m)
    # the graph the port solved is the plain rules' graph
    g = unit["graphs"][0]
    kf0 = loop["kf"]
    Wb = plain_loop.covisibility(kf0.mp_idx, kf0.feat_valid, kf0.valid, 8192).numpy()
    grp = plain_loop.correction_group(Wb, loop["cur"])
    assert np.array_equal(grp, g["group"])
    Wa = plain_loop.covisibility(g["kf"].mp_idx, g["kf"].feat_valid, g["kf"].valid, 8192,
                                 rows=grp).numpy()
    edges = plain_loop.essential_graph(loop["cur"], loop["cand"], grp, kf0.valid.numpy(),
                                       kf0.parent.numpy(), kf0.loop_edge.numpy(), Wb, Wa,
                                       closed["cfg"].opt.ess_graph_min_feats)
    slots = np.flatnonzero(kf0.valid.numpy())
    assert plain_loop.edge_diff(zip(slots[g["i"]], slots[g["j"]]), edges) == 0
    n_loop = int(edges.loop.sum())
    assert edges.loop[:n_loop].all() and (min(loop["cur"], loop["cand"]), max(
        loop["cur"], loop["cand"])) == (edges.i[0], edges.j[0])
    # the loop edge is recorded at both ends, and the drift falls
    le = closed["h"].map.kf.loop_edge.numpy()
    assert le[loop["cur"]] == loop["cand"] and le[loop["cand"]] == loop["cur"]
    true_c = plain_loop.centres(scene.Tcw_true)
    before = plain_loop.aligned_rms(plain_loop.centres(scene.Tcw), true_c)
    after = plain_loop.aligned_rms(plain_loop.centres(closed["h"].map.kf.Tcw), true_c)
    assert after < 0.8 * before, (after, before)
    assert isinstance(closed["h"].loop_closer, loop_closing.LoopCloser)


def test_benchmark_reference_is_this_copy():
    assert filecmp.cmp(os.path.join(ROOT, "tests", "plain_loop.py"),
                       os.path.join(ROOT, "slam_bench", "reference", "loop.py"), shallow=False)
