"""Driver of the loop cell: the server's loop closer, one loop after another.

Set-up builds the traffic's street map on the device (``street_map``),
writes it into the map of a ``system.server.ServerSystem``'s one handler
in place, and fills the handler's own ``KeyFrameDatabase`` with every
keyframe. Each unit then restores the map, the database (every keyframe
before the arrivals present) and the handler's loop closer (its
consistency groups, cooldown and RANSAC generator), leaving out the
drive's newest d keyframes (d drawn from the seed in
0..``drop_newest_max``, never the same draw twice in a row) and the
landmarks only they observed; then the last revisit's next
``arrivals`` keyframes arrive one by one, each
through ``handler.loop_closer.process_keyframe(slot,
interrupt_check=handler._interrupt_check())`` as ``ServerClientHandler.spin``
calls it. The third closes the loop: the Sim3, the correction and the
fusion, the essential graph (the route ``optimize_pose_graph`` picks for
its vertex count), the loop GBA through ``models/gba.run_gba`` with Motion
Check in gating mode, and the full-mode GBA if Motion Check asks for it.
One loop warms up. A unit that runs past ``unit_timeout_s`` stops between
arrivals and counts as failed, and so does one that closed no loop, whose
GBA cost is not finite or whose loop Motion Check gated.

After the window (``slam_bench/reference/loop.py``, ``reference/lm.py``,
``reference/motion_check.py``): every unit's loop pair against the
planted revisits and its Sim3 against the planted one (rotation and
scale; translation in metres, apart), and the drift its
unit left; the essential graph of ``checks.ess_graph_loops`` loops drawn
from the seed, its edges built again from the unit's snapshots and its
solve against the plain dense LM from the same start; the loop GBA of
``checks.lm_loops`` loops against the plain LM from the state handed to
``run_gba``; Motion Check's gating verdict of ``checks.mc_loops`` loops;
every GBA's write-back. The limits of the numbers new here are in
``limits_server_loop.json``.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import bench, roofline, spans, street_map
from ..reference import lm, loop as ref_loop, motion_check as ref_mc
from .common import capture_peak, check, free_device
from .server_gba import draws

def to_server(scene, cfg, device):
    """A ServerSystem for one agent whose handler's map holds the scene,
    written in place: every keyframe valid, chained by parent and
    predecessor, the closed loops' edges set."""
    from motioncheck_ccm_slam_tpu_torch.system import server as server_mod

    system = server_mod.ServerSystem(cfg, n_agents=1, device=device)
    h = system.handlers[0]
    m = h.map
    nk, nm = m.nk, m.nm
    chain = torch.arange(nk, dtype=torch.int32, device=device) - 1
    n_lev = cfg.extractor.n_levels
    max_d = scene.dist_ref * 1.2
    m.kf = m.kf._replace(
        kf_id=scene.kf_id.clone(), client_id=torch.zeros(nk, dtype=torch.int32, device=device),
        timestamp=scene.timestamp.clone(), Tcw=scene.Tcw.clone(), xy=scene.xy.clone(),
        desc=scene.desc.clone(), feat_valid=scene.mp_idx >= 0, mp_idx=scene.mp_idx.clone(),
        parent=chain, pred=chain.clone(), loop_edge=scene.loop_edge.clone(),
        valid=torch.ones(nk, dtype=torch.bool, device=device))
    m.mp = m.mp._replace(
        mp_id=torch.arange(nm, dtype=torch.int32, device=device),
        client_id=torch.where(scene.mp_valid, 0, -1).int(), Xw=scene.Xw.clone(),
        desc=scene.mp_desc.clone(), normal=scene.normal.clone(),
        min_dist=max_d / (cfg.extractor.scale_factor ** (n_lev - 1)) * 0.8,
        max_dist=torch.where(scene.mp_valid, max_d, 1e9),
        ref_kf=scene.ref_kf.clone(),
        first_kf_id=torch.where(scene.mp_valid, scene.ref_kf, -1).int(),
        valid=scene.mp_valid.clone())
    m.next_kf_slot = 0
    m.sync_host_index()
    db = h.loop_closer.database
    for s in range(nk):
        db.add(s, m.kf.desc[s], m.kf.feat_valid[s], map_id=h.client_id)
    db._flush()
    return system, h


class Restorer:
    """The map's, the database's and the closer's state before each loop."""

    def __init__(self, h, scene, arrivals: int):
        self.h, self.scene, self.arrivals = h, scene, arrivals
        m, db, lc = h.map, h.loop_closer.database, h.loop_closer
        self.kf0, self.mp0 = m.kf, m.mp
        self.bow0, self.present0, self.map_id0 = db.bow, db.present, db.map_id
        self.gen0 = lc.generator.get_state()

    def slots(self, drop: int) -> np.ndarray:
        """The unit's arriving slots."""
        nk = self.kf0.valid.shape[0]
        return np.arange(nk - drop - self.arrivals, nk - drop)

    def __call__(self, drop: int):
        kf_valid, mp_valid = valid_of(self.scene, drop)
        m, lc = self.h.map, self.h.loop_closer
        m.kf = self.kf0._replace(valid=kf_valid, Tcw=self.kf0.Tcw.clone(),
                                 mp_idx=self.kf0.mp_idx.clone())
        m.mp = self.mp0._replace(valid=mp_valid, Xw=self.mp0.Xw.clone())
        m.correct_kf_switch = True
        m.request_gba = False
        db = lc.database
        first = int(self.slots(drop)[0])
        db.bow, db.map_id = self.bow0, self.map_id0
        db.present = self.present0 & (torch.arange(self.present0.shape[0],
                                                   device=self.present0.device) < first)
        db._pending = []
        lc.consistent_groups = []
        lc.last_loop_kf_id = -1
        lc.generator.set_state(self.gen0)


def valid_of(scene, drop: int):
    """(keyframe valid, landmark valid) with the newest ``drop`` keyframes
    left out, and the landmarks they alone saw."""
    nk, nm = scene.mp_idx.shape[0], scene.Xw.shape[0]
    kf_valid = torch.arange(nk, device=scene.mp_idx.device) < nk - int(drop)
    seen = scene.mp_idx[kf_valid]
    seen = seen[seen >= 0].long()
    return kf_valid, (torch.bincount(seen, minlength=nm) > 0) & scene.mp_valid


class Recorder:
    """Wraps the closer's stages and the GBA for one unit: the loop pair
    and its Sim3, the map at the correction's start and at the essential
    graph's, the graph the port solved and its result, and each GBA's
    state in, solver result, verdict and state out."""

    def __init__(self, lc):
        self.lc = lc
        self.unit = {"loops": [], "graphs": [], "gbas": []}

    def start(self):
        self.unit = {"loops": [], "graphs": [], "gbas": []}

    def correct_loop(self, fn):
        def call(cur, cand, S12, *a, **kw):
            self.unit["loops"].append({"cur": int(cur), "cand": int(cand),
                                       "S12": S12.detach().clone(), "kf": self.lc.map.kf,
                                       "mp": self.lc.map.mp})
            return fn(cur, cand, S12, *a, **kw)
        return call

    def essential_graph(self, fn):
        def call(cur, cand, grp, *a, **kw):
            self.unit["graphs"].append({"group": np.asarray(sorted(grp), np.int64),
                                        "kf": self.lc.map.kf})
            return fn(cur, cand, grp, *a, **kw)
        return call

    def optimize(self, fn):
        def call(S_iw_init, edges, fixed, *a, **kw):
            res = fn(S_iw_init, edges, fixed, *a, **kw)
            if self.unit["graphs"]:
                self.unit["graphs"][-1].update(
                    S_init=S_iw_init.detach().clone(), i=edges.i.cpu().numpy(),
                    j=edges.j.cpu().numpy(), meas=edges.S_ji_meas.detach().clone(),
                    fixed=fixed.cpu().numpy(), S_iw=res.S_iw.detach().clone(),
                    route=_route(S_iw_init))
            return res
        return call

    def run_gba(self, fn):
        def call(m, cfg, *a, **kw):
            rec = {"kf_in": m.kf, "mp_in": m.mp, "final": None}
            self.unit["gbas"].append(rec)
            res = fn(m, cfg, *a, **kw)
            rec.update(result=res, kf_out=m.kf, mp_out=m.mp)
            return res
        return call

    def pick_solver(self, fn, timed=None):
        """``gba._pick_solver`` whose solver records each GBA's result,
        inside ``timed`` (the traced run's ``gba.solver`` span) if given."""
        def pick(*a, **kw):
            solver = fn(*a, **kw)
            if solver is None:
                return None
            if timed is not None:
                solver = timed(solver)

            def call(*sa, **skw):
                res = solver(*sa, **skw)
                if self.unit["gbas"]:
                    self.unit["gbas"][-1]["final"] = res
                return res
            return call
        return pick


def _route(S) -> str:
    """The route the port's ``optimize_pose_graph`` took for these vertices."""
    from motioncheck_ccm_slam_tpu_torch.solvers import pose_graph

    return "dense" if S.shape[0] <= pose_graph.DENSE_MAX_V else "cg"


def run(cell: bench.Cell, with_control: bool = False) -> dict:
    from motioncheck_ccm_slam_tpu_torch.models import gba, loop_closing
    from motioncheck_ccm_slam_tpu_torch.parallel import sharded_ba
    from motioncheck_ccm_slam_tpu_torch.solvers import pose_graph

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    cap = cfg.capacity
    cell.limits = {**cell.limits, **bench.load_json(bench.BENCH_DIR, "limits_server_loop.json")}
    t_in = time.perf_counter()
    scene = street_map.build(tr["map"], cell.config_data["camera"], cell.config_data["extractor"],
                             cap.server_max_kfs, cap.server_max_mps, cfg.extractor.max_features,
                             cell.seed, dev)
    spans.sync(dev)
    t_map = time.perf_counter()
    system, h = to_server(scene, cfg, dev)
    lc = h.loop_closer
    A = tr["arrivals"]
    restore = Restorer(h, scene, A)
    drops = draws(cell.seed, 4096, 1, tr["drop_newest_max"])[:, 0]
    spans.sync(dev)
    t_made = time.perf_counter()

    rec = Recorder(lc)
    sp = spans.Spans(cell.trace, dev)
    plans = []

    def plan_capture(build):
        def call(obs, C, L, n_shards=1):
            tp = build(obs, C, L, n_shards=n_shards)
            plans.append((tp, obs.valid, C))
            return tp
        return call

    launches = spans.Counters([("motioncheck_ccm_slam_tpu_torch.ops.schur_cuda",
                                k + ".launches", k)
                               for k in roofline.SCHUR_KERNELS])
    counters = spans.Counters(cell.counters)
    timeout = tr["unit_timeout_s"]

    def one_loop(i):
        t0 = time.perf_counter()
        drop = int(drops[i % len(drops)])
        rec.start()
        do_restore(drop)
        kf_start = h.map.kf
        launches.take()
        counters.take()
        n0 = lc.n_loops_closed
        timed_out = False
        for slot in restore.slots(drop):
            if time.perf_counter() - t0 > timeout:
                timed_out = True
                break
            process(int(slot), interrupt_check=h._interrupt_check())
        spans.sync(dev)
        unit = rec.unit
        unit.update(seconds=time.perf_counter() - t0, drop=drop, kf_start=kf_start,
                    closed=lc.n_loops_closed - n0, timed_out=timed_out,
                    kf_end=h.map.kf, launches=launches.take(), counters=counters.take(),
                    spans=sp.take())
        return unit

    with contextlib.ExitStack() as stack:
        stack.enter_context(spans.swapped(lc, "correct_loop", rec.correct_loop))
        stack.enter_context(spans.swapped(lc, "_optimize_essential_graph", rec.essential_graph))
        stack.enter_context(spans.swapped(pose_graph, "optimize_pose_graph", rec.optimize))
        timed = (lambda solver: sp.timed("gba.solver", solver)) if cell.trace else None
        stack.enter_context(spans.swapped(gba, "_pick_solver",
                                          lambda fn: rec.pick_solver(fn, timed)))
        run_gba = rec.run_gba(sp.timed("gba", gba.run_gba) if cell.trace else gba.run_gba)
        stack.enter_context(spans.swapped(loop_closing.gba_mod, "run_gba", lambda _: run_gba))
        if cell.trace:
            stack.enter_context(spans.swapped(sharded_ba, "build_tile_plan", plan_capture))
        do_restore = sp.timed("restore", restore) if cell.trace else restore
        process = (sp.timed("loop.arrival", lc.process_keyframe) if cell.trace
                   else lc.process_keyframe)
        sp.wrap_declared(cell.spans)
        stack.callback(sp.restore)
        one_loop(len(drops) - 1)              # warm-up: one whole loop
        sp.take()
        plans.clear()
        setup_s = time.perf_counter() - cell.t_start
        prof = spans.Profile(dev, sp.names) if cell.trace else None
        units = []
        t0 = time.perf_counter()
        while True:
            i = len(units)
            if prof is not None and i == 1:
                plans.clear()
                prof.start()
            units.append(one_loop(i))
            if prof is not None and i == 1:
                t0 += prof.stop()
            if time.perf_counter() - t0 >= cell.seconds:
                break
        window_s = time.perf_counter() - t0
    memory_peak = capture_peak(dev)

    def unit_failed(u):
        gb = [g for g in u["gbas"] if "result" in g]
        return (u["closed"] < 1 or u["timed_out"] or not gb
                or any(not np.isfinite(g["result"].cost) or g["result"].mc_gated for g in gb))

    closed = sum(u["closed"] >= 1 for u in units)
    failed = sum(unit_failed(u) for u in units)
    graphs = [g for u in units for g in u["graphs"] if "S_init" in g]
    out = {"attempted": len(units), "failed": failed, "memory_peak_bytes": memory_peak,
           "end_to_end": {"server_gba_s": window_s / max(closed, 1), "setup_s": setup_s},
           "info": {"loops": len(units), "closed": closed, "window_s": window_s,
                    "loop_s_p10_p50_p90": [bench.percentile([u["seconds"] for u in units], q)
                                           for q in (10, 50, 90)],
                    "gbas": sum(len(u["gbas"]) for u in units),
                    "gated": sum(any(g.get("result") is not None and g["result"].mc_gated
                                     for g in u["gbas"]) for u in units),
                    "ess_graph_route": sorted({g["route"] for g in graphs}),
                    "ess_graph_vertices": graphs[0]["S_init"].shape[0] if graphs else 0,
                    "ess_graph_edges": int(graphs[0]["i"].shape[0]) if graphs else 0,
                    "revisits": [list(map(int, r)) for r in scene.route["revisits"]],
                    "setup_parts_s": {"start_to_inputs": t_in - cell.t_start,
                                      "inputs": t_made - t_in, "street_map": t_map - t_in,
                                      "warmup": setup_s - (t_made - cell.t_start)}}}
    if cell.trace:
        out["trace"] = trace_data(units, prof, plans, cfg.opt.gba_iterations)
        out["profile"] = prof.result if prof else None
    del system, h, lc, restore
    free_device(dev)
    out["checks"], out["checked"], more = compare(cell, scene, units, with_control)
    out["info"].update(more)
    return out


def trace_data(units, prof, plans, iters: int) -> dict:
    data = {"units": [{"seconds": u["seconds"], "spans": u["spans"], "counters": u["counters"],
                       "iterations": iters * len(u["gbas"])} for u in units]}
    if prof is not None and prof.result is not None and len(units) > 1:
        bound = 0.0
        if plans:
            tp, valid, C = plans[0]
            n_valid = int(valid.sum())
            for k, n in units[1]["launches"].items():
                bound += n * roofline.schur_bound_s(k, ntl=tp.ntl, TP=tp.TP, L_pad=tp.L_pad,
                                                    C=C, n_valid=n_valid)
        kern_s = sum(s for name, (s, _) in prof.result["kernels"].items()
                     if any(sym in name for sym in roofline.SCHUR_SYMBOLS))
        data["roofline"] = {"bound_s": bound, "kernel_s": kern_s}
        data["busy_s"], data["window_s"] = prof.result["busy_s"], prof.result["window_s"]
    return data


def planted_pair(route: dict, cur: int, cand: int, radius: float) -> bool:
    """Is (cur, cand) a planted revisit: cur on the last revisit, cand on
    the drive before the drift, within ``radius`` and 30 degrees of it."""
    pos, hd = route["pos"], route["heading"]
    if not (cur >= route["final_first"] and cand < route["drift_first"]):
        return False
    dh = abs(np.angle(np.exp(1j * (hd[cur] - hd[cand]))))
    return bool(np.linalg.norm(pos[cur] - pos[cand]) <= radius and dh < np.deg2rad(30.0))


def gba_problem(kf, mp, cfg, device) -> lm.Problem:
    """The GBA's problem as the reference states it, from the map handed to
    ``run_gba``: every observation of a live keyframe, the live keyframe of
    least id and the dead ones fixed, the dead landmarks fixed."""
    nk, f = kf.mp_idx.shape
    ok = kf.feat_valid & (kf.mp_idx >= 0) & kf.valid[:, None]
    cam = torch.arange(nk, device=device)[:, None].expand(nk, f)[ok]
    lmi = kf.mp_idx[ok].long()
    fixed = ~kf.valid.clone()
    kf_id = kf.kf_id.masked_fill(~kf.valid, np.iinfo(np.int32).max)
    fixed[int(torch.argmin(kf_id))] = True
    K = torch.tensor([[cfg.camera.fx, 0, cfg.camera.cx], [0, cfg.camera.fy, cfg.camera.cy],
                      [0, 0, 1]], dtype=torch.float64, device=device)
    return lm.Problem(cam=cam, lm=lmi, uv=kf.xy[ok].double(),
                      info=torch.ones(lmi.shape[0], dtype=torch.float64, device=device),
                      valid=torch.ones(lmi.shape[0], dtype=torch.bool, device=device), K=K,
                      fixed_cam=fixed, fixed_lm=~mp.valid)


def graph_check(g, loop, cfg, nm: int, control: bool = False):
    """(edge diff, cost gap, the port's, the reference's and the start's
    costs, and the control's gap) of one solved essential graph: the graph
    and its start built again from the unit's snapshots (the loop pair and
    Sim3, the poses and covisibility before the correction, the
    covisibility after fusion), the plain dense LM run on it (and, with
    ``control``, again in bfloat16); an edge counts as differing where it
    is in one graph only or its measurement differs."""
    kf0, kf1 = loop["kf"], g["kf"]
    valid = kf0.valid
    slots = torch.nonzero(valid).squeeze(1)
    dev = slots.device
    minf = cfg.opt.ess_graph_min_feats
    Wb = ref_loop.covisibility(kf0.mp_idx, kf0.feat_valid, valid, nm).cpu().numpy()
    grp = ref_loop.correction_group(Wb, loop["cur"])
    Wa = ref_loop.covisibility(kf1.mp_idx, kf1.feat_valid, kf1.valid, nm, rows=grp).cpu().numpy()
    edges = ref_loop.essential_graph(loop["cur"], loop["cand"], grp, valid.cpu().numpy(),
                                     kf0.parent.cpu().numpy(), kf0.loop_edge.cpu().numpy(),
                                     Wb, Wa, minf)
    slot_np = slots.cpu().numpy()
    port_pairs = np.stack([slot_np[g["i"]], slot_np[g["j"]]], -1)
    diff = ref_loop.edge_diff(port_pairs, edges)
    diff += int(not np.array_equal(np.asarray(grp), g["group"]))
    # the start: the group's corrected Sim3, the rest as before the correction
    S0 = kf0.Tcw.double().clone()
    S0[torch.from_numpy(grp).to(dev)] = ref_loop.corrected_sim3(loop["S12"], kf0.Tcw,
                                                                loop["cur"], loop["cand"], grp)
    meas = ref_loop.measurements(S0, kf0.Tcw, edges)
    key = {(int(a), int(b)): n for n, (a, b) in enumerate(zip(edges.i, edges.j))}
    common = [(n, key[(min(a, b), max(a, b))]) for n, (a, b) in enumerate(port_pairs.tolist())
              if (min(a, b), max(a, b)) in key]
    if common:
        pn, rn = (torch.tensor(x, device=dev) for x in zip(*common))
        diff += ref_loop.measurement_diff(g["meas"][pn], meas[rn])
    comp = np.full(valid.shape[0], -1, np.int64)
    comp[slot_np] = np.arange(slot_np.shape[0])
    i, j = comp[edges.i], comp[edges.j]
    fixed = np.zeros(slot_np.shape[0], bool)
    fixed[comp[loop["cand"]]] = True
    S_start = S0[slots]
    iters = cfg.opt.ess_graph_iterations
    S_ref = ref_loop.pose_graph_lm(S_start, i, j, meas, fixed, iters)
    it = torch.from_numpy(i).to(dev)
    jt = torch.from_numpy(j).to(dev)
    gap, c_port, c_ref, c_0 = ref_loop.cost_gap(g["S_iw"], S_ref, S_start, it, jt, meas)
    c_gap = 0.0
    if control:
        S_c = ref_loop.pose_graph_lm(S_start, i, j, meas, fixed, iters, dtype=torch.bfloat16)
        c_gap = ref_loop.cost_gap(S_c, S_ref, S_start, it, jt, meas)[0]
    return diff, gap, c_port, c_ref, c_0, c_gap


def compare(cell, scene, units, with_control):
    """(checks, checked, info) of the window's loops; with ``with_control``
    the info also holds the precision control's readings of each number."""
    cfg, tr, dev, lim = cell.config, cell.traffic, cell.device, cell.limits
    rng = np.random.default_rng([cell.seed % (1 << 63), 31])
    route = scene.route
    ctrl, info = {}, {}
    nm = scene.Xw.shape[0]
    s_final = float(route["drift_scale"][route["final_first"]])
    # every unit: its loop pair, its Sim3 and the drift it left
    miss = 0
    sim3_err = c_sim3 = sim3_t = c_sim3_t = 0.0
    drift_left = c_drift = 0.0
    true_c = ref_loop.centres(scene.Tcw_true)
    for u in units:
        loops = u["loops"]
        ok = (u["closed"] == 1 and len(loops) == 1
              and planted_pair(route, loops[0]["cur"], loops[0]["cand"], tr["pair_radius_m"]))
        miss += int(not ok)
        if loops:
            lp = loops[0]
            cur, cand = lp["cur"], lp["cand"]
            S_true = ref_loop.planted_sim3(scene.Tcw_true[cur], scene.Tcw_true[cand], s_final)
            rot, sc, t_m = ref_loop.sim3_terms(lp["S12"], S_true)
            if max(rot, sc, t_m) > max(sim3_err, sim3_t):
                info["loop_sim3_terms_worst"] = [rot, sc, t_m, float(
                    np.linalg.norm(route["pos"][cur] - route["pos"][cand]))]
            sim3_err, sim3_t = max(sim3_err, rot, sc), max(sim3_t, t_m)
            if with_control:
                S_c = ref_loop.planted_sim3(scene.Tcw_true[cur], scene.Tcw_true[cand], s_final,
                                            dtype=torch.bfloat16)
                c_rot, c_sc, c_t = ref_loop.sim3_terms(S_c, S_true)
                c_sim3, c_sim3_t = max(c_sim3, c_rot, c_sc), max(c_sim3_t, c_t)
        kf_valid, _ = valid_of(scene, u["drop"])
        before = ref_loop.aligned_rms(ref_loop.centres(u["kf_start"].Tcw[kf_valid]),
                                      true_c[kf_valid])
        keep = kf_valid & u["kf_end"].valid
        after = ref_loop.aligned_rms(ref_loop.centres(u["kf_end"].Tcw[keep]), true_c[keep])
        drift_left = max(drift_left, after / max(before, 1e-12))
        if with_control:
            T_c = u["kf_end"].Tcw[keep].to(torch.bfloat16).float()
            c_drift = max(c_drift, ref_loop.aligned_rms(ref_loop.centres(T_c), true_c[keep])
                          / max(before, 1e-12))
    ctrl.update(loop_pair_miss=0, loop_sim3_err=c_sim3, loop_sim3_t_err=c_sim3_t,
                loop_drift_left=c_drift)
    checks = [check("loop_pair_miss", miss, lim), check("loop_sim3_err", sim3_err, lim),
              check("loop_sim3_t_err", sim3_t, lim), check("loop_drift_left", drift_left, lim)]
    done = [u for u in units if u["closed"] >= 1 and u["graphs"] and "S_init" in u["graphs"][0]]
    # the essential graph of drawn loops
    k_eg = min(tr["checks"]["ess_graph_loops"], len(done))
    ediff = 0
    gap = cgap = 0.0
    for n in sorted(rng.choice(len(done), k_eg, replace=False)) if k_eg else []:
        u = done[n]
        d, g_, c_port, c_ref, c_start, c_g = graph_check(u["graphs"][0], u["loops"][0], cfg,
                                                         nm, control=with_control)
        ediff += d
        gap = max(gap, g_)
        cgap = max(cgap, c_g)
        info.update(ess_graph_cost_program=c_port, ess_graph_cost_reference=c_ref,
                    ess_graph_cost_start=c_start)
    ctrl.update(ess_graph_edge_diff=0, ess_graph_cost_gap=cgap)
    checks += [check("ess_graph_edge_diff", ediff, lim), check("ess_graph_cost_gap", gap, lim)]
    # every GBA's write-back
    gbas = [g for u in units for g in u["gbas"] if g.get("final") is not None and "result" in g]
    wb = cwb = 0.0
    for g in gbas:
        kept, keep_mp = g["kf_out"].valid, g["mp_out"].valid
        if g["result"].reverted:
            want_T, want_X = g["kf_in"].Tcw, g["mp_in"].Xw
        else:
            want_T, want_X = g["final"].Tcw, g["final"].Xw
        dT = float((g["kf_out"].Tcw - want_T)[kept].abs().max()) if bool(kept.any()) else 0.0
        dX = float((g["mp_out"].Xw - want_X)[keep_mp].abs().max()) if bool(keep_mp.any()) else 0.0
        wb = max(wb, dT, dX)
        if with_control:
            cT = g["kf_out"].Tcw.to(torch.bfloat16).float()
            cwb = max(cwb, float((cT - want_T)[kept].abs().max()) if bool(kept.any()) else 0.0)
    ctrl["writeback_max_abs"] = cwb
    checks.append(check("writeback_max_abs", wb, lim))
    # Motion Check's gating verdict on drawn loops
    loop_gbas = [u["gbas"][0] for u in done if u["gbas"] and u["gbas"][0].get("final") is not None
                 and "result" in u["gbas"][0]]
    t_sc = np.asarray(cell.config_data["camera"]["t_sc"], np.float32).reshape(4, 4)
    prm = cell.config_data["motion_check"]
    k_mc = min(tr["checks"]["mc_loops"], len(loop_gbas))
    mdiff = cdiff = 0
    for n in sorted(rng.choice(len(loop_gbas), k_mc, replace=False)) if k_mc else []:
        g = loop_gbas[n]
        valid = g["kf_in"].valid.cpu().numpy()
        cid = g["kf_in"].client_id.cpu().numpy()
        ts = g["kf_in"].timestamp.cpu().numpy()
        v = ref_mc.verdict(g["kf_in"].Tcw, g["final"].Tcw, valid, cid, ts, t_sc, prm)
        mdiff += int(v.revert != bool(g["result"].mc_gated))
        if with_control:
            c = ref_mc.verdict(g["kf_in"].Tcw, g["final"].Tcw, valid, cid, ts, t_sc, prm,
                               dtype=torch.bfloat16)
            cdiff += int(c.revert != v.revert)
    ctrl["mc_verdict_diff"] = cdiff
    checks.append(check("mc_verdict_diff", mdiff, lim))
    # the loop GBA against the plain LM from the same start
    k_lm = min(tr["checks"]["lm_loops"], len(loop_gbas))
    lgap = clgap = 0.0
    for n in sorted(rng.choice(len(loop_gbas), k_lm, replace=False)) if k_lm else []:
        g = loop_gbas[n]
        p = gba_problem(g["kf_in"], g["mp_in"], cfg, dev)
        T0, X0 = g["kf_in"].Tcw, g["mp_in"].Xw
        T_ref, X_ref = lm.bundle_adjust(T0, X0, p, cfg.opt.gba_iterations, chunk=5)
        g_, c_prog, c_ref = lm.cost_gap(g["final"].Tcw, g["final"].Xw, T_ref, X_ref, p, False)
        lgap = max(lgap, g_)
        info.update(gba_cost_program=c_prog, gba_cost_reference=c_ref,
                    gba_cost_start=lm.cost(T0, X0, p, p.valid))
        if with_control:
            T_c, X_c = lm.bundle_adjust(T0, X0, p, cfg.opt.gba_iterations, chunk=5,
                                        dtype=torch.bfloat16)
            clgap = max(clgap, lm.cost_gap(T_c, X_c, T_ref, X_ref, p, False)[0])
    ctrl["gba_cost_gap"] = clgap
    checks.append(check("gba_cost_gap", lgap, lim))
    if with_control:
        info["control"] = ctrl
    info.update(ess_graph_loops=k_eg, mc_loops=k_mc, lm_loops=k_lm)
    return checks, len(units) > 0 and k_eg > 0 and k_mc > 0 and k_lm > 0, info
