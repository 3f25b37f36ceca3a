"""Driver of the server cells: the Motion-Check-gated GBA at capacity, one
after another.

Set-up builds the traffic's server map on the device (``server_map``),
hands it to the port as a ``MapState`` and runs one GBA to warm up. In the
window each GBA first restores the map from the device copy, leaving out
each client's newest k keyframes (k drawn from the seed in
0..``drop_newest_max``, never the same draw twice in a row) and the
landmarks no keyframe left observes; then it runs
``models/gba.run_gba`` with the configuration's iterations in chunks of
``chunk``, Motion Check in full mode, through the solver that
``gba._pick_solver`` returns for the map (with ``kick``, each chunk's
result is kicked on a band of keyframes, as a degraded solver would).

After the window: every GBA's written-back map against the solver's last
result (or, on a revert, the pre-GBA state); the Motion Check verdict of
``checks.mc_gbas`` GBAs drawn from the seed, worked out again from the
pre- and post-GBA poses; the solver's result of ``checks.lm_gbas`` GBAs
against the plain LM run from the same start on the same observations.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import bench, roofline, server_map, spans
from ..reference import lm, motion_check as ref_mc
from .common import capture_peak, check, free_device


def _kicker(kick, client_id: np.ndarray, kf_id: np.ndarray):
    """The traffic's kick as a function of poses (N, 4, 4), or None."""
    if not kick:
        return None
    slots = np.flatnonzero((client_id == kick["client"]) & (kf_id >= kick["first_kf"])
                           & (kf_id < kick["first_kf"] + kick["count"]))
    signs = np.where(np.arange(slots.size) % 2 == 0, 1.0, -1.0) * kick["metres"]

    def apply(T):
        idx = torch.from_numpy(slots).to(T.device)
        T = T.clone()
        T[idx, kick["axis"], 3] += torch.from_numpy(signs).to(T)
        return T
    return apply


class Restorer:
    """The map's device copy and the restore before each GBA."""

    def __init__(self, m, scene, n_clients: int):
        self.m, self.scene, self.n_clients = m, scene, n_clients
        self.kf0, self.mp0 = m.kf, m.mp

    def __call__(self, drop):
        kf_valid, mp_valid = valid_of(self.scene, drop, self.n_clients)
        self.m.kf = self.kf0._replace(valid=kf_valid, Tcw=self.kf0.Tcw.clone())
        self.m.mp = self.mp0._replace(valid=mp_valid, Xw=self.mp0.Xw.clone())
        self.m.correct_kf_switch = True
        self.m.request_gba = False


def valid_of(scene, drop, n_clients: int):
    """(keyframe valid, landmark valid) with each client's newest
    ``drop[c]`` keyframes left out, and the landmarks they alone saw."""
    nk, nm = scene.mp_idx.shape[0], scene.Xw.shape[0]
    per = nk // n_clients
    dev = scene.mp_idx.device
    k = torch.arange(nk, device=dev) % per
    limit = torch.as_tensor(per - np.asarray(drop), device=dev).repeat_interleave(per)
    kf_valid = k < limit
    seen = scene.mp_idx[kf_valid]
    seen = seen[seen >= 0].long()
    return kf_valid, torch.bincount(seen, minlength=nm) > 0


def draws(seed: int, n: int, n_clients: int, top: int) -> np.ndarray:
    rng = np.random.default_rng([int(seed) % (1 << 63), 17])
    out = [rng.integers(0, top + 1, n_clients)]
    while len(out) < n:
        d = rng.integers(0, top + 1, n_clients)
        if not np.array_equal(d, out[-1]):
            out.append(d)
    return np.stack(out)


def to_map(scene, cfg, n_clients: int, device):
    """The port's server MapState holding the scene: every slot valid, each
    client's keyframes chained by parent and predecessor."""
    from motioncheck_ccm_slam_tpu_torch.models import map_state

    m = map_state.MapState.create(cfg, server=True, device=device)
    per = m.nk // n_clients
    chain = torch.arange(m.nk, dtype=torch.int32, device=device) - 1
    chain[::per] = -1
    mp_client = scene.client_id[torch.clamp_min(scene.ref_kf, 0).long()]
    m.kf = m.kf._replace(
        kf_id=scene.kf_id.clone(), client_id=scene.client_id.clone(),
        timestamp=scene.timestamp.clone(), Tcw=scene.Tcw.clone(), xy=scene.xy.clone(),
        feat_valid=scene.mp_idx >= 0, mp_idx=scene.mp_idx.clone(), parent=chain,
        pred=chain.clone(), valid=torch.ones(m.nk, dtype=torch.bool, device=device))
    m.mp = m.mp._replace(
        mp_id=torch.arange(m.nm, dtype=torch.int32, device=device), client_id=mp_client,
        Xw=scene.Xw.clone(), min_dist=torch.full((m.nm,), 0.1, device=device),
        max_dist=torch.full((m.nm,), 100.0, device=device), ref_kf=scene.ref_kf.clone(),
        valid=torch.ones(m.nm, dtype=torch.bool, device=device))
    m.sync_host_index()
    return m


def problem(scene, kf_valid, mp_valid, cfg, device) -> lm.Problem:
    """The GBA's problem as the reference states it, from the benchmark's
    own map: every observation of a kept keyframe, the kept keyframe of
    least id (the first in slot order) and the left-out ones fixed, the
    left-out landmarks fixed."""
    nk, f = scene.mp_idx.shape
    ok = (scene.mp_idx >= 0) & kf_valid[:, None]
    cam = torch.arange(nk, device=device)[:, None].expand(nk, f)[ok]
    lmi = scene.mp_idx[ok].long()
    fixed = ~kf_valid.clone()
    kf_id = scene.kf_id.masked_fill(~kf_valid, np.iinfo(np.int32).max)
    fixed[int(torch.argmin(kf_id))] = True
    K = torch.tensor([[cfg.camera.fx, 0, cfg.camera.cx], [0, cfg.camera.fy, cfg.camera.cy],
                      [0, 0, 1]], dtype=torch.float64, device=device)
    return lm.Problem(cam=cam, lm=lmi, uv=scene.xy[ok].double(),
                      info=torch.ones(lmi.shape[0], dtype=torch.float64, device=device),
                      valid=torch.ones(lmi.shape[0], dtype=torch.bool, device=device), K=K,
                      fixed_cam=fixed, fixed_lm=~mp_valid)


def run(cell: bench.Cell, with_control: bool = False) -> dict:
    from motioncheck_ccm_slam_tpu_torch.models import gba
    from motioncheck_ccm_slam_tpu_torch.parallel import sharded_ba

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    cap = cfg.capacity
    mcfg = tr["map"]
    t_in = time.perf_counter()
    scene = server_map.build(mcfg, cell.config_data["camera"], cap.server_max_kfs,
                             cap.server_max_mps, cfg.extractor.max_features, cell.seed, dev)
    m = to_map(scene, cfg, mcfg["clients"], dev)
    restore = Restorer(m, scene, mcfg["clients"])
    host_cid = scene.client_id.cpu().numpy()
    kick = _kicker(tr["kick"], host_cid, scene.kf_id.cpu().numpy())
    drops = draws(cell.seed, 4096, mcfg["clients"], tr["drop_newest_max"])

    spans.sync(dev)
    t_made = time.perf_counter()
    base = gba._pick_solver(m.nk, m.nm, device=dev)
    last = {}

    def capture(tag, solver):
        def call(*a, **kw):
            res = solver(*a, **kw)
            last[tag] = res
            return res
        return call

    def kicked(solver):
        def call(*a, **kw):
            res = solver(*a, **kw)
            return res._replace(Tcw=kick(res.Tcw))
        return call

    solver = capture("base", base)
    if kick is not None:
        solver = kicked(solver)
    solver = capture("final", solver)

    sp = spans.Spans(cell.trace, dev)
    plans = []

    def plan_capture(build):
        def call(obs, C, L, n_shards=1):
            tp = build(obs, C, L, n_shards=n_shards)
            if len(plans) < 2:      # the roofline reads the profiled GBA's (the second)
                plans.append((tp, obs.valid, C))
            return tp
        return call

    iters, chunk = cfg.opt.gba_iterations, tr["chunk"]
    # the driver's own spans: the unit, the restore, the solver it hands over
    run_gba = sp.timed("gba", gba.run_gba) if cell.trace else gba.run_gba
    do_restore = sp.timed("restore", restore) if cell.trace else restore
    solver_used = sp.timed("gba.solver", solver) if cell.trace else solver
    # K3-K7's launches, for the roofline's bound
    launches = spans.Counters([("motioncheck_ccm_slam_tpu_torch.ops.schur_cuda", k + ".launches", k)
                               for k in roofline.SCHUR_KERNELS])
    counters = spans.Counters(cell.counters)

    def one_gba(i):
        t0 = time.perf_counter()
        drop = drops[i % len(drops)]
        do_restore(drop)
        launches.take()
        counters.take()
        res = run_gba(m, cfg, iterations=iters, chunk=chunk, sharded_solver=solver_used)
        spans.sync(dev)
        return {"seconds": time.perf_counter() - t0, "drop": drop, "result": res,
                "base": last["base"], "final": last["final"], "kf": m.kf, "mp": m.mp,
                "launches": launches.take(), "counters": counters.take(), "spans": sp.take()}

    with contextlib.ExitStack() as stack:
        if cell.trace:
            stack.enter_context(spans.swapped(sharded_ba, "build_tile_plan", plan_capture))
        sp.wrap_declared(cell.spans)
        stack.callback(sp.restore)
        one_gba(len(drops) - 1)            # warm-up: the plan, the solver, Motion Check
        sp.take()
        plans.clear()
        setup_s = time.perf_counter() - cell.t_start
        prof = spans.Profile(dev, sp.names) if cell.trace else None
        recs = []
        t0 = time.perf_counter()
        while True:
            i = len(recs)
            if prof is not None and i == 1:
                prof.start()
            recs.append(one_gba(i))
            if prof is not None and i == 1:
                t0 += prof.stop()
            if time.perf_counter() - t0 >= cell.seconds:
                break
        window_s = time.perf_counter() - t0
    memory_peak = capture_peak(dev)

    if tr["expect"] == "revert":
        failed = sum(1 for r in recs if not r["result"].reverted)
    else:
        failed = sum(1 for r in recs if r["result"].reverted or r["result"].n_deleted_kfs
                     or not np.isfinite(r["result"].cost))
    out = {"attempted": len(recs), "failed": failed, "memory_peak_bytes": memory_peak,
           "end_to_end": {"server_gba_s": window_s / len(recs), "setup_s": setup_s},
           "info": {"gbas": len(recs), "window_s": window_s,
                    "gba_s_p10_p50_p90": [bench.percentile([r["seconds"] for r in recs], q)
                                          for q in (10, 50, 90)],
                    "reverted": sum(r["result"].reverted for r in recs),
                    "deleted_kfs": sum(r["result"].n_deleted_kfs for r in recs),
                    "setup_parts_s": {"start_to_inputs": t_in - cell.t_start,
                                      "inputs": t_made - t_in,
                                      "warmup": setup_s - (t_made - cell.t_start)}}}
    if cell.trace:
        out["trace"] = trace_data(recs, iters, prof, plans)
        out["profile"] = prof.result if prof else None
    # the program's state goes before the reference runs
    kf0, mp0 = restore.kf0, restore.mp0
    del m, restore, base
    free_device(dev)
    out["checks"], out["checked"], more = compare(cell, scene, recs, kf0, mp0, kick,
                                                  with_control)
    out["info"].update(more)
    return out


def trace_data(recs, iters, prof, plans) -> dict:
    units = [{"seconds": r["seconds"], "spans": r["spans"], "counters": r["counters"],
              "iterations": iters} for r in recs]
    data = {"units": units, "iterations": iters}
    if prof is not None and prof.result is not None and len(recs) > 1:
        launches = recs[1]["launches"]
        bound = 0.0
        if len(plans) > 1:
            tp, valid, C = plans[1]
            n_valid = int(valid.sum())
            for k, n in launches.items():
                bound += n * roofline.schur_bound_s(k, ntl=tp.ntl, TP=tp.TP, L_pad=tp.L_pad,
                                                    C=C, n_valid=n_valid)
        kern_s = sum(s for name, (s, _) in prof.result["kernels"].items()
                     if any(sym in name for sym in roofline.SCHUR_SYMBOLS))
        data["roofline"] = {"bound_s": bound, "kernel_s": kern_s}
        data["busy_s"], data["window_s"] = prof.result["busy_s"], prof.result["window_s"]
    return data


def compare(cell, scene, recs, kf0, mp0, kick, with_control):
    """(checks, checked, info) of the window's GBAs; with ``with_control``
    the info also holds the precision control's readings of each number."""
    cfg, tr, dev, lim = cell.config, cell.traffic, cell.device, cell.limits
    rng = np.random.default_rng([cell.seed % (1 << 63), 29])
    n, nc = len(recs), tr["map"]["clients"]
    ctrl = {}

    def writeback(r, kf_valid, mp_valid, Tcw_map):
        kept, keep_mp = r["kf"].valid, r["mp"].valid
        if bool((kept & ~kf_valid).any()) or bool((keep_mp & ~mp_valid).any()):
            return float("inf")
        if r["result"].reverted:
            want_T, want_X = kf0.Tcw, mp0.Xw
        else:
            want_T, want_X = r["final"].Tcw, r["final"].Xw
        dT = float((Tcw_map - want_T)[kept].abs().max()) if bool(kept.any()) else 0.0
        dX = float((r["mp"].Xw - want_X)[keep_mp].abs().max()) if bool(keep_mp.any()) else 0.0
        return max(dT, dX)

    # the written-back map of every GBA
    wb = cwb = 0.0
    for r in recs:
        kf_valid, mp_valid = valid_of(scene, r["drop"], nc)
        wb = max(wb, writeback(r, kf_valid, mp_valid, r["kf"].Tcw))
        if with_control:
            cwb = max(cwb, writeback(r, kf_valid, mp_valid,
                                     r["kf"].Tcw.to(torch.bfloat16).float()))
    ctrl["writeback_max_abs"] = cwb
    checks = [check("writeback_max_abs", wb, lim)]
    # Motion Check's verdict on GBAs drawn from the seed
    t_sc = np.asarray(cell.config_data["camera"]["t_sc"], np.float32).reshape(4, 4)
    prm = cell.config_data["motion_check"]
    cid, ts = scene.client_id.cpu().numpy(), scene.timestamp.cpu().numpy()
    k_mc = min(tr["checks"]["mc_gbas"], n)
    diff = cdiff = 0
    for i in sorted(rng.choice(n, k_mc, replace=False)):
        r = recs[i]
        kf_valid, _ = valid_of(scene, r["drop"], nc)
        valid = kf_valid.cpu().numpy()
        v = ref_mc.verdict(kf0.Tcw, r["final"].Tcw, valid, cid, ts, t_sc, prm)
        deleted = torch.nonzero(kf_valid & ~r["kf"].valid).squeeze(1).cpu().numpy()
        diff += int(v.revert != bool(r["result"].reverted) or not np.array_equal(deleted,
                                                                                 v.deleted))
        if with_control:
            c = ref_mc.verdict(kf0.Tcw, r["final"].Tcw, valid, cid, ts, t_sc, prm,
                               dtype=torch.bfloat16)
            cdiff += int(c.revert != v.revert or not np.array_equal(c.deleted, v.deleted))
    ctrl["mc_verdict_diff"] = cdiff
    checks.append(check("mc_verdict_diff", diff, lim))
    # the solver against the plain LM from the same start
    k_lm = min(tr["checks"]["lm_gbas"], n)
    gap = cgap = 0.0
    info = {}
    for i in sorted(rng.choice(n, k_lm, replace=False)):
        r = recs[i]
        kf_valid, mp_valid = valid_of(scene, r["drop"], nc)
        p = problem(scene, kf_valid, mp_valid, cfg, dev)
        T_ref, X_ref = lm.bundle_adjust(kf0.Tcw, mp0.Xw, p, cfg.opt.gba_iterations,
                                        chunk=tr["chunk"], kick=kick)
        g, c_prog, c_ref = lm.cost_gap(r["base"].Tcw, r["base"].Xw, T_ref, X_ref, p, False)
        info.update(gba_cost_program=c_prog, gba_cost_reference=c_ref,
                    gba_cost_start=lm.cost(kf0.Tcw, mp0.Xw, p, p.valid))
        gap = max(gap, g)
        if with_control:
            T_c, X_c = lm.bundle_adjust(kf0.Tcw, mp0.Xw, p, cfg.opt.gba_iterations,
                                        chunk=tr["chunk"], kick=kick, dtype=torch.bfloat16)
            cgap = max(cgap, lm.cost_gap(T_c, X_c, T_ref, X_ref, p, False)[0])
    ctrl["gba_cost_gap"] = cgap
    checks.append(check("gba_cost_gap", gap, lim))
    if with_control:
        info["control"] = ctrl
    info.update(mc_gbas=k_mc, lm_gbas=k_lm)
    return checks, n > 0 and k_lm > 0 and k_mc > 0, info
