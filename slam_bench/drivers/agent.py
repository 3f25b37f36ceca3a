"""Driver of the agent cells: one agent's camera stream, replayed as a
closed loop.

Set-up renders the traffic's frames on the device (``scene``), makes the
port's ``ClientSystem`` on the cell's configuration and feeds it frames
until it has initialised and made ``warmup.keyframes_after_init``
keyframes. The window then hands it one frame after another, each when the
last returned: a frame's latency runs from the hand-over of the image to
the device synchronize after ``process_image`` returns, and a frame is a
keyframe frame when the mapper made a keyframe in it.

After the window, on frames and calls drawn from the seed: each drawn
frame's ORB features against the plain extractor on the same image; the
pose of drawn tracking frames against the plain pose optimisation from
that pose on the frame's inlier matches; their association against the
plain projection search at that pose on the map as it stood; the result of
drawn local BAs against the plain LM from the inputs the local BA was
handed; and the map's keyframe trajectory over the window, step by step,
against the scene's truth.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import bench, roofline, spans
from ..reference import lm, orb as ref_orb, track_match, trajectory
from ..scene import Scene
from .common import capture_peak, check, free_device

# the traced run profiles frames 4-11 of its window
PROFILE_FROM, PROFILE_FRAMES = 4, 8
# the plain pose optimisation's LM iterations from the tracked pose
POSE_ITERS = 10


def run(cell: bench.Cell, with_control: bool = False) -> dict:
    from motioncheck_ccm_slam_tpu_torch.models.tracking import TrackState
    from motioncheck_ccm_slam_tpu_torch.solvers import local_ba
    from motioncheck_ccm_slam_tpu_torch.system.client import ClientSystem

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    cam = cell.config_data["camera"]
    t_in = time.perf_counter()
    scene = Scene(tr, cam, cell.seed, dev)
    truth = np.stack([scene.pose(k) for k in range(tr["frames"])])
    frames = scene.render(truth)
    spans.sync(dev)
    t_made = time.perf_counter()
    client = ClientSystem(cfg, device=dev)
    fps = cam["fps"]

    bas = []
    state = {"capture": False}

    def ba_capture(solve):
        def call(*a, **kw):
            res = solve(*a, **kw)
            if state["capture"]:
                bas.append((a, kw, res))
            return res
        return call

    sp = spans.Spans(cell.trace, dev)
    # K1's and K2's launches, for the roofline's bound
    launches = spans.Counters([("motioncheck_ccm_slam_tpu_torch.ops.fast_cuda",
                                k + ".launches", k) for k in roofline.FAST_KERNELS])
    counters = spans.Counters(cell.counters)

    def one_frame(k):
        n_kf = client.mapper.next_kf_id
        launches.take()
        counters.take()
        t0 = time.perf_counter()
        fr = client.process_image(frames[k], k / fps)
        spans.sync(dev)
        return {"k": k, "seconds": time.perf_counter() - t0,
                "keyframe": client.mapper.next_kf_id > n_kf,
                "ok": client.tracker.state == TrackState.OK, "frame": fr, "mp": client.map.mp,
                "spans": sp.take(), "launches": launches.take(), "counters": counters.take()}

    with spans.swapped(local_ba, "bundle_adjust", ba_capture):
        sp.wrap_declared(cell.spans)
        try:
            k, warm = 0, tr["warmup"]
            while (client.tracker.state != TrackState.OK
                   or client.mapper.next_kf_id < 2 + warm["keyframes_after_init"]):
                if k >= warm["max_frames"]:
                    raise RuntimeError(f"the agent did not initialise and make "
                                       f"{warm['keyframes_after_init']} keyframes in {k} frames")
                one_frame(k)
                k += 1
            sp.take()
            setup_s = time.perf_counter() - cell.t_start
            state["capture"] = True
            prof = spans.Profile(dev, sp.names) if cell.trace else None
            recs, first = [], k
            t0 = time.perf_counter()
            while k < len(frames):
                i = k - first
                if prof is not None and i == PROFILE_FROM:
                    prof.start()
                recs.append(one_frame(k))
                if prof is not None and i == PROFILE_FROM + PROFILE_FRAMES - 1:
                    t0 += prof.stop()
                k += 1
                if time.perf_counter() - t0 >= cell.seconds:
                    break
            window_s = time.perf_counter() - t0
            if prof is not None and prof.prof is not None:
                prof.stop()
        finally:
            sp.restore()
    memory_peak = capture_peak(dev)
    # the map's keyframes made in the window, as they stand at its close
    kf = client.map.kf
    kf_k = torch.round(kf.timestamp.double() * fps).long()
    inw = torch.nonzero(kf.valid & (kf_k >= first)).squeeze(1)
    inw = inw[torch.argsort(kf_k[inw])]
    kf_traj = (kf_k[inw].cpu().numpy(), kf.Tcw[inw].cpu())
    n = len(recs)
    lat_ms = [r["seconds"] * 1e3 for r in recs]
    out = {"attempted": n, "failed": sum(1 for r in recs if not r["ok"]),
           "memory_peak_bytes": memory_peak,
           "end_to_end": {"agent_frames_per_s": n / window_s,
                          "agent_frame_ms_p95": bench.percentile(lat_ms, 95),
                          "setup_s": setup_s},
           "info": {"frames": n, "first_frame": first, "window_s": window_s,
                    "frames_exhausted": k >= len(frames),
                    "keyframes": sum(r["keyframe"] for r in recs),
                    "frame_ms_p10_p50_p90": [bench.percentile(lat_ms, q) for q in (10, 50, 90)],
                    "ate_m": ate(recs, truth),
                    "kf_ate_m": trajectory.ate(kf_traj[1].numpy(), truth[kf_traj[0]]),
                    "setup_parts_s": {"start_to_inputs": t_in - cell.t_start,
                                      "inputs": t_made - t_in, "warmup": setup_s - (t_made - cell.t_start),
                                      "warmup_frames": first}}}
    if cell.trace:
        out["trace"] = trace_data(cell, recs, prof, frames)
        out["profile"] = prof.result if prof else None
    del client
    free_device(dev)
    out["checks"], out["checked"], more = compare(cell, frames, recs, bas, kf_traj, truth,
                                                  with_control)
    out["info"].update(more)
    ok = [r for r in recs if r["ok"]]
    out["raw"] = {"frame_k": np.array([r["k"] for r in ok]),
                  "frame_T": np.stack([r["frame"].Tcw.cpu().numpy() for r in ok]) if ok
                  else np.zeros((0, 4, 4), np.float32),
                  "kf_k": kf_traj[0], "kf_T": kf_traj[1].numpy(), "truth": truth,
                  "keyframe": np.array([r["keyframe"] for r in recs]),
                  "frame_s": np.array([r["seconds"] for r in recs])}
    return out



def trace_data(cell, recs, prof, frames) -> dict:
    """The per-layer readers' input. K1's work depends on how many pixels
    score; the plain corner score of the profiled frames' pyramids (bitwise
    K1's output) counts them."""
    units = [{"seconds": r["seconds"], "keyframe": r["keyframe"], "spans": r["spans"],
              "counters": r["counters"]} for r in recs]
    data = {"units": units}
    if prof is not None and prof.result is not None:
        ex = cell.config_data["extractor"]
        bound = 0.0
        for r in recs[PROFILE_FROM:PROFILE_FROM + PROFILE_FRAMES]:
            levels = ref_orb.pyramid(frames[r["k"]], ex)
            n_scoring = sum(int((ref_orb.corner_score(
                lv, float(ex["ini_th_fast"]), float(ex["min_th_fast"]), ex["edge_threshold"])
                > 0).sum()) for lv in levels)
            per_launch = roofline.fast_bound_s([tuple(lv.shape) for lv in levels], n_scoring)
            bound += sum(r["launches"][k] * per_launch[k] for k in roofline.FAST_KERNELS)
        kern_s = sum(s for name, (s, _) in prof.result["kernels"].items()
                     if any(sym in name for sym in roofline.FAST_SYMBOLS))
        data["roofline"] = {"bound_s": bound, "kernel_s": kern_s}
        data["busy_s"], data["window_s"] = prof.result["busy_s"], prof.result["window_s"]
    return data


def ate(recs, truth) -> float:
    """RMS camera-centre error of the window's tracked frames after a
    similarity alignment to the truth; printed, not compared (it counts the
    map's drift of scale)."""
    ok = [r for r in recs if r["ok"]]
    if len(ok) < 3:
        return float("nan")
    return trajectory.ate(torch.stack([r["frame"].Tcw for r in ok]).cpu().numpy(),
                          truth[[r["k"] for r in ok]])


def _extractor(cell):
    return cell.config_data["extractor"], cell.config_data["camera"]


def orb_numbers(prog, ref) -> tuple:
    """(largest keypoint offset in pixels, 1000 where a slot's validity or
    level differs; mean descriptor bits that differ over slots valid in
    both)."""
    same_valid = torch.equal(prog.valid, ref.valid) and torch.equal(prog.octave, ref.octave)
    both = prog.valid & ref.valid
    if not same_valid:
        xy_px = 1000.0
    else:
        xy_px = float((prog.xy - ref.xy)[both].abs().max()) if bool(both.any()) else 0.0
    bits = ref_orb.hamming(prog.desc[both], ref.desc[both]).double()
    return xy_px, float(bits.mean()) if bits.numel() else 0.0


def pose_problem(cell, fr, Xw, dev):
    cfg = cell.config_data
    ex = cfg["extractor"]
    assoc = fr.mp_idx
    ok = assoc >= 0
    inv_s2 = torch.tensor([1.0 / ex["scale_factor"] ** (2 * l) for l in range(ex["n_levels"])],
                          dtype=torch.float64, device=dev)
    n = int(ok.sum())
    c = cfg["camera"]
    K = torch.tensor([[c["fx"], 0, c["cx"]], [0, c["fy"], c["cy"]], [0, 0, 1]],
                     dtype=torch.float64, device=dev)
    p = lm.Problem(cam=torch.zeros(n, dtype=torch.int64, device=dev),
                   lm=torch.arange(n, device=dev), uv=fr.feats.xy[ok].double(),
                   info=inv_s2[fr.feats.octave[ok]], valid=torch.ones(n, dtype=torch.bool,
                                                                       device=dev),
                   K=K, fixed_cam=torch.zeros(1, dtype=torch.bool, device=dev),
                   fixed_lm=torch.ones(n, dtype=torch.bool, device=dev))
    return p, Xw[assoc[ok]]


def ba_problem(args, kw) -> tuple:
    Tcw0, Xw0, obs, K, fixed_cam = args[:5]
    ok = obs.valid
    fixed_lm = kw.get("fixed_lm")
    if fixed_lm is None:
        fixed_lm = torch.zeros(Xw0.shape[0], dtype=torch.bool, device=Xw0.device)
    p = lm.Problem(cam=obs.cam_idx[ok].long(), lm=obs.lm_idx[ok].long(), uv=obs.uv[ok].double(),
                   info=obs.inv_sigma2[ok].double(),
                   valid=torch.ones(int(ok.sum()), dtype=torch.bool, device=ok.device),
                   K=K.double(), fixed_cam=fixed_cam.clone(), fixed_lm=fixed_lm.clone())
    return p, Tcw0, Xw0, kw.get("iterations", 10), kw.get("outlier_pass_at")


def match_miss(cell, r, dtype=torch.float64) -> tuple:
    """(pairs of the plain association at the frame's pose missing from
    the program's or added in it, pairs in either) of one tracking frame,
    on the map as it stood (a tracking frame's ``process_image`` changes
    only the landmarks' visibility counts)."""
    c = cell.config_data["camera"]
    ex = cell.config_data["extractor"]
    K = torch.tensor([[c["fx"], 0, c["cx"]], [0, c["fy"], c["cy"]], [0, 0, 1]],
                     dtype=torch.float64, device=cell.device)
    ref = track_match.pairs(r["frame"].Tcw, r["mp"], r["frame"].feats, K, c["width"],
                            c["height"], ex["scale_factor"], ex["n_levels"], dtype=dtype)
    prog = track_match.program_pairs(r["frame"].mp_idx)
    return len(ref ^ prog), len(ref | prog)


def step_numbers(T, truth_T) -> tuple:
    """(worst, 90th percentile, median) of the keyframe steps' direction
    errors, and the worst rotation error, degrees."""
    if len(T) < 2:
        return 0.0, 0.0, 0.0, 0.0
    d, rot = trajectory.step_errors(T, truth_T)
    return float(d.max()), float(np.percentile(d, 90)), float(np.median(d)), float(rot.max())


def compare(cell, frames, recs, bas, kf_traj, truth, with_control):
    """(checks, checked, info); with ``with_control`` the info also holds
    the precision control's readings of each number."""
    dev, lim, tr = cell.device, cell.limits, cell.traffic
    rng = np.random.default_rng([cell.seed % (1 << 63), 31])
    ex, cam = _extractor(cell)
    info, ctrl = {}, {}
    # ORB features
    n_orb = min(tr["checks"]["orb_frames"], len(recs))
    xy_px = bits = 0.0
    cx = cb = 0.0
    for i in sorted(rng.choice(len(recs), n_orb, replace=False)):
        r = recs[i]
        img = frames[r["k"]]
        ref = ref_orb.extract(img, ex, cam)
        a, b = orb_numbers(r["frame"].feats, ref)
        xy_px, bits = max(xy_px, a), max(bits, b)
        if with_control:
            a, b = orb_numbers(ref_orb.extract(img, ex, cam, dtype=torch.bfloat16), ref)
            cx, cb = max(cx, a), max(cb, b)
    ctrl.update(orb_xy_px=cx, orb_desc_bits=cb)
    checks = [check("orb_xy_px", xy_px, lim), check("orb_desc_bits", bits, lim)]
    # tracking frames: the pose against the plain pose optimisation from it
    # on the frame's inliers (the median frame's gap and the widest), and
    # the association against the plain projection search at that pose
    tracked = [i for i, r in enumerate(recs) if r["ok"] and not r["keyframe"]
               and int((r["frame"].mp_idx >= 0).sum()) >= 6]
    n_pose = min(tr["checks"]["pose_frames"], len(tracked))
    gaps, cgaps = [], []
    miss = cmiss = both = cboth = 0
    for i in sorted(rng.choice(len(tracked), n_pose, replace=False)):
        r = recs[tracked[i]]
        p, X = pose_problem(cell, r["frame"], r["mp"].Xw, dev)
        T0 = r["frame"].Tcw[None]
        T_ref, _ = lm.bundle_adjust(T0, X, p, POSE_ITERS)
        gaps.append(lm.cost_gap(T0, X, T_ref, X, p, False)[0])
        a, b = match_miss(cell, r)
        miss, both = miss + a, both + b
        if with_control:
            T_c, _ = lm.bundle_adjust(T0, X, p, POSE_ITERS, dtype=torch.bfloat16)
            cgaps.append(lm.cost_gap(T_c, X, T_ref, X, p, False)[0])
            a, b = match_miss(cell, r, torch.bfloat16)
            cmiss, cboth = cmiss + a, cboth + b
    if with_control:
        ctrl["pose_cost_gap_p50"] = float(np.median(cgaps)) if cgaps else 0.0
        ctrl["pose_cost_gap_max"] = max(cgaps, default=0.0)
        ctrl["track_match_miss"] = cmiss / max(cboth, 1)
    checks.append(check("pose_cost_gap_p50", float(np.median(gaps)) if gaps else 0.0, lim))
    checks.append(check("pose_cost_gap_max", max(gaps, default=0.0), lim))
    checks.append(check("track_match_miss", miss / max(both, 1), lim))
    info.update(track_match_pairs=both)
    # local BAs
    n_ba = min(tr["checks"]["local_bas"], len(bas))
    gap = cgap = 0.0
    for i in sorted(rng.choice(len(bas), n_ba, replace=False)):
        args, kw, res = bas[i]
        p, T0, X0, iters, opa = ba_problem(args, kw)
        T_ref, X_ref = lm.bundle_adjust(T0, X0, p, iters, outlier_pass_at=opa)
        g, c_prog, c_ref = lm.cost_gap(res.Tcw, res.Xw, T_ref, X_ref, p, opa is not None)
        gap = max(gap, g)
        info.update(local_ba_cost_program=c_prog, local_ba_cost_reference=c_ref)
        if with_control:
            T_c, X_c = lm.bundle_adjust(T0, X0, p, iters, outlier_pass_at=opa,
                                        dtype=torch.bfloat16)
            cgap = max(cgap, lm.cost_gap(T_c, X_c, T_ref, X_ref, p, opa is not None)[0])
    ctrl["local_ba_cost_gap"] = cgap
    checks.append(check("local_ba_cost_gap", gap, lim))
    # the window's keyframe trajectory against the truth, step by step
    kf_k, kf_T = kf_traj
    steps = step_numbers(kf_T.numpy(), truth[kf_k])
    info.update(kf_step_dir_deg_max_p90_p50=list(steps[:3]), kf_step_rot_deg_max=steps[3],
                window_keyframes=len(kf_k))
    checks.append(check("kf_step_dir_deg", steps[1], lim))
    if with_control:
        c = step_numbers(kf_T.to(torch.bfloat16).float().numpy(), truth[kf_k])
        ctrl["kf_step_dir_deg"] = c[1]
        ctrl["kf_step_dir_deg_max_p90_p50"] = list(c[:3])
        info["control"] = ctrl
    info.update(orb_frames=n_orb, pose_frames=n_pose, local_bas=n_ba)
    return checks, n_orb > 0 and n_pose > 0 and n_ba > 0 and len(kf_k) > 1, info
