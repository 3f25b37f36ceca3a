"""Command-line entry points.

Counterpart of ``motioncheck_ccm_slam_tpu/cli.py``, with its subcommands,
arguments and ``stats.json`` keys, plus ``--device`` on every subcommand:
``cuda`` (the default) runs on the card and raises when there is none;
``cpu`` runs on the CPU (the tests). ``main(argv)`` takes an argument list,
so that callers can run a subcommand in process. The synthetic scene is the
port's own copy (``utils/synth_scene.py``), the map images are rasterised
with numpy (``utils/viewer.py``), and the output directories default to
the repo's ``build/cli/``.

The JAX CLI replaces the reference's ClientNode / ServerNode mains + launch
files (src/client/ClientNode.cpp, src/server/ServerNode.cpp,
cslam/launch/*): one process hosts the agents and the server synchronously
(the reference's multi-process ROS graph becomes in-memory channels; a DCN
transport slots into the same Channel interface for true multi-host runs).

Usage:
    python -m motioncheck_ccm_slam_tpu_torch.cli synth --agents 2 --frames 40 \\
        --out runs/synth
    python -m motioncheck_ccm_slam_tpu_torch.cli euroc --seq <dir with mav0> \\
        --frames 600 --out runs/mh01
    python -m motioncheck_ccm_slam_tpu_torch.cli synth --agents 2 --frames 36 \\
        --small --device cpu --out runs/cpu
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

_OUT_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "build", "cli")


def _small_preset(config):
    """Reduced shapes for CPU smoke runs (compile time, not capability)."""
    from .config import CapacityParams, ExtractorParams, PlaceRecParams

    return config.replace(
        extractor=ExtractorParams(max_features=512, n_levels=4,
                                  n_features=512),
        capacity=CapacityParams(client_max_kfs=24, client_max_mps=2048,
                                server_max_kfs=64, server_max_mps=8192),
        # short runs produce few KFs: let map matching engage early so the
        # smoke run exercises the merge path (consistency gate still applies)
        placerec=PlaceRecParams(start_map_matching_after_kf=2),
    )


def _device(args) -> torch.device:
    """The subcommand's device; ``cuda`` without a card raises (there is no
    CPU fallback)."""
    dev = torch.device(getattr(args, "device", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch.cuda.is_available() is false "
                           "(pass --device cpu to run on the CPU)")
    return dev


def _build_system(config, n_agents, device):
    from .parallel import comm as comm_mod
    from .system.client import ClientSystem
    from .system.server import ServerSystem
    from .config import SystemParams

    server = ServerSystem(config=config, n_agents=n_agents, device=device)
    clients = []
    for cid in range(n_agents):
        cfg = config.replace(sys=SystemParams(client_id=cid,
                                              n_agents=n_agents))
        c = ClientSystem(config=cfg, device=device)
        c.comm = comm_mod.ClientComm(
            config=cfg, channel=server.channel_for(cid), client_id=cid
        )
        clients.append(c)
    return server, clients


def _peak_rss_mb():
    """Process peak RSS (VmHWM) in MB; None off-Linux."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM"):
                    return round(int(line.split()[1]) / 1024.0, 1)
    except OSError:
        pass
    return None


def _finish(server, clients, out_dir, t0):
    from .utils import viewer

    os.makedirs(out_dir, exist_ok=True)
    for h in server.handlers.values():
        h.comm.idle_cycles = 10**9
        h.comm.got_data = False
    # snapshot liveness at the END OF THE RUN PROPER: clients stop beating
    # once their frame loops end, and the final GBA + export/render work
    # below is wall-clock heavy on cold caches — computing the silence
    # report after it flagged every module of a healthy run. The final GBA
    # itself stays covered: it beats the server watchdog per chunk
    # (run_gba on_chunk) and a hang there never reaches stats at all.
    watchdog_silent = (
        [m for m, _, _ in server.watchdog.silent_modules()]
        + [f"client{cid}:{m}"
           for cid, c in enumerate(clients)
           for m, _, _ in c.watchdog.silent_modules()])
    server.maybe_final_gba()
    # trajectory + map exports (reference WriteStateToCsv + RViz)
    for cid, c in enumerate(clients):
        with open(os.path.join(out_dir, f"frames_client{cid}.tum"), "w") as f:
            f.write(c.trajectory_tum())
    for cid, tum in server.trajectories_tum().items():
        with open(os.path.join(out_dir, f"KF_FINAL_{cid}.tum"), "w") as f:
            f.write(tum)
    seen = set()
    for cid, h in server.handlers.items():
        if id(h.map) in seen:
            continue
        seen.add(id(h.map))
        viewer.render_map(
            h.map, os.path.join(out_dir, f"map_{cid}.png"),
            title=f"server map (handler {cid})",
        )
        viewer.export_html(
            h.map, os.path.join(out_dir, f"map_{cid}.html"),
            title=f"server map (handler {cid})",
        )
    stats = {
        "wall_s": round(time.time() - t0, 1),
        "n_merges": server.n_merges,
        # liveness (reference mylog watchdog): modules silent > timeout,
        # snapshotted before the finish-phase work (see above)
        "watchdog_silent": watchdog_silent,
        # soak observability: host memory high-water mark + per-tick comm
        # wall time (reference output_commtime.txt) — flat tick_ms_mean and
        # bounded RSS over long runs are the host-side-growth invariants
        "peak_rss_mb": _peak_rss_mb(),
        "comm": {
            "server": {cid: h.comm.tick_stats()
                       for cid, h in server.handlers.items()},
            "clients": {cid: c.comm.tick_stats()
                        for cid, c in enumerate(clients)},
        },
        "agents": {
            cid: {
                "frames": len(c.tracker.trajectory),
                "state": c.tracker.state.name,
                "relocs": c.tracker.n_relocs,
                "client_kfs": c.map.n_kfs,
                "client_mps": c.map.n_mps,
            }
            for cid, c in enumerate(clients)
        },
        "n_gba_interrupts": server.n_gba_interrupts,
        "server_maps": [
            {"kfs": h.map.n_kfs, "mps": h.map.n_mps,
             "loops": h.loop_closer.n_loops_closed,
             "regba": h.loop_closer.n_regba}
            for h in {id(h.map): h for h in server.handlers.values()}.values()
        ],
    }
    with open(os.path.join(out_dir, "stats.json"), "w") as f:
        json.dump(stats, f, indent=2)
    print(json.dumps(stats, indent=2))
    return stats


def cmd_synth(args):
    import sys

    from .config import CameraParams, Config, MotionCheckParams

    config = Config().replace(
        camera=CameraParams(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)
    )
    if args.small:
        config = _small_preset(config)
    if not getattr(args, "motion_check", True):
        config = config.replace(
            motion_check=MotionCheckParams(enabled=False))
    from .utils.synth_scene import RingScene, SynthScene

    device = _device(args)
    t0 = time.time()
    server, clients = _build_system(config, args.agents, device)
    if getattr(args, "load_map", None):
        hid = server.add_loaded_map(args.load_map)
        print(f"mounted prior map as handler {hid}: {args.load_map} "
              f"({server.handlers[hid].map.n_kfs} KFs)")
    if getattr(args, "world", "wall") == "ring":
        # corridor-loop world: every agent starts at its own angle of the
        # SAME ring (organic revisits -> loop closures; pairwise overlap ->
        # cascaded merges). --arc-offset-deg overrides the even spacing.
        offs = (args.arc_offset_deg if args.arc_offset_deg
                else [360.0 * cid / args.agents
                      for cid in range(args.agents)])
        scenes = [
            RingScene(config, seed=3, start_deg=offs[cid])
            for cid in range(args.agents)
        ]
    else:
        scenes = [
            SynthScene(config, n_points=700, seed=3 + (0 if args.shared_world
                                                       else cid), speed=0.9)
            for cid in range(args.agents)
        ]
    blackout = None
    if args.blackout:
        a, b = args.blackout.split(":")
        blackout = (int(a), int(b))
    live = None
    if getattr(args, "live", None) is not None:
        from .utils.live_viewer import LiveViewer

        live = LiveViewer(port=args.live)
        print(f"live viewer: {live.url}")
    seqs = [list(s.sequence(args.frames)) for s in scenes]
    import numpy as np
    progress = os.environ.get("MCSLAM_PROGRESS")
    for i in range(args.frames):
        for cid, c in enumerate(clients):
            t, _, img = seqs[cid][i]
            if blackout and blackout[0] <= i < blackout[1]:
                # fault injection: featureless frames force tracking loss
                # (the reference's launch-file "Disturber" analog)
                img = np.zeros_like(img)
            c.process_image(img, t)
        server.spin_once()
        if progress and (i + 1) % 10 == 0:
            print(f"[progress] frame {i + 1}/{args.frames} "
                  f"t={time.time() - t0:.0f}s", file=sys.stderr, flush=True)
        if live is not None and i % 2 == 0:
            seen, views = set(), {}
            for cid, h in server.handlers.items():
                if id(h.map) not in seen:
                    seen.add(id(h.map))
                    views[f"server{cid}"] = h.map
            live.update(views)
    stats = _finish(server, clients, args.out, t0)
    if getattr(args, "save_map", None):
        paths = server.save_maps(args.save_map)
        print(f"saved {len(paths)} map(s) to {args.save_map}")
    # ATE vs the synthetic ground truth — the accuracy stand-in for EuRoC
    # replay (the dataset is absent here; the evaluation machinery is the
    # same Sim3-aligned ATE used by 'cli euroc')
    from .utils import csv_io
    for cid, c in enumerate(clients):
        gt_by_t = {t: Tgt for (t, Tgt, _) in seqs[cid]}
        est, gt = [], []
        for (t, Tcw), ok in zip(c.tracker.trajectory,
                                c.tracker.trajectory_ok):
            if ok and t in gt_by_t:
                est.append(np.linalg.inv(Tcw)[:3, 3])
                gt.append(np.linalg.inv(gt_by_t[t])[:3, 3])
        if len(est) >= 3:
            rmse, mx = csv_io.ate_rmse(np.stack(est), np.stack(gt))
            stats["agents"][cid]["ate_rmse_m"] = round(rmse, 4)
            stats["agents"][cid]["ate_max_m"] = round(mx, 4)
    with open(os.path.join(args.out, "stats.json"), "w") as f:
        json.dump(stats, f, indent=2)
    print(json.dumps({cid: a.get("ate_rmse_m") for cid, a in
                      stats["agents"].items()}))
    if live is not None:
        live.close()
    return stats


def cmd_serve(args):
    """Server process: listen on TCP, mirror N agents, loop-close, merge,
    final GBA (the reference's ServerNode, src/server/ServerNode.cpp)."""
    from .config import CameraParams, Config
    from .parallel.transport import ServerTransport
    from .system.server import ServerSystem

    config = Config().replace(
        camera=CameraParams(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)
    )
    if args.small:
        config = _small_preset(config)
    t0 = time.time()
    device = _device(args)
    transport = ServerTransport(host=args.host, port=args.port)
    print(f"server listening on {args.host}:{transport.port} "
          f"for {args.agents} agent(s)", flush=True)
    server = ServerSystem(config=config, n_agents=args.agents, device=device)
    for cid in range(args.agents):
        ep = transport.wait_for(cid, timeout_s=args.timeout)
        server.handlers[cid].channel = ep
        server.handlers[cid].comm.channel = ep
        server.channels[cid] = ep
        print(f"agent {cid} connected", flush=True)
    deadline = time.time() + args.timeout
    while time.time() < deadline:
        server.spin_once()
        if server.maybe_final_gba():
            break
        time.sleep(0.1)
    os.makedirs(args.out, exist_ok=True)
    from .utils import viewer
    for cid, tum in server.trajectories_tum().items():
        with open(os.path.join(args.out, f"KF_FINAL_{cid}.tum"), "w") as f:
            f.write(tum)
    seen = set()
    stats = {"wall_s": round(time.time() - t0, 1),
             "n_merges": server.n_merges,
             "final_gba_done": server.final_gba_done,
             "server_maps": []}
    for cid, h in server.handlers.items():
        if id(h.map) in seen:
            continue
        seen.add(id(h.map))
        viewer.render_map(h.map, os.path.join(args.out, f"map_{cid}.png"))
        stats["server_maps"].append({
            "kfs": h.map.n_kfs, "mps": h.map.n_mps,
            "loops": h.loop_closer.n_loops_closed,
        })
    with open(os.path.join(args.out, "stats.json"), "w") as f:
        json.dump(stats, f, indent=2)
    print(json.dumps(stats))
    transport.close()
    return stats


def cmd_agent(args):
    """Agent process: synthetic camera -> tracking -> publish to the server
    over TCP (the reference's ClientNode, src/client/ClientNode.cpp)."""
    from .config import CameraParams, Config, SystemParams
    from .parallel import comm as comm_mod
    from .parallel.transport import ClientTransport
    from .system.client import ClientSystem

    config = Config().replace(
        camera=CameraParams(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)
    )
    if args.small:
        config = _small_preset(config)
    config = config.replace(sys=SystemParams(client_id=args.id))
    from .utils.synth_scene import SynthScene

    device = _device(args)
    host, port = args.connect.rsplit(":", 1)
    transport = ClientTransport(host, int(port), args.id)
    client = ClientSystem(config=config, device=device)
    client.comm = comm_mod.ClientComm(
        config=config, channel=transport, client_id=args.id
    )
    scene = SynthScene(config, n_points=700,
                       seed=3 + (0 if args.shared_world else args.id),
                       speed=0.9)
    t0 = time.time()
    for t, _, img in scene.sequence(args.frames):
        client.process_image(img, t)
    # drain retransmits until everything is acked, then say goodbye
    for _ in range(60):
        client.comm.tick(client.map)
        if not client.comm.sent_unacked_kf and not client.comm.sent_unacked_mp:
            break
        time.sleep(0.2)
    client.comm.send_goodbye()
    stats = {
        "wall_s": round(time.time() - t0, 1),
        "state": client.tracker.state.name,
        "client_kfs": client.map.n_kfs,
        "client_mps": client.map.n_mps,
        "unacked_kf": len(client.comm.sent_unacked_kf),
    }
    print(json.dumps(stats))
    transport.close()
    return stats


def cmd_euroc(args):
    from .config import CameraParams, Config
    from .utils.euroc import EurocSequence

    config = Config()
    if getattr(args, "synth_camera", False):
        # pure-pinhole camera for synthetic ASL-format fixtures (the renderer
        # applies no lens distortion)
        config = config.replace(
            camera=CameraParams(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)
        )
    if getattr(args, "small", False):
        config = _small_preset(config)
    device = _device(args)
    t0 = time.time()
    server, clients = _build_system(config, 1, device)
    seq = EurocSequence(args.seq)
    for i, (ts, img) in enumerate(seq.frames(stop=args.frames,
                                             stride=args.stride)):
        clients[0].process_image(img, ts)
        server.spin_once()
    stats = _finish(server, clients, args.out, t0)
    _report_dataset_ate(server, config, seq, stats, args.out)
    return stats


def _report_dataset_ate(server, config, seq, stats, out):
    """ATE vs ground truth, the reference's offline evaluation of its
    KF_FINAL_* dumps (SURVEY.md §4): Sim3-align the server keyframe
    trajectory (body frame) against interpolated groundtruth positions."""
    import numpy as np

    from .utils import csv_io

    if seq.ground_truth() is None:
        return
    h = server.handlers[0]
    kf = h.map.kf
    valid = kf.valid.cpu().numpy() & (kf.client_id.cpu().numpy() == 0)
    ts_kf = kf.timestamp.cpu().numpy()[valid]
    Ts = kf.Tcw.cpu().numpy()[valid]
    order = np.argsort(ts_kf)
    rows = csv_io.trajectory_rows(
        [(float(ts_kf[i]), Ts[i]) for i in order], config
    )
    if len(rows) < 3:
        return
    stamps = np.array([r[0] for r in rows])
    est = np.stack([r[1] for r in rows])
    gt_pos = seq.gt_positions_at(stamps)
    rmse, mx = csv_io.ate_rmse(est, gt_pos)
    stats["ate_rmse_m"] = round(rmse, 4)
    stats["ate_max_m"] = round(mx, 4)
    with open(os.path.join(out, "stats.json"), "w") as f:
        json.dump(stats, f, indent=2)
    print(f"ATE RMSE {rmse*100:.2f} cm  max {mx*100:.2f} cm "
          f"over {len(rows)} KFs")


def cmd_kitti(args):
    """KITTI odometry grayscale replay at the reference's KITTI operating
    point (cslam/conf/kitti_mono.yaml / kitti_mono_half_res.yaml,
    launch/KITTI/Client0_kitti*.launch)."""
    from .config import CameraParams, KITTI_CONFIG, KITTI_HALF_RES_CONFIG
    from .utils.kitti import KittiSequence

    config = KITTI_HALF_RES_CONFIG if args.half_res else KITTI_CONFIG
    if getattr(args, "synth_camera", False):
        # pure-pinhole synthetic-fixture camera (see cmd_euroc)
        from .config import Config

        config = Config().replace(
            camera=CameraParams(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)
        )
    if getattr(args, "small", False):
        config = _small_preset(config)
    device = _device(args)
    t0 = time.time()
    server, clients = _build_system(config, 1, device)
    seq = KittiSequence(args.seq, poses=args.poses, half_res=args.half_res)
    for ts, img in seq.frames(stop=args.frames, stride=args.stride):
        clients[0].process_image(img, ts)
        server.spin_once()
    stats = _finish(server, clients, args.out, t0)
    _report_dataset_ate(server, config, seq, stats, args.out)
    return stats


def main(argv=None):
    """Parse ``argv`` (default: the command line), run the subcommand and
    return what it returns (its stats, where it has any)."""
    p = argparse.ArgumentParser(prog="motioncheck_ccm_slam_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("synth", help="synthetic multi-agent run")
    ps.add_argument("--agents", type=int, default=1)
    ps.add_argument("--frames", type=int, default=30)
    ps.add_argument("--out", default=os.path.join(_OUT_ROOT, "synth"))
    ps.add_argument("--shared-world", action=argparse.BooleanOptionalAction,
                    default=True)
    ps.add_argument("--blackout", default=None, metavar="A:B",
                    help="zero out frames [A, B) to force tracking loss")
    ps.add_argument("--world", choices=["wall", "ring"], default="wall",
                    help="ring = corridor-loop world (organic loop closures"
                         " + cascaded merges)")
    ps.add_argument("--arc-offset-deg", type=float, nargs="*", default=None,
                    help="per-agent ring start angles (default: even)")
    ps.add_argument("--motion-check", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="--no-motion-check disables the GBA Motion Check")
    ps.add_argument("--small", action="store_true",
                    help="reduced feature/capacity preset for CPU smoke runs")
    ps.add_argument("--live", type=int, default=None, metavar="PORT",
                    help="serve a live 3D map view on this port (0 = auto)")
    ps.add_argument("--save-map", default=None, metavar="DIR",
                    help="persist final server map(s) (ccmslam_savemap)")
    ps.add_argument("--load-map", default=None, metavar="NPZ",
                    help="preload a saved map for agent 0 (LoadMap param)")
    ps.set_defaults(fn=cmd_synth)
    pv = sub.add_parser("serve", help="server process (TCP, multi-process)")
    pv.add_argument("--host", default="127.0.0.1")
    pv.add_argument("--port", type=int, default=0)
    pv.add_argument("--agents", type=int, default=1)
    pv.add_argument("--timeout", type=float, default=3600.0)
    pv.add_argument("--out", default=os.path.join(_OUT_ROOT, "server"))
    pv.add_argument("--small", action="store_true")
    pv.set_defaults(fn=cmd_serve)
    pa = sub.add_parser("agent", help="agent process (TCP, multi-process)")
    pa.add_argument("--connect", required=True, metavar="HOST:PORT")
    pa.add_argument("--id", type=int, default=0)
    pa.add_argument("--frames", type=int, default=30)
    pa.add_argument("--shared-world", action=argparse.BooleanOptionalAction,
                    default=True)
    pa.add_argument("--small", action="store_true")
    pa.set_defaults(fn=cmd_agent)
    pe = sub.add_parser("euroc", help="EuRoC sequence replay")
    pe.add_argument("--seq", required=True, help="sequence dir (contains mav0)")
    pe.add_argument("--frames", type=int, default=None)
    pe.add_argument("--stride", type=int, default=1)
    pe.add_argument("--out", default=os.path.join(_OUT_ROOT, "euroc"))
    pe.add_argument("--small", action="store_true",
                    help="reduced feature/capacity preset for CPU smoke runs")
    pe.add_argument("--synth-camera", action="store_true",
                    help="zero-distortion pinhole (for synthetic fixtures)")
    pe.set_defaults(fn=cmd_euroc)
    pk = sub.add_parser("kitti", help="KITTI odometry sequence replay")
    pk.add_argument("--seq", required=True,
                    help="sequence dir (contains image_0, times.txt)")
    pk.add_argument("--poses", default=None,
                    help="ground-truth poses file (default: "
                         "../../poses/NN.txt next to the sequence)")
    pk.add_argument("--half-res", action="store_true",
                    help="half-resolution operating point "
                         "(kitti_mono_half_res.yaml)")
    pk.add_argument("--frames", type=int, default=None)
    pk.add_argument("--stride", type=int, default=1)
    pk.add_argument("--out", default=os.path.join(_OUT_ROOT, "kitti"))
    pk.add_argument("--small", action="store_true",
                    help="reduced capacities for CPU-scale smoke runs")
    pk.add_argument("--synth-camera", action="store_true",
                    help="use the synthetic-fixture camera (tests)")
    pk.set_defaults(fn=cmd_kitti)
    for sp in (ps, pv, pa, pe, pk):
        sp.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
