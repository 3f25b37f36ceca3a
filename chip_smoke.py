"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main paths through their entry points, in phases.
The client tracking step at the EuRoC operating point (752x480, 8 pyramid
levels, 1024 feature slots, an 8192-landmark map):

1. check for a GPU and print its name and power limit;
2. build the CUDA kernels (csrc/fast.cu and csrc/schur.cu), one nvcc for
   each source, started together;
3. K1 (masked_corner_score_levels, one launch over all 8 levels) against
   its plain version on every level, on a rendered frame and on a random
   image: bitwise; and the one-level masked_corner_score at one odd shape;
4. K2 (blur_and_moments_levels, one launch over all 8 levels) likewise,
   on every level: blur within 1e-3, moments within 1.0; and the one-level
   blur_and_moments at one odd shape;
5. track 20 rendered frames with the port's Tracker; every frame keeps
   >= 15 inliers, the final camera-centre error is within 0.10 m of the
   truth, K1 and K2 were launched 20 times each (once a frame);
6. time the step with the kernels and with their plain versions, and each
   kernel alone against its plain version, its bound and a library call
   (K1 and K2 a frame in one launch each, and each level alone through
   the one-level wrappers).

The server's tile-stream GBA at the operating point of bench.py:bench_gba
(2048 keyframes, 65,536 landmarks, 2,048,000 observations):

7. print csrc/schur.cu's ptxas report (built in phase 2);
8. K3-K7 against their plain versions at these shapes, from a seeded
   perturbation of the problem (cameras 1.. by 0.005 rad / 0.04 m, points
   by 0.05 m): one K3 pass, then K5, K4, K6 and K7 on its W stream with a
   seeded v and u;
9. 10 LM iterations from the perturbed start with the kernels and with
   their plain versions: both lower the robust cost and agree (cost within
   1e-3 relative, Tcw within 1e-3, Xw within 5e-3); launches K3 = 11,
   K5 = K6 = K7 = 10, K4 >= 10;
10. LM iterations/s on bench_gba's exact problem (1-iteration warm-up,
    then 10 iterations), each of K3-K7 alone against its plain version, its
    bound and a library call; K3's, K4's, K5's and K7's launch geometry;
    K3, K4, K5, K6, K7 and the plan-form apply_a, apply_b and schur_apply
    at the edge shapes of EDGE_CASES (C up to 12,000, TP from 128 to
    25,600, a tile of pad slots only), each called twice, within 1e-4 of
    max-abs of the plain version and of each other (K3 part by part, its
    per-slot outputs bitwise equal between the calls; whether K6's two
    calls are bitwise equal is printed); and a torch.profiler split of one
    iteration.

The dual-layout matrix-free GBA on the same problem (entry.
matrix_free_gba_entry; its plan has the tile plan's 2,162,688 slots):

11. K9 (expand_sorted_streams) against its plain version, bitwise; the
    plan-form apply_a, apply_b and schur_apply within 1e-4 of each output's
    max-abs; K8 (d0_cost) within 1e-5 relative of its plain version and of
    the sum of K3's per-slot cost on the same state, two calls bitwise
    equal (K8 sums in a fixed order);
12. 10 LM iterations from phase 9's perturbed start with the kernels and
    with their plain versions, each priced by K8: both lower the robust
    cost and land within phase 9's bounds of each other and of the tile
    GBA's result; launches K9 = apply_a = apply_b = 10, schur_apply >= 10
    (one a PCG sweep); LM iterations/s on bench_gba's problem with the PCG
    sweep count; each of K8, K9 and the plan-form products alone against
    its plain version, its bound and a library call; a profiler split.

The Motion-Check-gated GBA driver (entry.server_gba_entry) on a server map
at capacity (2048 keyframes x 1024 features, 65,536 landmarks, 4 clients):

13. the driver picks the tile-stream GBA; (a) an honest 20-iteration GBA
    in chunks of 5 is neither reverted nor deletes a keyframe; (b) a GBA
    that kicks a band of 64 of client 0's keyframes 1 m sideways is
    reverted (or deletes >= 3 keyframes) by Motion Check, keeping client
    0's ATE below 0.1x its ATE without Motion Check, which exceeds 0.3 m;
    (c) (b) with the matrix-free GBA as the driver's solver. Each case's
    seconds split into solver (and its host-built plan), Motion Check and
    the rest of the driver.

The agent from a blank map (system/client.ClientSystem at the EuRoC
operating point: 752x480, 8 levels, 1024 feature slots, a client map of
96 keyframes x 8192 landmarks):

14. feed 60 frames of phase 5's rendered wall, given a relief of +-0.4 m
    (relocalization's DLT-PnP, as the JAX package's, finds no pose on
    coplanar landmarks), frames 40-43 zeroed (a
    blackout; it moves later, up to 80 frames in all, until the map holds
    6 keyframes, since with 5 or fewer a loss resets the map) to
    ClientSystem.process_image: two-view initialization, tracking,
    keyframes with local mapping and local BA, relocalization. Gates: OK
    by frame 10; every frame after initialization OK but the blackout and
    at most 5 frames after it; >= 6 keyframes before the blackout; a
    relocalization; >= 300 landmarks; check_structure clean; the
    Sim3-aligned ATE of the OK frames <= 0.10 m; K1 and K2 launched once a
    frame, blackout frames included. Prints each frame, and the median ms
    of a tracking frame and of a keyframe frame (tracking, mapping, local
    BA), the initialization frame's ms with its batched SVDs' share, and
    the relocalization frame's ms (not gated).

The server (system/server.ServerSystem, per-agent maps of 2048 keyframes
x 65,536 landmarks) with two agents (ClientSystem + parallel/comm.
ClientComm on the server's channels, in process):

15. both agents on phase 14's relief wall, agent 1 0.3 m to the side,
    DEFAULT_CONFIG but map matching from keyframe 2 (not 30), a server spin
    after each pair of frames until 5 frames after the merge (at most 100),
    then three flush ticks and the final GBA with the agents idle. Gates:
    both agents OK; one merge; both handlers on one map holding client ids
    {0, 1}; _pick_solver at this capacity is the tile GBA and the merge GBA
    launched K3-K7; check_structure clean; each agent's keyframes and both
    together within 0.10 m Sim3-aligned ATE; the final GBA once; K1 and K2
    once a frame of each agent. Prints the frame medians, spin_once's
    median, maximum and host synchronisations, the merge's seconds by part
    and the final GBA's seconds and Motion Check verdict.
16. tests/test_loop_closing's drifted revisit (an arc of 6 poses passed
    twice, the second drifted by se3_exp(0, 0.026, 0, 0.15, 0.05, 0)),
    built with numpy in a server-capacity map; a LoopCloser with its GBA
    over both passes. Gates: a loop closed, its edges at both ends, the
    loop GBA on the tile GBA with K3-K7 launched, the revisit's centre
    errors below 0.08 m (least) and 0.16 m (mean). Prints the seconds of
    detection, compute_sim3, correct_loop, the essential graph and the GBA.

The command line (cli.py: the entry points a user runs), at full width
unless it says --small:

17. in process, ``cli synth --agents 2 --frames 36`` (DEFAULT_CONFIG on
    the pinhole camera, utils/synth_scene.SynthScene, map matching from
    keyframe 30, so no merge): both agents OK, each agent's ATE <= 0.10 m,
    no silent watchdog module, the final GBA once with K3-K7 launched, K1
    and K2 once a frame of each agent, and its files (stats.json,
    frames_client{0,1}.tum, KF_FINAL_*.tum, map_*.html, a map_*.png that
    utils/png decodes); then the JAX fixture ``synth --agents 2 --frames
    36 --small --save-map``: one merge, both agents OK, each ATE <= 0.10 m,
    no silent module; then ``synth --agents 1 --frames 12 --small
    --load-map`` of the saved map: it mounts as handler 1 with the saved
    keyframe count. Prints the frame medians and the final GBA's seconds.
18. ``cli serve --agents 2 --port 0`` and two ``cli agent --id {0,1}
    --frames 36``, three processes on the one card under ``timeout`` (the
    port read from the server's "listening" line): the server's final GBA
    done with K3-K7 launched, each agent OK with every keyframe acked and
    K1/K2 once a frame, the server holding at least the agents' keyframes
    less 2, no CRC error, every process exiting 0. Prints the bytes on the
    wire a keyframe and a keyframe message, and each process's seconds.

The multi-device GBA (parallel/sharded_ba.Shards: shards of the tile or
observation axis, reduced on the first device in shard order and over a
torch.distributed group), on the one card:

19. from phase 9's perturbed start of bench_gba's problem, 10 LM
    iterations each: (a) make_tile_gba over 2 and 4 shards on this card:
    within phase 9's bounds of phase 9's one-device result; launches K3 =
    11n, K5 = K6 = K7 = 10n, K4 a multiple of n (n x the sweeps); LM it/s
    printed beside phases 9 and 10 (not gated). (b) two processes
    (gba_child) sharing the card over a gloo group joined through a
    FileStore, one shard each, under ``timeout``: each within the bounds of
    (a)'s 2-shard result, with the full Xw and inlier mask, both ranks the
    same PCG sweep count; beside them one process in an NCCL group of one,
    one LM iteration, within the bounds of the one-device iteration. (c)
    make_sharded_gba (the gather formulation, plain torch) over 2 shards:
    within the bounds of phase 9's result; it/s printed. (d)
    entry.dryrun_multichip over 2 shards at utils/bigmap's scale (the tile
    GBA over the shards and on one device at 256 KFs x 8192 landmarks x
    256 observations, the gather formulation at 1024 x 32,768 x 1024; 20
    LM iterations in chunks of 5 through GBAJob): each finite, its mean
    pose error below the start's. (e) _pick_solver's route with this
    machine's card count (one card: the one-device tile GBA).
20. tests/test_four_agents.py's scene at full width: four agents
    (DEFAULT_CONFIG on the pinhole camera, phase 15's one cut: map
    matching from keyframe 2; server maps 2048 x 65,536) on offset views
    of one SynthScene world (0.12 m x the client id), 32 frames each, a
    server spin a round, four flush rounds, then FINALBA. Gates: every
    agent OK; _pick_solver at this capacity is the tile GBA; three merges,
    each with one GBA launching K3-K7; every handler on one map holding
    client ids {0..3}; FINALBA fires once over it, launching K3-K7, and
    not again, no loop closer re-armed; every agent's keyframes in the
    fused map, its path spanning the shared x axis; K1 and K2 once a frame
    of each agent. Prints the frame medians, each merge's seconds and its
    GBA's, and FINALBA's seconds.

Each phase prints its own seconds. Prints a JSON line of step results,
one of GBA results, one each of the matrix-free GBA's, the driver's, the
agent's, the merge's, the loop's, the CLI's, the TCP run's, the shards'
and the four agents' results, one of each phase's seconds, one of kernel results, the card's name and power
limit and, last, the contract line ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero; without a GPU it exits non-zero before
printing any result.

Usage: python3 chip_smoke.py
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

N_FRAMES = 20
MIN_INLIERS = 15
MAX_FINAL_ERR_M = 0.10
K2_ATOL = (1e-3, 1.0, 1.0)   # blur, m10, m01
K2_ODD_SHAPE = (97, 131)     # the one-level wrappers' shape in phases 3 and 4
GBA_ITERS = 10
GBA_BOUNDS = dict(cost_rtol=1e-3, Tcw_atol=1e-3, Xw_atol=5e-3)
# K3-K7 against their plain versions, relative to each output's max-abs:
# 1e-4 for sums taken by atomics in no fixed order and for FMA contraction;
# 1e-3 for what is computed from a residual (rho, chi2, bl, bc), which is
# ~1e3 times smaller than the projection it is taken from.
SUM_RTOL, RESIDUAL_RTOL = 1e-4, 1e-3
# The card's published peaks (SXM part, 700 W): HBM bytes/s, f32 flop/s
# outside the tensor cores.
PEAK_BYTES_PER_S, PEAK_F32_PER_S = 3.35e12, 67e12
PKG = "motioncheck_ccm_slam_tpu_torch"
SOURCE = {
    "masked_corner_score": f"{PKG}/csrc/fast.cu",
    "blur_and_moments": f"{PKG}/csrc/fast.cu",
    "d1_assemble": f"{PKG}/csrc/schur.cu",
    "s_apply": f"{PKG}/csrc/schur.cu",
    "d2_precond": f"{PKG}/csrc/schur.cu",
    "apply_a_raw": f"{PKG}/csrc/schur.cu",
    "apply_b_raw": f"{PKG}/csrc/schur.cu",
    "d0_cost": f"{PKG}/csrc/schur.cu",
    "expand_sorted_streams": f"{PKG}/csrc/schur.cu",
    "apply_a": f"{PKG}/csrc/schur.cu",
    "apply_b": f"{PKG}/csrc/schur.cu",
    "schur_apply": f"{PKG}/csrc/schur.cu",
}
REPLACES = {
    "masked_corner_score": "motioncheck_ccm_slam_tpu/ops/fast_pallas.py:297",
    "blur_and_moments": "motioncheck_ccm_slam_tpu/ops/fast_pallas.py:256",
    "d1_assemble": "motioncheck_ccm_slam_tpu/ops/schur_pallas.py:893",
    "s_apply": "motioncheck_ccm_slam_tpu/ops/schur_pallas.py:1033",
    "d2_precond": "motioncheck_ccm_slam_tpu/ops/schur_pallas.py:919",
    "apply_a_raw": "motioncheck_ccm_slam_tpu/ops/schur_pallas.py:990",
    "apply_b_raw": "motioncheck_ccm_slam_tpu/ops/schur_pallas.py:1012",
    "d0_cost": "motioncheck_ccm_slam_tpu/ops/schur_pallas.py:937",
    "expand_sorted_streams": "motioncheck_ccm_slam_tpu/ops/schur_pallas.py:344",
    "apply_a": "motioncheck_ccm_slam_tpu/ops/schur_pallas.py:377",
    "apply_b": "motioncheck_ccm_slam_tpu/ops/schur_pallas.py:408",
    "schur_apply": "motioncheck_ccm_slam_tpu/ops/schur_pallas.py:423",
}
GBA_KERNELS = ("d1_assemble", "s_apply", "d2_precond", "apply_a_raw", "apply_b_raw")
# the matrix-free GBA's kernels (K8 prices its states; it is on no solver path)
MF_KERNELS = ("expand_sorted_streams", "apply_a", "apply_b", "schur_apply")
# each wrapper's __global__ function in csrc/schur.cu, as the profiler names it;
# camera_sum_kernel is the finishing pass of K3, K4, K5 and K7
KERNEL_SYMBOL = {"d1_assemble": "d1_assemble_kernel", "s_apply": "s_apply_kernel",
                 "d2_precond": "d2_precond_kernel", "apply_a_raw": "apply_a_kernel",
                 "apply_b_raw": "apply_b_kernel", "camera_sums": "camera_sum_kernel"}
# the matrix-free GBA's kernels by CUDA name: apply_a_kernel (K6) runs for
# apply_a and for each schur_apply, apply_b_kernel (K7) and its finishing
# pass for apply_b and each schur_apply
MF_SYMBOL = {"K9": "expand_streams_kernel", "K6": "apply_a_kernel", "K7": "apply_b_kernel",
             "K7_finish": "camera_sum_kernel"}
# the driver phase: a band of client 0's keyframes kicked sideways by a
# corrupted GBA, and the outcome bounds of tests/test_mc_gating.py
KICK_SLOTS = range(200, 264)
MC_ATE_RATIO, NO_MC_MIN_ATE_M = 0.1, 0.3
# phase 14, the agent from a blank map: a 4-frame blackout from frame 40 (or
# the first frame after it whose map holds 6 keyframes: with 5 or fewer a
# loss resets the map instead of relocalizing), then 16 frames, at most 80
# frames in all; its gates
AGENT_BLACKOUT_AT, AGENT_BLACKOUT, AGENT_AFTER, AGENT_MAX_FRAMES = 40, 4, 16, 80
AGENT_MIN_KFS, AGENT_INIT_BY, AGENT_RECOVERY = 6, 10, 5
AGENT_MIN_MPS, AGENT_MAX_ATE_M = 300, 0.10
# phase 14's wall relief (+-0.4 m at 4 m, a 4 m pitch): the DLT-PnP of
# relocalization finds no pose on a flat wall
AGENT_RELIEF_M, RELIEF_PITCH = 0.4, 4.0
# phase 15, two agents merge: agent 1 on phase 14's wall 0.3 m to the side;
# map matching from keyframe 2 (tests/test_multi_agent.py's value; the
# default 30 would put the merge ~200 frames in); 5 frames after the merge,
# at most 100 frames an agent; the fused ATE bound
MERGE_OFFSET_Y, MERGE_START_AFTER_KF, MERGE_AFTER, MERGE_MAX_FRAMES = 0.3, 2, 5, 100
MERGE_MAX_ATE_M = 0.10
# phase 16, loop closing: tests/test_loop_closing.test_drift_removed's limits
LOOP_MIN_ERR_M, LOOP_MEAN_ERR_M = 0.08, 0.16
# phases 17-18, the command line: frames an agent (the JAX fixture's 36),
# the --load-map run's frames, the ATE bound, each process's time limit;
# the CLI's outputs go under build/
CLI_FRAMES, CLI_LOAD_FRAMES, CLI_MAX_ATE_M, CLI_PROC_TIMEOUT_S = 36, 12, 0.10, 300
# phase 19, the multi-device GBA: each rank's time limit
SHARD_CHILD_TIMEOUT_S = 300
# phase 20: tests/test_four_agents.py's agents and frames (its scene at full width)
FOUR_AGENTS, FOUR_AGENT_FRAMES = 4, 32
ROOT = os.path.dirname(os.path.abspath(__file__))
CLI_DIR = os.path.join(ROOT, "build", "chip_smoke_cli")
FAST_LEVEL_KERNELS = {"masked_corner_score": "masked_corner_score_levels",
                      "blur_and_moments": "blur_and_moments_levels"}


# The camera-table kernels' edge shapes (K3, K4, K5, K7): (name, C, L,
# observations a landmark, observed landmark tiles or None for all). C = 5,
# 130, 2048 and 12,000 (whose camera tables fit no block's shared memory:
# the kernels split the cameras into ranges, and K4 gathers v from L2); TP =
# 128, 4224 and 25,600 (a tile too wide for 8 blocks to stage: K4 reads
# part of it twice); a tile of pad slots only.
EDGE_CASES = (
    ("c5_tp128", 5, 300, 1, None),
    ("c130_tp128_pad_tile", 130, 384, 1, (0, 2)),
    ("c2048_tp4224", 2048, 256, 33, None),
    ("c12000_tp4224", 12000, 256, 33, None),
    ("c2048_tp25600", 2048, 200, 200, None),
)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


class PlaneScene:
    """A textured wall at ``depth`` metres, seen through the EuRoC camera
    (lens distortion included) as it translates sideways ~5 px a frame.

    The wall holds a low-frequency background and anti-aliased blobs on a
    jittered grid, all painted in wall coordinates, so every rendered
    pixel is a known point of the wall. With ``relief`` > 0 the wall is
    not flat: its depth varies by +-relief metres (a product of sines of
    RELIEF_PITCH metres along x and y). Relocalization needs that: its
    DLT-PnP (ops/ransac.pnp_ransac, as the JAX package's) is degenerate on
    coplanar landmarks. ``offset_y`` moves the whole path sideways (a
    second agent's view of the same wall).
    """

    def __init__(self, cam, seed: int = 0, depth: float = 4.0, step: float = 0.045,
                 relief: float = 0.0, offset_y: float = 0.0):
        rng = np.random.default_rng(seed)
        self.cam, self.depth, self.step, self.relief = cam, depth, step, relief
        self.offset_y = offset_y
        h, w = cam.height, cam.width
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        xd, yd = (xx - cam.cx) / cam.fx, (yy - cam.cy) / cam.fy
        x, y = xd.copy(), yd.copy()
        for _ in range(20):     # invert the radtan model per pixel
            r2 = x * x + y * y
            radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
            dx = x * radial + 2 * cam.p1 * x * y + cam.p2 * (r2 + 2 * x * x)
            dy = y * radial + cam.p1 * (r2 + 2 * y * y) + 2 * cam.p2 * x * y
            x, y = x + (xd - dx), y + (yd - dy)
        self.rays = x, y
        self.origin = np.array([-6.0, -5.0])          # wall extent 16 x 10 m
        self.bg_cell = 0.25
        self.bg = rng.uniform(70.0, 150.0, (41, 65))
        self.g = 0.12                                  # blob grid pitch
        gy, gx = int(10 / self.g) + 1, int(16 / self.g) + 1
        self.has = rng.random((gy, gx)) < 0.6
        self.off = rng.uniform(-0.02, 0.02, (gy, gx, 2))
        self.rad = rng.uniform(0.016, 0.03, (gy, gx))
        self.val = np.where(rng.random((gy, gx)) < 0.4, rng.uniform(20, 90, (gy, gx)),
                            rng.uniform(150, 250, (gy, gx)))

    def center(self, k: int) -> np.ndarray:
        return np.array([self.step * k, self.offset_y + 0.01 * np.sin(0.3 * k), 0.0])

    def pose(self, k: int) -> np.ndarray:
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = -self.center(k)
        return T

    def wall_depth(self, x, y):
        """The wall's depth at world (x, y)."""
        return self.depth + self.relief * (np.sin(2 * np.pi * x / RELIEF_PITCH)
                                           * np.cos(2 * np.pi * y / RELIEF_PITCH))

    def render(self, k: int) -> np.ndarray:
        C = self.center(k)
        s = self.depth - C[2]
        if self.relief:
            # each pixel's ray meets the wall at depth s: a fixed-point
            # iteration, contracting by <= 0.52 a step at this relief
            for _ in range(16):
                s = self.wall_depth(C[0] + s * self.rays[0], C[1] + s * self.rays[1]) - C[2]
        px = C[0] + s * self.rays[0] - self.origin[0]
        py = C[1] + s * self.rays[1] - self.origin[1]
        u, v = px / self.bg_cell, py / self.bg_cell
        u0, v0 = np.floor(u).astype(int), np.floor(v).astype(int)
        fu, fv = u - u0, v - v0
        b = self.bg
        img = (b[v0, u0] * (1 - fu) * (1 - fv) + b[v0, u0 + 1] * fu * (1 - fv)
               + b[v0 + 1, u0] * (1 - fu) * fv + b[v0 + 1, u0 + 1] * fu * fv)
        i, j = np.floor(px / self.g).astype(int), np.floor(py / self.g).astype(int)
        cx = (i + 0.5) * self.g + self.off[j, i, 0]
        cy = (j + 0.5) * self.g + self.off[j, i, 1]
        d = np.hypot(px - cx, py - cy)
        m_per_px = s / self.cam.fx
        alpha = np.clip((self.rad[j, i] - d) / m_per_px + 0.5, 0.0, 1.0) * self.has[j, i]
        return (img * (1 - alpha) + self.val[j, i] * alpha).astype(np.float32)


def build_map(feats, scene, cfg, device):
    """Landmarks from frame 0's features back-projected onto the wall,
    padded to the client map capacity."""
    from motioncheck_ccm_slam_tpu_torch.models.map_state import empty_mp_block
    from motioncheck_ccm_slam_tpu_torch.ops import orb

    cam = cfg.camera
    v = torch.nonzero(feats.valid).squeeze(1)
    uv = feats.xy[v]
    C0 = torch.tensor(scene.center(0), dtype=torch.float32, device=device)
    ray = torch.stack([(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy,
                       torch.ones_like(uv[:, 0])], -1)
    Xw = C0 + (scene.depth - C0[2]) * ray
    dist = torch.linalg.norm(Xw - C0, dim=-1)
    sf = torch.from_numpy(orb.scale_factors(cfg.extractor)).to(device)
    level = sf[feats.octave[v]]
    n = v.numel()
    mp = empty_mp_block(cfg.capacity.client_max_mps, device)
    mp.Xw[:n] = Xw
    mp.desc[:n] = feats.desc[v]
    mp.normal[:n] = (Xw - C0) / dist[:, None]
    mp.max_dist[:n] = dist * level * 1.2
    mp.min_dist[:n] = dist * level / sf[-1] * 0.8
    mp.mp_id[:n] = torch.arange(n, dtype=torch.int32, device=device)
    mp.valid[:n] = True
    return mp, n


_SLEEP_CYCLES_PER_MS = []


def _sleep_cycles_per_ms() -> float:
    """Cycles of ``torch.cuda._sleep`` per device millisecond, timed once."""
    if not _SLEEP_CYCLES_PER_MS:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS.append(10_000_000 / start.elapsed_time(end))
    return _SLEEP_CYCLES_PER_MS[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps, by CUDA events. The
    device first sleeps for a little longer than the host took over one
    call, reps times, so that the host queues the calls before the start
    event runs: the events then time the device's work, not the host's
    launches (which outlast short kernels)."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms_one = (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.2 * reps * host_ms_one + 1.0, 2000.0) * _sleep_cycles_per_ms()))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> list:
    """Per-call host milliseconds of fn() ending in a device synchronize."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


@contextlib.contextmanager
def plain_kernels():
    """Route the extractor's K1/K2 calls to their plain versions (on CUDA
    tensors), for timing the step without the kernels."""
    from motioncheck_ccm_slam_tpu_torch.ops import fast_cuda

    saved = fast_cuda.masked_corner_score_levels, fast_cuda.blur_and_moments_levels
    fast_cuda.masked_corner_score_levels = fast_cuda.masked_corner_score_levels_ref
    fast_cuda.blur_and_moments_levels = fast_cuda.blur_and_moments_levels_ref
    try:
        yield
    finally:
        fast_cuda.masked_corner_score_levels, fast_cuda.blur_and_moments_levels = saved


def bound_ms(n_bytes: float, n_ops: float):
    """(least ms the card could take, "bytes" or "operations"): the larger
    of the bytes over the memory rate and the f32 operations over the f32
    rate."""
    t_b, t_o = n_bytes / PEAK_BYTES_PER_S * 1e3, n_ops / PEAK_F32_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def relmax(a, b) -> float:
    return float((a - b).abs().max() / (b.abs().max() + 1e-6))


def turns_ms(kern, plain, k_reps: int, p_reps: int):
    """(kernel ms, plain ms) by CUDA events, in turns plain, kernel,
    kernel, plain."""
    kern(), plain()
    torch.cuda.synchronize()
    p1 = cuda_ms(plain, p_reps)
    k1 = cuda_ms(kern, k_reps)
    k2 = cuda_ms(kern, k_reps)
    p2 = cuda_ms(plain, p_reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


@contextlib.contextmanager
def plain_gba_kernels(names=GBA_KERNELS):
    """Route the named schur_cuda wrappers (K3-K7 by default) to their plain
    versions (on CUDA tensors), for a GBA run without the kernels. Yields
    name -> number of plain-version calls in the block (for s_apply and
    schur_apply: the PCG sweeps)."""
    from motioncheck_ccm_slam_tpu_torch.ops import schur_cuda

    saved = {n: getattr(schur_cuda, n) for n in names}
    calls = dict.fromkeys(names, 0)

    def counted(n):
        ref = getattr(schur_cuda, n + "_ref")

        def call(*a, **kw):
            calls[n] += 1
            return ref(*a, **kw)
        return call

    for n in names:
        setattr(schur_cuda, n, counted(n))
    try:
        yield calls
    finally:
        for n, f in saved.items():
            setattr(schur_cuda, n, f)


def zero_launches(names) -> None:
    from motioncheck_ccm_slam_tpu_torch.ops import schur_cuda

    for n in names:
        getattr(schur_cuda, n).launches = 0


def read_launches(names) -> dict:
    from motioncheck_ccm_slam_tpu_torch.ops import schur_cuda

    return {n: getattr(schur_cuda, n).launches for n in names}


def k2_library_weight(device):
    """K2's three maps as one 31x31, 3-channel F.conv2d weight: the blur's
    7x7 outer product centred, each moment map's low-rank factors summed."""
    from motioncheck_ccm_slam_tpu_torch.ops import fast_cuda

    host, r = fast_cuda.k2_taps()
    taps = torch.from_numpy(host).to(device)
    kb = taps[:7]
    kh = taps[7:7 + 62 * r].reshape(2 * r, 31)
    kv = taps[7 + 62 * r:].reshape(2 * r, 31)
    w = torch.zeros((3, 1, 31, 31), device=device)
    w[0, 0, 12:19, 12:19] = kb[:, None] * kb[None, :]
    w[1, 0] = kv[:r].T @ kh[:r]
    w[2, 0] = kv[r:].T @ kh[r:]
    return w, r


def edge_case(C: int, L: int, per_lm: int, tiles, device, seed: int = 0,
              state: bool = False):
    """A problem of the camera-table kernels from a numpy seed: each
    observed landmark (those of ``tiles``, or all L) seen by per_lm distinct
    random cameras, in the plan of ``schur_cuda.build_schur_plan`` (so TP =
    128 per_lm); a random W stream, zero at pad slots and at 10% of the
    others; an SPD Hll^-1 (H9); a v and a u. Returns (plan on the device,
    W18, H9, v, u) and, with ``state``, K3's arguments after the plan's ids
    from the same generator: (uv, is2, valid, free, kp, pose, X).

    K3's state: cameras 0.05 rad and 0.5 m from the origin looking down +z,
    points 4-8 m ahead (3% of them behind the cameras), EuRoC intrinsics;
    each slot's uv its projection plus 2 px of noise, 10% of them 30 px
    off (the Huber branch); is2 of 8 pyramid levels; 5% of the observations
    invalid, pads invalid; camera 0 and every 17th landmark fixed."""
    from motioncheck_ccm_slam_tpu_torch.ops import schur_cuda

    rng = np.random.default_rng(seed)
    lms = np.arange(L) if tiles is None else np.concatenate(
        [np.arange(t * 128, min(L, (t + 1) * 128)) for t in tiles])
    cam = np.concatenate([np.sort(rng.choice(C, per_lm, replace=False)) for _ in lms])
    plan = schur_cuda.build_schur_plan(np.repeat(lms, per_lm), cam, L)
    OP = plan.ntl * plan.TP
    pad = plan.perm == cam.shape[0]
    W = rng.normal(0, 1, (18, OP)).astype(np.float32)
    W[:, pad | (rng.uniform(size=OP) < 0.1)] = 0.0
    Q = rng.normal(0, 0.05, (plan.L_pad, 3, 3))
    H = np.eye(3) * rng.uniform(0.2, 2.0, (plan.L_pad, 1, 1)) + Q @ Q.transpose(0, 2, 1)
    H9 = np.ascontiguousarray(H.reshape(-1, 9).T)
    v = rng.normal(0, 1, (C, 6))
    u = rng.normal(0, 1, (3, plan.L_pad))
    arrays = (W, H9, v, u)
    if state:
        w = rng.normal(0, 0.05, (C, 3))                  # Rodrigues, per camera
        th = np.linalg.norm(w, axis=1)[:, None, None]
        Kx = np.zeros((C, 3, 3))
        Kx[:, 0, 1], Kx[:, 0, 2], Kx[:, 1, 2] = -w[:, 2], w[:, 1], -w[:, 0]
        Kx -= Kx.transpose(0, 2, 1)
        R = np.eye(3) + np.sin(th) / th * Kx + (1 - np.cos(th)) / th ** 2 * Kx @ Kx
        t = rng.uniform(-0.5, 0.5, (C, 3))
        X = np.stack([rng.uniform(-3, 3, plan.L_pad), rng.uniform(-3, 3, plan.L_pad),
                      rng.uniform(4, 8, plan.L_pad)], 1)
        X[rng.uniform(size=plan.L_pad) < 0.03, 2] = -3.0
        kp = np.array([458.654, 457.296, 367.215, 248.375])
        lm = np.arange(OP) // plan.TP * 128 + plan.lmloc
        pc = np.einsum("sij,sj->si", R[plan.camid], X[lm]) + t[plan.camid]
        z = np.where(pc[:, 2] > 1e-6, pc[:, 2], 1.0)
        uv = np.stack([kp[0] * pc[:, 0] / z + kp[2], kp[1] * pc[:, 1] / z + kp[3]], 1)
        noise = rng.normal(0, 2.0, (OP, 2))
        uv += np.where(rng.uniform(size=(OP, 1)) < 0.1, 15 * noise, noise)
        is2 = 1.2 ** (-2.0 * rng.integers(0, 8, OP))
        valid = ~pad & (rng.uniform(size=OP) >= 0.05)
        free = ~pad & (plan.camid != 0) & (lm % 17 != 0)
        pose = np.concatenate([R.reshape(C, 9), t], 1)
        arrays += (uv, is2, valid, free, kp, pose, X)
    out = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device) for a in arrays]
    return (plan.to(device),) + tuple(out[:4]) + ((tuple(out[4:]),) if state else ())


def d1_errors(out, ref) -> dict:
    """K3's outputs (W18, aux, hllbl, cam27) against ref's, part by part,
    relative to each part's max-abs in ref; for the inlier flags, the
    fraction of slots whose flag differs."""
    (W18, aux, hllbl, cam27), (rW, raux, rh, rc) = out, ref
    return {"W18": relmax(W18, rW), "rho": relmax(aux[0], raux[0]),
            "chi2": relmax(aux[2], raux[2]),
            "inlier_flips": float((aux[1] != raux[1]).float().mean()),
            "Hll": relmax(hllbl[:9], rh[:9]), "bl": relmax(hllbl[9:], rh[9:]),
            "Hcc": relmax(cam27[:, :21], rc[:, :21]), "bc": relmax(cam27[:, 21:], rc[:, 21:])}


def k3_k5_edge_errors(C: int, plan, W, H9, state) -> dict:
    """K3 and K5 on an edge_case problem, each called twice: worst
    relative error of either call against the plain version and of the
    two calls against each other, per part of K3's outputs (inlier_flips:
    the larger fraction of flags that differ from the plain version's)
    and for K5. K3's per-slot outputs (W18, aux) take no atomics, so the
    two calls must agree bitwise; this raises where they do not."""
    from motioncheck_ccm_slam_tpu_torch.ops import schur_cuda

    d1 = (plan.camid, plan.lmloc) + tuple(state)
    a, b = (schur_cuda.d1_assemble(*d1, TP=plan.TP) for _ in range(2))
    ref = schur_cuda.d1_assemble_ref(*d1, TP=plan.TP)
    torch.cuda.synchronize()
    check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
          "K3's per-slot outputs differ between two calls")
    comps = [d1_errors(x, y) for x, y in ((a, ref), (b, ref), (a, b))]
    errs = {f"d1_assemble.{k}": max(c[k] for c in comps) for k in comps[0]}
    check(all(bool(x.isfinite().all()) for x in a), "K3 gave non-finite values")
    k5 = [schur_cuda.d2_precond(plan.camid, plan.lmloc, W, H9, C, TP=plan.TP) for _ in range(2)]
    r5 = schur_cuda.d2_precond_ref(plan.camid, plan.lmloc, W, H9, C, TP=plan.TP)
    torch.cuda.synchronize()
    check(bool(k5[0].isfinite().all()), "K5 gave non-finite values")
    errs["d2_precond"] = max(relmax(k5[0], r5), relmax(k5[1], r5), relmax(k5[0], k5[1]))
    return errs


def edge_products(device) -> dict:
    """K3, K4, K5, K6, K7 and the plan-form apply_a, apply_b and
    schur_apply against their plain versions at EDGE_CASES' shapes, each
    called twice: both calls within SUM_RTOL of the plain version's
    max-abs, and of each other (K3 part by part, its inlier flags differing
    from the plain version's on at most 1e-4 of the slots or one slot: a
    chi2 within rounding of the gate). Returns case -> (K4's geometry, K7's
    geometry, name -> worst relative error, name -> whether K6's two calls,
    raw and plan-form, were bitwise equal)."""
    from motioncheck_ccm_slam_tpu_torch.ops import schur_cuda

    out = {}
    for name, C, L, per_lm, tiles in EDGE_CASES:
        plan, W, H9, v, u, state = edge_case(C, L, per_lm, tiles, device, state=True)
        ids = (plan.camid, plan.lmloc, W)
        calls = {
            "s_apply": (lambda: schur_cuda.s_apply(*ids, v, H9, TP=plan.TP),
                        lambda: schur_cuda.s_apply_ref(*ids, v, H9, TP=plan.TP)),
            "apply_a_raw": (lambda: schur_cuda.apply_a_raw(*ids, v, H9, TP=plan.TP),
                            lambda: schur_cuda.apply_a_raw_ref(*ids, v, H9, TP=plan.TP)),
            "apply_a": (lambda: schur_cuda.apply_a(plan, W, v, H9),
                        lambda: schur_cuda.apply_a_ref(plan, W, v, H9)),
            "apply_b_raw": (lambda: schur_cuda.apply_b_raw(*ids, u, C, TP=plan.TP),
                            lambda: schur_cuda.apply_b_raw_ref(*ids, u, C, TP=plan.TP)),
            "apply_b": (lambda: schur_cuda.apply_b(plan, W, u, C),
                        lambda: schur_cuda.apply_b_ref(plan, W, u, C)),
            "schur_apply": (lambda: schur_cuda.schur_apply(plan, W, v, H9),
                            lambda: schur_cuda.schur_apply_ref(plan, W, v, H9)),
        }
        errs, bitwise = {}, {}
        for k, (kern, plain) in calls.items():
            a, b = kern(), kern()
            ref = plain()
            torch.cuda.synchronize()
            errs[k] = max(relmax(a, ref), relmax(b, ref), relmax(a, b))
            if k.startswith("apply_a"):
                bitwise[k] = torch.equal(a, b)
            check(bool(a.isfinite().all()) and errs[k] <= SUM_RTOL,
                  f"{k} at edge shape {name} off its plain version or its own second "
                  f"call by {errs[k]:.3g} > {SUM_RTOL}")
        k35 = k3_k5_edge_errors(C, plan, W, H9, state)
        flips = k35.pop("d1_assemble.inlier_flips")
        check(flips <= max(1e-4, 1.0 / (plan.ntl * plan.TP)),
              f"K3's inlier flags at edge shape {name} differ on {flips:.3g} of the slots")
        for k, e in k35.items():
            check(e <= SUM_RTOL, f"{k} at edge shape {name} off its plain version or its "
                  f"own second call by {e:.3g} > {SUM_RTOL}")
        errs.update(k35, **{"d1_assemble.inlier_flips": flips})
        geo = {k: schur_cuda.launch_geometry(k, C, plan.TP, plan.ntl, device)
               for k in ("s_apply", "apply_b", "d1_assemble", "d2_precond")}
        out[name] = (geo["s_apply"], geo["apply_b"], errs, bitwise)
        print(f"phase 10 edge shape {name}: C={C} TP={plan.TP} ntl={plan.ntl}; K4 cluster "
              f"{geo['s_apply'].cluster}, staged {geo['s_apply'].staged} of "
              f"{geo['s_apply'].share} slots a rank, v in shared memory "
              f"{geo['s_apply'].v_shared}, {geo['s_apply'].ranges} camera range(s), "
              f"{geo['s_apply'].shared_bytes} B; camera ranges K7 {geo['apply_b'].ranges}, "
              f"K3 {geo['d1_assemble'].ranges}, K5 {geo['d2_precond'].ranges}; K6's two calls "
              f"bitwise equal {bitwise}; worst relative error "
              + ", ".join(f"{k} {e:.3g}" for k, e in errs.items()))
        if name == "c12000_tp4224":
            check(all(g.ranges > 1 for g in geo.values()),
                  "C = 12,000 did not split every camera table")
    # every way K4 stages: v in shared memory or not, a tile whole or in part
    ways = {(g4.v_shared, g4.staged == g4.share) for g4, _, _, _ in out.values()}
    want = {(True, True), (False, True), (False, False)}
    check(ways >= want, f"the edge shapes miss K4's staging {sorted(want - ways)}")
    return out


def perturbed_state(Tcw, Xw, seed: int = 1):
    """Cameras 1.. moved by se3 noise of 0.005 rad / 0.04 m, points by 0.05 m
    (as tests/test_tile_gba._perturbed), from a numpy seed."""
    from motioncheck_ccm_slam_tpu_torch.ops import lie

    rng = np.random.default_rng(seed)
    C, L = Tcw.shape[0], Xw.shape[0]
    xi = np.zeros((C, 6), np.float32)
    xi[1:, :3] = rng.normal(0, 0.005, (C - 1, 3))
    xi[1:, 3:] = rng.normal(0, 0.04, (C - 1, 3))
    dX = rng.normal(0, 0.05, (L, 3)).astype(np.float32)
    Tp = lie.se3_exp(torch.from_numpy(xi).to(Tcw.device)) @ Tcw
    return Tp.contiguous(), Xw + torch.from_numpy(dX).to(Xw.device)


def profile_call(fn, args, n_iterations: int, symbols=KERNEL_SYMBOL,
                 sweep_kernel: str = "s_apply") -> dict:
    """A torch.profiler split of one GBA call of n_iterations LM iterations:
    device ms and launches per kernel (``symbols`` maps a name to the CUDA
    function's; ``sweep_kernel``'s launches are reported as the call's PCG
    sweeps), the rest of the device time, the host's scalar reads (the PCG
    exit tests), the wall time under the profiler and the device's idle
    share of that wall time. The profiler's tracing adds host time, so this
    idle share is an upper bound on an unprofiled call's."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*args, n_iterations=n_iterations)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    split = {n: 0.0 for n in symbols}
    launches = {n: 0 for n in symbols}
    dev_ms, n_sync, sync_ms, n_dev = 0.0, 0, 0.0, 0
    for e in prof.events():
        ms = e.time_range.elapsed_us() / 1e3
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_ms += ms
            n_dev += 1
            for n, sym in symbols.items():
                if sym in e.name:
                    split[n] += ms
                    launches[n] += 1
        elif e.name == "aten::_local_scalar_dense":
            n_sync += 1
            sync_ms += ms
    return {"wall_ms_under_profiler": wall_ms, "device_busy_ms": dev_ms,
            "device_idle_share_under_profiler": 1.0 - dev_ms / wall_ms,
            "sweep_kernel_launches": launches[sweep_kernel], "device_ops": n_dev,
            "kernel_ms": split, "kernel_launches": launches,
            "other_device_ms": dev_ms - sum(split.values()),
            "host_scalar_reads": n_sync, "host_scalar_read_ms": sync_ms}


def gba_phases(device, smi: str, schur_log: str) -> dict:
    """Phases 7-10. Returns name -> kernel record for K3-K7 and the GBA
    results."""
    from motioncheck_ccm_slam_tpu_torch.entry import gba_entry
    from motioncheck_ccm_slam_tpu_torch.ops import schur_cuda
    from motioncheck_ccm_slam_tpu_torch.parallel import sharded_ba as sba
    from motioncheck_ccm_slam_tpu_torch.solvers import ba_core

    CLOCK.start(7)
    # phase 7: the build report of csrc/schur.cu
    print(f"phase 7 build: {schur_cuda.library_path()}")
    for line in schur_log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("  " + line.strip())

    t0 = time.perf_counter()
    fn, (Tcw, Xw, obs, K, fixed_cam, fixed_lm) = gba_entry(device)
    C, L, O = Tcw.shape[0], Xw.shape[0], obs.cam_idx.shape[0]
    torch.cuda.synchronize()
    t_problem = time.perf_counter() - t0
    t0 = time.perf_counter()
    tp = sba.build_tile_plan(obs, C, L)
    t_plan = time.perf_counter() - t0
    OP, TP = tp.ntl * tp.TP, tp.TP
    print(f"phase 8 problem: C={C} L={L} O={O}: TP={TP} ntl={tp.ntl} OP={OP} "
          f"({100 * (OP - O) / OP:.1f}% pad) L_pad={tp.L_pad}; problem "
          f"{t_problem:.2f} s, plan {t_plan:.2f} s on the host")
    check((tp.TP, tp.ntl, OP, tp.L_pad) == (4224, 512, 2162688, 65536),
          "the tile plan differs from bench_gba's (TP 4224, 512 tiles)")

    CLOCK.start(8)
    # phase 8: K3-K7 against their plain versions at these shapes
    Tcw_p, Xw_p = perturbed_state(Tcw, Xw)
    fl_pad = torch.cat([fixed_lm, torch.ones(tp.L_pad - L, dtype=torch.bool, device=device)])
    Xp_pad = torch.cat([Xw_p, torch.zeros((tp.L_pad - L, 3), device=device)])
    st = sba.tile_streams(tp, obs, K, fixed_cam, fl_pad)
    d1_args = (tp.camid, tp.lmloc, st.uv, st.is2, st.valid, st.free, st.kp,
               schur_cuda.pose_table(Tcw_p), Xp_pad)
    out = schur_cuda.d1_assemble(*d1_args, TP=TP)
    ref = schur_cuda.d1_assemble_ref(*d1_args, TP=TP)
    torch.cuda.synchronize()
    W18, aux, hllbl, cam27 = out
    tol = {"W18": SUM_RTOL, "rho": RESIDUAL_RTOL, "chi2": RESIDUAL_RTOL, "inlier_flips": 1e-4,
           "Hll": SUM_RTOL, "bl": RESIDUAL_RTOL, "Hcc": SUM_RTOL, "bc": RESIDUAL_RTOL}
    errs = {k: (e, tol[k]) for k, e in d1_errors(out, ref).items()}
    max_abs = {"d1_assemble": max(float((a - b).abs().max()) for a, b in zip(out, ref))}
    for k, (e, tol) in errs.items():
        check(e <= tol and np.isfinite(e), f"K3 {k} off its plain version by {e:.3g} > {tol}")
    print("phase 8 K3 d1_assemble vs plain (relative to max-abs): "
          + ", ".join(f"{k} {e:.3g}" for k, (e, _) in errs.items()))
    n_active = int(st.valid.sum())
    Hll_d = ba_core.damp_blocks(hllbl[0:9].T.reshape(tp.L_pad, 3, 3),
                                torch.tensor(1e-4, device=device))
    Hll_d = torch.where(fl_pad[:, None, None], torch.eye(3, device=device), Hll_d)
    H9 = ba_core.inv33(Hll_d).reshape(tp.L_pad, 9).T.contiguous()
    rng = np.random.default_rng(2)
    v = torch.from_numpy(rng.normal(0, 1e-2, (C, 6)).astype(np.float32)).to(device)
    u = torch.from_numpy(rng.normal(0, 1e-2, (3, tp.L_pad)).astype(np.float32)).to(device)
    ids = (tp.camid, tp.lmloc, W18)
    calls = {   # name -> args after (camid, lmloc, W18)
        "d2_precond": (H9, C),
        "s_apply": (v, H9),
        "apply_a_raw": (v, H9),
        "apply_b_raw": (u, C),
    }
    for name, rest in calls.items():
        o = getattr(schur_cuda, name)(*ids, *rest, TP=TP)
        r = getattr(schur_cuda, name + "_ref")(*ids, *rest, TP=TP)
        torch.cuda.synchronize()
        e = relmax(o, r)
        max_abs[name] = float((o - r).abs().max())
        check(o.isfinite().all().item() and e <= SUM_RTOL,
              f"{name} off its plain version by {e:.3g} > {SUM_RTOL}")
        print(f"phase 8 {name} vs plain: {e:.3g} of max-abs (max |d| {max_abs[name]:.3g})")
    k6_twice = [schur_cuda.apply_a_raw(*ids, v, H9, TP=TP) for _ in range(2)]
    torch.cuda.synchronize()
    k6_bitwise = torch.equal(*k6_twice)
    print(f"phase 8 apply_a_raw: two calls bitwise equal {k6_bitwise}")
    del k6_twice
    n_w = int((W18 != 0).any(0).sum())

    CLOCK.start(9)
    # phase 9: 10 LM iterations from the perturbed start, kernels then plain
    def robust_cost(T, X):
        Xpad = torch.cat([X, torch.zeros((tp.L_pad - L, 3), device=device)])
        return float(sba._tile_linearize(T, [Xpad], [tp], [st], sba.Shards([device]))[4])

    cost0 = robust_cost(Tcw_p, Xw_p)
    fn(Tcw_p, Xw_p, obs, K, fixed_cam, fixed_lm, n_iterations=0)   # builds fn's plan
    torch.cuda.synchronize()
    zero_launches(GBA_KERNELS)
    t0 = time.perf_counter()
    res_k = fn(Tcw_p, Xw_p, obs, K, fixed_cam, fixed_lm, n_iterations=GBA_ITERS)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    launches = read_launches(GBA_KERNELS)
    t0 = time.perf_counter()
    with plain_gba_kernels() as plain_calls:
        res_p = fn(Tcw_p, Xw_p, obs, K, fixed_cam, fixed_lm, n_iterations=GBA_ITERS)
        torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    cost_k, cost_p = robust_cost(res_k.Tcw, res_k.Xw), robust_cost(res_p.Tcw, res_p.Xw)
    gba = {
        "robust_cost_start": cost0, "robust_cost_kernels": cost_k,
        "robust_cost_plain": cost_p, "inlier_cost_kernels": float(res_k.cost),
        "inlier_cost_plain": float(res_p.cost),
        "Tcw_max_diff": float((res_k.Tcw - res_p.Tcw).abs().max()),
        "Xw_max_diff": float((res_k.Xw - res_p.Xw).abs().max()),
        "inliers_kernels": int(res_k.obs_inlier.sum()),
        "inliers_plain": int(res_p.obs_inlier.sum()),
        "gba_iters_per_s_perturbed_start": GBA_ITERS / t_k,
        "k4_sweeps_perturbed_start": launches["s_apply"],
        "k6_calls_bitwise_equal_bench_shapes": k6_bitwise,
        "gba_iters_per_s_perturbed_start_plain": GBA_ITERS / t_p,
        "k4_sweeps_perturbed_start_plain": plain_calls["s_apply"],
    }
    print(f"phase 9 GBA, {GBA_ITERS} LM iterations from the perturbed start: robust cost "
          f"{cost0:.6g} -> {cost_k:.6g} (kernels, {t_k:.2f} s, {launches['s_apply']} PCG "
          f"sweeps) and {cost_p:.6g} (plain, {t_p:.2f} s, {plain_calls['s_apply']} sweeps); "
          f"|dTcw| {gba['Tcw_max_diff']:.3g}, |dXw| {gba['Xw_max_diff']:.3g}; "
          f"inlier cost {gba['inlier_cost_kernels']:.6g} vs {gba['inlier_cost_plain']:.6g}; "
          f"launches {launches}")
    check(np.isfinite(cost_k) and cost_k < cost0, "the kernels' GBA did not lower the cost")
    check(np.isfinite(cost_p) and cost_p < cost0, "the plain GBA did not lower the cost")
    for a, b in ((cost_k, cost_p), (gba["inlier_cost_kernels"], gba["inlier_cost_plain"])):
        check(abs(a - b) <= GBA_BOUNDS["cost_rtol"] * max(abs(b), 1.0),
              f"cost {a:.6g} with the kernels vs {b:.6g} plain")
    check(gba["Tcw_max_diff"] < GBA_BOUNDS["Tcw_atol"], "Tcw differs from the plain run")
    check(gba["Xw_max_diff"] < GBA_BOUNDS["Xw_atol"], "Xw differs from the plain run")
    want = {"d1_assemble": 1 + GBA_ITERS, "d2_precond": GBA_ITERS,
            "apply_a_raw": GBA_ITERS, "apply_b_raw": GBA_ITERS}
    for n, k in want.items():
        check(launches[n] == k, f"{n} launched {launches[n]} times, expected {k}")
    check(launches["s_apply"] >= GBA_ITERS, f"s_apply launched {launches['s_apply']} times")

    CLOCK.start(10)
    # phase 10: LM iterations/s on bench_gba's exact problem
    args = (Tcw, Xw, obs, K, fixed_cam, fixed_lm)
    float(fn(*args, n_iterations=1).cost)
    n0 = schur_cuda.s_apply.launches
    t0 = time.perf_counter()
    res = fn(*args, n_iterations=GBA_ITERS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    sweeps = schur_cuda.s_apply.launches - n0
    gba["gba_iters_per_s_2048kf_2Mobs"] = GBA_ITERS / dt
    gba["k4_sweeps_2048kf_2Mobs"] = sweeps
    gba["card"] = smi
    check(bool(res.Tcw.isfinite().all()) and np.isfinite(float(res.cost)),
          "non-finite GBA result on bench_gba's problem")
    print(f"phase 10 gba_iters_per_s_2048kf_2Mobs {GBA_ITERS / dt:.4f} "
          f"({dt:.3f} s for {GBA_ITERS} LM iterations, {sweeps} PCG sweeps, on {smi})")

    # each kernel alone at these shapes (bench state): ms, plain ms, bound
    X0 = torch.cat([Xw, torch.zeros((tp.L_pad - L, 3), device=device)])
    d1_0 = d1_args[:7] + (schur_cuda.pose_table(Tcw), X0)
    W0 = schur_cuda.d1_assemble(*d1_0, TP=TP)[0]
    ids0 = (tp.camid, tp.lmloc, W0)
    timed = {"d1_assemble": d1_0}
    timed.update({n: ids0 + rest for n, rest in calls.items()})
    slot_in = OP * (8 + 72)            # ids + the W row, read by K4-K7
    f, Lp = 4, tp.L_pad
    # f32 operations a slot, counted from csrc/schur.cu: K3 ~350 where the
    # weight is non-zero (projection and robust weight ~43, Jacobians ~38,
    # W 73, Hll + bl 60, Hcc + bc 135) and ~150 elsewhere (no sums); K4 72
    # (A's stage 36, B's 36) on a slot with a non-zero W row, plus 15 a
    # landmark solve; K5 216; K6 and K7 36. K4 reads each slot once (its
    # cluster stages the tile); the partial camera sums that K4 and K7 write
    # and add again are their own scratch, not counted
    # K3 reads ids, uv, is2, valid and the free flag of a valid slot (28 B)
    # and only valid of a pad or invalid slot, and writes W and aux (84 B)
    # for every slot
    work = {   # name -> (bytes read once + written once, f32 operations)
        "d1_assemble": (n_active * 28 + (OP - n_active) * 4 + OP * (72 + 12)
                        + C * (12 + 27) * f + Lp * (3 + 12) * f + 16,
                        n_active * 350 + (OP - n_active) * 150),
        "s_apply": (slot_in + C * 12 * f + Lp * 9 * f, n_w * 72 + Lp * 15),
        "d2_precond": (slot_in + C * 21 * f + Lp * 9 * f, n_w * 216),
        "apply_a_raw": (slot_in + C * 6 * f + Lp * 12 * f, n_w * 36 + Lp * 15),
        "apply_b_raw": (slot_in + C * 6 * f + Lp * 3 * f, n_w * 36),
    }
    records = {}
    for name, a in timed.items():
        kern = getattr(schur_cuda, name)
        plain = getattr(schur_cuda, name + "_ref")
        k_ms, p_ms = turns_ms(lambda: kern(*a, TP=TP), lambda: plain(*a, TP=TP), 20, 3)
        b_ms, b_by = bound_ms(*work[name])
        records[name] = {"max_abs_err": max_abs[name], "ms": k_ms, "plain_ms": p_ms,
                         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        print(f"phase 10 {name}: {k_ms:.4f} ms vs plain {p_ms:.4f} ms; bound {b_ms:.4f} ms "
              f"({b_by}), {100 * b_ms / k_ms:.1f}% of it")

    # library yardstick for K7: one sparse (6C x 3L) CSR product
    i6 = torch.arange(6, device=device)
    j3 = torch.arange(3, device=device)
    rows = (tp.camid.long()[None, None, :] * 6 + i6[None, :, None]).expand(3, 6, OP)
    cols = (tp.lm_p[None, None, :] * 3 + j3[:, None, None]).expand(3, 6, OP)
    Wsp = torch.sparse_coo_tensor(torch.stack([rows.reshape(-1), cols.reshape(-1)]),
                                  W0.reshape(-1), (6 * C, 3 * Lp),
                                  check_invariants=False).coalesce().to_sparse_csr()
    u_flat = u.T.reshape(-1, 1).contiguous()
    lib = (Wsp @ u_flat).reshape(C, 6)
    mine = schur_cuda.apply_b_raw(*ids0, u, C, TP=TP)
    check(relmax(lib, mine) <= SUM_RTOL, "the sparse yardstick disagrees with K7")
    records["apply_b_raw"]["library_ms"] = cuda_ms(lambda: Wsp @ u_flat, 20)
    del Wsp
    print(f"phase 10 apply_b_raw library call (CSR sparse product): "
          f"{records['apply_b_raw']['library_ms']:.4f} ms")
    # library yardstick for K6: the (3L x 6C) CSR product of W^T with v, from
    # the same entries: the sum alone, without the 3x3 solve
    WTsp = torch.sparse_coo_tensor(torch.stack([cols.reshape(-1), rows.reshape(-1)]),
                                   W0.reshape(-1), (3 * Lp, 6 * C),
                                   check_invariants=False).coalesce().to_sparse_csr()
    del rows, cols
    v_flat = v.reshape(-1, 1).contiguous()
    u_lib = torch.einsum("lij,lj->il", H9.T.reshape(Lp, 3, 3), (WTsp @ v_flat).reshape(Lp, 3))
    check(relmax(u_lib, schur_cuda.apply_a_raw(*ids0, v, H9, TP=TP)) <= SUM_RTOL,
          "the sparse yardstick (with the 3x3 solves) disagrees with K6")
    records["apply_a_raw"]["library_ms"] = cuda_ms(lambda: WTsp @ v_flat, 20)
    del WTsp
    print(f"phase 10 apply_a_raw library call (CSR sparse product of W^T with v, the sum "
          f"alone, without the 3x3 solve): {records['apply_a_raw']['library_ms']:.4f} ms")
    for n in GBA_KERNELS:
        records[n]["launches"] = launches[n]

    # the camera-table kernels' launch geometry at these shapes, and all of
    # them at the edge shapes
    geo = {n: schur_cuda.launch_geometry(n, C, TP, tp.ntl, device)
           for n in ("d1_assemble", "s_apply", "d2_precond", "apply_b")}
    print(f"phase 10 K4 geometry {geo['s_apply']._asdict()}, "
          f"{schur_cuda.s_apply_active_clusters(geo['s_apply'].cluster, geo['s_apply'].shared_bytes)}"
          f" clusters resident at once; K7 geometry {geo['apply_b']._asdict()}; K3 geometry "
          f"{geo['d1_assemble']._asdict()}; K5 geometry {geo['d2_precond']._asdict()}")
    edges = edge_products(device)
    gba["edge_shapes"] = {name: errs for name, (_, _, errs, _) in edges.items()}
    gba["k6_calls_bitwise_equal"] = {name: eq for name, (_, _, _, eq) in edges.items()}

    # torch.profiler splits of a 10-iteration call from each state (after one
    # profile that is thrown away: the profiler's first use starts its tracer)
    profile_call(fn, args, 1)
    for label, a in (("bench_state", args),
                     ("perturbed_start", (Tcw_p, Xw_p, obs, K, fixed_cam, fixed_lm))):
        line = profile_call(fn, a, GBA_ITERS)
        print(f"phase 10 profile of {GBA_ITERS} LM iterations from the {label.replace('_', ' ')}"
              f": {json.dumps(line)}")
        gba[f"profile_{label}"] = line
    print(json.dumps({"gba": gba}))
    ctx = dict(tp=tp, st=st, Tcw_p=Tcw_p, Xw_p=Xw_p, res_k=res_k, W18=W18,
               args_p=(Tcw_p, Xw_p, obs, K, fixed_cam, fixed_lm),
               iters_per_s_perturbed=GBA_ITERS / t_k, iters_per_s_bench=GBA_ITERS / dt,
               aux=aux, H9=H9, v=v, u=u, W0=W0, n_w=n_w, n_active=n_active,
               k6_library_ms=records["apply_a_raw"]["library_ms"],
               k7_library_ms=records["apply_b_raw"]["library_ms"], work=work)
    return records, ctx


def mf_phases(device, smi: str, ctx: dict) -> dict:
    """Phases 11-12: the matrix-free GBA's kernels and solver at bench_gba's
    shapes. Returns name -> kernel record for K8, K9 and the plan-form
    products."""
    from motioncheck_ccm_slam_tpu_torch.entry import matrix_free_gba_entry
    from motioncheck_ccm_slam_tpu_torch.ops import schur_cuda
    from motioncheck_ccm_slam_tpu_torch.parallel import sharded_ba as sba

    CLOCK.start(11)
    fn, (Tcw, Xw, obs, K, fixed_cam, fixed_lm) = matrix_free_gba_entry(device)
    C, L = Tcw.shape[0], Xw.shape[0]
    tp, st, TP = ctx["tp"], ctx["st"], ctx["tp"].TP
    Tcw_p, Xw_p = ctx["Tcw_p"], ctx["Xw_p"]
    t0 = time.perf_counter()
    mp = sba.build_matrix_free_plan(obs, C, L)
    t_plan = time.perf_counter() - t0
    sp = mp.sp
    OP = sp.ntl * sp.TP
    print(f"phase 11 matrix-free plan: OP={OP} TP={sp.TP} seg={mp.seg}, {t_plan:.2f} s on the host")
    check((sp.TP, sp.ntl) == (tp.TP, tp.ntl) and torch.equal(sp.camid, tp.camid)
          and torch.equal(sp.lmloc, tp.lmloc), "the matrix-free plan differs from the tile plan")

    # phase 11: K9 bitwise, the plan-form products, K8
    max_abs = {}
    out = schur_cuda.expand_sorted_streams(sp, Tcw_p, Xw_p)
    ref = schur_cuda.expand_sorted_streams_ref(sp, Tcw_p, Xw_p)
    torch.cuda.synchronize()
    max_abs["expand_sorted_streams"] = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    check(all(torch.equal(a, b) for a, b in zip(out, ref)),
          f"K9 differs from its plain version by {max_abs['expand_sorted_streams']:.3g}")
    print("phase 11 K9 expand_sorted_streams: bitwise equal to its plain version")
    del out, ref
    W18, H9, v, u = ctx["W18"], ctx["H9"], ctx["v"], ctx["u"]
    calls = {"apply_a": (W18, v, H9), "apply_b": (W18, u, C), "schur_apply": (W18, v, H9)}
    for name, rest in calls.items():
        o = getattr(schur_cuda, name)(sp, *rest)
        r = getattr(schur_cuda, name + "_ref")(sp, *rest)
        torch.cuda.synchronize()
        e = relmax(o, r)
        max_abs[name] = float((o - r).abs().max())
        check(bool(o.isfinite().all()) and e <= SUM_RTOL,
              f"{name} off its plain version by {e:.3g} > {SUM_RTOL}")
        print(f"phase 11 {name} vs plain: {e:.3g} of max-abs (max |d| {max_abs[name]:.3g})")
    L_pad = tp.L_pad

    def d0_args(T, X):
        Xpad = torch.cat([X, torch.zeros((L_pad - L, 3), device=device)])
        return (tp.camid, tp.lmloc, st.uv, st.is2, st.valid, st.kp, schur_cuda.pose_table(T), Xpad)

    def k8(T, X) -> float:
        return float(schur_cuda.d0_cost(*d0_args(T, X), TP=TP))

    a_p = d0_args(Tcw_p, Xw_p)
    c8a, c8b = (schur_cuda.d0_cost(*a_p, TP=TP) for _ in range(2))
    c8, c8_ref = float(c8a), float(schur_cuda.d0_cost_ref(*a_p, TP=TP))
    c3 = float(torch.sum(ctx["aux"][0]))
    max_abs["d0_cost"] = abs(c8 - c8_ref)
    check(torch.equal(c8a, c8b), f"two K8 calls differ: {c8:.9g} and {float(c8b):.9g}")
    for name, b in (("its plain version", c8_ref), ("the sum of K3's per-slot cost", c3)):
        check(np.isfinite(c8) and abs(c8 - b) <= 1e-5 * abs(b),
              f"K8 cost {c8:.9g} vs {b:.9g} ({name})")
    print(f"phase 11 K8 d0_cost: {c8:.9g} (two calls bitwise equal) vs plain {c8_ref:.9g} "
          f"and K3's sum {c3:.9g}")

    CLOCK.start(12)
    # phase 12: 10 LM iterations from the perturbed start, priced by K8
    fn(Tcw_p, Xw_p, obs, K, fixed_cam, fixed_lm, n_iterations=0)   # builds fn's plan
    torch.cuda.synchronize()
    names = MF_KERNELS + ("d0_cost",)
    zero_launches(names)
    cost0 = k8(Tcw_p, Xw_p)
    t0 = time.perf_counter()
    res_m = fn(Tcw_p, Xw_p, obs, K, fixed_cam, fixed_lm, n_iterations=GBA_ITERS)
    torch.cuda.synchronize()
    t_m = time.perf_counter() - t0
    cost_m = k8(res_m.Tcw, res_m.Xw)
    launches = read_launches(names)
    t0 = time.perf_counter()
    with plain_gba_kernels(MF_KERNELS) as plain_calls:
        res_p = fn(Tcw_p, Xw_p, obs, K, fixed_cam, fixed_lm, n_iterations=GBA_ITERS)
        torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    res_k = ctx["res_k"]
    cost_p, cost_k = k8(res_p.Tcw, res_p.Xw), k8(res_k.Tcw, res_k.Xw)
    mf = {
        "robust_cost_start_k8": cost0, "robust_cost_kernels_k8": cost_m,
        "robust_cost_plain_k8": cost_p, "robust_cost_tile_gba_k8": cost_k,
        "inlier_cost_kernels": float(res_m.cost), "inlier_cost_plain": float(res_p.cost),
        "Tcw_max_diff_plain": float((res_m.Tcw - res_p.Tcw).abs().max()),
        "Xw_max_diff_plain": float((res_m.Xw - res_p.Xw).abs().max()),
        "Tcw_max_diff_tile_gba": float((res_m.Tcw - res_k.Tcw).abs().max()),
        "Xw_max_diff_tile_gba": float((res_m.Xw - res_k.Xw).abs().max()),
        "gba_iters_per_s_perturbed_start": GBA_ITERS / t_m,
        "pcg_sweeps_perturbed_start": launches["schur_apply"],
        "gba_iters_per_s_perturbed_start_plain": GBA_ITERS / t_p,
        "pcg_sweeps_perturbed_start_plain": plain_calls["schur_apply"],
        "launches": launches,
    }
    print(f"phase 12 matrix-free GBA, {GBA_ITERS} LM iterations from the perturbed start: "
          f"K8 cost {cost0:.6g} -> {cost_m:.6g} (kernels, {t_m:.2f} s, "
          f"{launches['schur_apply']} PCG sweeps), {cost_p:.6g} (plain, {t_p:.2f} s, "
          f"{plain_calls['schur_apply']} sweeps), tile GBA {cost_k:.6g}; |dTcw| plain "
          f"{mf['Tcw_max_diff_plain']:.3g} tile {mf['Tcw_max_diff_tile_gba']:.3g}, |dXw| plain "
          f"{mf['Xw_max_diff_plain']:.3g} tile {mf['Xw_max_diff_tile_gba']:.3g}; launches {launches}")
    for label, c in (("kernels", cost_m), ("plain", cost_p)):
        check(np.isfinite(c) and c < cost0, f"the matrix-free GBA ({label}) did not lower the cost")
    for label, b in (("plain", cost_p), ("tile GBA", cost_k)):
        check(abs(cost_m - b) <= GBA_BOUNDS["cost_rtol"] * max(abs(b), 1.0),
              f"matrix-free cost {cost_m:.6g} vs {b:.6g} ({label})")
    for key in ("plain", "tile_gba"):
        check(mf[f"Tcw_max_diff_{key}"] < GBA_BOUNDS["Tcw_atol"], f"Tcw differs from the {key} run")
        check(mf[f"Xw_max_diff_{key}"] < GBA_BOUNDS["Xw_atol"], f"Xw differs from the {key} run")
    want = {"expand_sorted_streams": GBA_ITERS, "apply_a": GBA_ITERS, "apply_b": GBA_ITERS,
            "d0_cost": 2}
    for n, k in want.items():
        check(launches[n] == k, f"{n} launched {launches[n]} times, expected {k}")
    check(launches["schur_apply"] >= GBA_ITERS, f"schur_apply launched {launches['schur_apply']} times")
    del res_p

    # LM iterations/s on bench_gba's exact problem
    args = (Tcw, Xw, obs, K, fixed_cam, fixed_lm)
    float(fn(*args, n_iterations=1).cost)
    n0 = schur_cuda.schur_apply.launches
    t0 = time.perf_counter()
    res = fn(*args, n_iterations=GBA_ITERS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    sweeps = schur_cuda.schur_apply.launches - n0
    check(bool(res.Tcw.isfinite().all()) and np.isfinite(float(res.cost)),
          "non-finite matrix-free GBA result on bench_gba's problem")
    mf["gba_iters_per_s_2048kf_2Mobs"] = GBA_ITERS / dt
    mf["pcg_sweeps_2048kf_2Mobs"] = sweeps
    mf["card"] = smi
    print(f"phase 12 matrix-free gba_iters_per_s_2048kf_2Mobs {GBA_ITERS / dt:.4f} "
          f"({dt:.3f} s for {GBA_ITERS} LM iterations, {sweeps} PCG sweeps, on {smi})")

    # each kernel alone at these shapes (bench state)
    W0, a_bench = ctx["W0"], d0_args(Tcw, Xw)
    timed = {
        "d0_cost": (lambda: schur_cuda.d0_cost(*a_bench, TP=TP),
                    lambda: schur_cuda.d0_cost_ref(*a_bench, TP=TP)),
        "expand_sorted_streams": (lambda: schur_cuda.expand_sorted_streams(sp, Tcw, Xw),
                                  lambda: schur_cuda.expand_sorted_streams_ref(sp, Tcw, Xw)),
        "apply_a": (lambda: schur_cuda.apply_a(sp, W0, v, H9),
                    lambda: schur_cuda.apply_a_ref(sp, W0, v, H9)),
        "apply_b": (lambda: schur_cuda.apply_b(sp, W0, u, C),
                    lambda: schur_cuda.apply_b_ref(sp, W0, u, C)),
        "schur_apply": (lambda: schur_cuda.schur_apply(sp, W0, v, H9),
                        lambda: schur_cuda.schur_apply_ref(sp, W0, v, H9)),
    }
    f, n_w, work, n_act = 4, ctx["n_w"], ctx["work"], ctx["n_active"]
    # K8 reads ids, uv, is2 and valid of a valid slot (24 B) and only valid
    # (4 B) of a pad or invalid slot, whose cost is 0; the pose table and the
    # L points, and does ~45 f32 operations a valid slot (projection,
    # residual, Huber cost, sum); K9 reads 8 B of ids and writes 60 B a
    # slot; the plan-form products do K6's, K7's and K4's work
    bounds = {
        "d0_cost": bound_ms(n_act * 24 + (OP - n_act) * 4 + C * 12 * f + L * 3 * f + f,
                            n_act * 45),
        "expand_sorted_streams": bound_ms(OP * (8 + 15 * f) + C * 12 * f + L * 3 * f, 0),
        "apply_a": bound_ms(*work["apply_a_raw"]),
        "apply_b": bound_ms(*work["apply_b_raw"]),
        "schur_apply": bound_ms(*work["s_apply"]),
    }
    records = {}
    for name, (kern, plain) in timed.items():
        k_ms, p_ms = turns_ms(kern, plain, 20, 3)
        b_ms, b_by = bounds[name]
        records[name] = {"launches": launches[name], "max_abs_err": max_abs[name], "ms": k_ms,
                         "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": None}
        print(f"phase 12 {name}: {k_ms:.4f} ms vs plain {p_ms:.4f} ms; bound {b_ms:.4f} ms "
              f"({b_by}), {100 * b_ms / k_ms:.1f}% of it")
    # yardsticks: K9 against one indexing gather of each table; apply_a and
    # apply_b are K6's and K7's functions on their inputs, so they share
    # their CSR product times
    tab, cam_l, lm_l = schur_cuda.pose_table(Tcw), sp.camid.long(), mp.lm_p
    records["expand_sorted_streams"]["library_ms"] = cuda_ms(lambda: (tab[cam_l], Xw[lm_l]), 20)
    records["apply_a"]["library_ms"] = ctx["k6_library_ms"]
    records["apply_b"]["library_ms"] = ctx["k7_library_ms"]
    print(f"phase 12 expand_sorted_streams library call (two indexing gathers): "
          f"{records['expand_sorted_streams']['library_ms']:.4f} ms")

    profile_call(fn, args, 1, MF_SYMBOL, "K6")
    line = profile_call(fn, args, GBA_ITERS, MF_SYMBOL, "K6")
    line["pcg_sweeps"] = line["kernel_launches"]["K6"] - GBA_ITERS
    print(f"phase 12 profile of {GBA_ITERS} matrix-free LM iterations from the bench state: "
          f"{json.dumps(line)}")
    mf["profile_bench_state"] = line
    print(json.dumps({"matrix_free_gba": mf}))
    return records


@contextlib.contextmanager
def timed_driver():
    """Time the GBA driver's parts: wraps ``_pick_solver``'s choice and any
    solver handed to it, the solvers' host-built plans (part of the solver's
    time) and Motion Check's two calls, each ending in a device synchronize.
    Yields a dict of seconds: solver, plan, mc; and ``timed(part, f)``."""
    from motioncheck_ccm_slam_tpu_torch.models import gba as gba_mod
    from motioncheck_ccm_slam_tpu_torch.models import motion_check as mc
    from motioncheck_ccm_slam_tpu_torch.parallel import sharded_ba as sba

    secs = {"solver": 0.0, "plan": 0.0, "mc": 0.0}

    def timed(part, f):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = f(*a, **kw)
            torch.cuda.synchronize()
            secs[part] += time.perf_counter() - t0
            return out
        return call

    saved = (gba_mod._pick_solver, mc.check_after_gba, mc.apply_verdict,
             sba.build_tile_plan, sba.build_matrix_free_plan)

    def pick(*a, **kw):
        solver = saved[0](*a, **kw)
        return solver if solver is None else timed("solver", solver)

    gba_mod._pick_solver = pick
    mc.check_after_gba = timed("mc", saved[1])
    mc.apply_verdict = timed("mc", saved[2])
    sba.build_tile_plan = timed("plan", saved[3])
    sba.build_matrix_free_plan = timed("plan", saved[4])
    secs["timed"] = timed
    try:
        yield secs
    finally:
        (gba_mod._pick_solver, mc.check_after_gba, mc.apply_verdict,
         sba.build_tile_plan, sba.build_matrix_free_plan) = saved


def client_ate(m, truth: np.ndarray, slots: np.ndarray) -> float:
    """RMS camera-centre error of the valid keyframes among ``slots``
    against the true poses."""
    idx = torch.from_numpy(slots).to(m.kf.Tcw.device)
    T = m.kf.Tcw[idx].double()
    est = -torch.einsum("kji,kj->ki", T[:, :3, :3], T[:, :3, 3])
    Tt = torch.from_numpy(truth[slots]).to(T)
    ref = -torch.einsum("kji,kj->ki", Tt[:, :3, :3], Tt[:, :3, 3])
    ok = m.kf.valid[idx]
    return float(torch.sqrt(((est - ref) ** 2).sum(1)[ok].mean()))


def driver_phases(device, smi: str) -> dict:
    """Phase 13: the Motion-Check-gated GBA driver on a server map at
    capacity. Returns the driver's results."""
    from motioncheck_ccm_slam_tpu_torch import entry
    from motioncheck_ccm_slam_tpu_torch.models import gba as gba_mod
    from motioncheck_ccm_slam_tpu_torch.parallel import sharded_ba as sba

    t0 = time.perf_counter()
    fn, (m, cfg) = entry.server_gba_entry(device, seed=0)
    torch.cuda.synchronize()
    t_map = time.perf_counter() - t0
    scene = entry.server_scene(0)
    truth = scene.Tcw
    per = m.nk // entry.N_CLIENTS
    client0, every = np.arange(per), np.arange(m.nk)
    n_obs = int((scene.mp_idx >= 0).sum())
    print(f"phase 13 server map: {m.nk} keyframes x {m.kf.xy.shape[1]} features, {m.nm} "
          f"landmarks, {n_obs} observations, all valid; built in {t_map:.2f} s on the host")
    check(bool(m.kf.valid.all()) and bool(m.mp.valid.all()), "the server map is not full")
    chosen = gba_mod._pick_solver(m.nk, m.nm, device=m.kf.Tcw.device)
    check(chosen is not None and chosen.__qualname__.startswith("make_tile_gba"),
          f"_pick_solver chose {chosen} for the server map, not the tile-stream GBA")
    iters, chunk = cfg.opt.gba_iterations, 5

    def kicked(base):
        """base, then client 0's keyframes in KICK_SLOTS kicked 1 m sideways,
        alternately (as tests/test_mc_gating.corrupting_solver)."""
        def solver(Tcw, Xw, obs, K, fixed_cam, fixed_lm, n_it=None):
            res = base(Tcw, Xw, obs, K, fixed_cam, fixed_lm, n_it)
            T = res.Tcw.clone()
            for i, s in enumerate(KICK_SLOTS):
                T[s, 1, 3] += 1.0 if i % 2 == 0 else -1.0
            return res._replace(Tcw=T)
        return solver

    out = {"card": smi, "map_build_s": t_map}

    def run(label, m, **kw):
        zero_launches(GBA_KERNELS + MF_KERNELS)
        with timed_driver() as secs:
            if "sharded_solver" in kw:
                kw["sharded_solver"] = secs["timed"]("solver", kw["sharded_solver"])
            t0 = time.perf_counter()
            res = fn(m, cfg, iterations=iters, chunk=chunk, **kw)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
        launches = {k: v for k, v in read_launches(GBA_KERNELS + MF_KERNELS).items() if v}
        rec = {"reverted": res.reverted, "n_deleted_kfs": res.n_deleted_kfs,
               "mc_longest_run": res.mc_longest_run, "solver_cost": res.cost,
               "ate_client0_m": client_ate(m, truth, client0),
               "ate_all_m": client_ate(m, truth, every),
               "seconds": total, "solver_s": secs["solver"], "plan_s": secs["plan"],
               "mc_s": secs["mc"], "other_s": total - secs["solver"] - secs["mc"],
               "launches": launches}
        out[label] = rec
        print(f"phase 13 {label}: reverted {res.reverted}, deleted {res.n_deleted_kfs}, "
              f"longest run {res.mc_longest_run}, client 0 ATE {rec['ate_client0_m']:.4g} m, "
              f"all {rec['ate_all_m']:.4g} m; {total:.3f} s = solver {secs['solver']:.3f} "
              f"(host plan {secs['plan']:.3f}) + MC {secs['mc']:.3f} + rest "
              f"{rec['other_s']:.3f}; launches {launches}")
        return res, rec

    # (a) honest, through _pick_solver
    res, rec = run("a_honest", m)
    check(not res.reverted and res.n_deleted_kfs == 0,
          f"Motion Check flagged the honest GBA: {res}")
    check(rec["launches"].get("d1_assemble", 0) >= 1, "the driver did not run the tile GBA's K3")
    # (b) and (c): a GBA that kicks a band of client 0's keyframes
    for tag, base in (("b", chosen), ("c", sba.make_matrix_free_gba(pcg_iters=25))):
        res_mc, rec_mc = run(f"{tag}_kicked_mc", entry.server_map(scene, device),
                             sharded_solver=kicked(base))
        res_no, rec_no = run(f"{tag}_kicked_no_mc", entry.server_map(scene, device),
                             sharded_solver=kicked(base), enable_motion_check=False)
        check(res_mc.reverted or res_mc.n_deleted_kfs >= 3,
              f"({tag}) Motion Check neither reverted nor deleted: {res_mc}")
        check(rec_no["ate_client0_m"] > NO_MC_MIN_ATE_M,
              f"({tag}) the kick did not bite: ATE {rec_no['ate_client0_m']:.4g} m")
        check(rec_mc["ate_client0_m"] < MC_ATE_RATIO * rec_no["ate_client0_m"],
              f"({tag}) ATE with MC {rec_mc['ate_client0_m']:.4g} m vs "
              f"{rec_no['ate_client0_m']:.4g} m without")
    check(out["c_kicked_mc"]["launches"].get("schur_apply", 0) >= 1,
          "the driver did not run the matrix-free GBA's kernels")
    print(json.dumps({"driver": out}))
    return out


@contextlib.contextmanager
def timed_agent(client):
    """Time the client's parts, each ending in a device synchronize: the
    tracking of a frame, its keyframe's mapping and the local BA within
    it, and torch.linalg.svd while ``svd_on`` is set (the initialization
    frames). Yields a dict of the current frame's milliseconds."""
    from motioncheck_ccm_slam_tpu_torch.models import mapping as mapping_mod

    ms = {"track": 0.0, "map": 0.0, "ba": 0.0, "svd": 0.0, "svd_on": False}

    def timed(part, f):
        def call(*a, **kw):
            if part == "svd" and not ms["svd_on"]:
                return f(*a, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(*a, **kw)
            torch.cuda.synchronize()
            ms[part] += (time.perf_counter() - t0) * 1e3
            return out
        return call

    saved = (client.tracker.process, client.mapper.process_keyframe, mapping_mod.run_local_ba,
             torch.linalg.svd)
    client.tracker.process = timed("track", saved[0])
    client.mapper.process_keyframe = timed("map", saved[1])
    mapping_mod.run_local_ba = timed("ba", saved[2])
    torch.linalg.svd = timed("svd", saved[3])
    try:
        yield ms
    finally:
        del client.tracker.process, client.mapper.process_keyframe
        mapping_mod.run_local_ba, torch.linalg.svd = saved[2:]


def agent_phase(device, smi: str) -> dict:
    """Phase 14: the agent from a blank map, through the port's
    ClientSystem at the EuRoC operating point. Returns its results."""
    from motioncheck_ccm_slam_tpu_torch.config import DEFAULT_CONFIG
    from motioncheck_ccm_slam_tpu_torch.models.map_state import check_structure
    from motioncheck_ccm_slam_tpu_torch.models.tracking import TrackState
    from motioncheck_ccm_slam_tpu_torch.ops import fast_cuda
    from motioncheck_ccm_slam_tpu_torch.system.client import ClientSystem
    from motioncheck_ccm_slam_tpu_torch.utils.csv_io import ate_rmse

    cfg = DEFAULT_CONFIG
    cap = cfg.capacity
    scene = PlaneScene(cfg.camera, relief=AGENT_RELIEF_M)
    client = ClientSystem(cfg, device=device)
    blank = np.zeros((cfg.camera.height, cfg.camera.width), np.float32)
    print(f"phase 14 agent: {cfg.camera.width}x{cfg.camera.height}, {cfg.extractor.n_levels} "
          f"levels, {cfg.extractor.max_features} feature slots, client map "
          f"{cap.client_max_kfs} keyframes x {cap.client_max_mps} landmarks")
    torch.cuda.synchronize()
    zero_fast_launches()
    log, blackout = [], None
    with timed_agent(client) as part:
        k = 0
        while blackout is None or k < blackout + AGENT_BLACKOUT + AGENT_AFTER:
            # the blackout starts at the first frame from AGENT_BLACKOUT_AT
            # on whose map holds enough keyframes to relocalize, not reset
            if blackout is None and k >= AGENT_BLACKOUT_AT and client.map.n_kfs >= AGENT_MIN_KFS:
                blackout = k
            check(blackout is not None or k <= AGENT_MAX_FRAMES - AGENT_BLACKOUT - AGENT_AFTER,
                  f"{AGENT_MIN_KFS} keyframes not reached in "
                  f"{AGENT_MAX_FRAMES - AGENT_BLACKOUT - AGENT_AFTER} frames")
            dark = blackout is not None and k < blackout + AGENT_BLACKOUT
            state0, n_kf0, relocs0 = client.tracker.state, client.mapper.next_kf_id, \
                client.tracker.n_relocs
            part.update(track=0.0, map=0.0, ba=0.0, svd=0.0,
                        svd_on=state0 == TrackState.NOT_INITIALIZED)
            img = blank if dark else scene.render(k)     # on the host, not timed
            t0 = time.perf_counter()
            client.process_image(img, k / cfg.camera.fps)
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
            kind = ("init" if state0 == TrackState.NOT_INITIALIZED
                    and client.tracker.state == TrackState.OK
                    else "reloc" if client.tracker.n_relocs > relocs0
                    else "keyframe" if client.mapper.next_kf_id > n_kf0
                    else "dark" if dark else "track")
            log.append(dict(k=k, kind=kind, state=client.tracker.state.name, ms=total,
                            track_ms=part["track"], map_ms=part["map"] - part["ba"],
                            ba_ms=part["ba"], svd_ms=part["svd"], kfs=client.map.n_kfs,
                            mps=client.map.n_mps))
            k += 1
    n_frames = k
    launches = fast_launches()
    for r in log:
        print(f"  frame {r['k']:2d}: {r['state']:9s} {r['kind']:8s} {r['ms']:8.1f} ms "
              f"(tracking {r['track_ms']:.1f}, mapping {r['map_ms']:.1f}, local BA "
              f"{r['ba_ms']:.1f}) {r['kfs']:2d} KFs {r['mps']:5d} landmarks")
    if blackout != AGENT_BLACKOUT_AT:
        print(f"phase 14: the blackout moved to frames {blackout}-{blackout + AGENT_BLACKOUT - 1}"
              f" (fewer than {AGENT_MIN_KFS} keyframes by frame {AGENT_BLACKOUT_AT})")

    states = [r["state"] for r in log]
    check("OK" in states[:AGENT_INIT_BY + 1], f"not initialized by frame {AGENT_INIT_BY}")
    init = states.index("OK")
    lost = [r["k"] for r in log if r["state"] != "OK" and init < r["k"] < blackout
            or r["k"] >= blackout + AGENT_BLACKOUT + AGENT_RECOVERY and r["state"] != "OK"]
    check(not lost, f"frames lost outside the blackout and its recovery: {lost}")
    kfs_before = log[blackout - 1]["kfs"]
    check(kfs_before >= AGENT_MIN_KFS, f"{kfs_before} keyframes before the blackout")
    check(client.tracker.n_relocs >= 1, "no relocalization after the blackout")
    n_mps = client.map.n_mps
    check(n_mps >= AGENT_MIN_MPS, f"{n_mps} landmarks in the map")
    problems = check_structure(client.map)
    check(not problems, f"check_structure: {problems}")
    ok = np.array(client.tracker.trajectory_ok)
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for _, T in client.tracker.trajectory])[ok]
    truth = np.stack([scene.center(r["k"]) for r in log])[ok]
    ate, ate_max = ate_rmse(est, truth)
    check(ate <= AGENT_MAX_ATE_M, f"ATE {ate:.4f} m")
    for name, n in launches.items():
        check(n == n_frames, f"{name} launched {n} times in {n_frames} frames")
    check(fast_cuda.masked_corner_score.launches == 0 and fast_cuda.blur_and_moments.launches == 0,
          "the agent used a one-level K1 or K2 wrapper")

    def med(kind, key="ms"):
        vals = [r[key] for r in log if r["kind"] == kind]
        return statistics.median(vals) if vals else None

    init_r = log[init]
    reloc_r = next(r for r in log if r["kind"] == "reloc")
    out = {
        "card": smi, "frames": n_frames, "blackout": [blackout, blackout + AGENT_BLACKOUT - 1],
        "init_frame": init, "relocalized_frame": reloc_r["k"], "n_relocs": client.tracker.n_relocs,
        "keyframes_created": client.mapper.next_kf_id, "kfs_before_blackout": kfs_before,
        "kfs": client.map.n_kfs, "landmarks": n_mps, "ate_m": ate, "ate_max_m": ate_max,
        "launches": launches,
        "track_frame_ms": med("track"),
        "keyframe_ms": med("keyframe"), "keyframe_track_ms": med("keyframe", "track_ms"),
        "keyframe_mapping_ms": med("keyframe", "map_ms"),
        "keyframe_local_ba_ms": med("keyframe", "ba_ms"),
        "init_frame_ms": init_r["ms"], "init_svd_ms": init_r["svd_ms"],
        "init_svd_share": init_r["svd_ms"] / init_r["ms"],
        "reloc_frame_ms": reloc_r["ms"],
    }
    print(f"phase 14 agent: initialized at frame {init}, {out['keyframes_created']} keyframes "
          f"made ({kfs_before} before the blackout), {client.map.n_kfs} in the map, {n_mps} "
          f"landmarks, relocalized at frame {reloc_r['k']}, ATE {ate:.4f} m (max "
          f"{ate_max:.4f}) over {int(ok.sum())} OK frames, launches {launches}")
    print(f"phase 14 times on {smi}: tracking frame median {out['track_frame_ms']:.1f} ms; "
          f"keyframe frame median {out['keyframe_ms']:.1f} ms = tracking "
          f"{out['keyframe_track_ms']:.1f} + mapping (triangulate, fuse, cull, trim) "
          f"{out['keyframe_mapping_ms']:.1f} + local BA {out['keyframe_local_ba_ms']:.1f}; "
          f"initialization frame {out['init_frame_ms']:.1f} ms (batched SVDs "
          f"{out['init_svd_ms']:.1f} ms, {100 * out['init_svd_share']:.1f}%); relocalization "
          f"frame {out['reloc_frame_ms']:.1f} ms")
    print(json.dumps({"agent": out}))
    return out


def arc_poses(n: int, step: float = 0.25):
    """tests/synth_map.arc_poses with the port's se3_exp: n translating
    poses with a slow yaw, 0.25 s apart."""
    from motioncheck_ccm_slam_tpu_torch.ops import lie

    xi = torch.tensor([[0.0, 0.002 * k, 0.0, step * k, 0.0, 0.0] for k in range(n)])
    return list(lie.se3_exp(xi).numpy()), [k * 0.25 for k in range(n)]


class RevisitWorld:
    """tests/synth_map.SynthWorld in numpy: landmarks in a box 5-7 m ahead
    with random descriptors, observed by projection with K (the keypoints
    are undistorted) with 0.3 px noise."""

    def __init__(self, cfg, n_points: int = 400, seed: int = 0, depth: float = 6.0):
        rng = np.random.default_rng(seed)
        self.cfg = cfg
        self.pts = np.stack([rng.uniform(-6, 6, n_points), rng.uniform(-3.5, 3.5, n_points),
                             depth + rng.uniform(-1.0, 1.0, n_points)], -1).astype(np.float32)
        self.desc = rng.integers(0, 2**32, (n_points, 8), dtype=np.uint32)
        self.K = cfg.camera.K()

    def observe(self, Tcw, rng, noise_px: float = 0.3):
        cam, K = self.cfg.camera, self.K
        pc = self.pts @ Tcw[:3, :3].T + Tcw[:3, 3]
        z = pc[:, 2]
        u = K[0, 0] * pc[:, 0] / np.maximum(z, 1e-6) + K[0, 2]
        v = K[1, 1] * pc[:, 1] / np.maximum(z, 1e-6) + K[1, 2]
        vis = (z > 0.2) & (u >= 10) & (u < cam.width - 10) & (v >= 10) & (v < cam.height - 10)
        idx = np.flatnonzero(vis)[:self.cfg.extractor.max_features]
        uv = np.stack([u[idx], v[idx]], -1) + rng.normal(0, noise_px, (len(idx), 2))
        return idx, uv.astype(np.float32)


def drifted_revisit(cfg, device, server: bool = True):
    """tests/test_loop_closing.drifted_revisit built with numpy into an
    empty port MapState (server capacity by default): an arc of 6 poses
    passed twice, each pass observing its own copies of the world's
    landmarks (tests/synth_map.add_pass, slots allocated in the same
    order), the second pass's poses and landmarks carrying the rigid drift
    D = se3_exp(0, 0.026, 0, 0.15, 0.05, 0). Returns (map, pass-1 slots,
    pass-2 slots, true poses)."""
    from motioncheck_ccm_slam_tpu_torch import convert
    from motioncheck_ccm_slam_tpu_torch.models.map_state import MapState
    from motioncheck_ccm_slam_tpu_torch.ops import lie

    m = MapState.create(cfg, server=server, device="cpu")
    kf = convert.kf_block_to_numpy(m.kf)._asdict()
    mp = convert.mp_block_to_numpy(m.mp)._asdict()
    world = RevisitWorld(cfg)
    poses, ts = arc_poses(6)
    D = lie.se3_exp(torch.tensor([0.0, 0.026, 0.0, 0.15, 0.05, 0.0])).numpy()
    F = cfg.extractor.max_features
    next_mp, next_kf = 0, 0
    passes = []
    for kf_id_start, drift, seed, t0 in ((0, None, 1, 0.0), (50, D, 2, 10.0)):
        rng = np.random.default_rng(seed)
        slot_of, kf_slots = {}, []
        for k, Tcw in enumerate(poses):
            idx, uv = world.observe(Tcw, rng)
            n = min(len(idx), F)
            new = [int(w) for w in idx[:n] if int(w) not in slot_of]
            if new:
                s = np.arange(next_mp, next_mp + len(new))
                next_mp += len(new)
                X = world.pts[new]
                if drift is not None:
                    X = X @ drift[:3, :3].T + drift[:3, 3]
                mp["mp_id"][s] = [kf_id_start * 100000 + w for w in new]
                mp["client_id"][s] = 0
                mp["Xw"][s] = X
                mp["desc"][s] = world.desc[new]
                mp["min_dist"][s], mp["max_dist"][s] = 0.1, 100.0
                mp["valid"][s] = True
                mp["first_kf_id"][s] = kf_id_start + k
                mp["ref_kf"][s] = next_kf       # the first observing KF's slot
                slot_of.update(zip(new, s.tolist()))
            slot = next_kf
            next_kf += 1
            T_eff = Tcw if drift is None else Tcw @ np.linalg.inv(drift)
            link = kf_slots[-1] if kf_slots else -1
            kf["kf_id"][slot], kf["client_id"][slot] = kf_id_start + k, 0
            kf["timestamp"][slot] = t0 + ts[k]
            kf["Tcw"][slot] = T_eff.astype(np.float32)
            kf["xy"][slot, :n] = uv[:n]
            kf["desc"][slot, :n] = world.desc[idx[:n]]
            kf["feat_valid"][slot, :n] = True
            kf["mp_idx"][slot, :n] = [slot_of[int(w)] for w in idx[:n]]
            kf["valid"][slot] = True
            kf["parent"][slot] = kf["pred"][slot] = link
            kf_slots.append(slot)
        passes.append(kf_slots)
    m = MapState(kf=convert.kf_block_from_numpy(types.SimpleNamespace(**kf), device),
                 mp=convert.mp_block_from_numpy(types.SimpleNamespace(**mp), device),
                 config=cfg, next_kf_slot=next_kf % m.nk)
    m.sync_host_index()
    return m, passes[0], passes[1], poses


@contextlib.contextmanager
def recorded_gbas():
    """Wrap models.gba.run_gba for the block: each call's seconds, its
    solver / host plan / Motion Check parts (``timed_driver``), its K3-K7
    launches and its result, in call order."""
    from motioncheck_ccm_slam_tpu_torch.models import gba as gba_mod

    calls = []
    run_gba = gba_mod.run_gba

    def recording(*a, **kw):
        zero_launches(GBA_KERNELS)
        with timed_driver() as secs:
            t0 = time.perf_counter()
            res = run_gba(*a, **kw)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
        calls.append(dict(seconds=total, solver_s=secs["solver"], plan_s=secs["plan"],
                          mc_s=secs["mc"], launches=read_launches(GBA_KERNELS),
                          mc_mode=kw.get("mc_mode", "full"), reverted=res.reverted,
                          n_deleted_kfs=res.n_deleted_kfs, mc_longest_run=res.mc_longest_run,
                          mc_gated=res.mc_gated, interrupted=res.interrupted, cost=res.cost))
        return res

    gba_mod.run_gba = recording
    try:
        yield calls
    finally:
        gba_mod.run_gba = run_gba


@contextlib.contextmanager
def timed_calls(targets):
    """Time ``(owner, attribute, label)`` callables (a class's methods
    included) for the block, each call ending in a device synchronize;
    yields label -> list of seconds."""
    secs = {label: [] for _, _, label in targets}
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in targets]

    def timed(f, label):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = f(*a, **kw)
            torch.cuda.synchronize()
            secs[label].append(time.perf_counter() - t0)
            return out
        return call

    for (owner, attr, f), (_, _, label) in zip(saved, targets):
        setattr(owner, attr, timed(f, label))
    try:
        yield secs
    finally:
        for owner, attr, f in saved:
            setattr(owner, attr, f)


def count_syncs(fn):
    """fn() with torch's synchronizing-operation warnings on: returns
    (fn's result, the number of host synchronizations it made)."""
    import warnings

    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def kf_centres(m, cid: int):
    """(timestamps, camera centres) of client ``cid``'s keyframes in map m."""
    valid = (m.kf.valid & (m.kf.client_id == cid)).cpu().numpy()
    T = m.kf.Tcw.cpu().numpy()[valid].astype(np.float64)
    return m.kf.timestamp.cpu().numpy()[valid], -np.einsum("kji,kj->ki", T[:, :3, :3],
                                                           T[:, :3, 3])


def merge_phase(device, smi: str) -> dict:
    """Phase 15: two agents stream their keyframes to the server, which
    merges their maps at server capacity. Returns its results."""
    import dataclasses

    from motioncheck_ccm_slam_tpu_torch.config import DEFAULT_CONFIG, SystemParams
    from motioncheck_ccm_slam_tpu_torch.models import gba as gba_mod
    from motioncheck_ccm_slam_tpu_torch.models import map_merging, mapping as mapping_mod
    from motioncheck_ccm_slam_tpu_torch.models.map_state import check_structure
    from motioncheck_ccm_slam_tpu_torch.models.tracking import TrackState
    from motioncheck_ccm_slam_tpu_torch.parallel.comm import ClientComm
    from motioncheck_ccm_slam_tpu_torch.system.client import ClientSystem
    from motioncheck_ccm_slam_tpu_torch.system.server import ServerSystem
    from motioncheck_ccm_slam_tpu_torch.utils.csv_io import ate_rmse

    base = DEFAULT_CONFIG
    cfg = base.replace(placerec=dataclasses.replace(
        base.placerec, start_map_matching_after_kf=MERGE_START_AFTER_KF))
    cap = cfg.capacity
    print(f"phase 15 two agents: {cfg.camera.width}x{cfg.camera.height}, "
          f"{cfg.extractor.n_levels} levels, {cfg.extractor.max_features} feature slots, client "
          f"maps {cap.client_max_kfs} x {cap.client_max_mps}, server maps {cap.server_max_kfs} "
          f"x {cap.server_max_mps}; the one cut from DEFAULT_CONFIG: "
          f"placerec.start_map_matching_after_kf {base.placerec.start_map_matching_after_kf} -> "
          f"{MERGE_START_AFTER_KF}; agent 1 offset {MERGE_OFFSET_Y} m sideways")
    scenes = [PlaneScene(cfg.camera, relief=AGENT_RELIEF_M),
              PlaneScene(cfg.camera, relief=AGENT_RELIEF_M, offset_y=MERGE_OFFSET_Y)]
    server = ServerSystem(cfg, n_agents=2, device=device)
    clients = []
    for cid in range(2):
        c_cfg = cfg.replace(sys=SystemParams(client_id=cid, n_agents=2))
        c = ClientSystem(c_cfg, device=device)
        c.comm = ClientComm(config=c_cfg, channel=server.channel_for(cid), client_id=cid)
        clients.append(c)
    m0 = server.handlers[0].map
    chosen = gba_mod._pick_solver(m0.nk, m0.nm, device=m0.kf.Tcw.device)
    check(chosen is not None and chosen.__qualname__.startswith("make_tile_gba"),
          f"_pick_solver chose {chosen} at server capacity, not the tile-stream GBA")
    torch.cuda.synchronize()
    zero_fast_launches()
    merge_parts = [(server.matcher, "check", "matcher_check"),
                   (server.matcher, "_compute_cross_sim3", "cross_sim3"),
                   (map_merging, "sim3_transform_map", "sim3_transform_map"),
                   (map_merging, "merge_maps", "merge_maps"),
                   (map_merging, "optimize_seam_essential_graph", "seam_essential_graph"),
                   (server, "_merge", "merge")]
    frame_ms = [[], []]
    spin_s, syncs, merged_at = [], [], None
    with recorded_gbas() as gbas, timed_calls(merge_parts) as parts:
        seam_fuse = []
        fuse = mapping_mod.fuse_neighbors

        def fuse_timed(*a, **kw):
            t0 = time.perf_counter()
            out = fuse(*a, **kw)
            torch.cuda.synchronize()
            if in_merge[0]:
                seam_fuse.append(time.perf_counter() - t0)
            return out

        in_merge = [False]
        merge_fn = server._merge

        def merge_marked(hit):
            in_merge[0] = True
            try:
                return merge_fn(hit)
            finally:
                in_merge[0] = False

        server._merge = merge_marked
        mapping_mod.fuse_neighbors = fuse_timed
        try:
            k = 0
            while merged_at is None or k < merged_at + MERGE_AFTER:
                check(k < MERGE_MAX_FRAMES, f"no merge in {MERGE_MAX_FRAMES} frames an agent")
                for cid, c in enumerate(clients):
                    img = scenes[cid].render(k)              # on the host, not timed
                    t0 = time.perf_counter()
                    c.process_image(img, k / cfg.camera.fps)
                    torch.cuda.synchronize()
                    frame_ms[cid].append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                _, n_sync = count_syncs(server.spin_once)
                torch.cuda.synchronize()
                spin_s.append(time.perf_counter() - t0)
                syncs.append(n_sync)
                if merged_at is None and server.n_merges:
                    merged_at = k
                k += 1
            n_frames = k
            launches = fast_launches()
            # the flush ticks, then the agents go idle (tests/test_multi_agent.py)
            for _ in range(3):
                for c in clients:
                    c.comm.tick(c.map)
                server.spin_once()
            merge_gbas = list(gbas)
            for h in server.handlers.values():
                h.comm.idle_cycles = 10**9
                h.comm.got_data = False
            t0 = time.perf_counter()
            fired = server.maybe_final_gba()
            torch.cuda.synchronize()
            final_s = time.perf_counter() - t0
            again = server.maybe_final_gba()
        finally:
            mapping_mod.fuse_neighbors = fuse
            del server._merge
    final_gbas = gbas[len(merge_gbas):]

    for cid, c in enumerate(clients):
        check(c.tracker.state == TrackState.OK, f"agent {cid} ends in {c.tracker.state.name}")
    check(server.n_merges == 1, f"{server.n_merges} merges")
    m = server.handlers[0].map
    check(server.handlers[1].map is m and server.matcher.maps[0] is server.matcher.maps[1] is m,
          "the handlers do not point at one fused map")
    cids = {cid for (_, cid) in m.kf_slot_by_id}
    check(cids == {0, 1}, f"the fused map holds client ids {cids}")
    check(len(merge_gbas) >= 1, "the merge ran no GBA")
    merge_gba = merge_gbas[-1]
    check(all(merge_gba["launches"][n] >= 1 for n in GBA_KERNELS),
          f"the merge GBA's launches {merge_gba['launches']}")
    problems = check_structure(m)
    check(not problems, f"check_structure on the fused map: {problems}")
    check(fired and not again, f"the final GBA fired {fired}, then {again}")
    check(len(final_gbas) == 1, f"{len(final_gbas)} final GBAs")
    for name, n in launches.items():
        check(n == 2 * n_frames, f"{name} launched {n} times in {n_frames} frames of 2 agents")
    # ATE of each agent's keyframes, and of both under one Sim3
    est, gt = [], []
    for cid in (0, 1):
        ts, C = kf_centres(m, cid)
        est.append(C)
        gt.append(np.stack([scenes[cid].center(int(round(t * cfg.camera.fps))) for t in ts]))
    ate = [ate_rmse(e, g)[0] for e, g in zip(est, gt)]
    ate_joint = ate_rmse(np.concatenate(est), np.concatenate(gt))[0]
    for cid in (0, 1):
        check(ate[cid] <= MERGE_MAX_ATE_M, f"agent {cid}'s fused ATE {ate[cid]:.4f} m")
    check(ate_joint <= MERGE_MAX_ATE_M, f"the joint ATE {ate_joint:.4f} m: not one frame")

    merge_s = {label: sum(v) for label, v in parts.items()}
    out = {
        "card": smi, "frames_per_agent": n_frames, "merged_at_frame": merged_at,
        "n_merges": server.n_merges, "kfs": len(m.kf_slot_by_id), "landmarks": m.n_mps,
        "ate_m": ate, "ate_joint_m": ate_joint, "launches": launches,
        "frame_ms_median": [statistics.median(v) for v in frame_ms],
        "spin_s_median": statistics.median(spin_s), "spin_s_max": max(spin_s),
        "spin_host_syncs_median": statistics.median(syncs), "spin_host_syncs_total": sum(syncs),
        "merge_s": merge_s["merge"], "matcher_check_s": merge_s["matcher_check"],
        "cross_sim3_s": merge_s["cross_sim3"],
        "sim3_transform_s": merge_s["sim3_transform_map"], "merge_maps_s": merge_s["merge_maps"],
        "seam_fuse_s": sum(seam_fuse), "seam_essential_graph_s": merge_s["seam_essential_graph"],
        "merge_gba": merge_gba, "final_gba": final_gbas[0], "final_gba_s": final_s,
    }
    g, fg = merge_gba, final_gbas[0]
    print(f"phase 15 merged at frame {merged_at} of {n_frames} an agent: {out['kfs']} KFs, "
          f"{m.n_mps} landmarks in the fused map, client ids {sorted(cids)}; ATE agent 0 "
          f"{ate[0]:.4f} m, agent 1 {ate[1]:.4f} m, both under one Sim3 {ate_joint:.4f} m; "
          f"launches {launches}")
    print(f"phase 15 times on {smi}: frame median agent 0 {out['frame_ms_median'][0]:.1f} ms, "
          f"agent 1 {out['frame_ms_median'][1]:.1f} ms; spin_once median "
          f"{out['spin_s_median']:.3f} s, max {out['spin_s_max']:.3f} s; host syncs a spin "
          f"median {out['spin_host_syncs_median']}, total {out['spin_host_syncs_total']}")
    print(f"phase 15 merge on {smi}: {out['merge_s']:.3f} s (matcher checks in all spins "
          f"{out['matcher_check_s']:.3f} s, of which cross Sim3 {out['cross_sim3_s']:.3f} s); "
          f"sim3_transform_map {out['sim3_transform_s']:.3f} + merge_maps "
          f"{out['merge_maps_s']:.3f} + seam fuse {out['seam_fuse_s']:.3f} + seam essential "
          f"graph {out['seam_essential_graph_s']:.3f} + run_gba {g['seconds']:.3f} (solver "
          f"{g['solver_s']:.3f}, host plan {g['plan_s']:.3f}, MC {g['mc_s']:.3f}); merge GBA "
          f"launches {g['launches']}, interrupted {g['interrupted']} (INTERRUPTBA: fresh agent "
          f"data on the channel), reverted {g['reverted']}, deleted {g['n_deleted_kfs']}")
    print(f"phase 15 final GBA on {smi}: {final_s:.3f} s (solver {fg['solver_s']:.3f}, host plan "
          f"{fg['plan_s']:.3f}, MC {fg['mc_s']:.3f}); MC verdict: reverted {fg['reverted']}, "
          f"deleted {fg['n_deleted_kfs']}, longest run {fg['mc_longest_run']}; launches "
          f"{fg['launches']}")
    print(json.dumps({"merge": out}))
    return out


def loop_phase(device, smi: str) -> dict:
    """Phase 16: loop closing on a drifted revisit in a server-capacity map.
    Returns its results."""
    from motioncheck_ccm_slam_tpu_torch.config import DEFAULT_CONFIG
    from motioncheck_ccm_slam_tpu_torch.models import gba as gba_mod, loop_closing
    from motioncheck_ccm_slam_tpu_torch.models.database import KeyFrameDatabase
    from motioncheck_ccm_slam_tpu_torch.models.vocabulary import default_vocabulary

    cfg = DEFAULT_CONFIG
    t0 = time.perf_counter()
    m, slots1, slots2, poses = drifted_revisit(cfg, device)
    torch.cuda.synchronize()
    t_map = time.perf_counter() - t0
    print(f"phase 16 drifted revisit: {len(slots1)} + {len(slots2)} keyframes, {m.n_mps} "
          f"landmarks in a {m.nk} x {m.nm} map; built in {t_map:.2f} s on the host")
    chosen = gba_mod._pick_solver(m.nk, m.nm, device=m.kf.Tcw.device)
    check(chosen is not None and chosen.__qualname__.startswith("make_tile_gba"),
          f"_pick_solver chose {chosen} for the loop map, not the tile-stream GBA")

    def centre_errors():
        T = m.kf.Tcw.cpu().numpy()
        return [float(np.linalg.norm(np.linalg.inv(T[s])[:3, 3] - np.linalg.inv(poses[k])[:3, 3]))
                for k, s in enumerate(slots2)]

    before = centre_errors()
    closer = loop_closing.LoopCloser(
        config=cfg, map=m, run_gba_after_loop=True,
        database=KeyFrameDatabase(vocab=default_vocabulary(), capacity=m.nk, device=device))
    parts = [(closer, "detect", "detect"), (closer, "compute_sim3", "compute_sim3"),
             (closer, "correct_loop", "correct_loop"),
             (closer, "_optimize_essential_graph", "essential_graph")]
    t0 = time.perf_counter()
    with recorded_gbas() as gbas, timed_calls(parts) as secs:
        closed = [closer.process_keyframe(s) for s in slots1 + slots2]
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    after = centre_errors()
    check(closer.n_loops_closed >= 1 and any(closed), "no loop closed")
    le = m.kf.loop_edge.cpu().numpy()
    ends = np.flatnonzero(le >= 0)
    check(len(ends) >= 2 and all(le[le[s]] == s for s in ends),
          f"loop edges not recorded at both ends: {le[ends]} at {ends}")
    check(len(gbas) >= 1, "the loop ran no GBA")
    check(all(gbas[0]["launches"][n] >= 1 for n in GBA_KERNELS),
          f"the loop GBA's launches {gbas[0]['launches']}")
    check(min(after) < LOOP_MIN_ERR_M and np.mean(after) < LOOP_MEAN_ERR_M,
          f"drift not removed: centre errors {np.round(after, 4).tolist()}")
    s = {k: sum(v) for k, v in secs.items()}
    gba_s = sum(g["seconds"] for g in gbas)
    out = {"card": smi, "map_build_s": t_map, "n_loops_closed": closer.n_loops_closed,
           "n_regba": closer.n_regba, "loop_edges": {int(a): int(le[a]) for a in ends},
           "centre_err_before_m": before, "centre_err_after_m": after, "seconds": total,
           "detect_s": s["detect"], "compute_sim3_s": s["compute_sim3"],
           "correct_loop_s": s["correct_loop"], "essential_graph_s": s["essential_graph"],
           "gba_s": gba_s, "gbas": gbas}
    print(f"phase 16 loop: {closer.n_loops_closed} closed, edges {out['loop_edges']}, "
          f"{len(gbas)} GBA(s) ({[g['mc_mode'] for g in gbas]}; follow-ups {closer.n_regba}); "
          f"revisit centre errors {np.mean(before):.4f} m mean before, {np.mean(after):.4f} m "
          f"mean / {min(after):.4f} m min after; launches {gbas[0]['launches']}")
    print(f"phase 16 times on {smi}: {total:.3f} s = detect {s['detect']:.3f} + compute_sim3 "
          f"{s['compute_sim3']:.3f} + correct_loop {s['correct_loop']:.3f} (essential graph "
          f"{s['essential_graph']:.3f}, GBA {gba_s:.3f}: solver "
          f"{sum(g['solver_s'] for g in gbas):.3f}, host plan {sum(g['plan_s'] for g in gbas):.3f}"
          f", MC {sum(g['mc_s'] for g in gbas):.3f}); GBA verdicts "
          f"{[(g['reverted'], g['n_deleted_kfs'], g['mc_gated']) for g in gbas]}")
    print(json.dumps({"loop": out}))
    return out


def fast_launches() -> dict:
    """K1's and K2's launch counts (the one-launch-a-frame wrappers)."""
    from motioncheck_ccm_slam_tpu_torch.ops import fast_cuda

    return {n: getattr(fast_cuda, f).launches for n, f in FAST_LEVEL_KERNELS.items()}


def zero_fast_launches() -> None:
    """Zero K1's and K2's launch counts, the one-level wrappers' too."""
    from motioncheck_ccm_slam_tpu_torch.ops import fast_cuda

    for f in (*FAST_LEVEL_KERNELS.values(), *FAST_LEVEL_KERNELS):
        getattr(fast_cuda, f).launches = 0


def run_cli(argv, log_path: str):
    """cli.main(argv) in process, its standard output written to
    ``log_path``: returns (its stats, that output)."""
    from motioncheck_ccm_slam_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        stats = cli.main(argv)
    with open(log_path, "w") as f:
        f.write(buf.getvalue())
    return stats, buf.getvalue()


def check_synth(stats: dict, n_agents: int, label: str) -> list:
    """The JAX fixture's per-run gates: every agent OK within the ATE
    bound, no silent watchdog module. Returns the ATEs."""
    ate = []
    for cid in range(n_agents):
        a = stats["agents"][cid]
        check(a["state"] == "OK", f"{label}: agent {cid} ends in {a['state']}")
        check(a.get("ate_rmse_m") is not None and a["ate_rmse_m"] <= CLI_MAX_ATE_M,
              f"{label}: agent {cid}'s ATE {a.get('ate_rmse_m')} m")
        ate.append(a["ate_rmse_m"])
    check(stats["watchdog_silent"] == [], f"{label}: silent modules {stats['watchdog_silent']}")
    return ate


def cli_phase(device, smi: str, extra_args=()) -> dict:
    """Phase 17: the port's command line in process. ``cli synth --agents
    2 --frames 36`` at full width (DEFAULT_CONFIG on the pinhole camera),
    then the JAX fixture ``--small`` with its merge and ``--save-map``, then
    ``--agents 1 --frames 12 --small --load-map`` of that map. ``extra_args``
    end every command line (a CPU rehearsal: ``--device cpu --small``).
    Returns its results."""
    extra = list(extra_args)
    from motioncheck_ccm_slam_tpu_torch.system.client import ClientSystem
    from motioncheck_ccm_slam_tpu_torch.system.server import ServerSystem
    from motioncheck_ccm_slam_tpu_torch.utils import png

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    os.makedirs(CLI_DIR)
    full = os.path.join(CLI_DIR, "synth_full")
    torch.cuda.synchronize()
    zero_fast_launches()
    calls = [(ClientSystem, "process_image", "frame"), (ServerSystem, "maybe_final_gba", "final")]
    with recorded_gbas() as gbas, timed_calls(calls) as timed:
        t0 = time.perf_counter()
        stats, _ = run_cli(["synth", "--agents", "2", "--frames", str(CLI_FRAMES), "--out", full]
                           + extra, full + ".log")
        wall = time.perf_counter() - t0
    launches = fast_launches()
    frames, finals = timed["frame"], timed["final"]
    ate = check_synth(stats, 2, "synth at full width")
    # the finish calls maybe_final_gba once; done, it ran one GBA a distinct
    # server map, the last GBAs of the run, none interrupted (at full width
    # no merge or loop comes before them)
    n_maps = len(stats["server_maps"])
    final_gbas = gbas[-n_maps:]
    check(len(finals) == 1 and len(gbas) >= n_maps
          and not any(g["interrupted"] for g in final_gbas),
          f"{len(finals)} final GBA calls; GBAs {len(gbas)} over {n_maps} maps, the last "
          f"interrupted {[g['interrupted'] for g in final_gbas]}")
    check(all(g["launches"][n] >= 1 for g in final_gbas for n in GBA_KERNELS),
          f"the final GBA's launches {[g['launches'] for g in final_gbas]}")
    for name, n in launches.items():
        check(n == 2 * CLI_FRAMES, f"{name} launched {n} times in {CLI_FRAMES} frames of 2 agents")
    names = os.listdir(full)
    for need in ("stats.json", "frames_client0.tum", "frames_client1.tum"):
        check(need in names, f"synth wrote no {need}")
    for pattern in (r"KF_FINAL_\d+\.tum", r"map_\d+\.html", r"map_\d+\.png"):
        check(any(re.fullmatch(pattern, n) for n in names), f"synth wrote no {pattern}")
    for n in names:
        if re.fullmatch(r"map_\d+\.png", n):
            img = png.read_png(os.path.join(full, n))
            check(img.ndim == 3 and (img != 255).any(), f"{n} decodes to {img.shape}, blank")
    frame_ms = [statistics.median(1e3 * t for t in frames[cid::2]) for cid in (0, 1)]
    # the final GBA's parts and launches, summed over its maps
    final_gba = {k: sum(g[k] for g in final_gbas) for k in ("solver_s", "plan_s", "mc_s")}
    final_gba["launches"] = {n: sum(g["launches"][n] for g in final_gbas) for n in GBA_KERNELS}
    out = {"card": smi, "full": {
        "seconds": wall, "n_merges": stats["n_merges"], "ate_m": ate,
        "kfs": [stats["agents"][c]["client_kfs"] for c in (0, 1)],
        "server_maps": stats["server_maps"], "frame_ms_median": frame_ms,
        "frame_ms_max": [max(1e3 * t for t in frames[c::2]) for c in (0, 1)],
        "final_gba_s": finals[0], "final_gba_solver_s": final_gba["solver_s"],
        "final_gba_plan_s": final_gba["plan_s"], "final_gba_mc_s": final_gba["mc_s"],
        "final_gba_launches": final_gba["launches"], "n_gbas": len(gbas), "launches": launches}}
    print(f"phase 17 synth at full width: {CLI_FRAMES} frames of 2 agents in {wall:.2f} s; "
          f"ATE {ate[0]:.4f} / {ate[1]:.4f} m; {stats['n_merges']} merges (map matching from "
          f"keyframe 30); server maps {stats['server_maps']}; launches {launches}")
    print(f"phase 17 times on {smi}: frame median {frame_ms[0]:.1f} / {frame_ms[1]:.1f} ms; "
          f"final GBA {finals[0]:.3f} s (solver {final_gba['solver_s']:.3f}, host plan "
          f"{final_gba['plan_s']:.3f}, MC {final_gba['mc_s']:.3f}), launches "
          f"{final_gba['launches']}")

    # the JAX fixture: --small, map matching from keyframe 2: one merge
    small, maps = os.path.join(CLI_DIR, "synth_small"), os.path.join(CLI_DIR, "maps")
    zero_fast_launches()
    t0 = time.perf_counter()
    stats, _ = run_cli(["synth", "--agents", "2", "--frames", str(CLI_FRAMES), "--small",
                        "--save-map", maps, "--out", small] + extra, small + ".log")
    small_s = time.perf_counter() - t0
    ate_small = check_synth(stats, 2, "the --small fixture")
    check(stats["n_merges"] == 1, f"the --small fixture made {stats['n_merges']} merges")
    saved = os.path.join(maps, "map_0.npz")
    with open(saved + ".index.json") as f:
        n_saved = len(json.load(f)["kf_slots"])
    out["small"] = {"seconds": small_s, "n_merges": stats["n_merges"], "ate_m": ate_small,
                    "server_maps": stats["server_maps"], "saved_kfs": n_saved,
                    "launches": fast_launches()}
    # mount the saved map as a prior map beside one live agent
    load = os.path.join(CLI_DIR, "synth_load")
    t0 = time.perf_counter()
    stats, text = run_cli(["synth", "--agents", "1", "--frames", str(CLI_LOAD_FRAMES), "--small",
                           "--load-map", saved, "--out", load] + extra, load + ".log")
    mount = re.search(r"mounted prior map as handler (\d+): .* \((\d+) KFs\)", text)
    check(mount is not None and int(mount[1]) == 1 and int(mount[2]) == n_saved,
          f"the prior map mounted as {mount and mount.groups()}, saved with {n_saved} KFs")
    out["load"] = {"seconds": time.perf_counter() - t0, "handler": int(mount[1]),
                   "kfs": int(mount[2]), "n_merges": stats["n_merges"],
                   "agent": stats["agents"][0], "server_maps": stats["server_maps"]}
    print(f"phase 17 --small fixture: {out['small']['n_merges']} merge, ATE "
          f"{ate_small[0]:.4f} / {ate_small[1]:.4f} m, {n_saved} KFs saved, {small_s:.2f} s; "
          f"--load-map mounted handler {mount[1]} with {mount[2]} KFs beside one agent "
          f"({out['load']['agent']['state']}, {stats['n_merges']} merges), "
          f"{out['load']['seconds']:.2f} s")
    print(json.dumps({"cli": out}))
    return out


def cli_child() -> None:
    """A process of phase 18: ``cli.main(sys.argv[1:])`` with the codec's
    framed bytes counted, then one line ``chip_smoke_child {...}``: the
    command's stats, its seconds, its K1, K2 and K3-K7 launches and the
    bytes it put on the wire (all messages; those carrying keyframes; each
    keyframe's own share of its payload)."""
    from motioncheck_ccm_slam_tpu_torch import cli
    from motioncheck_ccm_slam_tpu_torch.parallel import codec, comm

    wire = dict.fromkeys(("messages", "bytes", "kf_messages", "kf_message_bytes", "keyframes",
                          "keyframe_bytes"), 0)
    encode_framed = codec.encode_framed

    def counted(msg):
        data = encode_framed(msg)
        wire["messages"] += 1
        wire["bytes"] += len(data)
        if msg.keyframes:
            wire["kf_messages"] += 1
            wire["kf_message_bytes"] += len(data)
            empty = len(codec.encode(comm.MapMsg(sender_client_id=msg.sender_client_id)))
            for k in msg.keyframes:
                wire["keyframes"] += 1
                wire["keyframe_bytes"] += len(codec.encode(comm.MapMsg(
                    sender_client_id=msg.sender_client_id, keyframes=[k]))) - empty
        return data

    codec.encode_framed = counted
    t0 = time.perf_counter()
    stats = cli.main(sys.argv[1:])
    print("chip_smoke_child " + json.dumps({
        "stats": stats, "seconds": time.perf_counter() - t0,
        "launches": {**fast_launches(), **read_launches(GBA_KERNELS)}, "wire": wire}), flush=True)


def load_gba_problem(problem: str, device):
    """(Tcw, Xw, obs, K, fixed_cam, fixed_lm) on ``device``: "bench" is
    entry.gba_problem's problem from ``perturbed_state``'s start (phase 9's);
    else the path of an .npz with those arrays (``save_gba_problem``)."""
    from motioncheck_ccm_slam_tpu_torch import convert
    from motioncheck_ccm_slam_tpu_torch.entry import gba_problem

    if problem == "bench":
        Tcw, Xw, obs, K, fixed_cam, fixed_lm = gba_problem(device)
        Tcw, Xw = perturbed_state(Tcw, Xw)
        return Tcw, Xw, obs, K, fixed_cam, fixed_lm
    a = np.load(problem)
    obs = convert.ba_observations_from_numpy(types.SimpleNamespace(
        cam_idx=a["cam_idx"], lm_idx=a["lm_idx"], uv=a["uv"], inv_sigma2=a["inv_sigma2"],
        valid=a["valid"]), device)
    Tcw, Xw, K, fc, fl = convert.gba_state_from_numpy(a["Tcw"], a["Xw"], a["K"], a["fixed_cam"],
                                                      a["fixed_lm"], device)
    return Tcw, Xw, obs, K, fc, fl


def save_gba_problem(path: str, Tcw, Xw, obs, K, fixed_cam, fixed_lm) -> None:
    """Writes a GBA problem (numpy arrays or tensors) for ``load_gba_problem``."""
    def a(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    np.savez(path, Tcw=a(Tcw), Xw=a(Xw), K=a(K), fixed_cam=a(fixed_cam), fixed_lm=a(fixed_lm),
             **{k: a(getattr(obs, k)) for k in ("cam_idx", "lm_idx", "uv", "inv_sigma2", "valid")})


def gba_child() -> None:
    """One rank of a multi-process GBA (phase 19 and the port's tests):
    ``python -c "import chip_smoke; chip_smoke.gba_child()" PROBLEM OUT
    SOLVER BACKEND RANK WORLD STORE DEVICE ITERS PCG``. Loads PROBLEM
    (``load_gba_problem``) on DEVICE, joins a process group of WORLD ranks
    over BACKEND ("gloo" or "nccl") through a FileStore at STORE, runs
    SOLVER ("tile": make_tile_gba, "gather": make_sharded_gba) for ITERS
    LM iterations of at most PCG sweeps with one shard on DEVICE over the
    group, and saves Tcw, Xw, obs_inlier and cost to OUT (.npz); prints one
    line ``chip_smoke_gba_child {...}`` with its seconds and its K3-K7
    launches."""
    import torch.distributed as dist
    from motioncheck_ccm_slam_tpu_torch.parallel import sharded_ba as sba

    problem, out, solver, backend, rank, world, store, device, iters, pcg = sys.argv[1:11]
    rank, world = int(rank), int(world)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    args = load_gba_problem(problem, device)
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    make = {"tile": sba.make_tile_gba, "gather": sba.make_sharded_gba}[solver]
    fn = make(iterations=int(iters), pcg_iters=int(pcg), devices=[device],
              group=dist.group.WORLD)
    zero_launches(GBA_KERNELS)
    t0 = time.perf_counter()
    res = fn(*args)
    cost = float(res.cost)
    seconds = time.perf_counter() - t0
    np.savez(out, Tcw=res.Tcw.cpu().numpy(), Xw=res.Xw.cpu().numpy(),
             obs_inlier=res.obs_inlier.cpu().numpy(), cost=cost)
    dist.destroy_process_group()
    print("chip_smoke_gba_child " + json.dumps({
        "rank": rank, "seconds": seconds, "launches": read_launches(GBA_KERNELS)}), flush=True)


def run_gba_children(problem: str, solver: str, backend: str, world: int, device: str,
                     iters: int, pcg: int, workdir: str, timeout_s: float) -> list:
    """Starts ``world`` ``gba_child`` ranks together, each under
    ``timeout``, waits for all and kills any still running after
    ``timeout_s`` (the call then fails). Returns each rank's printed
    record with its saved arrays under "result"."""
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, f"store_{backend}_{solver}_{world}")
    if os.path.exists(store):
        os.remove(store)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    procs, logs = [], []
    try:
        for rank in range(world):
            out = os.path.join(workdir, f"{backend}_{solver}_rank{rank}.npz")
            logs.append((open(os.path.join(workdir, f"{backend}_{solver}_rank{rank}.log"), "w+"),
                         out))
            procs.append(subprocess.Popen(
                ["timeout", "-k", "5", str(int(timeout_s)), sys.executable, "-c",
                 "import chip_smoke; chip_smoke.gba_child()", problem, out, solver, backend,
                 str(rank), str(world), store, device, str(iters), str(pcg)],
                cwd=ROOT, env=env, stdout=logs[-1][0], stderr=subprocess.STDOUT,
                start_new_session=True))
        t0 = time.perf_counter()
        while any(p.poll() is None for p in procs):
            check(time.perf_counter() - t0 < timeout_s + 10,
                  f"{backend} {solver} ranks still running after {timeout_s} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    recs = []
    for (f, out), p in zip(logs, procs):
        f.seek(0)
        text = f.read()
        f.close()
        check(p.returncode == 0, f"a {backend} {solver} rank exited {p.returncode}: "
              f"{text[-3000:]}")
        line = [ln for ln in text.splitlines() if ln.startswith("chip_smoke_gba_child ")]
        check(len(line) == 1, f"a {backend} {solver} rank printed no result: {text[-2000:]}")
        rec = json.loads(line[0][len("chip_smoke_gba_child "):])
        with np.load(out) as a:
            rec["result"] = {k: a[k] for k in a.files}
        recs.append(rec)
    return recs


def tcp_phase(device, smi: str, extra_args=()) -> dict:
    """Phase 18: ``cli serve --agents 2 --port 0`` and two ``cli agent
    --id {0,1} --frames 36`` at full width, three processes on the one
    card, each under ``timeout``; the server's port is read from its
    "listening" line. ``extra_args`` end every command line, as in
    ``cli_phase``. Returns its results."""
    out_dir = os.path.join(CLI_DIR, "tcp")
    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.empty_cache()
    base = ["timeout", "-k", "10", str(CLI_PROC_TIMEOUT_S), sys.executable, "-c",
            "import chip_smoke; chip_smoke.cli_child()"]
    procs, started, ended, files = {}, {}, {}, {}

    def start(name, argv):
        files[name] = (open(os.path.join(out_dir, name + ".out"), "w"),
                       open(os.path.join(out_dir, name + ".err"), "w"))
        started[name] = time.perf_counter()
        procs[name] = subprocess.Popen(base + argv + list(extra_args), cwd=ROOT,
                                       stdout=files[name][0], stderr=files[name][1],
                                       start_new_session=True)

    def text(name, k=0):
        with open(files[name][k].name) as f:
            return f.read()

    try:
        start("server", ["serve", "--agents", "2", "--port", "0", "--timeout",
                         str(CLI_PROC_TIMEOUT_S - 60), "--out", os.path.join(out_dir, "server")])
        while True:
            m = re.search(r"server listening on [\d.]+:(\d+)", text("server"))
            if m:
                port = int(m[1])
                break
            check(procs["server"].poll() is None, f"the server exited before listening: "
                  f"{text('server', 1)[-2000:]}")
            check(time.perf_counter() - started["server"] < 120, "the server never listened")
            time.sleep(0.1)
        listen_s = time.perf_counter() - started["server"]
        for cid in (0, 1):
            start(f"agent{cid}", ["agent", "--connect", f"127.0.0.1:{port}", "--id", str(cid),
                                  "--frames", str(CLI_FRAMES)])
        while len(ended) < len(procs):
            for name, p in procs.items():
                if name not in ended and p.poll() is not None:
                    ended[name] = time.perf_counter() - started[name]
            check(time.perf_counter() - started["server"] < CLI_PROC_TIMEOUT_S + 30,
                  f"processes still running: {sorted(set(procs) - set(ended))}")
            time.sleep(0.05)
    finally:
        for name, p in procs.items():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        for f in files.values():
            f[0].close()
            f[1].close()

    res = {}
    for name, p in procs.items():
        check(p.returncode == 0, f"{name} exited {p.returncode}: {text(name, 1)[-3000:]}")
        both = text(name) + text(name, 1)
        check("CRC" not in both, f"{name} reported a CRC error")
        line = [ln for ln in text(name).splitlines() if ln.startswith("chip_smoke_child ")]
        check(len(line) == 1, f"{name} printed no result")
        res[name] = json.loads(line[0][len("chip_smoke_child "):])
    srv = res["server"]["stats"]
    check(srv["final_gba_done"] is True, "the server's final GBA did not run")
    agent_kfs = 0
    for cid in (0, 1):
        a = res[f"agent{cid}"]
        check(a["stats"]["state"] == "OK", f"agent {cid} ends in {a['stats']['state']}")
        check(a["stats"]["unacked_kf"] == 0, f"agent {cid}: {a['stats']['unacked_kf']} unacked")
        for name in FAST_LEVEL_KERNELS:
            check(a["launches"][name] == CLI_FRAMES,
                  f"agent {cid}: {name} launched {a['launches'][name]} times")
        agent_kfs += a["stats"]["client_kfs"]
    server_kfs = sum(m["kfs"] for m in srv["server_maps"])
    check(server_kfs >= agent_kfs - 2, f"the server holds {server_kfs} of {agent_kfs} keyframes")
    check(all(res["server"]["launches"][n] >= 1 for n in GBA_KERNELS),
          f"the server's GBA launches {res['server']['launches']}")
    up = [res[f"agent{c}"]["wire"] for c in (0, 1)]
    n_kf = sum(w["keyframes"] for w in up)
    out = {
        "card": smi, "port": port, "server_listening_s": listen_s, "wall_s": ended,
        "server": srv, "agents": [res[f"agent{c}"]["stats"] for c in (0, 1)],
        "launches": {name: res[name]["launches"] for name in res},
        "wire": {name: res[name]["wire"] for name in res},
        "keyframe_bytes_mean": sum(w["keyframe_bytes"] for w in up) / max(n_kf, 1),
        "kf_message_bytes_mean": sum(w["kf_message_bytes"] for w in up)
        / max(sum(w["kf_messages"] for w in up), 1),
    }
    print(f"phase 18 TCP: server on port {port} (listening after {listen_s:.2f} s), final GBA "
          f"{srv['final_gba_done']}, server maps {srv['server_maps']}; agents "
          f"{[a['state'] for a in out['agents']]} with {agent_kfs} KFs, unacked "
          f"{[a['unacked_kf'] for a in out['agents']]}; launches {out['launches']}")
    print(f"phase 18 wire at full width: {out['keyframe_bytes_mean']:.0f} bytes a keyframe "
          f"({n_kf} keyframes sent), {out['kf_message_bytes_mean']:.0f} bytes a framed message "
          f"carrying keyframes; all messages {[res[n]['wire']['bytes'] for n in res]} bytes")
    print(f"phase 18 wall seconds on {smi}: " + ", ".join(
        f"{name} {t:.2f}" for name, t in ended.items()))
    print(json.dumps({"tcp": out}))
    return out


def shard_phase(device, smi: str, ctx: dict) -> dict:
    """Phase 19: the multi-device GBA on the card, from phase 9's perturbed
    start of bench_gba's problem (``ctx``: its arguments, its one-device
    result and rates). Returns its results."""
    from motioncheck_ccm_slam_tpu_torch import entry
    from motioncheck_ccm_slam_tpu_torch.models import gba as gba_mod
    from motioncheck_ccm_slam_tpu_torch.parallel import sharded_ba as sba

    args, ref = ctx["args_p"], ctx["res_k"]
    O = args[2].cam_idx.shape[0]
    out = {"card": smi, "one_device_iters_per_s_perturbed_start": ctx["iters_per_s_perturbed"],
           "one_device_iters_per_s_bench_state": ctx["iters_per_s_bench"]}

    def close(label, cost, Tcw, Xw, inlier, to=ref):
        d = {"cost": float(cost), "cost_rel_diff": abs(float(cost) - float(to.cost))
             / max(abs(float(to.cost)), 1.0),
             "Tcw_max_diff": float((torch.as_tensor(Tcw) - to.Tcw.cpu()).abs().max()),
             "Xw_max_diff": float((torch.as_tensor(Xw) - to.Xw.cpu()).abs().max())}
        check(np.isfinite(d["cost"]), f"{label}: non-finite cost")
        check(d["cost_rel_diff"] <= GBA_BOUNDS["cost_rtol"], f"{label}: cost {d}")
        check(d["Tcw_max_diff"] < GBA_BOUNDS["Tcw_atol"], f"{label}: Tcw {d}")
        check(d["Xw_max_diff"] < GBA_BOUNDS["Xw_atol"], f"{label}: Xw {d}")
        check(tuple(np.shape(Xw)) == tuple(to.Xw.shape) and tuple(np.shape(inlier)) == (O,),
              f"{label}: Xw {tuple(np.shape(Xw))}, inliers {tuple(np.shape(inlier))}")
        return d

    # (a) n shards of the tile axis in this process, all on this card
    shard_res = {}
    for n in (2, 4):
        fn = sba.make_tile_gba(pcg_iters=25, devices=[device] * n)
        fn(*args, n_iterations=0)          # the host plan, built once
        torch.cuda.synchronize()
        zero_launches(GBA_KERNELS)
        t0 = time.perf_counter()
        res = fn(*args, n_iterations=GBA_ITERS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_launches(GBA_KERNELS)
        d = close(f"{n} shards", res.cost, res.Tcw.cpu(), res.Xw.cpu(), res.obs_inlier)
        want = {"d1_assemble": n * (1 + GBA_ITERS), "d2_precond": n * GBA_ITERS,
                "apply_a_raw": n * GBA_ITERS, "apply_b_raw": n * GBA_ITERS}
        for name, k in want.items():
            check(launches[name] == k, f"{n} shards: {name} launched {launches[name]}, not {k}")
        check(launches["s_apply"] % n == 0 and launches["s_apply"] >= n * GBA_ITERS,
              f"{n} shards: s_apply launched {launches['s_apply']} times")
        d.update(iters_per_s=GBA_ITERS / dt, sweeps=launches["s_apply"] // n, launches=launches)
        out[f"shards_{n}"] = d
        shard_res[n] = res
        print(f"phase 19 (a) {n} shards on one card: {GBA_ITERS / dt:.4f} LM it/s ({d['sweeps']} "
              f"PCG sweeps) vs one device {ctx['iters_per_s_perturbed']:.4f} from this start "
              f"(phase 9) and {ctx['iters_per_s_bench']:.4f} from the bench state (phase 10); "
              f"cost {d['cost']:.6g} (rel diff {d['cost_rel_diff']:.3g}), |dTcw| "
              f"{d['Tcw_max_diff']:.3g}, |dXw| {d['Xw_max_diff']:.3g}; launches {launches}")

    # (b) two processes sharing the card over a gloo group, one shard each;
    # beside them one process in an NCCL group of one, one LM iteration
    work = os.path.join(ROOT, "build", "chip_smoke_shards")
    shutil.rmtree(work, ignore_errors=True)
    one_iter = sba.make_tile_gba(pcg_iters=25)(*args, n_iterations=1)
    with ThreadPoolExecutor(2) as pool:
        gloo = pool.submit(run_gba_children, "bench", "tile", "gloo", 2, "cuda:0", GBA_ITERS, 25,
                           work, SHARD_CHILD_TIMEOUT_S)
        nccl = pool.submit(run_gba_children, "bench", "tile", "nccl", 1, "cuda:0", 1, 25,
                           work, SHARD_CHILD_TIMEOUT_S)
        gloo, nccl = gloo.result(), nccl.result()
    ref2 = shard_res[2]
    for rec in gloo:
        r = rec["result"]
        rec["vs_two_shards"] = close(f"gloo rank {rec['rank']}", r["cost"], r["Tcw"], r["Xw"],
                                     r["obs_inlier"], to=ref2)
    sweeps = [rec["launches"]["s_apply"] for rec in gloo]
    check(sweeps[0] == sweeps[1], f"the gloo ranks took {sweeps} PCG sweeps")
    for rec in gloo:
        check(rec["launches"]["d1_assemble"] == 1 + GBA_ITERS,
              f"gloo rank {rec['rank']}: launches {rec['launches']}")
    r = nccl[0]["result"]
    nccl_d = close("nccl group of one", r["cost"], r["Tcw"], r["Xw"], r["obs_inlier"],
                   to=one_iter)
    check(nccl[0]["launches"]["d1_assemble"] == 2 and nccl[0]["launches"]["s_apply"] >= 1,
          f"nccl: launches {nccl[0]['launches']}")
    out["gloo_ranks"] = [{k: v for k, v in rec.items() if k != "result"} for rec in gloo]
    out["nccl_one_rank"] = {**nccl_d, "launches": nccl[0]["launches"],
                            "seconds": nccl[0]["seconds"]}
    print(f"phase 19 (b) two gloo processes on one card, one shard each: sweeps {sweeps}, "
          f"seconds (plan and {GBA_ITERS} LM iterations) "
          f"{[round(rec['seconds'], 3) for rec in gloo]}; against (a)'s two shards "
          f"{[rec['vs_two_shards'] for rec in gloo]}; NCCL group of one, one LM iteration: "
          f"{out['nccl_one_rank']}")

    # (c) the gather formulation over two shards of the observations
    fn = sba.make_sharded_gba(pcg_iters=25, devices=[device] * 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn(*args, n_iterations=GBA_ITERS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out["gather_2"] = {**close("gather formulation", res.cost, res.Tcw.cpu(), res.Xw.cpu(),
                               res.obs_inlier), "iters_per_s": GBA_ITERS / dt}
    print(f"phase 19 (c) gather formulation over two shards: {GBA_ITERS / dt:.4f} LM it/s "
          f"(plain torch); against the tile GBA {out['gather_2']}")
    del fn, res

    # (d) the product GBAJob path on bigmap's maps, sharded over two shards
    torch.cuda.empty_cache()
    dry = entry.dryrun_multichip([device] * 2)
    for label, d in dry.items():
        check(np.isfinite(d["cost"]) and d["mean_pose_err"] < d["mean_pose_err_start"],
              f"dryrun_multichip {label}: {d}")
    out["dryrun_multichip"] = dry

    # (e) the route this machine's product path takes
    n_dev = torch.cuda.device_count()
    chosen = gba_mod._pick_solver(2048, 65536, device=device)
    route = ("mesh" if chosen is gba_mod._solver_cache.get(("mesh", n_dev, 25))
             else "one-device tile GBA" if chosen is gba_mod._solver_cache.get(25) else "other")
    check(n_dev > 1 or route == "one-device tile GBA",
          f"_pick_solver took the {route} route on {n_dev} card(s)")
    out["pick_solver_route"] = {"cards": n_dev, "route": route}
    print(f"phase 19 (e) _pick_solver with {n_dev} card(s) visible: {route}")
    print(json.dumps({"shards": out}))
    return out


def offset_scene(config, offset_y: float, **kw):
    """tests/test_multi_agent.OffsetScene: utils/synth_scene.SynthScene's
    world, the camera path moved ``offset_y`` metres along the camera's y
    axis."""
    from motioncheck_ccm_slam_tpu_torch.utils.synth_scene import SynthScene

    class OffsetScene(SynthScene):
        def pose(self, t):
            T = super().pose(t).copy()
            T[1, 3] += offset_y
            return T

    return OffsetScene(config, **kw)


def four_agent_config():
    """Phase 20's configuration: DEFAULT_CONFIG (1024 feature slots, 8
    levels, client maps 96 x 8192, server maps 2048 x 65,536) on the
    pinhole camera SynthScene renders (as ``cli synth``), with phase 15's
    one cut: map matching from keyframe 2, not 30."""
    import dataclasses

    from motioncheck_ccm_slam_tpu_torch.config import CameraParams, DEFAULT_CONFIG

    return DEFAULT_CONFIG.replace(
        camera=CameraParams(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0),
        placerec=dataclasses.replace(DEFAULT_CONFIG.placerec,
                                     start_map_matching_after_kf=MERGE_START_AFTER_KF))


def four_agent_phase(device, smi: str) -> dict:
    """Phase 20: tests/test_four_agents.py's scene on the card at full
    width: four agents on offset views of one SynthScene world (0.12 m x
    the client id, 500 points, seed 3, 0.9 m/s), 32 frames each with a
    server spin after each round, four flush rounds, then FINALBA. Returns
    its results."""
    from motioncheck_ccm_slam_tpu_torch.config import DEFAULT_CONFIG, SystemParams
    from motioncheck_ccm_slam_tpu_torch.models import gba as gba_mod
    from motioncheck_ccm_slam_tpu_torch.models.tracking import TrackState
    from motioncheck_ccm_slam_tpu_torch.parallel.comm import ClientComm
    from motioncheck_ccm_slam_tpu_torch.system.client import ClientSystem
    from motioncheck_ccm_slam_tpu_torch.system.server import ServerSystem
    from motioncheck_ccm_slam_tpu_torch.utils.synth_scene import SynthScene

    cfg = four_agent_config()
    n, cap = FOUR_AGENTS, cfg.capacity
    print(f"phase 20 four agents: {cfg.camera.width}x{cfg.camera.height}, "
          f"{cfg.extractor.n_levels} levels, {cfg.extractor.max_features} feature slots, client "
          f"maps {cap.client_max_kfs} x {cap.client_max_mps}, server maps {cap.server_max_kfs} "
          f"x {cap.server_max_mps}; the one cut from DEFAULT_CONFIG on the pinhole camera: "
          f"placerec.start_map_matching_after_kf "
          f"{DEFAULT_CONFIG.placerec.start_map_matching_after_kf} -> {MERGE_START_AFTER_KF}; "
          f"{FOUR_AGENT_FRAMES} frames an agent")
    server = ServerSystem(config=cfg, n_agents=n, device=device)
    m0 = server.handlers[0].map
    chosen = gba_mod._pick_solver(m0.nk, m0.nm, device=m0.kf.Tcw.device)
    check(chosen is not None and chosen.__qualname__.startswith("make_tile_gba"),
          f"_pick_solver chose {chosen} at server capacity, not the tile-stream GBA")
    for h in server.handlers.values():
        h.loop_closer.run_gba_after_loop = False
    clients, seqs = [], []
    for cid in range(n):
        c_cfg = cfg.replace(sys=SystemParams(client_id=cid, n_agents=n))
        c = ClientSystem(config=c_cfg, device=device)
        c.comm = ClientComm(config=c_cfg, channel=server.channel_for(cid), client_id=cid)
        clients.append(c)
        scene = (SynthScene(c_cfg, n_points=500, seed=3, speed=0.9) if cid == 0
                 else offset_scene(c_cfg, 0.12 * cid, n_points=500, seed=3, speed=0.9))
        seqs.append(list(scene.sequence(FOUR_AGENT_FRAMES)))    # rendered on the host first
    torch.cuda.synchronize()
    zero_fast_launches()
    frame_ms = [[] for _ in range(n)]
    merged_at = []
    with recorded_gbas() as gbas, timed_calls([(server, "_merge", "merge")]) as parts:
        for i in range(FOUR_AGENT_FRAMES):
            for cid, c in enumerate(clients):
                t, _, img = seqs[cid][i]
                t0 = time.perf_counter()
                c.process_image(img, t)
                torch.cuda.synchronize()
                frame_ms[cid].append((time.perf_counter() - t0) * 1e3)
            before = server.n_merges
            server.spin_once()
            merged_at += [i] * (server.n_merges - before)
        launches = fast_launches()
        for _ in range(4):
            for c in clients:
                c.comm.tick(c.map)
            server.spin_once()
        n_streaming_gbas = len(gbas)
        for h in server.handlers.values():
            h.comm.idle_cycles = 10**9
            h.comm.got_data = False
        n_regba = [h.loop_closer.n_regba for h in server.handlers.values()]
        fired = server.maybe_final_gba()
        again = server.maybe_final_gba()
    final_gbas = gbas[n_streaming_gbas:]

    for cid, c in enumerate(clients):
        check(c.tracker.state == TrackState.OK, f"agent {cid} ends in {c.tracker.state.name}")
    check(server.n_merges == n - 1, f"{server.n_merges} merges, not {n - 1}")
    maps = {id(h.map) for h in server.handlers.values()}
    check(len(maps) == 1, f"the handlers point at {len(maps)} maps")
    m = server.handlers[0].map
    cids = {cid for (_, cid) in m.kf_slot_by_id}
    check(cids == set(range(n)), f"the fused map holds client ids {cids}")
    check(fired and server.final_gba_done and not again,
          f"the final GBA fired {fired}, then {again}")
    check(len(final_gbas) == 1, f"{len(final_gbas)} final GBAs")
    check(n_regba == [h.loop_closer.n_regba for h in server.handlers.values()],
          "FINALBA re-armed a loop closer's GBA")
    streaming = gbas[:n_streaming_gbas]
    check(len(streaming) == n - 1, f"{len(streaming)} merge GBAs for {server.n_merges} merges")
    for label, g in [(f"merge GBA {i}", g) for i, g in enumerate(streaming)] + [
            ("FINALBA", final_gbas[0])]:
        check(all(g["launches"][k] >= 1 for k in GBA_KERNELS),
              f"the {label}'s launches {g['launches']}")
    valid = m.kf.valid.cpu().numpy()
    cid_arr = m.kf.client_id.cpu().numpy()
    spans = []
    for cid in range(n):
        sel = valid & (cid_arr == cid)
        check(sel.any(), f"agent {cid} contributed no keyframes")
        C = np.stack([np.linalg.inv(T)[:3, 3] for T in m.kf.Tcw.cpu().numpy()[sel]])
        span = C.max(0) - C.min(0)
        spans.append(span.tolist())
        check(span[0] > 2 * span[1], f"agent {cid}'s path spans {span}: not the shared x axis")
    for name, k in launches.items():
        check(k == n * FOUR_AGENT_FRAMES, f"{name} launched {k} times in {FOUR_AGENT_FRAMES} "
              f"frames of {n} agents")
    out = {"card": smi, "n_merges": server.n_merges, "merged_after_frame": merged_at,
           "merge_s": parts["merge"], "kfs": len(m.kf_slot_by_id), "landmarks": m.n_mps,
           "client_ids": sorted(cids), "kf_centre_spans": spans, "launches": launches,
           "frame_ms_median": [statistics.median(v) for v in frame_ms],
           "final_gba": final_gbas[0], "merge_gbas": streaming}
    fg = final_gbas[0]
    print(f"phase 20 four agents: merges after frames {merged_at} ({server.n_merges}), one fused "
          f"map of {out['kfs']} KFs and {m.n_mps} landmarks with client ids {sorted(cids)}; "
          f"launches {launches}")
    print(f"phase 20 times on {smi}: frame medians "
          + ", ".join(f"{v:.1f}" for v in out["frame_ms_median"])
          + " ms; merges " + ", ".join(f"{s:.3f}" for s in parts["merge"]) + " s, their GBAs "
          + ", ".join(f"{g['seconds']:.3f} s (interrupted {g['interrupted']}, launches "
                      f"{g['launches']})" for g in streaming)
          + f"; FINALBA once, {fg['seconds']:.3f} s (solver {fg['solver_s']:.3f}, host plan "
          f"{fg['plan_s']:.3f}, MC {fg['mc_s']:.3f}), launches {fg['launches']}")
    print(json.dumps({"four_agents": out}))
    return out


class PhaseClock:
    """Prints each phase's own seconds (host clock) as the next begins."""

    def __init__(self):
        self.phase, self.t0, self.seconds = None, time.perf_counter(), {}

    def start(self, phase) -> None:
        now = time.perf_counter()
        if self.phase is not None:
            self.seconds[self.phase] = now - self.t0
            print(f"phase {self.phase} took {now - self.t0:.2f} s")
        self.phase, self.t0 = phase, now


CLOCK = PhaseClock()


def main() -> None:
    # phase 1: the card
    CLOCK.start(1)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false: no GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    device = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from motioncheck_ccm_slam_tpu_torch.config import DEFAULT_CONFIG
    from motioncheck_ccm_slam_tpu_torch.entry import entry
    from motioncheck_ccm_slam_tpu_torch.models import frame as frame_mod
    from motioncheck_ccm_slam_tpu_torch.models.tracking import Tracker, TrackState
    from motioncheck_ccm_slam_tpu_torch.ops import fast_cuda, image as image_ops, schur_cuda
    from motioncheck_ccm_slam_tpu_torch.utils import native

    cfg = DEFAULT_CONFIG
    ex = cfg.extractor
    k1_kw = dict(th_hi=float(ex.ini_th_fast), th_lo=float(ex.min_th_fast),
                 border=ex.edge_threshold)

    CLOCK.start(2)
    # phase 2: build both sources, one nvcc each, started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(fast_cuda.build), pool.submit(schur_cuda.build),
                pool.submit(native.build)]
        log, schur_log, _ = (j.result() for j in jobs)
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s "
          f"({fast_cuda.library_path()}, {schur_cuda.library_path()}, {native.library_path()})")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  " + line.strip())

    scene = PlaneScene(cfg.camera)
    frames = [scene.render(k) for k in range(N_FRAMES + 1)]
    rng = np.random.default_rng(0)
    rendered = image_ops.build_pyramid(torch.from_numpy(frames[0]).to(device),
                                       ex.n_levels, ex.scale_factor)
    level_sets = {
        "rendered": [lv.contiguous() for lv in rendered],
        "random": [torch.from_numpy(rng.uniform(0, 255, tuple(lv.shape))
                                    .astype(np.float32)).to(device) for lv in rendered],
    }

    CLOCK.start(3)
    # phase 3: K1 vs its plain version, bitwise: each frame's 8 levels in
    # one launch, and the one-level wrapper at one odd shape
    odd = torch.from_numpy(np.random.default_rng(4).uniform(0, 255, K2_ODD_SHAPE)
                           .astype(np.float32)).to(device)
    k1_err = 0.0
    n1 = fast_cuda.masked_corner_score_levels.launches
    cases = [(name, fast_cuda.masked_corner_score_levels(levels, **k1_kw), levels)
             for name, levels in level_sets.items()]
    check(fast_cuda.masked_corner_score_levels.launches == n1 + len(level_sets),
          "K1 took more than one launch a frame")
    cases.append(("one-level", [fast_cuda.masked_corner_score(odd, **k1_kw)], [odd]))
    for name, outs, levels in cases:
        for out, lv in zip(outs, levels):
            ref = fast_cuda.masked_corner_score_ref(lv, **k1_kw)
            torch.cuda.synchronize()
            k1_err = max(k1_err, float((out - ref).abs().max()))
            check(torch.equal(out, ref), f"K1 differs from its plain version on the "
                  f"{name} level {tuple(lv.shape)}: max |d| {k1_err:.3g}")
            check(name != "rendered" or int((ref > 0).sum()) > 0,
                  f"no corners on rendered level {tuple(lv.shape)}")
    print(f"phase 3 K1: bitwise equal to its plain version at "
          f"{[tuple(lv.shape) for lv in rendered]}, rendered and random, one launch a "
          f"frame, and the one-level wrapper at {K2_ODD_SHAPE}")

    CLOCK.start(4)
    # phase 4: K2 vs its plain version, within tolerance: each frame's 8
    # levels in one launch, and the one-level wrapper at one odd shape
    cases = [(name, fast_cuda.blur_and_moments_levels(levels, half_patch=ex.half_patch_size),
              levels) for name, levels in level_sets.items()]
    cases.append(("one-level", [fast_cuda.blur_and_moments(odd, half_patch=ex.half_patch_size)],
                  [odd]))
    k2_err = [0.0, 0.0, 0.0]
    for name, outs, levels in cases:
        for out, lv in zip(outs, levels):
            ref = fast_cuda.blur_and_moments_ref(lv, half_patch=ex.half_patch_size)
            torch.cuda.synchronize()
            for c, (o, r, atol) in enumerate(zip(out, ref, K2_ATOL)):
                e = float((o - r).abs().max())
                k2_err[c] = max(k2_err[c], e)
                check(e <= atol, f"K2 map {c} off by {e:.3g} > {atol} on the {name} "
                      f"level {tuple(lv.shape)}")
    print(f"phase 4 K2: max |err| blur {k2_err[0]:.3g}, m10 {k2_err[1]:.3g}, "
          f"m01 {k2_err[2]:.3g} (atol {K2_ATOL}) on every level, one launch a frame, and "
          f"the one-level wrapper at {K2_ODD_SHAPE}")

    CLOCK.start(5)
    # phase 5: track N_FRAMES frames through the port's Tracker
    fr0 = frame_mod.make_frame(cfg, 0, 0.0, frames[0], device)
    fr0.Tcw = torch.from_numpy(scene.pose(0)).to(device)
    mp, n_mps = build_map(fr0.feats, scene, cfg, device)
    tracker = Tracker(config=cfg, map=types.SimpleNamespace(mp=mp), device=device)
    tracker.state, tracker.last_frame, tracker.n_frames = TrackState.OK, fr0, 1
    print(f"phase 5 map: {n_mps} landmarks from frame 0 in "
          f"{cfg.capacity.client_max_mps} slots")
    torch.cuda.synchronize()
    zero_fast_launches()
    errs = []
    for k in range(1, N_FRAMES + 1):
        fr = tracker.process(frames[k], k / cfg.camera.fps)
        Tcw = fr.Tcw.cpu().numpy()
        err = float(np.linalg.norm(-Tcw[:3, :3].T @ Tcw[:3, 3] - scene.center(k)))
        errs.append(err)
        print(f"  frame {k:2d}: inliers {fr.n_tracked:4d}  centre error {err:.4f} m")
        check(tracker.state == TrackState.OK, f"frame {k}: tracking lost")
        check(fr.n_tracked >= MIN_INLIERS, f"frame {k}: {fr.n_tracked} inliers")
    launches = fast_launches()
    check(errs[-1] < MAX_FINAL_ERR_M, f"final centre error {errs[-1]:.4f} m")
    # K1 and K2 once a frame each, over all levels
    for name, n in launches.items():
        check(n == N_FRAMES, f"{name} launched {n} times, expected {N_FRAMES}")
    check(fast_cuda.masked_corner_score.launches == 0 and fast_cuda.blur_and_moments.launches == 0,
          "the tracking step used a one-level K1 or K2 wrapper")
    print(f"phase 5 tracking: {N_FRAMES} frames OK, final centre error "
          f"{errs[-1]:.4f} m, launches {launches}")

    CLOCK.start(6)
    # phase 6: timing (turns: plain, kernel, kernel, plain)
    fn, _ = entry(device)
    img1 = torch.from_numpy(frames[1]).to(device)
    T0 = fr0.Tcw
    args = (img1, T0, T0, mp.Xw, mp.desc, mp.normal, mp.min_dist, mp.max_dist, mp.valid)

    def step():
        return fn(*args)

    for _ in range(3):
        step()
    with plain_kernels():
        for _ in range(2):
            step()
    step_ms = {"kernel": [], "plain": []}
    for turn in ("plain", "kernel", "kernel", "plain"):
        with plain_kernels() if turn == "plain" else contextlib.nullcontext():
            step_ms[turn] += host_ms(step, 10)
    step_med = {k: statistics.median(v) for k, v in step_ms.items()}

    lv1 = [lv.contiguous() for lv in image_ops.build_pyramid(img1, ex.n_levels,
                                                            ex.scale_factor)]
    timed = {   # name -> (kernel, plain version) on a frame's levels
        "masked_corner_score": (
            lambda lvs: fast_cuda.masked_corner_score_levels(lvs, **k1_kw),
            lambda lvs: fast_cuda.masked_corner_score_levels_ref(lvs, **k1_kw)),
        "blur_and_moments": (fast_cuda.blur_and_moments_levels,
                             fast_cuda.blur_and_moments_levels_ref),
    }
    one_level = {"masked_corner_score": lambda lv: fast_cuda.masked_corner_score(lv, **k1_kw),
                 "blur_and_moments": fast_cuda.blur_and_moments}
    kernel_ms = {}
    for name, (kern, plain) in timed.items():
        kernel_ms[name] = turns_ms(lambda: kern(lv1), lambda: plain(lv1), 50, 5)
        level_ms = [cuda_ms(lambda: one_level[name](lv), 100) for lv in lv1]
        print(f"phase 6 {name}: {kernel_ms[name][0]:.4f} ms per frame (one launch) vs "
              f"plain {kernel_ms[name][1]:.4f} ms; each level alone " + ", ".join(
                  f"{tuple(lv.shape)} {ms:.4f}" for lv, ms in zip(lv1, level_ms)) + " ms")
    print(f"phase 6 step: median {step_med['kernel']:.3f} ms with the kernels, "
          f"{step_med['plain']:.3f} ms with the plain versions "
          f"({len(step_ms['kernel'])} steps each, on {smi})")
    check(all(np.isfinite(v) for v in step_med.values()), "non-finite step time")

    # K1/K2 bounds per frame (8 levels). K1's work depends on the data: 16
    # ring taps x 9 f32 ops (the difference, 4 compares and their 4 ORs)
    # for every output pixel, plus 16 x 3 (subtract, max, add) for each of
    # the chosen threshold's two sums on each pixel that scores, counted
    # from the plain version's output on this frame; the count before K1's
    # redesign (16 x 17 for every pixel: all four sums) is printed beside
    # it. K2 does the 7+7-tap blur and 2r separable moment channels of
    # 31+31 FMA taps
    w_k2, rank = k2_library_weight(device)
    px_in = sum(lv.numel() for lv in lv1)
    px_out = sum(int(np.prod(fast_cuda.padded_shape(*lv.shape))) for lv in lv1)
    n_scoring = sum(int((m > 0).sum()) for m in
                    fast_cuda.masked_corner_score_levels_ref(lv1, **k1_kw))
    k1_flat_bound = bound_ms(4 * (px_in + px_out), 16 * 17 * px_out)
    k_bound = {
        "masked_corner_score": bound_ms(4 * (px_in + px_out),
                                        16 * 9 * px_out + 2 * 16 * 3 * n_scoring),
        "blur_and_moments": bound_ms(4 * (px_in + 3 * px_out),
                                     (28 + 2 * rank * 62 * 2) * px_out),
    }
    # K2's library yardstick: one F.conv2d with a 3-channel 31x31 weight on
    # each edge-padded level (the padding is input preparation, not timed);
    # it sums the 961 taps in another order than the separable passes, so it
    # is held to 1e-4 of each map's max-abs
    padded = []
    for lv in lv1:
        hp, wc = fast_cuda.padded_shape(*lv.shape)
        padded.append(torch.nn.functional.pad(
            lv[None, None], (15, wc - lv.shape[1] + 15, 15, hp - lv.shape[0] + 15),
            mode="replicate"))
    for lv, x in zip(lv1, padded):
        lib_maps = torch.nn.functional.conv2d(x, w_k2)[0]
        for o, r in zip(lib_maps, fast_cuda.blur_and_moments_ref(lv)):
            check(relmax(o, r) <= 1e-4, "the conv2d yardstick disagrees with K2's plain version")
    lib_k2 = cuda_ms(lambda: [torch.nn.functional.conv2d(x, w_k2) for x in padded], 20)
    print(f"phase 6 blur_and_moments library call (F.conv2d, 3x31x31): {lib_k2:.4f} ms per frame")
    records = {}
    for name in ("masked_corner_score", "blur_and_moments"):
        b_ms, b_by = k_bound[name]
        records[name] = {
            "launches": launches[name],
            "max_abs_err": k1_err if name == "masked_corner_score" else max(k2_err),
            "ms": kernel_ms[name][0], "plain_ms": kernel_ms[name][1], "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": lib_k2 if name == "blur_and_moments" else None}
        extra = (f"; {n_scoring} scoring pixels of {px_out}; by 16 x 17 operations a "
                 f"pixel (the count before K1's redesign) {k1_flat_bound[0]:.4f} ms "
                 f"({k1_flat_bound[1]})" if name == "masked_corner_score" else "")
        print(f"phase 6 {name}: bound {b_ms:.4f} ms per frame ({b_by}){extra}")

    gba_records, ctx = gba_phases(device, smi, schur_log)
    records.update(gba_records)
    records.update(mf_phases(device, smi, ctx))
    shard_ctx = {k: ctx[k] for k in ("args_p", "res_k", "iters_per_s_perturbed",
                                     "iters_per_s_bench")}
    del ctx
    CLOCK.start(13)
    driver_phases(device, smi)
    CLOCK.start(14)
    agent_phase(device, smi)
    CLOCK.start(15)
    merge_phase(device, smi)
    CLOCK.start(16)
    loop_phase(device, smi)
    CLOCK.start(17)
    cli_phase(device, smi)
    CLOCK.start(18)
    tcp_phase(device, smi)
    CLOCK.start(19)
    shard_phase(device, smi, shard_ctx)
    del shard_ctx
    CLOCK.start(20)
    four_agent_phase(device, smi)
    CLOCK.start(None)
    print(json.dumps({"phase_seconds": CLOCK.seconds}))

    print(json.dumps({"step_ms": step_med["kernel"], "step_plain_ms": step_med["plain"],
                      "final_centre_error_m": errs[-1], "card": smi}))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
         **records[name]} for name in SOURCE]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
