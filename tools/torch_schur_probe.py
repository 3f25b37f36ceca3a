"""Per-phase clocks and ablations of the port's K4 and K7 on the card.

Builds instrumented copies of motioncheck_ccm_slam_tpu_torch/csrc/schur.cu
under build/schur_probe/: thread 0 of every K4 block adds clock64()
deltas of each phase of a tile (zeroing and copy issue, the wait for the
stage buffer, the A stage, the cluster barrier, the solves, the B stage)
into a device counter. Besides the kernel as it is, three copies each
drop one cost, for timing only (their results are wrong or slower): no v
gather in the A stage, no camera-table atomics (plain adds), no warp run
sums (an atomic a slot); a fifth swaps the camera table's atomics of the
two kernels (single f32 atomics in K4, paired compare-and-swap in K7).
Each copy runs K4 at bench_gba's shapes in the geometry the wrapper picks
and in a few others, and K7, with CUDA-event times.

Usage (on the card): python3 tools/torch_schur_probe.py
"""
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402
from motioncheck_ccm_slam_tpu_torch.entry import gba_entry  # noqa: E402
from motioncheck_ccm_slam_tpu_torch.ops import cuda_build, schur_cuda as sc  # noqa: E402
from motioncheck_ccm_slam_tpu_torch.parallel import sharded_ba as sba  # noqa: E402
from motioncheck_ccm_slam_tpu_torch.solvers import ba_core  # noqa: E402

PHASES = ("issue_and_zero", "wait", "A", "cluster_sync", "solve", "B")


def _tick(i: int) -> str:
    return (f"    if (threadIdx.x == 0) {{ long long now = clock64(); ph[{i}] += now - tc; "
            f"tc = now; }}\n")


# (text in csrc/schur.cu, what the instrumented copy has instead)
CLOCKS = [
    ("  const int lane = threadIdx.x & 31;\n  if (threadIdx.x == 0) {\n    mbar_init",
     "  const int lane = threadIdx.x & 31;\n  long long ph[6] = {0, 0, 0, 0, 0, 0};\n"
     "  long long tc = clock64();\n  if (threadIdx.x == 0) {\n    mbar_init"),
    ("    mbar_wait(bar, static_cast<uint32_t>(it & 1));\n",
     _tick(0) + "    mbar_wait(bar, static_cast<uint32_t>(it & 1));\n" + _tick(1)),
    ("    cluster.sync();\n    // 2.", _tick(2) + "    cluster.sync();\n" + _tick(3) + "    // 2."),
    ("    __syncthreads();\n    // 3. B stage",
     "    __syncthreads();\n" + _tick(4) + "    // 3. B stage"),
    ("    __syncthreads();    // the buffer, u_s and the next u_part are free again\n",
     "    __syncthreads();    // the buffer, u_s and the next u_part are free again\n" + _tick(5)),
    ("  cluster.sync();       // no rank leaves",
     "  if (threadIdx.x == 0) { for (int i = 0; i < 6; ++i) atomicAdd(&g_probe[i], "
     "(unsigned long long)ph[i]); atomicAdd(&g_probe[6], (unsigned long long)(t1 - t0)); }\n"
     "  cluster.sync();       // no rank leaves"),
    ("namespace {\n\nconstexpr int kLm = 128;",
     "__device__ unsigned long long g_probe[7];\nnamespace {\n\nconstexpr int kLm = 128;"),
    ('extern "C" {\n',
     'extern "C" {\nint probe_read(unsigned long long* h) { cudaMemcpyFromSymbol(h, g_probe, 56); '
     'unsigned long long z[7] = {0}; return (int)cudaMemcpyToSymbol(g_probe, z, 56); }\n'),
]
VARIANTS = {
    "as_is": [],
    "no_v_gather": [
        ("            for (int i = 0; i < 6; ++i) vc[i] = v_s[cam * 6 + i];",
         "            for (int i = 0; i < 6; ++i) vc[i] = 1.0f;"),
        ("            for (int i = 0; i < 6; ++i) vc[i] = __ldg(v + cam * 6 + i);",
         "            for (int i = 0; i < 6; ++i) vc[i] = 1.0f;")],
    "no_camera_atomics": [
        ("    for (int i = 0; i < 6; i += 2) atomic_add_pair(row + i, o[i], o[i + 1]);",
         "    for (int i = 0; i < 6; ++i) row[i] += o[i];"),
        ("    for (int i = 0; i < 6; ++i) atomicAdd(row + i, o[i]);",
         "    for (int i = 0; i < 6; ++i) row[i] += o[i];")],
    "no_run_sums": [("if (warp_run_sum(key, a0, a1, a2) && key >= 0", "if (key >= 0")],
    # the other atomics of the camera table in each kernel: single in K4's
    # B stage, paired in K7 (results right)
    "swapped_atomics": [("table_add<true>(", "table_add<false>("),
                        ("table_add<false>(", "table_add<true>(")],
}
# K4 geometries tried beside the wrapper's: (cluster, v in shared memory)
K4_GEOMETRIES = ((2, False), (4, True), (6, True))


def instrumented(edits) -> str:
    with open(sc.SOURCE) as f:
        src = f.read()
    for a, b in CLOCKS:
        if src.count(a) != 1:
            raise RuntimeError(f"probe: {a!r} is not once in {sc.SOURCE}")
        src = src.replace(a, b)
    marked = src
    for i, (a, _) in enumerate(edits):       # every place, each edit on the source
        if a not in src:
            raise RuntimeError(f"probe: {a!r} is not in {sc.SOURCE}")
        marked = marked.replace(a, f"@EDIT{i}@")
    for i, (_, b) in enumerate(edits):
        marked = marked.replace(f"@EDIT{i}@", b)
    return marked


def load(path: str) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return cuda_build.load(path, {"mcs_s_apply": [p] * 5 + [i, i, p] + [i] * 8 + [p, p],
                                  "mcs_apply_b": [p] * 4 + [i, i, p] + [i] * 4 + [p, p],
                                  "mcs_s_apply_active_clusters": [i, i], "probe_read": [p]})


def k4_geometry(C, TP, ntl, cluster, v_shared, lib):
    share = sc._round_up(-(-TP // cluster), 32)
    fixed = sc.K4_FIXED_BYTES + C * sc.CAM_ROW_BYTES * (1 + v_shared)
    room = sc.SHARED_BYTES_MAX - fixed
    staged = min(share, (room - sc.STAGE_TILE_BYTES) // sc.STAGE_SLOT_BYTES // 32 * 32)
    smem = fixed + staged * sc.STAGE_SLOT_BYTES + sc.STAGE_TILE_BYTES
    grid = cluster * min(ntl, lib.mcs_s_apply_active_clusters(cluster, smem))
    return sc.CameraReduction("s_apply", ntl, TP, C, grid, cluster, C, share, staged,
                              v_shared, smem)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_schur_probe: needs an NVIDIA GPU")
    dev = torch.device("cuda:0")
    os.makedirs(os.path.join(cuda_build.BUILD_DIR, "..", "schur_probe"), exist_ok=True)
    paths = {}
    for name, edits in VARIANTS.items():
        paths[name] = os.path.join(cuda_build.BUILD_DIR, "..", "schur_probe", f"{name}.cu")
        with open(paths[name], "w") as f:
            f.write(instrumented(edits))
    with ThreadPoolExecutor(len(paths)) as pool:
        list(pool.map(cuda_build.build, paths.values()))
    libs = {name: load(path) for name, path in paths.items()}

    fn, (Tcw, Xw, obs, K, fixed_cam, fixed_lm) = gba_entry(dev)
    C, L = Tcw.shape[0], Xw.shape[0]
    tp = sba.build_tile_plan(obs, C, L)
    TP, ntl = tp.TP, tp.ntl
    fl_pad = torch.cat([fixed_lm, torch.ones(tp.L_pad - L, dtype=torch.bool, device=dev)])
    st = sba.tile_streams(tp, obs, K, fixed_cam, fl_pad)
    X0 = torch.cat([Xw, torch.zeros((tp.L_pad - L, 3), device=dev)])
    W, _, hllbl, _ = sc.d1_assemble(tp.camid, tp.lmloc, st.uv, st.is2, st.valid, st.free,
                                    st.kp, sc.pose_table(Tcw), X0, TP=TP)
    Hll_d = ba_core.damp_blocks(hllbl[0:9].T.reshape(tp.L_pad, 3, 3),
                                torch.tensor(1e-4, device=dev))
    Hll_d = torch.where(fl_pad[:, None, None], torch.eye(3, device=dev), Hll_d)
    H9 = ba_core.inv33(Hll_d).reshape(tp.L_pad, 9).T.contiguous()
    rng = np.random.default_rng(2)
    v = torch.from_numpy(rng.normal(0, 1e-2, (C, 6)).astype(np.float32)).to(dev)
    u = torch.from_numpy(rng.normal(0, 1e-2, (3, tp.L_pad)).astype(np.float32)).to(dev)
    ref4 = sc.s_apply_ref(tp.camid, tp.lmloc, W, v, H9, TP=TP)
    ref7 = sc.apply_b_raw_ref(tp.camid, tp.lmloc, W, u, C, TP=TP)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi)
    counts = (ctypes.c_ulonglong * 7)()
    for name, lib in libs.items():
        geo7 = sc.launch_geometry("apply_b", C, TP, ntl, dev)
        part7 = torch.empty((geo7.grid, C, 6), device=dev)

        def k7():
            out = torch.empty((C, 6), device=dev)
            err = lib.mcs_apply_b(tp.camid.data_ptr(), tp.lmloc.data_ptr(), W.data_ptr(),
                                  u.data_ptr(), ntl, TP, out.data_ptr(), C, geo7.grid,
                                  geo7.cam_range, geo7.shared_bytes, part7.data_ptr(), sc._stream())
            cuda_build.check_launch(err, "probe apply_b")
            return out
        err7 = cs.relmax(k7(), ref7)
        print(f"{name} K7: {cs.cuda_ms(k7, 30):.4f} ms, relative error {err7:.2g}")
        wrapper = sc.launch_geometry("s_apply", C, TP, ntl, dev)
        for geo in (wrapper,) + tuple(k4_geometry(C, TP, ntl, *g, lib) for g in K4_GEOMETRIES):
            partial = torch.empty((geo.grid, C, 6), device=dev)

            def k4():
                out = torch.empty((C, 6), device=dev)
                err = lib.mcs_s_apply(tp.camid.data_ptr(), tp.lmloc.data_ptr(), W.data_ptr(),
                                      v.data_ptr(), H9.data_ptr(), ntl, TP, out.data_ptr(), C,
                                      geo.grid, geo.cluster, geo.cam_range, geo.share,
                                      geo.staged, int(geo.v_shared), geo.shared_bytes,
                                      partial.data_ptr(), sc._stream())
                cuda_build.check_launch(err, "probe s_apply")
                return out
            k4()
            torch.cuda.synchronize()
            lib.probe_read(counts)          # zeroes the counters
            err4 = cs.relmax(k4(), ref4)
            torch.cuda.synchronize()
            lib.probe_read(counts)
            tiles = max(counts[6], 1)
            cycles = {p: round(counts[i] / tiles) for i, p in enumerate(PHASES)}
            tag = "wrapper's" if geo is wrapper else "other"
            print(f"{name} K4 ({tag}: cluster {geo.cluster}, v shared {geo.v_shared}, "
                  f"{geo.grid // geo.cluster} clusters): "
                  f"{cs.cuda_ms(k4, 30):.4f} ms, relative error {err4:.2g}; "
                  f"thread 0's cycles a tile {cycles}")


if __name__ == "__main__":
    main()
