"""Per-phase clocks and ablations of the port's K3, K4, K5 and K7 on the card.

Builds edited copies of motioncheck_ccm_slam_tpu_torch/csrc/schur.cu (or of
the file given with --source) under build/schur_probe/ and times them with
CUDA events at bench_gba's shapes. Every copy carries clocks in K4: thread
0 of every K4 block adds clock64() deltas of each phase of a tile (zeroing
and copy issue, the wait for the stage buffer, the A stage, the cluster
barrier, the solves, the B stage) into a device counter.

K4 and K7 (--only k4_k7): besides the kernel as it is, three copies each
drop one cost, for timing only (their results are wrong or slower): no v
gather in the A stage, no camera-table atomics (plain adds), no warp run
sums (an atomic a slot); a fifth swaps the camera table's atomics of the
two kernels (single f32 atomics in K4, paired compare-and-swap in K7). Each
copy runs K4 in the geometry the wrapper picks and in a few others, and K7.

K3 and K5 (--only k3_k5): the kernels as they are, and copies in which the
camera sums, the landmark sums or both are plain stores instead of atomic
adds, or the camera sums are dropped (wrong results, timed only), and
copies with right results: the camera tables' atomics swapped (single f32
ones in K3, paired compare-and-swap ones in K5), K3's pose gather as
4-byte loads, 512 threads a block instead of 1024. The edits name
both K3/K5 designs in the repository's history, so --source also takes the
csrc/schur.cu of the commit before their redesign (per-slot global
atomics, no geometry arguments), e.g. from ``git show
<commit>:motioncheck_ccm_slam_tpu_torch/csrc/schur.cu``.

K6 (--only k6): the kernel as it is and two copies whose A stage sums
each warp's run of slots of one landmark first (warp_run_sums), as K4's
does: run_sums_atomics, where the run's first lane takes the three shared
atomics into one table, and run_sums_ordered, where it adds them into its
warp's own table (plain adds, one run at a time where a landmark has two
runs in a warp), the tables then summed in warp order, so that every
landmark's sum is taken in one fixed order. Each copy replaces the source's
apply_a_kernel whole, so --source takes either design (in the design with
warp run sums, run_sums_atomics is the kernel as it is); each is called
twice on one input and the two results compared bitwise.

K8 (--only k8), at bench_gba's shapes and state. The design with one
atomicAdd a block into a zeroed output (the csrc/schur.cu before K8's
redesign) gets the kernel as it is and copies (K8_ATOMIC_VARIANTS): the
pose gather as three 16-byte loads (load_pose_vec, as K3's), uv read as
one float2, no pose load at all (a fixed pose: wrong cost, timed only),
the block's atomicAdd replaced by a plain store of its partial (the
partials then summed by torch), and the three right ones together. The
design with a partial a tile, summed in tile order by a second launch,
gets the kernel as it is and copies with 256 threads a block, without
its register cap, with its slot loop unrolled by the compiler, or
finishing with one atomicAdd a block instead of the ordered sum
(K8_VARIANTS); ptxas's registers are printed for each. Each copy is
called twice on one state, the two costs compared bitwise and with the
plain version.

Usage (on the card): python3 tools/torch_schur_probe.py
    [--only k3_k5|k4_k7|k6|k8] [--source PATH]
"""
import argparse
import ctypes
import os
import re
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
    "no_run_sums": [("if (warp_run_sums(key, a) && key >= 0", "if (key >= 0")],
    # the other atomics of the camera table in each kernel: single in K4's
    # B stage, paired in K7 (results right)
    "swapped_atomics": [("table_add<true>(", "table_add<false>("),
                        ("table_add<false>(", "table_add<true>(")],
}
# K4 geometries tried beside the wrapper's: (cluster, v in shared memory)
K4_GEOMETRIES = ((2, False), (4, True), (6, True))

# K3's and K5's ablations. Each edit names text of one of the two designs
# (per-slot global atomics, or the per-block camera tables); an edit
# whose text a source lacks is left out, but every variant must change
# something in it.
_K3_CAM_OLD = [
    ("        atomicAdd(c + idx, w * (Jc0[i] * Jc0[j] + Jc1[i] * Jc1[j]));",
     "        c[idx] = w * (Jc0[i] * Jc0[j] + Jc1[i] * Jc1[j]);"),
    ("    for (int i = 0; i < 6; ++i) atomicAdd(c + 21 + i, -w * (Jc0[i] * rx + Jc1[i] * ry));",
     "    for (int i = 0; i < 6; ++i) c[21 + i] = -w * (Jc0[i] * rx + Jc1[i] * ry);")]
_K3_LM_OLD = [
    ("        atomicAdd(&lm_acc[j * 3 + q][l], w * (Jl0[j] * Jl0[q] + Jl1[j] * Jl1[q]));",
     "        lm_acc[j * 3 + q][l] = w * (Jl0[j] * Jl0[q] + Jl1[j] * Jl1[q]);"),
    ("      atomicAdd(&lm_acc[9 + j][l], -w * (Jl0[j] * rx + Jl1[j] * ry));",
     "      lm_acc[9 + j][l] = -w * (Jl0[j] * rx + Jl1[j] * ry);")]
_K5_CAM_OLD = [
    ("        atomicAdd(c + idx, WG[i][0] * w[j] + WG[i][1] * w[6 + j] + WG[i][2] * w[12 + j]);",
     "        c[idx] = WG[i][0] * w[j] + WG[i][1] * w[6 + j] + WG[i][2] * w[12 + j];")]
# the camera tables: row_add<N, kPaired> adds a camera's row (K3: N = 27,
# K5: N = 21); lm_add is K3's landmark add after the warp's run sums
_K3_ROW = "row_add<kD1Row, true>(table, cam - c0, x);"
_K5_ROW = "row_add<kD2Row, false>(table, cam - c0, x);"
_K3_CAM_NEW = [(_K3_ROW, "for (int i = 0; i < kD1Row; ++i) table[(cam - c0) * kD1Row + i] = x[i];")]
_K3_LM_NEW = [("if (any) lm_add(lm, l, a);",
               "if (any) for (int r = 0; r < kLmRow; ++r) lm[r * kLm + l] = a[r];")]
_K5_CAM_NEW = [(_K5_ROW, "for (int i = 0; i < kD2Row; ++i) table[(cam - c0) * kD2Row + i] = x[i];")]
K3K5_VARIANTS = {
    "as_is": [],
    "k3_camera_stores": _K3_CAM_OLD + _K3_CAM_NEW,
    "k3_landmark_stores": _K3_LM_OLD + _K3_LM_NEW,
    "k3_both_stores": _K3_CAM_OLD + _K3_LM_OLD + _K3_CAM_NEW + _K3_LM_NEW,
    "k5_camera_stores": _K5_CAM_OLD + _K5_CAM_NEW,
    # no camera sums at all (the slot's work up to them stays)
    "k3_no_camera_sums": [(a, "(void)0;") for a, _ in _K3_CAM_OLD] + [(_K3_ROW, "(void)x;")],
    "k5_no_camera_sums": [(a, "(void)0;") for a, _ in _K5_CAM_OLD] + [(_K5_ROW, "(void)x;")],
    # the camera tables' other atomics: single f32 ones in K3, paired
    # compare-and-swap ones in K5
    "swapped_atomics": [(_K3_ROW, _K3_ROW.replace("true", "false")),
                        (_K5_ROW, _K5_ROW.replace("false", "true"))],
    # K3's pose gather as twelve 4-byte loads instead of three 16-byte ones
    "k3_scalar_pose_loads": [("  load_pose_vec(P.pose, cam, R, t);",
                              "  for (int q = 0; q < 9; ++q) R[q] = __ldg(P.pose + cam * 12 + q);\n"
                              "  for (int q = 0; q < 3; ++q) t[q] = __ldg(P.pose + cam * 12 + 9 + q);")],
    # half the threads a block, twice the registers a thread
    "threads_512": [("constexpr int kD1Threads = 1024;", "constexpr int kD1Threads = 512;"),
                    ("constexpr int kD2Threads = 1024;", "constexpr int kD2Threads = 512;")],
}

# K6's kernel with its A stage summing each warp's runs of one landmark
# first; {add} is how the run's first lane adds the run's three sums
_K6_KERNEL = """__global__ void __launch_bounds__(kThreads)
apply_a_kernel(const int* __restrict__ camid, const int* __restrict__ lmloc,
               const float* __restrict__ W18, const float* __restrict__ v,
               const float* __restrict__ H9, int TP, size_t OP, size_t L_pad,
               float* __restrict__ u) {{
  constexpr int kWarps = kThreads / 32;
  __shared__ float part[{tables}][3 * kLm];
  for (int i = threadIdx.x; i < {tables} * 3 * kLm; i += blockDim.x) (&part[0][0])[i] = 0.0f;
  __syncthreads();
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float* mine = part[{table}];
  const size_t base = static_cast<size_t>(blockIdx.x) * TP;
  for (int k = threadIdx.x; k < TP; k += blockDim.x) {{
    const size_t s = base + k;
    float w[18];
    float a[3] = {{0.0f, 0.0f, 0.0f}};
    if (load_w(W18, OP, s, w)) {{
      const int cam = camid[s];
      float vc[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) vc[i] = __ldg(v + cam * 6 + i);
#pragma unroll
      for (int j = 0; j < 3; ++j) {{
        a[j] = w[j * 6] * vc[0];
#pragma unroll
        for (int i = 1; i < 6; ++i) a[j] = a[j] + w[j * 6 + i] * vc[i];
      }}
    }}
    const int l = lmloc[s];
    const bool head = warp_run_sums(l, a);
{add}
  }}
  __syncthreads();
  for (int l = threadIdx.x; l < kLm; l += blockDim.x) {{
    float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f;
    for (int q = 0; q < {tables}; ++q) {{
      p0 += part[q][l];
      p1 += part[q][kLm + l];
      p2 += part[q][2 * kLm + l];
    }}
    const size_t g = static_cast<size_t>(blockIdx.x) * kLm + l;
#pragma unroll
    for (int i = 0; i < 3; ++i) {{
      u[i * L_pad + g] = H9[(i * 3) * L_pad + g] * p0 + H9[(i * 3 + 1) * L_pad + g] * p1
                         + H9[(i * 3 + 2) * L_pad + g] * p2;
    }}
  }}
  (void)lane;
  (void)all;
}}
"""
_K6_ATOMIC_ADD = """    if (head && (a[0] != 0.0f || a[1] != 0.0f || a[2] != 0.0f)) {
      atomicAdd(&mine[l], a[0]);
      atomicAdd(&mine[kLm + l], a[1]);
      atomicAdd(&mine[2 * kLm + l], a[2]);
    }"""
_K6_ORDERED_ADD = """    unsigned pend = __ballot_sync(all, head && (a[0] != 0.0f || a[1] != 0.0f || a[2] != 0.0f));
    while (pend != 0u) {
      const unsigned same = __match_any_sync(all, l) & pend;
      const bool go = ((pend >> lane) & 1u) != 0u && __ffs(same) - 1 == lane;
      if (go) {
        mine[l] += a[0];
        mine[kLm + l] += a[1];
        mine[2 * kLm + l] += a[2];
      }
      __syncwarp();
      pend &= ~__ballot_sync(all, go);
    }"""
K6_VARIANTS = {
    "as_is": None,
    "run_sums_atomics": _K6_KERNEL.format(tables="1", table="0", add=_K6_ATOMIC_ADD),
    "run_sums_ordered": _K6_KERNEL.format(tables="kWarps", table="threadIdx.x >> 5",
                                          add=_K6_ORDERED_ADD),
}


# K8's copies in the design with one atomicAdd a block: (text, the copy's
# text instead)
_K8_POSE = ("    load_pose(pose, cam, R, t);\n", "    load_pose_vec(pose, cam, R, t);\n")
_K8_UV = ("    acc += project_slot(R, t, x_s[0][l], x_s[1][l], x_s[2][l], uv[2 * s], uv[2 * s + 1],",
          "    const float2 q = __ldg(reinterpret_cast<const float2*>(uv) + s);\n"
          "    acc += project_slot(R, t, x_s[0][l], x_s[1][l], x_s[2][l], q.x, q.y,")
_K8_NO_POSE = (_K8_POSE[0],
               "    for (int q = 0; q < 9; ++q) R[q] = q % 4 == 0 ? 1.0f : 0.0f;\n"
               "    t[0] = static_cast<float>(cam) * 1e-9f;\n    t[1] = 0.0f;\n    t[2] = 4.0f;\n")
_K8_STORE = ("    if (threadIdx.x == 0) atomicAdd(out, acc);",
             "    if (threadIdx.x == 0) out[blockIdx.x] = acc;")
K8_ATOMIC_VARIANTS = {
    "as_is": [],
    "pose_vec": [_K8_POSE],
    "uv_float2": [_K8_UV],
    "no_pose": [_K8_NO_POSE],
    "partial_store": [_K8_STORE],
    "pose_vec_uv_float2_partial_store": [_K8_POSE, _K8_UV, _K8_STORE],
}
# the design with a partial a tile: its constants, and the finish
_K8_THREADS = "constexpr int kD0Threads = 512;"
K8_VARIANTS = {
    "as_is": [],
    "threads_256": [(_K8_THREADS, _K8_THREADS.replace("512", "256"))],
    # no register cap from a minimum of blocks an SM
    "no_min_blocks": [("__launch_bounds__(kD0Threads, kD0MinBlocks)",
                       "__launch_bounds__(kD0Threads)")],
    # the slot loop left to the compiler's unrolling
    "unrolled": [("#pragma unroll 1                    // unrolled, the loop takes 40 registers\n",
                  "")],
    # one atomicAdd a block into the zeroed out, no second launch
    # (into partial[0], zeroed by the caller)
    "atomic_finish": [
        ("  if (threadIdx.x == 0) partial[blockIdx.x] = sum;",
         "  if (threadIdx.x == 0) atomicAdd(partial, sum);"),
        ("  if (e != cudaSuccess) return static_cast<int>(e);\n  d0_sum_kernel",
         "  if (true) return static_cast<int>(e);\n  d0_sum_kernel")],
}


def k8_atomic_design(src: str) -> bool:
    """Whether src has K8 with one atomicAdd a block into a zeroed output."""
    return _K8_STORE[0] in src


def k8_part(libs: dict, atomic: bool, pb: dict, dev) -> None:
    tp, d1 = pb["tp"], pb["d1_args"]
    args = d1[:5] + d1[6:]                   # d1_assemble's without free
    ref = float(sc.d0_cost_ref(*args, TP=tp.TP))
    ptrs = [a.data_ptr() for a in args]
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, path in libs.items():
        if atomic:
            lib = cuda_build.load(path, {"mcs_d0_cost": [p] * 8 + [i, i, p, p]})

            def k8():
                out = torch.zeros(tp.ntl, device=dev)   # a partial a block, or out[0]
                err = lib.mcs_d0_cost(*ptrs, tp.ntl, tp.TP, out.data_ptr(), sc._stream())
                cuda_build.check_launch(err, "probe d0_cost")
                return out.sum()
        else:
            lib = cuda_build.load(path, {"mcs_d0_cost": [p] * 8 + [i, i, p, p, p]})

            def k8(atomic=name == "atomic_finish"):
                out = torch.empty((), device=dev)
                partial = (torch.zeros if atomic else torch.empty)(tp.ntl, device=dev)
                err = lib.mcs_d0_cost(*ptrs, tp.ntl, tp.TP, partial.data_ptr(),
                                      out.data_ptr(), sc._stream())
                cuda_build.check_launch(err, "probe d0_cost")
                return partial[0] if atomic else out
        a, b = k8(), k8()
        torch.cuda.synchronize()
        rel = abs(float(a) - ref) / abs(ref)
        print(f"{name} K8: {cs.cuda_ms(k8, 30):.4f} ms in {tp.ntl} blocks, relative error "
              f"{rel:.2g}; two calls bitwise equal: {torch.equal(a, b)}")


def k6_kernel_text(src: str) -> str:
    """The source's apply_a_kernel, from its __global__ line to its end."""
    start = src.index("__global__ void __launch_bounds__(kThreads)\napply_a_kernel(")
    return src[start:src.index("\n}\n", start) + 3]


def instrumented(src: str, edits, some: bool = False) -> str:
    """src with the clocks in and each edit applied at every place its text
    occurs. With ``some``, edits whose text src lacks are left out, but at
    least one must apply."""
    for a, b in CLOCKS:
        if src.count(a) != 1:
            raise RuntimeError(f"probe: {a!r} is not once in the source")
        src = src.replace(a, b)
    if some:
        edits = [e for e in edits if e[0] in src]
        if not edits:
            raise RuntimeError("probe: no edit of this variant applies to the source")
    marked = src
    for i, (a, _) in enumerate(edits):       # every place, each edit on the source
        if a not in src:
            raise RuntimeError(f"probe: {a!r} is not in the source")
        marked = marked.replace(a, f"@EDIT{i}@")
    for i, (_, b) in enumerate(edits):
        marked = marked.replace(f"@EDIT{i}@", b)
    return marked


def legacy_k3_k5(src: str) -> bool:
    """Whether src has K3 and K5 as they were before their redesign: no
    geometry arguments, outputs zeroed by the caller."""
    args = re.search(r"int mcs_d2_precond\(([^)]*)\)", src).group(1)
    return args.count(",") == 7


def load(path: str, legacy: bool) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    sig = {"mcs_s_apply": [p] * 5 + [i, i, p] + [i] * 8 + [p, p],
           "mcs_apply_a": [p] * 5 + [i, i, p, p],
           "mcs_apply_b": [p] * 4 + [i, i, p] + [i] * 4 + [p, p],
           "mcs_s_apply_active_clusters": [i, i], "probe_read": [p]}
    if legacy:
        sig.update(mcs_d1_assemble=[p] * 9 + [i, i] + [p] * 5,
                   mcs_d2_precond=[p] * 4 + [i, i, p, p])
    else:
        sig.update(mcs_d1_assemble=[p] * 9 + [i, i] + [p] * 4 + [i] * 4 + [p, p],
                   mcs_d2_precond=[p] * 4 + [i, i, p] + [i] * 4 + [p, p])
    return cuda_build.load(path, sig)


def build_all(src: str, variants: dict) -> dict:
    """name -> built library path of each variant (name -> (edits, some))
    of src, one nvcc each, started together."""
    out_dir = os.path.join(cuda_build.BUILD_DIR, "..", "schur_probe")
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for name, (edits, some) in variants.items():
        paths[name] = os.path.join(out_dir, f"{name}.cu")
        with open(paths[name], "w") as f:
            f.write(instrumented(src, edits, some))
    with ThreadPoolExecutor(len(paths)) as pool:
        logs = list(pool.map(cuda_build.build, paths.values()))
    for name, log in zip(paths, logs):      # K8's registers
        show = False
        for line in log.splitlines():
            if "Function properties for" in line:
                show = name.startswith("k8_") and "d0_cost" in line
            elif show and ("registers" in line or "stack frame" in line):
                print(f"  {name}: {line.strip()}")
    return paths


def k4_geometry(C, TP, ntl, cluster, v_shared, lib):
    share = sc._round_up(-(-TP // cluster), 32)
    fixed = sc.K4_FIXED_BYTES + C * sc.CAM_ROW_BYTES * (1 + v_shared)
    room = sc.SHARED_BYTES_MAX - fixed
    staged = min(share, (room - sc.STAGE_TILE_BYTES) // sc.STAGE_SLOT_BYTES // 32 * 32)
    smem = fixed + staged * sc.STAGE_SLOT_BYTES + sc.STAGE_TILE_BYTES
    grid = cluster * min(ntl, lib.mcs_s_apply_active_clusters(cluster, smem))
    return sc.CameraReduction("s_apply", ntl, TP, C, grid, cluster, C, share, staged,
                              v_shared, smem)


def problem(dev):
    """bench_gba's problem: the tile plan, K3's arguments at the bench
    state, its W stream, an H9 and seeded v and u."""
    _fn, (Tcw, Xw, obs, K, fixed_cam, fixed_lm) = gba_entry(dev)
    C, L = Tcw.shape[0], Xw.shape[0]
    tp = sba.build_tile_plan(obs, C, L)
    fl_pad = torch.cat([fixed_lm, torch.ones(tp.L_pad - L, dtype=torch.bool, device=dev)])
    st = sba.tile_streams(tp, obs, K, fixed_cam, fl_pad)
    X0 = torch.cat([Xw, torch.zeros((tp.L_pad - L, 3), device=dev)])
    d1_args = (tp.camid, tp.lmloc, st.uv, st.is2, st.valid, st.free, st.kp,
               sc.pose_table(Tcw), X0)
    W, _, hllbl, _ = sc.d1_assemble_ref(*d1_args, TP=tp.TP)
    Hll_d = ba_core.damp_blocks(hllbl[0:9].T.reshape(tp.L_pad, 3, 3),
                                torch.tensor(1e-4, device=dev))
    Hll_d = torch.where(fl_pad[:, None, None], torch.eye(3, device=dev), Hll_d)
    H9 = ba_core.inv33(Hll_d).reshape(tp.L_pad, 9).T.contiguous()
    rng = np.random.default_rng(2)
    v = torch.from_numpy(rng.normal(0, 1e-2, (C, 6)).astype(np.float32)).to(dev)
    u = torch.from_numpy(rng.normal(0, 1e-2, (3, tp.L_pad)).astype(np.float32)).to(dev)
    return dict(C=C, tp=tp, d1_args=d1_args, W=W, H9=H9, v=v, u=u)


def k4_k7_part(libs: dict, pb: dict, dev) -> None:
    C, tp, W, H9, v, u = pb["C"], pb["tp"], pb["W"], pb["H9"], pb["v"], pb["u"]
    TP, ntl = tp.TP, tp.ntl
    ref4 = sc.s_apply_ref(tp.camid, tp.lmloc, W, v, H9, TP=TP)
    ref7 = sc.apply_b_raw_ref(tp.camid, tp.lmloc, W, u, C, TP=TP)
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


def k3_k5_part(libs: dict, legacy: bool, pb: dict, dev) -> None:
    C, tp, W, H9 = pb["C"], pb["tp"], pb["W"], pb["H9"]
    TP, ntl, OP, L_pad = tp.TP, tp.ntl, tp.ntl * tp.TP, tp.L_pad
    d1 = pb["d1_args"]
    ref3 = sc.d1_assemble_ref(*d1, TP=TP)
    ref5 = sc.d2_precond_ref(tp.camid, tp.lmloc, W, H9, C, TP=TP)
    W18 = torch.empty((18, OP), device=dev)
    aux = torch.empty((3, OP), device=dev)
    hllbl = torch.empty((12, L_pad), device=dev)
    cam27 = torch.empty((C, sc.D1_CAM_ROWS), device=dev)
    out5 = torch.empty((C, sc.D2_CAM_ROWS), device=dev)
    ptrs = [a.data_ptr() for a in d1]
    if not legacy:
        geo3 = sc.launch_geometry("d1_assemble", C, TP, ntl, dev)
        geo5 = sc.launch_geometry("d2_precond", C, TP, ntl, dev)
        part3 = torch.empty((geo3.grid, C, sc.D1_CAM_ROWS), device=dev)
        part5 = torch.empty((geo5.grid, C, sc.D2_CAM_ROWS), device=dev)
        print(f"K3 geometry {geo3._asdict()}; K5 geometry {geo5._asdict()}")
    for name, lib in libs.items():
        def k3():
            if legacy:
                cam27.zero_()
                err = lib.mcs_d1_assemble(*ptrs, ntl, TP, W18.data_ptr(), aux.data_ptr(),
                                          hllbl.data_ptr(), cam27.data_ptr(), sc._stream())
            else:
                err = lib.mcs_d1_assemble(*ptrs, ntl, TP, W18.data_ptr(), aux.data_ptr(),
                                          hllbl.data_ptr(), cam27.data_ptr(), C, geo3.grid,
                                          geo3.cam_range, geo3.shared_bytes, part3.data_ptr(),
                                          sc._stream())
            cuda_build.check_launch(err, "probe d1_assemble")

        def k5():
            if legacy:
                out5.zero_()
                err = lib.mcs_d2_precond(tp.camid.data_ptr(), tp.lmloc.data_ptr(), W.data_ptr(),
                                         H9.data_ptr(), ntl, TP, out5.data_ptr(), sc._stream())
            else:
                err = lib.mcs_d2_precond(tp.camid.data_ptr(), tp.lmloc.data_ptr(), W.data_ptr(),
                                         H9.data_ptr(), ntl, TP, out5.data_ptr(), C, geo5.grid,
                                         geo5.cam_range, geo5.shared_bytes, part5.data_ptr(),
                                         sc._stream())
            cuda_build.check_launch(err, "probe d2_precond")
        k3()
        k5()
        torch.cuda.synchronize()
        e3 = {k: cs.relmax(a, b) for k, a, b in (("W18", W18, ref3[0]), ("hllbl", hllbl, ref3[2]),
                                                 ("cam27", cam27, ref3[3]))}
        e5 = cs.relmax(out5, ref5)
        ms3, ms5 = cs.cuda_ms(k3, 30), cs.cuda_ms(k5, 30)
        print(f"{name} K3: {ms3:.4f} ms, relative errors "
              + ", ".join(f"{k} {e:.2g}" for k, e in e3.items()))
        print(f"{name} K5: {ms5:.4f} ms, relative error {e5:.2g}")


def k6_part(libs: dict, pb: dict, dev) -> None:
    tp, W, H9, v = pb["tp"], pb["W"], pb["H9"], pb["v"]
    ref = sc.apply_a_raw_ref(tp.camid, tp.lmloc, W, v, H9, TP=tp.TP)
    for name, lib in libs.items():
        def k6():
            u = torch.empty((3, tp.L_pad), device=dev)
            err = lib.mcs_apply_a(tp.camid.data_ptr(), tp.lmloc.data_ptr(), W.data_ptr(),
                                  v.data_ptr(), H9.data_ptr(), tp.ntl, tp.TP, u.data_ptr(),
                                  sc._stream())
            cuda_build.check_launch(err, "probe apply_a")
            return u
        a, b = k6(), k6()
        torch.cuda.synchronize()
        print(f"{name} K6: {cs.cuda_ms(k6, 30):.4f} ms, relative error "
              f"{max(cs.relmax(a, ref), cs.relmax(b, ref)):.2g}; two calls bitwise equal: "
              f"{torch.equal(a, b)}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("k3_k5", "k4_k7", "k6", "k8"))
    ap.add_argument("--source", default=sc.SOURCE)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_schur_probe: needs an NVIDIA GPU")
    dev = torch.device("cuda:0")
    with open(a.source) as f:
        src = f.read()
    legacy = legacy_k3_k5(src)
    parts = ("k4_k7", "k3_k5", "k6", "k8") if a.only is None else (a.only,)
    variants = {}
    if "k4_k7" in parts:
        variants.update({f"k4k7_{n}": (e, False) for n, e in VARIANTS.items()})
    if "k3_k5" in parts:    # the variants that apply to this design of K3 and K5
        variants.update({f"k3k5_{n}": (e, bool(e)) for n, e in K3K5_VARIANTS.items()
                         if not e or any(t in src for t, _ in e)})
    if "k6" in parts:       # each copy's kernel in place of the source's
        variants.update({f"k6_{n}": ([] if t is None else [(k6_kernel_text(src), t)], False)
                         for n, t in K6_VARIANTS.items()})
    atomic_k8 = k8_atomic_design(src)
    if "k8" in parts:
        variants.update({f"k8_{n}": (e, False) for n, e in
                         (K8_ATOMIC_VARIANTS if atomic_k8 else K8_VARIANTS).items()})
    paths = build_all(src, variants)
    libs = {name: load(path, legacy) for name, path in paths.items()
            if not name.startswith("k8_")}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    design = "per-slot global atomics" if legacy else "per-block camera tables"
    print(f"{smi}; source {a.source}, K3 and K5 with {design}")
    pb = problem(dev)
    if "k4_k7" in parts:
        k4_k7_part({n[5:]: lib for n, lib in libs.items() if n.startswith("k4k7_")}, pb, dev)
    if "k3_k5" in parts:
        k3_k5_part({n[5:]: lib for n, lib in libs.items() if n.startswith("k3k5_")}, legacy,
                   pb, dev)
    if "k6" in parts:
        k6_part({n[3:]: lib for n, lib in libs.items() if n.startswith("k6_")}, pb, dev)
    if "k8" in parts:
        k8_part({n[3:]: path for n, path in paths.items() if n.startswith("k8_")}, atomic_k8,
                pb, dev)


if __name__ == "__main__":
    main()
