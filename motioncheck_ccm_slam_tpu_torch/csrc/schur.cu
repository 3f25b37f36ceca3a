// Tile-stream GBA kernels for Hopper (sm_90a), plain C interface.
//
// K3 mcs_d1_assemble replaces motioncheck_ccm_slam_tpu/ops/schur_pallas.py:
//    d1_assemble (body _d1_kernel with _pose_point_streams and _project).
// K4 mcs_s_apply replaces schur_pallas.py: s_apply (body _s_kernel).
// K5 mcs_d2_precond replaces schur_pallas.py: d2_precond (body _d2_kernel).
// K6 mcs_apply_a replaces schur_pallas.py: apply_a_raw (body _kernel_a).
// K7 mcs_apply_b replaces schur_pallas.py: apply_b_raw (body _kernel_b);
//    with K6 it also serves the plan-form apply_a, apply_b and schur_apply
//    (schur_pallas.py:377, :408, :423, the same _kernel_a/_kernel_b bodies).
// K8 mcs_d0_cost replaces schur_pallas.py: d0_cost (body _d0_kernel).
// K9 mcs_expand_streams replaces schur_pallas.py: expand_sorted_streams
//    (body _kernel_c).
//
// Layout. Observations lie in landmark-aligned tiles: tile t holds the
// (padded) slots of landmarks [128t, 128t+128), TP slots a tile, OP = ntl*TP
// slots in all. Every slot has a camera id and a tile-local landmark id.
// K6, K8: one block runs one tile; K6's warps and K8's threads stride over
// the tile's slots. K3, K4, K5 and K7 run persistent grids, described at
// each kernel.
//
// - Camera-side inputs (the (C,12) pose table, the (C,6) vector v) are read
//   in f32 through the read-only cache. The Pallas kernels expanded them with
//   one-hot MXU products of bf16 splits; here the gather is native and exact.
// - Landmark-side sums (Hll+bl, W^T v) go into shared memory: a tile lies
//   whole in one block (in K4, one cluster), so these need no global atomics
//   and no second pass. K3, K4 and K6 first sum each warp's run of slots of
//   one landmark (warp_run_sums), so that one lane a run takes the atomics.
// - Camera-side sums of K3 (Hcc+bc), K4 and K7 (the Schur products) and K5
//   (the preconditioner) go into a camera table in each block's shared
//   memory, flushed once a block and summed in block order by a finishing
//   pass (see "The camera reduction"): no global atomic per slot. Each of
//   these outputs, and K3's and K6's landmark sums, is the same from run to
//   run up to the order of one block's shared-memory atomics, which sum in
//   no fixed order, so they differ in the last bits of f32; the tests hold
//   them to a relative tolerance. Per-slot outputs (K3's W and aux, K9's
//   streams) take no atomics and are the same bits on every run, and so is
//   K8's cost, whose tile partials are summed in tile order.
// - A slot whose weight is zero (a pad slot, an invalid observation, a point
//   behind the camera, or a fixed entity in the W stream) adds exact zeros,
//   so it is skipped before any atomic: pad slots all name camera 0, and
//   their atomics would serialise on one address.
//
// Bounds on this card: the least traffic streams per-slot data once (K3 reads
// 28 and writes 84 bytes a slot, K4-K7 read the 72-byte W row plus 8 bytes of
// ids, K8 reads 24 bytes, K9 reads 8 and writes 60) with 0-350 flops a slot,
// under the f32 ridge of ~20 flop/byte, so all seven are bounded by memory
// traffic. K4 stages each slot's W row and ids in its cluster's shared
// memory, so it reads them once wherever a tile fits 8 blocks' shared memory
// (TP up to ~19,000 slots at C = 2048). What keeps each kernel above its
// one-read bound is said at the kernel: mostly the camera tables' shared
// atomics, which are compare-and-swap loops on this card, and for K4 the
// barriers between a tile's phases; the finishing passes move grid x C x
// 4k bytes twice for k floats a camera (6.3 MB at bench_gba's shapes for
// K4 and K7, k = 6; 29.2 MB for K3, k = 27; 22.7 MB for K5, k = 21).
//
// Each entry point launches on the stream it is given and returns
// cudaGetLastError(); the Python wrapper raises when that is not 0.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLm = 128;            // landmarks per tile (LM_BLOCK)
constexpr int kThreads = 512;       // threads per block
constexpr float kHuberDelta = 2.447f;   // sqrt(5.991)
constexpr float kChi2Gate = 5.991f;

// The 18 W entries of slot s in J-major order: w[j*6+i] = W[i][j].
__device__ __forceinline__ bool load_w(const float* __restrict__ W18, size_t OP,
                                       size_t s, float (&w)[18]) {
  bool any = false;
#pragma unroll
  for (int r = 0; r < 18; ++r) {
    w[r] = W18[r * OP + s];
    any |= w[r] != 0.0f;
  }
  return any;
}

// ---------------------------------------------------------------------------
// The camera reduction of K3, K4, K5 and K7.
// ---------------------------------------------------------------------------
//
// A block owns a table of cameras [c0, c0 + ncam) in dynamic shared memory,
// k floats a camera (K4, K7: 6; K3: 27; K5: 21). It adds the camera-side
// sums of every slot it handles into that table by shared-memory atomics
// (the grids are persistent: a block takes many tiles or slots), then writes
// the table once, with plain stores, to row blockIdx.x of a (grid.x, C, k)
// partial buffer. Where one (C, k) table does not fit beside the rest of a
// block's shared memory, grid.y splits the cameras into ranges of
// cam_range, and a block skips the slots of cameras outside its range.
// camera_sum_kernel then adds the partial rows in block order. No global
// atomic is taken per slot.

__device__ __forceinline__ bool in_range(int cam, int c0, int ncam) {
  return static_cast<unsigned>(cam - c0) < static_cast<unsigned>(ncam);
}

__device__ __forceinline__ void table_zero(float* table, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) table[i] = 0.0f;
}

// p[0] += a and p[1] += b as one 64-bit compare-and-swap loop (p 8-byte
// aligned in shared memory). A shared-memory f32 atomicAdd is itself a
// compare-and-swap loop on this card, so pairing halves the loops.
__device__ __forceinline__ void atomic_add_pair(float* p, float a, float b) {
  unsigned long long* q = reinterpret_cast<unsigned long long*>(p);
  unsigned long long seen = *q, prev;
  do {
    prev = seen;
    const float x = __uint_as_float(static_cast<unsigned>(prev)) + a;
    const float y = __uint_as_float(static_cast<unsigned>(prev >> 32)) + b;
    seen = atomicCAS(q, prev,
                     (static_cast<unsigned long long>(__float_as_uint(y)) << 32)
                         | __float_as_uint(x));
  } while (seen != prev);
}

// table[cam - c0][i] += sum_j W[i][j] u_j, for a camera inside the range:
// six f32 atomics (K7, whose loads they overlap), or three paired ones
// (K4's B stage, which reads shared memory only and is bound by them).
template <bool kPaired>
__device__ __forceinline__ void table_add(float* table, int cam, int c0,
                                          const float (&w)[18], float u0, float u1,
                                          float u2) {
  float* row = table + (cam - c0) * 6;
  float o[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) o[i] = w[i] * u0 + w[6 + i] * u1 + w[12 + i] * u2;
  if (kPaired) {
#pragma unroll
    for (int i = 0; i < 6; i += 2) atomic_add_pair(row + i, o[i], o[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < 6; ++i) atomicAdd(row + i, o[i]);
  }
}

// Row r of a camera table of N floats a row (N odd: K3's 27, K5's 21) +=
// x, by 64-bit compare-and-swap pairs (kPaired) or N single f32 atomics. A
// row starts 8-byte aligned where r is even and 4 bytes past that where r is
// odd (the table itself is 16-byte aligned); the pairs start at its first
// 8-byte boundary, and the entry left over (the last or the first) takes a
// single atomic: (N + 1) / 2 compare-and-swap loops instead of N.
template <int N, bool kPaired>
__device__ __forceinline__ void row_add(float* table, int r, const float (&x)[N]) {
  static_assert(N % 2 == 1, "row_add pairs the entries of odd-width rows");
  float* row = table + r * N;
  if (!kPaired) {
#pragma unroll
    for (int i = 0; i < N; ++i) atomicAdd(row + i, x[i]);
    return;
  }
  const bool odd = r & 1;
  atomicAdd(row + (odd ? 0 : N - 1), odd ? x[0] : x[N - 1]);
#pragma unroll
  for (int p = 0; p < N / 2; ++p) {
    atomic_add_pair(row + 2 * p + (odd ? 1 : 0), odd ? x[2 * p + 1] : x[2 * p],
                    odd ? x[2 * p + 2] : x[2 * p + 1]);
  }
}

// The table (k floats a camera) to partial row blockIdx.x, cameras
// [c0, c0 + ncam) of C, after a __syncthreads() that follows every add (in
// K4 and K7 each thread reads the entries that it zeroed itself, so their
// last __syncthreads() is that barrier).
__device__ __forceinline__ void table_flush(const float* table, int C, int c0, int ncam,
                                            int k, float* __restrict__ partial) {
  float* dst = partial + (static_cast<size_t>(blockIdx.x) * C + c0) * k;
  for (int i = threadIdx.x; i < ncam * k; i += blockDim.x) dst[i] = table[i];
}

constexpr int kSumCols = 32, kSumRows = 8;

// The finishing pass: out[e] = sum_g partial[g][e], e < n = kC. A block
// takes 32 neighbouring entries; thread row r adds rows g = r, r+8, ... in
// turn, then row 0 adds the 8 row sums. The order is fixed, so run-to-run
// differences come only from the shared-memory atomics inside each block.
__global__ void __launch_bounds__(kSumCols * kSumRows)
camera_sum_kernel(const float* __restrict__ partial, int groups, size_t n,
                  float* __restrict__ out) {
  __shared__ float acc_s[kSumRows][kSumCols];
  const size_t e = static_cast<size_t>(blockIdx.x) * kSumCols + threadIdx.x;
  float acc = 0.0f;
  if (e < n) {
    for (int g = threadIdx.y; g < groups; g += kSumRows) acc += partial[g * n + e];
  }
  acc_s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && e < n) {
    float sum = acc_s[0][threadIdx.x];
#pragma unroll
    for (int r = 1; r < kSumRows; ++r) sum += acc_s[r][threadIdx.x];
    out[e] = sum;
  }
}

// After this, the first lane of each run of equal keys among the warp's
// lanes (neighbouring lanes, any key order) holds the run's sums of a.
// Returns whether this lane is such a first lane.
template <int N>
__device__ __forceinline__ bool warp_run_sums(int key, float (&a)[N]) {
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int up = __shfl_up_sync(all, key, 1);      // every lane takes part
  const bool head = lane == 0 || up != key;
  // the run's index: the heads at or below this lane
  const int run = __popc(__ballot_sync(all, head) & ((2u << lane) - 1u));
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int ro = __shfl_down_sync(all, run, d);
    float o[N];
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = __shfl_down_sync(all, a[i], d);
    if (lane + d < 32 && ro == run) {
#pragma unroll
      for (int i = 0; i < N; ++i) a[i] += o[i];
    }
  }
  return head;
}

// ---------------------------------------------------------------------------
// The per-slot projection stage, shared by K3 and K8.
// ---------------------------------------------------------------------------

// Camera row of the (C, 12) pose table (R row-major, then t) by three
// 16-byte loads from a 16-byte aligned table. K3 gives most of an SM's L1
// to its camera table, so twelve 4-byte loads would each be a separate
// request to L2 for a slot's camera; K8 is faster with them too.
__device__ __forceinline__ void load_pose_vec(const float* __restrict__ pose, int cam,
                                              float (&R)[9], float (&t)[3]) {
  const float4* p = reinterpret_cast<const float4*>(pose) + cam * 3;
  const float4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
  R[0] = a.x;
  R[1] = a.y;
  R[2] = a.z;
  R[3] = a.w;
  R[4] = b.x;
  R[5] = b.y;
  R[6] = b.z;
  R[7] = b.w;
  R[8] = c.x;
  t[0] = c.y;
  t[1] = c.z;
  t[2] = c.w;
}

struct Projection {
  float pc0, pc1, pc2;  // camera-frame point
  float iz;             // 1 / depth (1 for a point behind the camera)
  float rx, ry;         // residual uv - projection
  float chi2;           // weighted squared residual
  float w;              // robust weight is2 * huber * valid * front
  float rho;            // robust (Huber) cost, times valid
  bool front;
};

// p_c = R X + t, the residual, chi2, the Huber weight and cost of one slot.
// Depth guard as _project: a point at or behind the camera projects with
// z = 1 and gets zero weight, so every value stays finite.
__device__ __forceinline__ Projection project_slot(const float (&R)[9], const float (&t)[3],
                                                   float X0, float X1, float X2, float u,
                                                   float v, float is2s, float vs, float fx,
                                                   float fy, float cx, float cy) {
  Projection p;
  p.pc0 = R[0] * X0 + R[1] * X1 + R[2] * X2 + t[0];
  p.pc1 = R[3] * X0 + R[4] * X1 + R[5] * X2 + t[1];
  p.pc2 = R[6] * X0 + R[7] * X1 + R[8] * X2 + t[2];
  p.front = p.pc2 > 1e-6f;
  p.iz = 1.0f / (p.front ? p.pc2 : 1.0f);
  p.rx = u - (fx * p.pc0 * p.iz + cx);
  p.ry = v - (fy * p.pc1 * p.iz + cy);
  p.chi2 = (p.rx * p.rx + p.ry * p.ry) * is2s;
  const float e = sqrtf(fmaxf(p.chi2, 1e-12f));
  const bool core = e <= kHuberDelta;
  p.w = is2s * (core ? 1.0f : kHuberDelta / e) * vs * (p.front ? 1.0f : 0.0f);
  p.rho = (core ? p.chi2 : 2.0f * kHuberDelta * e - kHuberDelta * kHuberDelta) * vs;
  return p;
}

// ---------------------------------------------------------------------------
// K3: one linearisation pass.
// ---------------------------------------------------------------------------
//
// Per slot: p = R X + t, residual, chi2, Huber weight, camera Jacobian Jc
// (2x6, left se3 perturbation (omega, upsilon)) and point Jacobian Jl (2x3);
// W = wf Jc^T Jl in J-major rows; aux rows rho / inlier / chi2. Per landmark
// Hll (9, rows j*3+k) and bl (3); per camera the Hcc upper triangle (21,
// PAIRS6 order) and bc (6). Hll and Hcc use w, the W stream w * free (fixed
// entities couple nothing; their blocks are overwritten by the caller).
//
// A persistent grid: block (x, y) takes the tiles [ntl x / X, ntl (x+1) / X)
// of the grid's X blocks along x, each tile whole, and the cameras of range
// y, whose Hcc + bc it adds into its camera table (27 floats a camera,
// 221,184 B at C = 2048: one block an SM). Only range 0's blocks write the
// per-slot outputs and the landmark sums; a block of another range (C above
// 2066) reads a slot's camera id first and skips the slot unless the camera
// is in its range, so that each of those is written once. Landmark side:
// the slots of one landmark are neighbours, so a warp first sums each run of
// one landmark (warp_run_sums, 9 values: Hll's upper triangle and bl), and
// the run's first lane takes the 9 shared atomics into the tile's (9, 128)
// landmark table; there are two such tables, one for odd tiles, so one
// barrier a tile suffices: after it the block writes the tile's hllbl rows
// (Hll mirrored, so exactly symmetric) and zeroes the table for the tile
// after next. X is read through the read-only cache (a tile's 128 points
// are 1.5 KB), each slot's pose row by three 16-byte loads.
//
// Measured on NVIDIA H100 80GB HBM3 cards at 700.00 W (chip_smoke.py phase
// 10 and tools/torch_schur_probe.py; each run's numbers in PERF.md): ~0.20
// ms a call at bench_gba's shapes against a byte bound of 0.0728 ms (~1.02
// ms with a global atomic per slot and camera entry instead). Without
// its camera sums (a wrong result, timed only) it takes ~0.16 ms: the
// per-slot work keeps it at a third of its bound. The camera table takes
// most of the SM's L1, so the pose rows come from L2: as twelve 4-byte
// loads a slot K3 took ~0.25 ms. The table's paired atomics cost ~0.035 ms
// (single f32 atomics ~0.085), the landmark atomics after the run sums
// ~0.01; 512 threads a block instead of 1024 took ~0.23 ms.
constexpr int kD1Threads = 1024;
constexpr int kD1Row = 27;                          // a camera's Hcc upper triangle, bc
constexpr int kLmRow = 9;                           // a landmark's Hll upper triangle, bl
constexpr int kD1FixedBytes = 2 * kLmRow * kLm * 4;    // the two landmark tables

struct D1Params {
  const int* __restrict__ camid;
  const int* __restrict__ lmloc;
  const float* __restrict__ uv;
  const float* __restrict__ is2;
  const float* __restrict__ valid;
  const float* __restrict__ free_;
  const float* __restrict__ kp;
  const float* __restrict__ pose;
  const float* __restrict__ X;
  int ntl, TP, C, cam_range;
  size_t OP, L_pad;
  float* __restrict__ W18;
  float* __restrict__ aux;
  float* __restrict__ hllbl;
  float* __restrict__ partial;
};

// K3's work on slot s, landmark lm (global id), camera cam: the projection,
// robust weight and Jacobians; with kFirst the slot's W and aux and its
// landmark values a (which stay zero where the weight is zero); its Hcc and
// bc into the block's table if cam lies in [c0, c0 + ncam).
template <bool kFirst>
__device__ __forceinline__ void d1_slot(const D1Params& P, const float (&k)[4], size_t s,
                                        size_t lm, int cam, int c0, int ncam, float* table,
                                        float (&a)[kLmRow]) {
  float R[9], t[3];
  load_pose_vec(P.pose, cam, R, t);
  const float vs = P.valid[s];
  const float2 obs = reinterpret_cast<const float2*>(P.uv)[s];
  const Projection p = project_slot(R, t, __ldg(P.X + lm * 3), __ldg(P.X + lm * 3 + 1),
                                    __ldg(P.X + lm * 3 + 2), obs.x, obs.y, P.is2[s], vs,
                                    k[0], k[1], k[2], k[3]);
  const float pc0 = p.pc0, pc1 = p.pc1, pc2 = p.pc2, iz = p.iz, rx = p.rx, ry = p.ry;
  const float w = p.w;
  if (kFirst) {
    P.aux[s] = p.rho;
    P.aux[P.OP + s] = (vs != 0.0f && p.front && p.chi2 <= kChi2Gate) ? vs : 0.0f;
    P.aux[2 * P.OP + s] = p.chi2;
  }
  const float a00 = k[0] * iz, a02 = -k[0] * pc0 * iz * iz;
  const float a11 = k[1] * iz, a12 = -k[1] * pc1 * iz * iz;
  const float Jc0[6] = {-(a02 * pc1), -(a00 * pc2 - a02 * pc0), a00 * pc1, -a00, 0.0f, -a02};
  const float Jc1[6] = {a11 * pc2 - a12 * pc1, a12 * pc0, -a11 * pc0, 0.0f, -a11, -a12};
  float Jl0[3], Jl1[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    Jl0[j] = -(a00 * R[j] + a02 * R[6 + j]);
    Jl1[j] = -(a11 * R[3 + j] + a12 * R[6 + j]);
  }
  if (kFirst) {
    const float wf = w * P.free_[s];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        P.W18[(j * 6 + i) * P.OP + s] = wf * (Jc0[i] * Jl0[j] + Jc1[i] * Jl1[j]);
      }
    }
  }
  if (w == 0.0f) return;
  if (kFirst) {
    int idx = 0;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int q = j; q < 3; ++q) a[idx++] = w * (Jl0[j] * Jl0[q] + Jl1[j] * Jl1[q]);
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) a[6 + j] = -w * (Jl0[j] * rx + Jl1[j] * ry);
  }
  if (!in_range(cam, c0, ncam)) return;
  float x[kD1Row];
  int idx = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) x[idx++] = w * (Jc0[i] * Jc0[j] + Jc1[i] * Jc1[j]);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) x[21 + i] = -w * (Jc0[i] * rx + Jc1[i] * ry);
  row_add<kD1Row, true>(table, cam - c0, x);
}

// lm[r][key] += a[r], r < 9: a landmark run's sums into the tile's table.
__device__ __forceinline__ void lm_add(float* lm, int key, const float (&a)[kLmRow]) {
#pragma unroll
  for (int r = 0; r < kLmRow; ++r) atomicAdd(lm + r * kLm + key, a[r]);
}

__global__ void __launch_bounds__(kD1Threads, 1)
d1_assemble_kernel(const __grid_constant__ D1Params P) {
  extern __shared__ __align__(16) float table[];            // (cam_range, 27)
  const int c0 = blockIdx.y * P.cam_range, ncam = min(P.cam_range, P.C - c0);
  float* lm_tab = table + P.cam_range * kD1Row;             // (2, 9, 128)
  table_zero(table, ncam * kD1Row);
  table_zero(lm_tab, 2 * kLmRow * kLm);
  __syncthreads();
  const float k[4] = {__ldg(P.kp), __ldg(P.kp + 1), __ldg(P.kp + 2), __ldg(P.kp + 3)};
  const int t0 = static_cast<int>(static_cast<long long>(P.ntl) * blockIdx.x / gridDim.x);
  const int t1 = static_cast<int>(static_cast<long long>(P.ntl) * (blockIdx.x + 1) / gridDim.x);
  const bool first = blockIdx.y == 0;
  for (int t = t0, it = 0; t < t1; ++t, ++it) {
    const size_t base = static_cast<size_t>(t) * P.TP, lm0 = static_cast<size_t>(t) * kLm;
    float* lm = lm_tab + (it & 1) * kLmRow * kLm;
    if (first) {
      // whole warps at a time (TP is a multiple of 32): warp_run_sums needs
      // every lane
      for (int kk = threadIdx.x; kk < P.TP; kk += blockDim.x) {
        const size_t s = base + kk;
        const int cam = P.camid[s], l = P.lmloc[s];
        float a[kLmRow] = {};
        d1_slot<true>(P, k, s, lm0 + l, cam, c0, ncam, table, a);
        if (warp_run_sums(l, a)) {
          bool any = false;
#pragma unroll
          for (int r = 0; r < kLmRow; ++r) any |= a[r] != 0.0f;
          if (any) lm_add(lm, l, a);
        }
      }
    } else {
      for (int kk = threadIdx.x; kk < P.TP; kk += blockDim.x) {
        const size_t s = base + kk;
        const int cam = P.camid[s];
        if (!in_range(cam, c0, ncam)) continue;
        float a[kLmRow];
        d1_slot<false>(P, k, s, lm0 + P.lmloc[s], cam, c0, ncam, table, a);
      }
    }
    __syncthreads();
    if (!first) continue;
    // the tile's hllbl: rows j*3+q of Hll (both halves) and 9+j of bl
    for (int i = threadIdx.x; i < kLmRow * kLm; i += blockDim.x) {
      const int r = i / kLm;
      const size_t g = lm0 + i % kLm;
      const float v = lm[i];
      lm[i] = 0.0f;
      if (r < 6) {
        const int j = r < 3 ? 0 : (r < 5 ? 1 : 2), q = r < 3 ? r : (r < 5 ? r - 2 : 2);
        P.hllbl[(j * 3 + q) * P.L_pad + g] = v;
        if (j != q) P.hllbl[(q * 3 + j) * P.L_pad + g] = v;
      } else {
        P.hllbl[(r + 3) * P.L_pad + g] = v;
      }
    }
  }
  // the last __syncthreads() above (or the one after zeroing, for a block
  // without tiles) follows every add into the table
  table_flush(table, P.C, c0, ncam, kD1Row, P.partial);
}

// ---------------------------------------------------------------------------
// K4: the fused PCG product, each slot's W row and ids read once.
// ---------------------------------------------------------------------------
//
// A thread-block cluster of k blocks runs a tile; the grid is persistent, so
// cluster p of P takes the contiguous tiles [ntl p / P, ntl (p+1) / P). Rank
// r of a cluster takes the tile's slots [r share, (r+1) share). Its first
// `staged` slots (W rows, camera and landmark ids) and the tile's H9 come
// into a stage buffer in shared memory by TMA bulk copies, one copy a warp
// (29 of them), counted on an mbarrier; the next tile's copies start as
// soon as the B stage is done with the buffer. Where it fits, each block
// also keeps v (C, 6) in shared memory. Per tile:
//
// 1. A stage: W^T v[cam] of each of the rank's slots, from the buffer (a
//    slot past the staging room, in a tile too wide for 8 blocks, from
//    global memory), into the rank's u_part (3 x 128, two of them, one for
//    odd tiles). Slots of one landmark are neighbours, so a warp first sums
//    each run of one landmark (warp_run_sums) and the run's first lane takes
//    the 3 shared atomics: they no longer serialise on one address across
//    the ~30 slots of a landmark.
// 2. cluster.sync(); every rank sums the k ranks' u_part in rank order
//    through distributed shared memory and solves the tile's 128 3x3
//    systems itself into its own u_s (the same bits on every rank). The
//    u_part of the next tile is the other one, so one cluster barrier a
//    tile is enough.
// 3. B stage: W u[l] of the rank's slots, again from the buffer (the slots
//    past the staging room are read from global memory a second time), into
//    the block's camera table by paired compare-and-swap atomics.
//
// The wrapper (schur_cuda.camera_reduction_geometry) picks the smallest k
// whose share of a tile fits beside the camera table, with v in shared
// memory where that fits too (gathering v from L2 costs more than a smaller
// cluster saves). Shared memory a block: 80 B a staged slot + 4,608 B of
// H9 + 4,608 B of u_part and u_s + 24 B a camera for the table (and as
// much again for v) + 8 B of mbarrier. At bench_gba's shapes (TP = 4224,
// C = 2048): k = 3, 1408 slots a rank, v shared: 117,248 + 4,608 + 49,152
// + 49,152 + 8 = 220,168 B of the 232,448 a block may have, one block an
// SM, 39 clusters resident (117 SMs).
//
// Measured on NVIDIA H100 80GB HBM3 cards at 700.00 W (chip_smoke.py phase
// 10 and tools/torch_schur_probe.py; each run's numbers in PERF.md): ~0.15
// ms a call against a one-read byte bound of 0.0524 ms, about a third of
// the bound's rate. Thread 0's cycles a tile: copy issue and zeroing
// ~3,000, waiting for the buffer ~3,300, A stage 3,800-4,700, cluster
// barrier ~2,100, solves ~900, B stage ~6,500. So what keeps it above its
// bound: a block waits for each tile's copies (a second buffer does not
// fit beside v and the table); its three phases are separated by barriers,
// each a few latency-bound rounds of 32 warps (1408 slots are 44 warp
// rounds); and the B stage's shared compare-and-swap atomics take the
// largest share (with plain adds, a wrong result timed only, ~0.125 ms).
// Gathering v from L2 instead, at k = 2 (the smallest cluster that stages
// a tile, with no room for v), takes ~0.174 ms.
constexpr int kSApplyThreads = 1024;
constexpr int kStageSlotBytes = 80;                 // 18 W floats, camid, lmloc
constexpr int kStageTileBytes = 9 * kLm * 4;        // the tile's H9

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Copies `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One stage buffer: w (18, staged), cam (staged,), lm (staged,), h (9, 128).
struct Stage {
  float* w;
  int* cam;
  int* lm;
  float* h;
};

// load_w for slot j of the buffer: 32-bit shared-memory offsets.
__device__ __forceinline__ bool load_staged_w(const Stage& st, int staged, int j,
                                              float (&w)[18]) {
  bool any = false;
#pragma unroll
  for (int r = 0; r < 18; ++r) {
    w[r] = st.w[r * staged + j];
    any |= w[r] != 0.0f;
  }
  return any;
}

__device__ __forceinline__ Stage stage_at(unsigned char* base, int staged) {
  Stage st;
  st.w = reinterpret_cast<float*>(base);
  st.cam = reinterpret_cast<int*>(st.w + 18 * staged);
  st.lm = st.cam + staged;
  st.h = reinterpret_cast<float*>(st.lm + staged);
  return st;
}

constexpr int kStageCopies = 29;    // 18 W rows, camera ids, landmark ids, 9 H9 rows

// Thread 0, before a __syncthreads(): the bytes the next fill of the buffer
// brings (n staged slots and the tile's H9), and its arrival on `bar`.
__device__ __forceinline__ void stage_expect(uint64_t* bar, int n) {
  const uint32_t tx = static_cast<uint32_t>(n) * kStageSlotBytes + kStageTileBytes;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(tx) : "memory");
}

// After that __syncthreads(): lane 0 of warp c < kStageCopies issues copy c
// of tile t's n staged slots from slot s0 and its H9 into `st`, so that no
// warp is held up by more than one copy.
__device__ __forceinline__ void stage_copy(const Stage& st, uint64_t* bar,
                                           const int* __restrict__ camid,
                                           const int* __restrict__ lmloc,
                                           const float* __restrict__ W18,
                                           const float* __restrict__ H9, size_t OP,
                                           size_t L_pad, int staged, size_t s0, int n,
                                           int t) {
  const int c = threadIdx.x >> 5;
  if ((threadIdx.x & 31) != 0 || c >= kStageCopies) return;
  if (c < 18) {
    if (n > 0) bulk_copy(st.w + c * staged, W18 + c * OP + s0, n * 4, bar);
  } else if (c < 20) {
    if (n > 0) bulk_copy(c == 18 ? st.cam : st.lm, (c == 18 ? camid : lmloc) + s0, n * 4, bar);
  } else {
    bulk_copy(st.h + (c - 20) * kLm, H9 + (c - 20) * L_pad + static_cast<size_t>(t) * kLm,
              kLm * 4, bar);
  }
}

__global__ void __launch_bounds__(kSApplyThreads, 1)
s_apply_kernel(const int* __restrict__ camid, const int* __restrict__ lmloc,
               const float* __restrict__ W18, const float* __restrict__ v,
               const float* __restrict__ H9, int ntl, int TP, size_t OP, size_t L_pad,
               int C, int cam_range, int share, int staged, int v_shared,
               float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int c0 = blockIdx.y * cam_range, ncam = min(cam_range, C - c0);
  const Stage st = stage_at(smem, staged);
  float* u_part0 = st.h + 9 * kLm;                                      // (2, 3, 128)
  float* u_s = u_part0 + 6 * kLm;                                       // (3, 128)
  float* table = u_s + 3 * kLm;                                         // (cam_range, 6)
  float* v_s = table + cam_range * 6;                                   // (C, 6) or none
  uint64_t* bar = reinterpret_cast<uint64_t*>(v_s + (v_shared ? C * 6 : 0));
  const int parts = gridDim.x / k, p = blockIdx.x / k;
  const int t0 = static_cast<int>(static_cast<long long>(ntl) * p / parts);
  const int t1 = static_cast<int>(static_cast<long long>(ntl) * (p + 1) / parts);
  const int k0 = min(rank * share, TP), k1 = min(k0 + share, TP);
  const int ks = min(k1, k0 + staged);          // staged: [k0, ks); read twice: [ks, k1)
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (t0 < t1) stage_expect(bar, ks - k0);
  }
  table_zero(table, ncam * 6);
  if (v_shared) {
    for (int i = threadIdx.x; i < C * 6; i += blockDim.x) v_s[i] = v[i];
  }
  __syncthreads();
  if (t0 < t1) {
    stage_copy(st, bar, camid, lmloc, W18, H9, OP, L_pad, staged,
               static_cast<size_t>(t0) * TP + k0, ks - k0, t0);
  }
  for (int t = t0, it = 0; t < t1; ++t, ++it) {
    const size_t base = static_cast<size_t>(t) * TP;
    float* up = u_part0 + (it & 1) * 3 * kLm;
    for (int i = threadIdx.x; i < 3 * kLm; i += blockDim.x) up[i] = 0.0f;
    __syncthreads();
    mbar_wait(bar, static_cast<uint32_t>(it & 1));
    // 1. A stage, whole warps at a time (warp_run_sums needs every lane)
    for (int kw = k0 + (threadIdx.x & ~31); kw < k1; kw += blockDim.x) {
      const int kk = kw + lane;
      int key = -1 - lane;                      // a lane past the end: a run of its own
      float a[3] = {0.0f, 0.0f, 0.0f};
      if (kk < k1) {
        int cam, l;
        float w[18];
        bool any;
        if (kk < ks) {
          const int j = kk - k0;
          cam = st.cam[j];
          l = st.lm[j];
          any = load_staged_w(st, staged, j, w);
        } else {
          const size_t s = base + kk;
          cam = camid[s];
          l = lmloc[s];
          any = load_w(W18, OP, s, w);
        }
        key = l;
        if (any) {
          float vc[6];
          if (v_shared) {
#pragma unroll
            for (int i = 0; i < 6; ++i) vc[i] = v_s[cam * 6 + i];
          } else {
#pragma unroll
            for (int i = 0; i < 6; ++i) vc[i] = __ldg(v + cam * 6 + i);
          }
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            a[j] = w[j * 6] * vc[0];
#pragma unroll
            for (int i = 1; i < 6; ++i) a[j] = a[j] + w[j * 6 + i] * vc[i];
          }
        }
      }
      if (warp_run_sums(key, a) && key >= 0
          && (a[0] != 0.0f || a[1] != 0.0f || a[2] != 0.0f)) {
        atomicAdd(&up[key], a[0]);
        atomicAdd(&up[kLm + key], a[1]);
        atomicAdd(&up[2 * kLm + key], a[2]);
      }
    }
    cluster.sync();
    // 2. the tile's 3x3 solves, u_part summed over the ranks in rank order
    for (int l = threadIdx.x; l < kLm; l += blockDim.x) {
      float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f;
      for (int q = 0; q < k; ++q) {
        const float* pq = cluster.map_shared_rank(up, q);
        p0 += pq[l];
        p1 += pq[kLm + l];
        p2 += pq[2 * kLm + l];
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        u_s[i * kLm + l] = st.h[(i * 3) * kLm + l] * p0 + st.h[(i * 3 + 1) * kLm + l] * p1
                           + st.h[(i * 3 + 2) * kLm + l] * p2;
      }
    }
    __syncthreads();
    // 3. B stage: staged slots from the buffer, the rest from global memory
    for (int j = threadIdx.x; j < ks - k0; j += blockDim.x) {
      const int cam = st.cam[j];
      float w[18];
      if (!in_range(cam, c0, ncam) || !load_staged_w(st, staged, j, w)) continue;
      const int l = st.lm[j];
      table_add<true>(table, cam, c0, w, u_s[l], u_s[kLm + l], u_s[2 * kLm + l]);
    }
    for (int kk = ks + threadIdx.x; kk < k1; kk += blockDim.x) {
      const size_t s = base + kk;
      const int cam = camid[s], l = lmloc[s];
      float w[18];
      if (!load_w(W18, OP, s, w) || !in_range(cam, c0, ncam)) continue;
      table_add<true>(table, cam, c0, w, u_s[l], u_s[kLm + l], u_s[2 * kLm + l]);
    }
    const bool next = t + 1 < t1;
    if (next && threadIdx.x == 0) stage_expect(bar, ks - k0);
    __syncthreads();    // the buffer, u_s and the next u_part are free again
    if (next) {
      stage_copy(st, bar, camid, lmloc, W18, H9, OP, L_pad, staged, base + TP + k0, ks - k0,
                 t + 1);
    }
  }
  cluster.sync();       // no rank leaves while another may read its u_part
  table_flush(table, C, c0, ncam, 6, partial);
}

// ---------------------------------------------------------------------------
// K5: per-camera upper triangle of sum_obs W Hinv[l] W^T.
// ---------------------------------------------------------------------------
//
// As K7: one block an SM; block (x, y) takes the slots [OP x / X, OP (x+1) /
// X) of the grid's X blocks along x, whatever tiles they lie in, and the
// cameras of range y. Each slot reads its ids and W row in one go, gathers
// its landmark's Hll^-1 (9 floats) through the read-only cache (a tile's
// are 4.6 KB), and adds the 21 entries of W Hll^-1 W^T's upper triangle
// into the block's camera table (21 floats a camera, 172,032 B at C =
// 2048; up to 2767 cameras a range) by single f32 atomics, which the next
// slots' loads overlap (paired, as in K3, they took ~6% longer).
//
// Measured on NVIDIA H100 80GB HBM3 cards at 700.00 W (chip_smoke.py phase
// 10 and tools/torch_schur_probe.py; each run's numbers in PERF.md): ~0.14
// ms a call at bench_gba's shapes against a byte bound of 0.0524 ms (~0.73
// ms with a global atomic per slot and entry instead). Without its
// camera sums (a wrong result, timed only) it takes ~0.077 ms: the rest is
// the table's shared atomics, compare-and-swap loops on this card (as plain
// shared stores, ~0.085 ms). 512 threads a block took ~0.21 ms.
constexpr int kD2Threads = 1024;
constexpr int kD2Row = 21;                          // a camera's S66 upper triangle

__global__ void __launch_bounds__(kD2Threads, 1)
d2_precond_kernel(const int* __restrict__ camid, const int* __restrict__ lmloc,
                  const float* __restrict__ W18, const float* __restrict__ H9,
                  int TP, size_t OP, size_t L_pad, int C, int cam_range,
                  float* __restrict__ partial) {
  extern __shared__ __align__(16) float table[];
  const int c0 = blockIdx.y * cam_range, ncam = min(cam_range, C - c0);
  table_zero(table, ncam * kD2Row);
  __syncthreads();
  const size_t s0 = OP * blockIdx.x / gridDim.x, s1 = OP * (blockIdx.x + 1) / gridDim.x;
  for (size_t s = s0 + threadIdx.x; s < s1; s += blockDim.x) {
    const int cam = camid[s], l = lmloc[s];
    float w[18];
    if (!load_w(W18, OP, s, w) || !in_range(cam, c0, ncam)) continue;
    const size_t lm = (s / TP) * kLm + l;
    float G[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) G[q] = __ldg(H9 + q * L_pad + lm);
    // WG[i][q] = sum_j W[i][j] G[j][q]
    float WG[6][3];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        WG[i][q] = w[i] * G[q] + w[6 + i] * G[3 + q] + w[12 + i] * G[6 + q];
      }
    }
    float x[kD2Row];
    int idx = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = i; j < 6; ++j) {
        x[idx++] = WG[i][0] * w[j] + WG[i][1] * w[6 + j] + WG[i][2] * w[12 + j];
      }
    }
    row_add<kD2Row, false>(table, cam - c0, x);
  }
  __syncthreads();
  table_flush(table, C, c0, ncam, kD2Row, partial);
}

// ---------------------------------------------------------------------------
// K6: u = Hinv @ sum_obs W^T v[cam], per landmark.
// ---------------------------------------------------------------------------
//
// One block runs one tile; its warps walk the tile's slots 32 at a time (TP
// is a multiple of 128). Each lane forms its slot's W^T v[cam] (zeros for a
// zero W row: warp_run_sums needs every lane), the warp sums each run of
// one landmark (warp_run_sums; the slots are landmark-sorted, ~33 a
// landmark at bench_gba's shapes), and the run's first lane takes the three
// shared atomics, where 32 lanes once took them on one or two addresses
// (compare-and-swap loops on this card). After a barrier, each landmark's
// 3x3 solve. Bounded by bytes: each slot's 72-byte W row and 8 bytes of ids
// once. On NVIDIA H100 80GB HBM3 cards at 700.00 W (chip_smoke.py phase 10
// and tools/torch_schur_probe.py --only k6; each run's numbers in PERF.md):
// 0.076-0.078 ms against a byte bound of 0.0526 ms, from 0.134-0.137 ms
// with an atomic a slot. Adding the runs instead into per-warp tables
// summed in warp order, which makes two calls bitwise equal, took
// 0.082-0.084 ms.
__global__ void __launch_bounds__(kThreads)
apply_a_kernel(const int* __restrict__ camid, const int* __restrict__ lmloc,
               const float* __restrict__ W18, const float* __restrict__ v,
               const float* __restrict__ H9, int TP, size_t OP, size_t L_pad,
               float* __restrict__ u) {
  __shared__ float u_part[3 * kLm];
  for (int i = threadIdx.x; i < 3 * kLm; i += blockDim.x) u_part[i] = 0.0f;
  __syncthreads();
  const size_t base = static_cast<size_t>(blockIdx.x) * TP;
  for (int k = threadIdx.x; k < TP; k += blockDim.x) {    // whole warps
    const size_t s = base + k;
    float w[18];
    float a[3] = {0.0f, 0.0f, 0.0f};
    if (load_w(W18, OP, s, w)) {
      const int cam = camid[s];
      float vc[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) vc[i] = __ldg(v + cam * 6 + i);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        a[j] = w[j * 6] * vc[0];
#pragma unroll
        for (int i = 1; i < 6; ++i) a[j] = a[j] + w[j * 6 + i] * vc[i];
      }
    }
    const int l = lmloc[s];
    if (warp_run_sums(l, a) && (a[0] != 0.0f || a[1] != 0.0f || a[2] != 0.0f)) {
      atomicAdd(&u_part[l], a[0]);
      atomicAdd(&u_part[kLm + l], a[1]);
      atomicAdd(&u_part[2 * kLm + l], a[2]);
    }
  }
  __syncthreads();
  for (int l = threadIdx.x; l < kLm; l += blockDim.x) {
    const float p0 = u_part[l], p1 = u_part[kLm + l], p2 = u_part[2 * kLm + l];
    const size_t g = static_cast<size_t>(blockIdx.x) * kLm + l;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      u[i * L_pad + g] = H9[(i * 3) * L_pad + g] * p0 + H9[(i * 3 + 1) * L_pad + g] * p1
                         + H9[(i * 3 + 2) * L_pad + g] * p2;
    }
  }
}

// ---------------------------------------------------------------------------
// K7: per-camera sum of W u[l].
// ---------------------------------------------------------------------------
//
// One block an SM; block (x, y) takes the slots [OP x / X, OP (x+1) / X) of
// the grid's X blocks along x, whatever tiles they lie in, and the cameras
// of range y. A slot's u is gathered from the (3, L_pad) input through the
// read-only cache (a tile's 128 landmarks are 1.5 KB). Each slot reads its
// ids and W row in one go (20 independent loads), then adds W u into the
// block's camera table (up to the whole 232,448 B a block may have: 9,685
// cameras a range; 49,152 B at C = 2048), with plain f32 shared atomics,
// which the next slots' loads overlap. On NVIDIA H100 80GB HBM3 cards at
// 700.00 W (chip_smoke.py phase 10 and tools/torch_schur_probe.py; each
// run's numbers in PERF.md): 0.085-0.089 ms against a byte bound of 0.0519
// ms and ~0.164 ms for a CSR sparse product of the same W. Most of the gap
// is the table's atomics (compare-and-swap loops on this card): with plain
// adds (a wrong result, timed only) it runs ~0.07 ms; paired, as in K4,
// ~0.09.
constexpr int kApplyBThreads = 1024;

__global__ void __launch_bounds__(kApplyBThreads, 1)
apply_b_kernel(const int* __restrict__ camid, const int* __restrict__ lmloc,
               const float* __restrict__ W18, const float* __restrict__ u,
               int TP, size_t OP, size_t L_pad, int C, int cam_range,
               float* __restrict__ partial) {
  extern __shared__ __align__(16) float table[];
  const int c0 = blockIdx.y * cam_range, ncam = min(cam_range, C - c0);
  table_zero(table, ncam * 6);
  __syncthreads();
  const size_t s0 = OP * blockIdx.x / gridDim.x, s1 = OP * (blockIdx.x + 1) / gridDim.x;
  for (size_t s = s0 + threadIdx.x; s < s1; s += blockDim.x) {
    const int cam = camid[s], l = lmloc[s];
    float w[18];
    if (!load_w(W18, OP, s, w) || !in_range(cam, c0, ncam)) continue;
    const size_t lm = (s / TP) * kLm + l;
    table_add<false>(table, cam, c0, w, __ldg(u + lm), __ldg(u + L_pad + lm),
                     __ldg(u + 2 * L_pad + lm));
  }
  __syncthreads();
  table_flush(table, C, c0, ncam, 6, partial);
}

// ---------------------------------------------------------------------------
// K8: the robust cost of a state, one scalar.
// ---------------------------------------------------------------------------

// K3's per-slot stage reduced to sum rho, in a fixed order. Bounded by its
// streams (24 bytes a valid slot, 4 a pad); what holds it above that is
// the latency of each slot's chain of loads (valid, then the ids, then the
// pose gather; tools/torch_schur_probe.py --only k8), which twelve 4-byte
// pose loads a slot made worse: the pose comes by three 16-byte loads and
// uv by one 8-byte load. One block of kD0Threads runs a tile, staging its
// 128 points; a slot with valid = 0 (a pad or an invalid observation) has
// rho = 0 exactly and is skipped before any load of its pose (two blocks a
// tile, or 256 threads, were no faster). A thread sums its slots in turn,
// then a fixed warp-shuffle and shared-memory tree gives the tile's
// partial. A second launch of one block, d0_sum_kernel, adds the partials
// in tile order by the same tree, so two calls on one state give the same
// bits; finding the last block by an atomic ticket instead cost K8 ~15%
// (a fence and an atomic in every block, and registers that spilled). 512
// threads at <= 32 registers keep all 512 blocks of bench_gba's tiles in
// one wave.
constexpr int kD0Threads = 512;     // threads a block
constexpr int kD0MinBlocks = 2048 / kD0Threads;   // a full SM: <= 32 registers

// The sum of acc over the block by a fixed tree, returned to thread 0.
__device__ __forceinline__ float d0_block_sum(float acc, float* warp_sum) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    acc = threadIdx.x < kD0Threads / 32 ? warp_sum[threadIdx.x] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  }
  return acc;
}

__global__ void __launch_bounds__(kD0Threads, kD0MinBlocks)
d0_cost_kernel(const int* __restrict__ camid, const int* __restrict__ lmloc,
               const float* __restrict__ uv, const float* __restrict__ is2,
               const float* __restrict__ valid, const float* __restrict__ kp,
               const float* __restrict__ pose, const float* __restrict__ X, int TP,
               float* __restrict__ partial) {
  __shared__ float x_s[3][kLm];
  __shared__ float warp_sum[kD0Threads / 32];
  const size_t lm0 = static_cast<size_t>(blockIdx.x) * kLm;
  for (int i = threadIdx.x; i < 3 * kLm; i += kD0Threads) {
    const int l = i / 3, c = i % 3;
    x_s[c][l] = X[(lm0 + l) * 3 + c];
  }
  __syncthreads();
  const float fx = __ldg(kp), fy = __ldg(kp + 1), cx = __ldg(kp + 2), cy = __ldg(kp + 3);
  const size_t base = static_cast<size_t>(blockIdx.x) * TP;
  float acc = 0.0f;
#pragma unroll 1                    // unrolled, the loop takes 40 registers
  for (int k = threadIdx.x; k < TP; k += kD0Threads) {
    const size_t s = base + k;
    const float vs = valid[s];
    if (vs == 0.0f) continue;
    const int cam = camid[s], l = lmloc[s];
    float R[9], t[3];
    load_pose_vec(pose, cam, R, t);
    const float2 q = __ldg(reinterpret_cast<const float2*>(uv) + s);
    acc += project_slot(R, t, x_s[0][l], x_s[1][l], x_s[2][l], q.x, q.y, is2[s], vs, fx, fy,
                        cx, cy).rho;
  }
  const float sum = d0_block_sum(acc, warp_sum);
  if (threadIdx.x == 0) partial[blockIdx.x] = sum;
}

// K8's finishing pass: out = the sum of n partials in a fixed order
// (thread t adds partials t, t + kD0Threads, ... in turn, then the tree).
__global__ void __launch_bounds__(kD0Threads)
d0_sum_kernel(const float* __restrict__ partial, int n, float* __restrict__ out) {
  __shared__ float warp_sum[kD0Threads / 32];
  float a = 0.0f;
  for (int g = threadIdx.x; g < n; g += kD0Threads) a += partial[g];
  const float cost = d0_block_sum(a, warp_sum);
  if (threadIdx.x == 0) *out = cost;
}

// ---------------------------------------------------------------------------
// K9: the matrix-free GBA's per-slot streams R, t, X.
// ---------------------------------------------------------------------------

// One thread a slot: the slot's camera row (12 floats) and landmark position
// (3 floats) through the read-only cache, written as rows of the (15, OP)
// output so that neighbouring threads write neighbouring addresses. Pad
// slots (camera 0, tile-local landmark 0) read camera 0 and their tile's
// first landmark, as the Pallas kernel does. No arithmetic: the output is
// the inputs' bits.
constexpr int kExpandThreads = 256;

__global__ void __launch_bounds__(kExpandThreads)
expand_streams_kernel(const int* __restrict__ camid, const int* __restrict__ lmloc,
                      const float* __restrict__ pose, const float* __restrict__ X,
                      int TP, size_t OP, float* __restrict__ out) {
  const size_t s = static_cast<size_t>(blockIdx.x) * kExpandThreads + threadIdx.x;
  if (s >= OP) return;
  const int cam = camid[s];
  const size_t lm = (s / TP) * kLm + lmloc[s];
#pragma unroll
  for (int q = 0; q < 12; ++q) out[q * OP + s] = __ldg(pose + cam * 12 + q);
#pragma unroll
  for (int c = 0; c < 3; ++c) out[(12 + c) * OP + s] = __ldg(X + lm * 3 + c);
}

inline cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

// The finishing pass of K3, K4, K5 and K7 over (groups, C, k) partial rows.
int camera_sum(const float* partial, int groups, int C, int k, float* out,
               cudaStream_t stream) {
  const size_t n = static_cast<size_t>(C) * k;
  const unsigned blocks = static_cast<unsigned>((n + kSumCols - 1) / kSumCols);
  camera_sum_kernel<<<blocks, dim3(kSumCols, kSumRows), 0, stream>>>(partial, groups, n, out);
  return static_cast<int>(cudaGetLastError());
}

// Whether a camera-table launch's geometry is one the card takes: a
// positive grid, at most 65,535 camera ranges, and shared_bytes at least
// `need` and at most what a block may have.
bool table_geometry_ok(int C, int grid_x, int cam_range, int shared_bytes, long long need) {
  return C > 0 && grid_x > 0 && cam_range > 0
         && (C + static_cast<long long>(cam_range) - 1) / cam_range <= 65535
         && shared_bytes >= need && shared_bytes <= 232448;
}

}  // namespace

extern "C" {

// Common arguments: camid, lmloc (OP,) i32 with OP = ntl * TP; W18 (18, OP)
// f32 J-major; H9 (9, L_pad) f32 with L_pad = ntl * 128. Where an entry
// point takes a launch geometry (schur_cuda.camera_reduction_geometry):
// grid_x blocks along x, ceil(C / cam_range) camera ranges along y,
// shared_bytes of dynamic shared memory a block; its partial (grid_x, C, k)
// is scratch, written whole.

// uv (OP, 2); is2, valid, free (OP,); kp (4,) = fx, fy, cx, cy; pose (C, 12)
// = R row-major then t; X (L_pad, 3) -> W18 (18, OP), aux (3, OP),
// hllbl (12, L_pad), cam27 (C, 27). TP a multiple of 32; pose 16-byte and
// uv 8-byte aligned; shared_bytes >= 108 cam_range + 9,216.
int mcs_d1_assemble(const int* camid, const int* lmloc, const float* uv,
                    const float* is2, const float* valid, const float* free_,
                    const float* kp, const float* pose, const float* X, int ntl,
                    int TP, float* W18, float* aux, float* hllbl, float* cam27, int C,
                    int grid_x, int cam_range, int shared_bytes, float* partial,
                    void* stream) {
  const long long need = 4LL * kD1Row * cam_range + kD1FixedBytes;
  if (ntl <= 0 || TP <= 0 || TP % 32 || reinterpret_cast<uintptr_t>(pose) % 16
      || reinterpret_cast<uintptr_t>(uv) % 8
      || !table_geometry_ok(C, grid_x, cam_range, shared_bytes, need)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaFuncSetAttribute(d1_assemble_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       shared_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t OP = static_cast<size_t>(ntl) * TP, L_pad = static_cast<size_t>(ntl) * kLm;
  const D1Params P = {camid, lmloc, uv, is2, valid, free_, kp, pose, X, ntl, TP, C,
                      cam_range, OP, L_pad, W18, aux, hllbl, partial};
  const dim3 grid(grid_x, (C + cam_range - 1) / cam_range, 1);
  d1_assemble_kernel<<<grid, kD1Threads, shared_bytes, as_stream(stream)>>>(P);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return camera_sum(partial, grid_x, C, kD1Row, cam27, as_stream(stream));
}

// v (C, 6) -> out (C, 6). The launch geometry comes from the wrapper
// (schur_cuda.camera_reduction_geometry): grid_x blocks in clusters of
// `cluster`, ceil(C / cam_range) camera ranges along y, each rank `share`
// slots of a tile of which it stages `staged`, v in shared memory if
// v_shared, shared_bytes of dynamic shared memory a block; partial
// (grid_x, C, 6) is scratch, written whole. camid, lmloc, W18 and H9 must be
// 16-byte aligned (the bulk copies' rule).
int mcs_s_apply(const int* camid, const int* lmloc, const float* W18,
                const float* v, const float* H9, int ntl, int TP, float* out, int C,
                int grid_x, int cluster, int cam_range, int share, int staged,
                int v_shared, int shared_bytes, float* partial, void* stream) {
  const long long need = static_cast<long long>(staged) * kStageSlotBytes + kStageTileBytes
                         + 9LL * kLm * 4 + 24LL * cam_range + (v_shared ? 24LL * C : 0) + 8;
  const bool aligned = ((reinterpret_cast<uintptr_t>(camid) | reinterpret_cast<uintptr_t>(lmloc)
                         | reinterpret_cast<uintptr_t>(W18) | reinterpret_cast<uintptr_t>(H9))
                        & 15u) == 0;
  if (ntl <= 0 || TP <= 0 || TP % 128 || C <= 0 || cluster < 1 || cluster > 8
      || grid_x < cluster || grid_x % cluster || cam_range <= 0 || share <= 0
      || share % 32 || staged < 0 || staged % 32 || staged > share
      || (v_shared != 0 && v_shared != 1) || shared_bytes < need || !aligned) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t OP = static_cast<size_t>(ntl) * TP, L_pad = static_cast<size_t>(ntl) * kLm;
  cudaError_t e = cudaFuncSetAttribute(s_apply_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       shared_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x, (C + cam_range - 1) / cam_range, 1);
  cfg.blockDim = dim3(kSApplyThreads, 1, 1);
  cfg.dynamicSmemBytes = shared_bytes;
  cfg.stream = as_stream(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, s_apply_kernel, camid, lmloc, W18, v, H9, ntl, TP, OP,
                         L_pad, C, cam_range, share, staged, v_shared, partial);
  if (e != cudaSuccess) return static_cast<int>(e);
  return camera_sum(partial, grid_x, C, 6, out, as_stream(stream));
}

// How many of K4's clusters of `cluster` blocks with shared_bytes each can
// be resident at once (cudaOccupancyMaxActiveClusters), or -cudaError_t.
int mcs_s_apply_active_clusters(int cluster, int shared_bytes) {
  cudaError_t e = cudaFuncSetAttribute(s_apply_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       shared_bytes);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(kSApplyThreads, 1, 1);
  cfg.dynamicSmemBytes = shared_bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, s_apply_kernel, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// -> out (C, 21); shared_bytes >= 84 cam_range.
int mcs_d2_precond(const int* camid, const int* lmloc, const float* W18,
                   const float* H9, int ntl, int TP, float* out, int C, int grid_x,
                   int cam_range, int shared_bytes, float* partial, void* stream) {
  if (ntl <= 0 || TP <= 0
      || !table_geometry_ok(C, grid_x, cam_range, shared_bytes, 4LL * kD2Row * cam_range)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaFuncSetAttribute(d2_precond_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       shared_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t OP = static_cast<size_t>(ntl) * TP, L_pad = static_cast<size_t>(ntl) * kLm;
  const dim3 grid(grid_x, (C + cam_range - 1) / cam_range, 1);
  d2_precond_kernel<<<grid, kD2Threads, shared_bytes, as_stream(stream)>>>(
      camid, lmloc, W18, H9, TP, OP, L_pad, C, cam_range, partial);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return camera_sum(partial, grid_x, C, kD2Row, out, as_stream(stream));
}

// v (C, 6) -> u (3, L_pad).
int mcs_apply_a(const int* camid, const int* lmloc, const float* W18,
                const float* v, const float* H9, int ntl, int TP, float* u,
                void* stream) {
  if (ntl <= 0 || TP <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t OP = static_cast<size_t>(ntl) * TP, L_pad = static_cast<size_t>(ntl) * kLm;
  apply_a_kernel<<<ntl, kThreads, 0, as_stream(stream)>>>(
      camid, lmloc, W18, v, H9, TP, OP, L_pad, u);
  return static_cast<int>(cudaGetLastError());
}

// u (3, L_pad) -> out (C, 6). grid_x blocks along x, ceil(C / cam_range)
// camera ranges along y, shared_bytes = 24 cam_range; partial (grid_x, C, 6)
// is scratch, written whole.
int mcs_apply_b(const int* camid, const int* lmloc, const float* W18,
                const float* u, int ntl, int TP, float* out, int C, int grid_x,
                int cam_range, int shared_bytes, float* partial, void* stream) {
  if (ntl <= 0 || TP <= 0
      || !table_geometry_ok(C, grid_x, cam_range, shared_bytes, 24LL * cam_range)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t OP = static_cast<size_t>(ntl) * TP, L_pad = static_cast<size_t>(ntl) * kLm;
  cudaError_t e = cudaFuncSetAttribute(apply_b_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       shared_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(grid_x, (C + cam_range - 1) / cam_range, 1);
  apply_b_kernel<<<grid, kApplyBThreads, shared_bytes, as_stream(stream)>>>(
      camid, lmloc, W18, u, TP, OP, L_pad, C, cam_range, partial);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return camera_sum(partial, grid_x, C, 6, out, as_stream(stream));
}

// Arguments of mcs_d1_assemble without free (pose 16-byte, uv 8-byte
// aligned) -> out (0-d) = sum rho; partial (ntl,) is scratch. Two launches:
// a partial a tile, then their sum in tile order.
int mcs_d0_cost(const int* camid, const int* lmloc, const float* uv, const float* is2,
                const float* valid, const float* kp, const float* pose, const float* X,
                int ntl, int TP, float* partial, float* out, void* stream) {
  if (ntl <= 0 || TP <= 0) return static_cast<int>(cudaErrorInvalidValue);
  d0_cost_kernel<<<ntl, kD0Threads, 0, as_stream(stream)>>>(
      camid, lmloc, uv, is2, valid, kp, pose, X, TP, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  d0_sum_kernel<<<1, kD0Threads, 0, as_stream(stream)>>>(partial, ntl, out);
  return static_cast<int>(cudaGetLastError());
}

// pose (C, 12); X (L, 3) with every slot's landmark < L -> out (15, OP):
// rows 0-8 R row-major, 9-11 t, 12-14 X.
int mcs_expand_streams(const int* camid, const int* lmloc, const float* pose,
                       const float* X, int ntl, int TP, float* out, void* stream) {
  if (ntl <= 0 || TP <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t OP = static_cast<size_t>(ntl) * TP;
  const unsigned blocks = static_cast<unsigned>((OP + kExpandThreads - 1) / kExpandThreads);
  expand_streams_kernel<<<blocks, kExpandThreads, 0, as_stream(stream)>>>(
      camid, lmloc, pose, X, TP, OP, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
