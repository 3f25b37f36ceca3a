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
// slots in all. Every slot has a camera id and a tile-local landmark id. One
// block runs one tile; its threads stride over the tile's slots.
//
// - Camera-side inputs (the (C,12) pose table, the (C,6) vector v) are read
//   in f32 through the read-only cache. The Pallas kernels expanded them with
//   one-hot MXU products of bf16 splits; here the gather is native and exact.
// - Landmark-side sums (Hll+bl, W^T v) go into shared memory: a tile owns its
//   128 landmarks, so these need no global atomics and no second pass.
// - Camera-side sums (Hcc+bc, the Schur products, the preconditioner) go by
//   atomicAdd into (C,27) / (C,6) / (C,21) outputs that the wrapper zeroes.
//   Atomics sum in no fixed order, so these outputs differ from run to run in
//   the last bits of f32; the tests hold them to a relative tolerance.
// - A slot whose weight is zero (a pad slot, an invalid observation, a point
//   behind the camera, or a fixed entity in the W stream) adds exact zeros,
//   so it is skipped before any atomic: pad slots all name camera 0, and
//   their atomics would serialise on one address.
//
// Bounds on this card: the least traffic streams per-slot data once (K3 reads
// 28 and writes 84 bytes a slot, K4-K7 read the 72-byte W row plus 8 bytes of
// ids, K8 reads 24 bytes, K9 reads 8 and writes 60) with 0-350 flops a slot,
// under the f32 ridge of ~20 flop/byte, so all seven are bounded by memory
// traffic. K4 as written reads each slot's W row
// and ids twice, once in each stage (a tile's W rows do not fit in shared
// memory), so it cannot come closer than about twice its bound; the camera
// atomics are the other risk of running far above it.
//
// Each entry point launches on the stream it is given and returns
// cudaGetLastError(); the Python wrapper raises when that is not 0.

#include <cuda_runtime.h>
#include <stddef.h>

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

// Landmark stage (the A half): u_part[j][l] += sum_i W[i][j] v[cam][i] over
// the tile's slots, into shared memory. The caller zeroes u_part.
__device__ __forceinline__ void a_stage(const int* __restrict__ camid,
                                        const int* __restrict__ lmloc,
                                        const float* __restrict__ W18,
                                        const float* __restrict__ v, size_t OP,
                                        int TP, float* u_part) {
  const size_t base = static_cast<size_t>(blockIdx.x) * TP;
  for (int k = threadIdx.x; k < TP; k += blockDim.x) {
    const size_t s = base + k;
    float w[18];
    if (!load_w(W18, OP, s, w)) continue;
    const int cam = camid[s], l = lmloc[s];
    float vc[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) vc[i] = __ldg(v + cam * 6 + i);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float acc = w[j * 6] * vc[0];
#pragma unroll
      for (int i = 1; i < 6; ++i) acc = acc + w[j * 6 + i] * vc[i];
      atomicAdd(&u_part[j * kLm + l], acc);
    }
  }
}

// Per-landmark 3x3 solve: u[i][l] = sum_j Hinv[l][i][j] u_part[j][l], with
// H9 (9, L_pad) holding row i*3+j. Writes u[i*stride + l].
__device__ __forceinline__ void solve_stage(const float* __restrict__ H9,
                                            size_t L_pad, const float* u_part,
                                            float* u, size_t stride) {
  for (int l = threadIdx.x; l < kLm; l += blockDim.x) {
    const size_t g = static_cast<size_t>(blockIdx.x) * kLm + l;
    const float p0 = u_part[l], p1 = u_part[kLm + l], p2 = u_part[2 * kLm + l];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      u[i * stride + l] = H9[(i * 3) * L_pad + g] * p0
                          + H9[(i * 3 + 1) * L_pad + g] * p1
                          + H9[(i * 3 + 2) * L_pad + g] * p2;
    }
  }
}

// Camera stage (the B half): out[cam][i] += sum_j W[i][j] u[j][l], with u
// the tile's landmark vectors in shared memory, u_s[j*128 + l].
__device__ __forceinline__ void b_stage(const int* __restrict__ camid,
                                        const int* __restrict__ lmloc,
                                        const float* __restrict__ W18, size_t OP,
                                        int TP, const float* u_s,
                                        float* __restrict__ out) {
  const size_t base = static_cast<size_t>(blockIdx.x) * TP;
  for (int k = threadIdx.x; k < TP; k += blockDim.x) {
    const size_t s = base + k;
    float w[18];
    if (!load_w(W18, OP, s, w)) continue;
    const int cam = camid[s], l = lmloc[s];
    const float u0 = u_s[l], u1 = u_s[kLm + l], u2 = u_s[2 * kLm + l];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      atomicAdd(out + cam * 6 + i, w[i] * u0 + w[6 + i] * u1 + w[12 + i] * u2);
    }
  }
}

// ---------------------------------------------------------------------------
// The per-slot projection stage, shared by K3 and K8.
// ---------------------------------------------------------------------------

// Camera row of the (C, 12) pose table: R row-major, then t.
__device__ __forceinline__ void load_pose(const float* __restrict__ pose, int cam,
                                          float (&R)[9], float (&t)[3]) {
#pragma unroll
  for (int q = 0; q < 9; ++q) R[q] = __ldg(pose + cam * 12 + q);
#pragma unroll
  for (int q = 0; q < 3; ++q) t[q] = __ldg(pose + cam * 12 + 9 + q);
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

// Per slot: p = R X + t, residual, chi2, Huber weight, camera Jacobian Jc
// (2x6, left se3 perturbation (omega, upsilon)) and point Jacobian Jl (2x3);
// W = wf Jc^T Jl in J-major rows; aux rows rho / inlier / chi2. Per landmark
// Hll (9, rows j*3+k) and bl (3) in shared memory; per camera the Hcc upper
// triangle (21, PAIRS6 order) and bc (6) by atomicAdd. Hll and Hcc use w, the
// W stream w * free (fixed entities couple nothing; their blocks are
// overwritten by the caller).
__global__ void __launch_bounds__(kThreads)
d1_assemble_kernel(const int* __restrict__ camid, const int* __restrict__ lmloc,
                   const float* __restrict__ uv, const float* __restrict__ is2,
                   const float* __restrict__ valid, const float* __restrict__ free_,
                   const float* __restrict__ kp, const float* __restrict__ pose,
                   const float* __restrict__ X, int TP, size_t OP, size_t L_pad,
                   float* __restrict__ W18, float* __restrict__ aux,
                   float* __restrict__ hllbl, float* __restrict__ cam27) {
  __shared__ float x_s[3][kLm];
  __shared__ float lm_acc[12][kLm];
  const size_t lm0 = static_cast<size_t>(blockIdx.x) * kLm;
  for (int i = threadIdx.x; i < 12 * kLm; i += blockDim.x) lm_acc[i / kLm][i % kLm] = 0.0f;
  for (int i = threadIdx.x; i < 3 * kLm; i += blockDim.x) {
    const int l = i / 3, c = i % 3;
    x_s[c][l] = X[(lm0 + l) * 3 + c];
  }
  __syncthreads();
  const float fx = __ldg(kp), fy = __ldg(kp + 1), cx = __ldg(kp + 2), cy = __ldg(kp + 3);
  const size_t base = static_cast<size_t>(blockIdx.x) * TP;
  for (int k = threadIdx.x; k < TP; k += blockDim.x) {
    const size_t s = base + k;
    const int cam = camid[s], l = lmloc[s];
    float R[9], t[3];
    load_pose(pose, cam, R, t);
    const float vs = valid[s];
    const Projection p = project_slot(R, t, x_s[0][l], x_s[1][l], x_s[2][l], uv[2 * s],
                                      uv[2 * s + 1], is2[s], vs, fx, fy, cx, cy);
    const float pc0 = p.pc0, pc1 = p.pc1, pc2 = p.pc2, iz = p.iz, rx = p.rx, ry = p.ry;
    const float w = p.w;
    aux[s] = p.rho;
    aux[OP + s] = (vs != 0.0f && p.front && p.chi2 <= kChi2Gate) ? vs : 0.0f;
    aux[2 * OP + s] = p.chi2;

    const float a00 = fx * iz, a02 = -fx * pc0 * iz * iz;
    const float a11 = fy * iz, a12 = -fy * pc1 * iz * iz;
    const float Jc0[6] = {-(a02 * pc1), -(a00 * pc2 - a02 * pc0), a00 * pc1, -a00, 0.0f, -a02};
    const float Jc1[6] = {a11 * pc2 - a12 * pc1, a12 * pc0, -a11 * pc0, 0.0f, -a11, -a12};
    float Jl0[3], Jl1[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      Jl0[j] = -(a00 * R[j] + a02 * R[6 + j]);
      Jl1[j] = -(a11 * R[3 + j] + a12 * R[6 + j]);
    }
    const float wf = w * free_[s];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        W18[(j * 6 + i) * OP + s] = wf * (Jc0[i] * Jl0[j] + Jc1[i] * Jl1[j]);
      }
    }
    if (w == 0.0f) continue;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        atomicAdd(&lm_acc[j * 3 + q][l], w * (Jl0[j] * Jl0[q] + Jl1[j] * Jl1[q]));
      }
      atomicAdd(&lm_acc[9 + j][l], -w * (Jl0[j] * rx + Jl1[j] * ry));
    }
    float* c = cam27 + cam * 27;
    int idx = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = i; j < 6; ++j) {
        atomicAdd(c + idx, w * (Jc0[i] * Jc0[j] + Jc1[i] * Jc1[j]));
        ++idx;
      }
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) atomicAdd(c + 21 + i, -w * (Jc0[i] * rx + Jc1[i] * ry));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 12 * kLm; i += blockDim.x) {
    const int r = i / kLm, l = i % kLm;
    hllbl[r * L_pad + lm0 + l] = lm_acc[r][l];
  }
}

// ---------------------------------------------------------------------------
// K4: the fused PCG product, A's stage then B's, u kept in shared memory.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
s_apply_kernel(const int* __restrict__ camid, const int* __restrict__ lmloc,
               const float* __restrict__ W18, const float* __restrict__ v,
               const float* __restrict__ H9, int TP, size_t OP, size_t L_pad,
               float* __restrict__ out) {
  __shared__ float u_part[3 * kLm];
  __shared__ float u_s[3 * kLm];
  for (int i = threadIdx.x; i < 3 * kLm; i += blockDim.x) u_part[i] = 0.0f;
  __syncthreads();
  a_stage(camid, lmloc, W18, v, OP, TP, u_part);
  __syncthreads();
  solve_stage(H9, L_pad, u_part, u_s, kLm);
  __syncthreads();
  b_stage(camid, lmloc, W18, OP, TP, u_s, out);
}

// ---------------------------------------------------------------------------
// K5: per-camera upper triangle of sum_obs W Hinv[l] W^T.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
d2_precond_kernel(const int* __restrict__ camid, const int* __restrict__ lmloc,
                  const float* __restrict__ W18, const float* __restrict__ H9,
                  int TP, size_t OP, size_t L_pad, float* __restrict__ out) {
  __shared__ float h_s[9][kLm];
  const size_t lm0 = static_cast<size_t>(blockIdx.x) * kLm;
  for (int i = threadIdx.x; i < 9 * kLm; i += blockDim.x) {
    const int r = i / kLm, l = i % kLm;
    h_s[r][l] = H9[r * L_pad + lm0 + l];
  }
  __syncthreads();
  const size_t base = static_cast<size_t>(blockIdx.x) * TP;
  for (int k = threadIdx.x; k < TP; k += blockDim.x) {
    const size_t s = base + k;
    float w[18];
    if (!load_w(W18, OP, s, w)) continue;
    const int cam = camid[s], l = lmloc[s];
    float G[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) G[q] = h_s[q][l];
    // WG[i][q] = sum_j W[i][j] G[j][q]
    float WG[6][3];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        WG[i][q] = w[i] * G[q] + w[6 + i] * G[3 + q] + w[12 + i] * G[6 + q];
      }
    }
    float* c = out + cam * 21;
    int idx = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = i; j < 6; ++j) {
        atomicAdd(c + idx, WG[i][0] * w[j] + WG[i][1] * w[6 + j] + WG[i][2] * w[12 + j]);
        ++idx;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K6: u = Hinv @ sum_obs W^T v[cam], per landmark.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
apply_a_kernel(const int* __restrict__ camid, const int* __restrict__ lmloc,
               const float* __restrict__ W18, const float* __restrict__ v,
               const float* __restrict__ H9, int TP, size_t OP, size_t L_pad,
               float* __restrict__ u) {
  __shared__ float u_part[3 * kLm];
  for (int i = threadIdx.x; i < 3 * kLm; i += blockDim.x) u_part[i] = 0.0f;
  __syncthreads();
  a_stage(camid, lmloc, W18, v, OP, TP, u_part);
  __syncthreads();
  solve_stage(H9, L_pad, u_part, u + static_cast<size_t>(blockIdx.x) * kLm, L_pad);
}

// ---------------------------------------------------------------------------
// K7: per-camera sum of W u[l].
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
apply_b_kernel(const int* __restrict__ camid, const int* __restrict__ lmloc,
               const float* __restrict__ W18, const float* __restrict__ u,
               int TP, size_t OP, size_t L_pad, float* __restrict__ out) {
  __shared__ float u_s[3 * kLm];
  const size_t lm0 = static_cast<size_t>(blockIdx.x) * kLm;
  for (int i = threadIdx.x; i < 3 * kLm; i += blockDim.x) {
    const int r = i / kLm, l = i % kLm;
    u_s[i] = u[r * L_pad + lm0 + l];
  }
  __syncthreads();
  b_stage(camid, lmloc, W18, OP, TP, u_s, out);
}

// ---------------------------------------------------------------------------
// K8: the robust cost of a state, one scalar.
// ---------------------------------------------------------------------------

// K3's per-slot stage reduced to sum rho: per-thread sums, a warp-shuffle and
// shared-memory block reduction, and one atomicAdd a block into the zeroed
// 0-d output. A slot with valid = 0 (a pad or an invalid observation) has
// rho = 0 exactly and is skipped before any load of its pose.
__global__ void __launch_bounds__(kThreads)
d0_cost_kernel(const int* __restrict__ camid, const int* __restrict__ lmloc,
               const float* __restrict__ uv, const float* __restrict__ is2,
               const float* __restrict__ valid, const float* __restrict__ kp,
               const float* __restrict__ pose, const float* __restrict__ X, int TP,
               float* __restrict__ out) {
  __shared__ float x_s[3][kLm];
  __shared__ float warp_sum[kThreads / 32];
  const size_t lm0 = static_cast<size_t>(blockIdx.x) * kLm;
  for (int i = threadIdx.x; i < 3 * kLm; i += blockDim.x) {
    const int l = i / 3, c = i % 3;
    x_s[c][l] = X[(lm0 + l) * 3 + c];
  }
  __syncthreads();
  const float fx = __ldg(kp), fy = __ldg(kp + 1), cx = __ldg(kp + 2), cy = __ldg(kp + 3);
  const size_t base = static_cast<size_t>(blockIdx.x) * TP;
  float acc = 0.0f;
  for (int k = threadIdx.x; k < TP; k += blockDim.x) {
    const size_t s = base + k;
    const float vs = valid[s];
    if (vs == 0.0f) continue;
    const int cam = camid[s], l = lmloc[s];
    float R[9], t[3];
    load_pose(pose, cam, R, t);
    acc += project_slot(R, t, x_s[0][l], x_s[1][l], x_s[2][l], uv[2 * s], uv[2 * s + 1],
                        is2[s], vs, fx, fy, cx, cy).rho;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    acc = threadIdx.x < (blockDim.x >> 5) ? warp_sum[threadIdx.x] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (threadIdx.x == 0) atomicAdd(out, acc);
  }
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

}  // namespace

extern "C" {

// Common arguments: camid, lmloc (OP,) i32 with OP = ntl * TP; W18 (18, OP)
// f32 J-major; H9 (9, L_pad) f32 with L_pad = ntl * 128. Outputs that take
// atomics are zeroed by the caller.

// uv (OP, 2); is2, valid, free (OP,); kp (4,) = fx, fy, cx, cy; pose (C, 12)
// = R row-major then t; X (L_pad, 3) -> W18 (18, OP), aux (3, OP),
// hllbl (12, L_pad), cam27 (C, 27) (zeroed).
int mcs_d1_assemble(const int* camid, const int* lmloc, const float* uv,
                    const float* is2, const float* valid, const float* free_,
                    const float* kp, const float* pose, const float* X, int ntl,
                    int TP, float* W18, float* aux, float* hllbl, float* cam27,
                    void* stream) {
  if (ntl <= 0 || TP <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t OP = static_cast<size_t>(ntl) * TP, L_pad = static_cast<size_t>(ntl) * kLm;
  d1_assemble_kernel<<<ntl, kThreads, 0, as_stream(stream)>>>(
      camid, lmloc, uv, is2, valid, free_, kp, pose, X, TP, OP, L_pad, W18, aux,
      hllbl, cam27);
  return static_cast<int>(cudaGetLastError());
}

// v (C, 6) -> out (C, 6) (zeroed).
int mcs_s_apply(const int* camid, const int* lmloc, const float* W18,
                const float* v, const float* H9, int ntl, int TP, float* out,
                void* stream) {
  if (ntl <= 0 || TP <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t OP = static_cast<size_t>(ntl) * TP, L_pad = static_cast<size_t>(ntl) * kLm;
  s_apply_kernel<<<ntl, kThreads, 0, as_stream(stream)>>>(
      camid, lmloc, W18, v, H9, TP, OP, L_pad, out);
  return static_cast<int>(cudaGetLastError());
}

// -> out (C, 21) (zeroed).
int mcs_d2_precond(const int* camid, const int* lmloc, const float* W18,
                   const float* H9, int ntl, int TP, float* out, void* stream) {
  if (ntl <= 0 || TP <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t OP = static_cast<size_t>(ntl) * TP, L_pad = static_cast<size_t>(ntl) * kLm;
  d2_precond_kernel<<<ntl, kThreads, 0, as_stream(stream)>>>(
      camid, lmloc, W18, H9, TP, OP, L_pad, out);
  return static_cast<int>(cudaGetLastError());
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

// u (3, L_pad) -> out (C, 6) (zeroed).
int mcs_apply_b(const int* camid, const int* lmloc, const float* W18,
                const float* u, int ntl, int TP, float* out, void* stream) {
  if (ntl <= 0 || TP <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t OP = static_cast<size_t>(ntl) * TP, L_pad = static_cast<size_t>(ntl) * kLm;
  apply_b_kernel<<<ntl, kThreads, 0, as_stream(stream)>>>(
      camid, lmloc, W18, u, TP, OP, L_pad, out);
  return static_cast<int>(cudaGetLastError());
}

// Arguments of mcs_d1_assemble without free -> out (0-d, zeroed) += sum rho.
int mcs_d0_cost(const int* camid, const int* lmloc, const float* uv, const float* is2,
                const float* valid, const float* kp, const float* pose, const float* X,
                int ntl, int TP, float* out, void* stream) {
  if (ntl <= 0 || TP <= 0) return static_cast<int>(cudaErrorInvalidValue);
  d0_cost_kernel<<<ntl, kThreads, 0, as_stream(stream)>>>(
      camid, lmloc, uv, is2, valid, kp, pose, X, TP, out);
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
