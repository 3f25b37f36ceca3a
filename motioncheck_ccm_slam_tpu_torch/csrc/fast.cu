// Dense FAST front-end kernels for Hopper (sm_90a), plain C interface.
//
// K1 mcs_masked_corner_score replaces the Pallas kernel
//    motioncheck_ccm_slam_tpu/ops/fast_pallas.py: masked_corner_score
//    (body _make_kernel).
// K2 mcs_blur_and_moments replaces the Pallas kernel
//    motioncheck_ccm_slam_tpu/ops/fast_pallas.py: blur_and_moments
//    (body _make_blur_moments_kernel).
//
// Both are stencils that read one float32 image and write one (K1) or three
// (K2) float32 maps of the same size. Each block stages its output tile plus
// the stencil halo in shared memory once, so device memory sees each input
// pixel about once per block and each output pixel once. At 752x480 that
// traffic takes ~1 us (K1) and ~2 us (K2) at 3.35 TB/s; K1's ~20 ALU ops per
// ring tap cost the same order, so K1 is bounded by memory and ALU together.
//
// K2's 7-tap blur and 18 separable 31-tap moment channels come to ~1,130
// FMAs a pixel (~140 flop per byte moved, far above the card's f32 ridge of
// ~20), so its least time is the f32 FMA rate's: 0.0440 ms for a frame's 8
// levels. FMA issue is not what a plain port reaches, though: with one output
// a thread, each FMA takes two shared loads (its tap and its pixel), and the
// SM's one shared load a cycle against four warp FMAs holds the kernel near
// 1/8 of the bound; one launch a level leaves most launches under one wave.
// So K2 runs once a frame over a table of all levels (637 tiles of 64x32 at
// 752x480, six blocks an SM, one wave), its taps come from __constant__
// memory into registers once a channel, and each thread makes 16 outputs a
// pass from a window of registers: ~10 FMAs a shared load. On NVIDIA H100
// 80GB HBM3 cards at 700.00 W (chip_smoke.py phase 6 and
// tools/torch_fast_probe.py; each run's numbers in PERF.md): 0.092-0.093 ms
// a frame, 47-48% of the bound, where one launch a level with shared taps
// took 0.717-0.722 ms. The row halo (94 rows staged and passed horizontally
// for 64 output rows) and the two barriers a channel take much of the rest.
//
// Each entry point launches on the stream it is given and returns
// cudaGetLastError(); the Python wrapper raises when that is not 0. Build
// without --use_fast_math: K1 must stay bit-identical to its plain version.

#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// K1: two-threshold FAST-9/16 with the per-32x32-cell threshold retry.
// ---------------------------------------------------------------------------

constexpr int kCell = 32;                    // output cell = one block
constexpr int kHalo = 4;                     // ring radius 3, +1 slack
constexpr int kTile = kCell + 2 * kHalo;     // staged tile edge (40)
constexpr int kArc = 9;                      // FAST-9

// FAST ring (dx, dy) in ring order, as FAST_RING in ops/fast_cuda.py.
__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

// Wraparound run of >= kArc set bits among the 16 ring bits of m.
__device__ __forceinline__ bool has_arc(unsigned m) {
  const unsigned dup = m | (m << 16);
  unsigned run = dup;
#pragma unroll
  for (int k = 1; k < kArc; ++k) run &= dup >> k;
  return (run & 0xFFFFu) != 0u;
}

// One block per 32x32 output cell, one thread per output pixel. The
// (32+8)x(32+8) tile is staged with a zero halo, as the Pallas wrapper pads;
// since border >= kHalo no pixel that can score reads the pad. The cell's
// "any hi corner" is __syncthreads_or, which takes the place of the Pallas
// kernel's four 0/1 MXU matmuls. Scores are summed in ring order from 0, as
// the jnp path sums, so the result is bit-identical to it.
__global__ void __launch_bounds__(kCell * kCell)
masked_corner_score_kernel(const float* __restrict__ img, int H, int W,
                           float* __restrict__ out, int Wc, float th_hi,
                           float th_lo, int border) {
  __shared__ float tile[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * kCell, y0 = blockIdx.y * kCell;
  for (int i = ty * kCell + tx; i < kTile * kTile; i += kCell * kCell) {
    const int r = i / kTile, c = i % kTile;
    const int y = y0 - kHalo + r, x = x0 - kHalo + c;
    tile[r][c] = (y >= 0 && y < H && x >= 0 && x < W)
                     ? img[static_cast<size_t>(y) * W + x] : 0.0f;
  }
  __syncthreads();

  const float center = tile[ty + kHalo][tx + kHalo];
  unsigned m_hb = 0u, m_hd = 0u, m_lb = 0u, m_ld = 0u;
  float s_hb = 0.0f, s_hd = 0.0f, s_lb = 0.0f, s_ld = 0.0f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float d = tile[ty + kHalo + kRingDy[k]][tx + kHalo + kRingDx[k]] - center;
    m_hb |= static_cast<unsigned>(d > th_hi) << k;
    m_hd |= static_cast<unsigned>(d < -th_hi) << k;
    m_lb |= static_cast<unsigned>(d > th_lo) << k;
    m_ld |= static_cast<unsigned>(d < -th_lo) << k;
    s_hb = s_hb + fmaxf(d - th_hi, 0.0f);
    s_hd = s_hd + fmaxf(-d - th_hi, 0.0f);
    s_lb = s_lb + fmaxf(d - th_lo, 0.0f);
    s_ld = s_ld + fmaxf(-d - th_lo, 0.0f);
  }
  const int y = y0 + ty, x = x0 + tx;
  const bool ok = y >= border && y < H - border && x >= border && x < W - border;
  const bool corner_hi = (has_arc(m_hb) || has_arc(m_hd)) && ok;
  const bool corner_lo = (has_arc(m_lb) || has_arc(m_ld)) && ok;
  const bool use_hi = __syncthreads_or(corner_hi) != 0;
  float v;
  if (use_hi) {
    v = corner_hi ? fmaxf(s_hb, s_hd) : 0.0f;
  } else {
    v = corner_lo ? fmaxf(s_lb, s_ld) : 0.0f;
  }
  out[static_cast<size_t>(y) * Wc + x] = v;
}

// ---------------------------------------------------------------------------
// K2: 7-tap Gaussian blur + IC moment maps m10/m01 from one image read.
// ---------------------------------------------------------------------------

constexpr int kR = 15;                       // moment radius (half_patch)
constexpr int kMomTaps = 2 * kR + 1;         // 31
constexpr int kBlurTaps = 7;
constexpr int kRank = 9;                     // moment factor rank at half_patch 15
constexpr int kNTaps = kBlurTaps + 2 * 2 * kRank * kMomTaps;   // kb, kh (2r, 31), kv (2r, 31)
constexpr int kTH = 64;                      // output tile rows
constexpr int kTW = 32;                      // output tile columns (a warp)
constexpr int kRV = 16;                      // output rows a thread, vertical passes
constexpr int kRH = 16;                      // output columns a unit, horizontal passes
constexpr int kK2Threads = kTW * kTH / kRV;  // 128
constexpr int kSR = kTH + 2 * kR;            // staged rows (94)
constexpr int kSC = kTW + 2 * kR;            // staged columns (62)
constexpr int kInStride = kSC + 1;           // odd: a warp's rows fall in distinct banks
constexpr int kMidStride = kTW + 1;
constexpr int kMaxLevels = 16;

// [kb (7), kh (2r, 31), kv (2r, 31)]: channels [0, r) build m10, [r, 2r)
// m01. Set once per device by mcs_k2_set_taps.
__constant__ float c_k2_taps[kNTaps];

// One pyramid level: its image and its (3, Hp, Wc) output (blur, m10,
// m01), and the first of its tiles in the launch's block order.
struct K2Level {
  const float* img;
  float* out;
  int H, W, Hp, Wc, tiles_x, first_tile;
};
struct K2Levels {
  K2Level lv[kMaxLevels];
  int n;
};

// Horizontal pass of one channel over rows [row0, row0 + rows) of the
// staged tile: mid[r][c] = sum_i w[i] in[row0 + r][col0 + c + i] for the
// tile's 32 columns. A unit is one row's run of kRH outputs; it streams
// its kRH + NT - 1 inputs once, each into every output it feeds, so each
// output sums its taps in ascending order, as the jnp path does.
template <int NT>
__device__ __forceinline__ void k2_hpass(const float* in, int row0, int col0, int rows,
                                         int tap0, float* mid) {
  float w[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) w[i] = c_k2_taps[tap0 + i];
  constexpr int kRuns = kTW / kRH;
  for (int unit = threadIdx.x; unit < rows * kRuns; unit += kK2Threads) {
    const int r = unit / kRuns, c0 = unit % kRuns * kRH;
    const float* src = in + (row0 + r) * kInStride + col0 + c0;
    float acc[kRH];
#pragma unroll
    for (int n = 0; n < kRH; ++n) acc[n] = 0.0f;
#pragma unroll
    for (int k = 0; k < kRH + NT - 1; ++k) {
      const float x = src[k];
#pragma unroll
      for (int n = 0; n < kRH; ++n) {
        if (k - n >= 0 && k - n < NT) acc[n] = fmaf(w[k - n], x, acc[n]);
      }
    }
    float* dst = mid + r * kMidStride + c0;
#pragma unroll
    for (int n = 0; n < kRH; ++n) dst[n] = acc[n];
  }
}

// Vertical pass of one channel for this thread's kRV rows of one column,
// added to acc: acc[n] += sum_j w[j] mid[row + n + j][col], taps
// ascending, from a window of kRV + NT - 1 mid values streamed once.
template <int NT>
__device__ __forceinline__ void k2_vpass(const float* mid, int tap0, float (&acc)[kRV]) {
  float w[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) w[i] = c_k2_taps[tap0 + i];
  const float* src = mid + (threadIdx.x / kTW) * kRV * kMidStride + threadIdx.x % kTW;
#pragma unroll
  for (int k = 0; k < kRV + NT - 1; ++k) {
    const float m = src[k * kMidStride];
#pragma unroll
    for (int n = 0; n < kRV; ++n) {
      if (k - n >= 0 && k - n < NT) acc[n] = fmaf(w[k - n], m, acc[n]);
    }
  }
}

// One block of 128 threads per 64x32 output tile of any level; the launch
// covers every level of the table, the largest first, and a level alone
// takes ~0.034-0.048 ms (one block's latency and at most two tiles an SM;
// the same card and runs). The tile plus a 15-pixel halo is
// staged once, with the edge replicated by clamping coordinates (the jnp
// path pads with mode="edge"). Each channel runs its horizontal pass over
// the rows it needs into the shared `mid` buffer, then its vertical pass
// into each thread's accumulators, channel-outer and tap-inner ascending
// as the jnp path and the Pallas kernel accumulate; every add is an FMA
// (fmaf), where the jnp path rounds the product and the sum apart, and the
// tests hold the maps to a tolerance for that reason.
__global__ void __launch_bounds__(kK2Threads)
blur_and_moments_kernel(const K2Levels P) {
  __shared__ float in[kSR * kInStride];
  __shared__ float mid[kSR * kMidStride];
  K2Level L = P.lv[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (i < P.n && static_cast<int>(blockIdx.x) >= P.lv[i].first_tile) L = P.lv[i];
  }
  const int tile = static_cast<int>(blockIdx.x) - L.first_tile;
  const int x0 = tile % L.tiles_x * kTW, y0 = tile / L.tiles_x * kTH;
  for (int i = threadIdx.x; i < kSR * kSC; i += kK2Threads) {
    const int r = i / kSC, c = i % kSC;
    const int y = min(max(y0 - kR + r, 0), L.H - 1);
    const int x = min(max(x0 - kR + c, 0), L.W - 1);
    in[r * kInStride + c] = __ldg(L.img + static_cast<size_t>(y) * L.W + x);
  }
  __syncthreads();

  // this thread's outputs: rows y0 + strip * kRV + n of column x0 + lane
  const int strip = threadIdx.x / kTW, y = y0 + strip * kRV;
  const size_t plane = static_cast<size_t>(L.Hp) * L.Wc;
  float* out = L.out + static_cast<size_t>(y) * L.Wc + x0 + threadIdx.x % kTW;
  float acc[kRV];
  auto store = [&](int map) {
#pragma unroll
    for (int n = 0; n < kRV; ++n) {
      if (y + n < L.Hp) out[map * plane + static_cast<size_t>(n) * L.Wc] = acc[n];
    }
  };
#pragma unroll
  for (int n = 0; n < kRV; ++n) acc[n] = 0.0f;
  constexpr int kBH = kBlurTaps / 2;
  k2_hpass<kBlurTaps>(in, kR - kBH, kR - kBH, kTH + kBlurTaps - 1, 0, mid);
  __syncthreads();
  k2_vpass<kBlurTaps>(mid, 0, acc);
  store(0);
  for (int c = 0; c < 2 * kRank; ++c) {
    __syncthreads();                         // every vertical pass has read mid
    k2_hpass<kMomTaps>(in, 0, 0, kSR, kBlurTaps + c * kMomTaps, mid);
    __syncthreads();
    if (c % kRank == 0) {
#pragma unroll
      for (int n = 0; n < kRV; ++n) acc[n] = 0.0f;
    }
    k2_vpass<kMomTaps>(mid, kBlurTaps + (2 * kRank + c) * kMomTaps, acc);
    if (c % kRank == kRank - 1) store(1 + c / kRank);
  }
}

}  // namespace

extern "C" {

// img (H, W) f32 -> out (Hp, Wc) f32; Hp and Wc multiples of 32, Hp >= H,
// Wc >= W; border >= 4.
int mcs_masked_corner_score(const float* img, int H, int W, float* out, int Hp,
                            int Wc, float th_hi, float th_lo, int border,
                            void* stream) {
  const dim3 grid(Wc / kCell, Hp / kCell), block(kCell, kCell);
  masked_corner_score_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, H, W, out, Wc, th_hi, th_lo, border);
  return static_cast<int>(cudaGetLastError());
}

// K2's taps [kb (7), kh (2r, 31), kv (2r, 31)] (host memory) into the
// current device's constant memory; r must be kRank. Synchronises the
// device, once per device before its first K2 launch.
int mcs_k2_set_taps(const float* taps, int n_taps, int rank) {
  if (rank != kRank || n_taps != kNTaps) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMemcpyToSymbol(c_k2_taps, taps, sizeof(float) * kNTaps);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaDeviceSynchronize());
}

// K2 over n levels in one launch: level i's image imgs[i] (H, W) f32 ->
// outs[i] (3, Hp, Wc) f32 (blur, m10, m01), dims[4i..4i+3] = H, W, Hp, Wc
// with Hp >= H, Wc >= W and Wc a multiple of 32; 1 <= n <= 16. The table
// goes to the kernel by value.
int mcs_blur_and_moments(int n, const float* const* imgs, float* const* outs,
                         const int* dims, void* stream) {
  if (n < 1 || n > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  K2Levels P = {};
  P.n = n;
  int tiles = 0;
  for (int i = 0; i < n; ++i) {
    const int H = dims[4 * i], W = dims[4 * i + 1], Hp = dims[4 * i + 2], Wc = dims[4 * i + 3];
    if (H < 1 || W < 1 || Hp < H || Wc < W || Wc % kTW != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int tiles_x = Wc / kTW, tiles_y = (Hp + kTH - 1) / kTH;
    P.lv[i] = K2Level{imgs[i], outs[i], H, W, Hp, Wc, tiles_x, tiles};
    tiles += tiles_x * tiles_y;
  }
  blur_and_moments_kernel<<<tiles, kK2Threads, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
