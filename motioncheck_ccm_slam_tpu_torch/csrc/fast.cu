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
// pixel about once per block and each output pixel once.
//
// K1 at 752x480 moves 9.7 MB a frame (0.0029 ms at 3.35 TB/s), and its ALU
// work, 16 taps x 9 operations an output pixel plus 96 for each pixel that
// scores, takes as long at 67 TFLOP/s: its least time is ~0.0029 ms a
// frame (chip_smoke.py phase 6 counts it). One launch a level of
// 1024-thread cells that summed all four scores at every pixel took
// 0.0647-0.0665 ms: ten waves of one block's latency over 8 launches
// (tools/torch_fast_probe.py --only k1). So K1 runs once a frame over a
// table of all levels (1,274 cells of 32x32, 128 threads each, ten blocks
// an SM: one wave), takes its four masks with six operations a tap, and
// sums scores only for the corners of the cell's threshold. On NVIDIA H100
// 80GB HBM3 cards at 700.00 W (PERF.md): ~0.016 ms a frame, 18% of the
// bound; the mask pass takes nearly all of it (0.0155 ms with no second
// pass), and a level alone takes one block's latency, ~0.006 ms.
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
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// K1: two-threshold FAST-9/16 with the per-32x32-cell threshold retry.
// ---------------------------------------------------------------------------

constexpr int kCell = 32;                    // output cell = one block
constexpr int kHalo = 4;                     // ring radius 3, +1 slack
constexpr int kTile = kCell + 2 * kHalo;     // staged tile edge (40)
constexpr int kMaxLevels = 16;
constexpr int kK1Rows = 8;                   // output rows a thread, one column
constexpr int kK1Threads = kCell * kCell / kK1Rows;

// FAST ring (dx, dy) in ring order, as FAST_RING in ops/fast_cuda.py.
__host__ __device__ constexpr int ring_tri(int j) {
  return j < 3 ? j : (8 - j < 3 ? 8 - j : 3);    // 0 1 2 3 3 3 2 1
}
__host__ __device__ constexpr int ring_dx(int k) {
  return k < 8 ? ring_tri(k) : -ring_tri(k - 8);
}
__host__ __device__ constexpr int ring_dy(int k) { return -ring_dx((k + 4) & 15); }

// Wraparound run of >= 9 set bits among the 16 ring bits of m (FAST-9),
// by doubling: r8 bit i holds bits i..i+7 of the doubled ring, and the
// last step adds bit i+8. A ring read in reverse order has the same runs.
__device__ __forceinline__ bool has_arc(unsigned m) {
  const unsigned dup = m | (m << 16);
  const unsigned r2 = dup & (dup >> 1);
  const unsigned r4 = r2 & (r2 >> 2);
  const unsigned r8 = r4 & (r4 >> 4);
  return (r8 & (dup >> 8) & 0xFFFFu) != 0u;
}

// One pyramid level: its image, its (Hp, Wc) output, and the first of its
// 32x32 cells in the launch's block order.
struct K1Level {
  const float* img;
  float* out;
  int H, W, Wc, cells_x, first_cell;
};
struct K1Levels {
  K1Level lv[kMaxLevels];
  int n;
  float th_hi, th_lo;
  int border;
};

// One block of kK1Threads per 32x32 output cell of any level; a thread
// takes kK1Rows rows of one column, a warp 32 neighbouring columns. The
// launch covers every level of the table, the largest first.
//
// 1. A cell with no pixel inside the border (the 64-row pad, the pad
//    columns, a level smaller than its border) only writes its zeros.
// 2. The (32+8)x(32+8) tile is staged with a zero halo, as the Pallas
//    wrapper pads, by 16-byte loads where a row's 4-pixel chunk is aligned
//    and inside the image; since border >= kHalo no pixel that can score
//    reads the pad.
// 3. Each pixel takes its four arc masks from the 16 taps: d = tap - centre
//    (the same f32 difference as the jnp path), then the sign bit of
//    th - |d| is set exactly when |d| > th (th >= 0, the wrapper checks),
//    and the sign bit of d tells bright from dark: after the difference a
//    tap costs two subtractions and three funnel shifts, where four
//    compares and four ORs took eight. The masks come out in reverse ring
//    order.
// 4. The cell's "any hi corner" is __syncthreads_or, which takes the place
//    of the Pallas kernel's four 0/1 MXU matmuls.
// 5. Only a pixel that is a corner under the cell's threshold sums its two
//    scores, in a second pass over the 16 taps in shared memory, each in
//    ring order from 0 with the same f32 adds as the jnp path. A
//    non-corner writes 0 whatever its sums are, so the output is
//    bit-identical to the one-pass form that summed all four for every
//    pixel. Corners are few (~5% of a rendered frame's pixels) but lie in
//    most warps' rows, so the cell first lists them in shared memory (a
//    warp scan, one shared atomic a warp) and its threads take the list
//    one corner each: the pass costs about one sum a thread, not one a
//    row.
__global__ void __launch_bounds__(kK1Threads)
masked_corner_score_kernel(const K1Levels P) {
  __shared__ __align__(16) float tile[kTile * kTile];
  __shared__ unsigned short corner_at[kCell * kCell];   // row * 32 + column
  __shared__ int n_corners;
  K1Level L = P.lv[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (i < P.n && static_cast<int>(blockIdx.x) >= P.lv[i].first_cell) L = P.lv[i];
  }
  const int cell = static_cast<int>(blockIdx.x) - L.first_cell;
  const int x0 = cell % L.cells_x * kCell, y0 = cell / L.cells_x * kCell;
  const int lane = threadIdx.x % kCell, row0 = threadIdx.x / kCell * kK1Rows;
  float* out = L.out + static_cast<size_t>(y0 + row0) * L.Wc + x0 + lane;
  const int b = P.border;
  // the cell's rows and columns inside the border: [ylo, yhi) x [xlo, xhi)
  const int ylo = max(y0, b), yhi = min(y0 + kCell, L.H - b);
  const int xlo = max(x0, b), xhi = min(x0 + kCell, L.W - b);
  if (ylo >= yhi || xlo >= xhi) {                // the same for the whole block
#pragma unroll
    for (int p = 0; p < kK1Rows; ++p) out[static_cast<size_t>(p) * L.Wc] = 0.0f;
    return;
  }

  if (threadIdx.x == 0) n_corners = 0;
  constexpr int kChunks = kTile / 4;             // 4-pixel chunks a tile row
  for (int i = threadIdx.x; i < kTile * kChunks; i += kK1Threads) {
    const int r = i / kChunks, c = i % kChunks * 4;
    const int y = y0 - kHalo + r, x = x0 - kHalo + c;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (y >= 0 && y < L.H) {
      const float* src = L.img + static_cast<size_t>(y) * L.W + x;
      if (x >= 0 && x + 4 <= L.W && (reinterpret_cast<uintptr_t>(src) & 15u) == 0u) {
        v = __ldg(reinterpret_cast<const float4*>(src));
      } else {
        v.x = x >= 0 && x < L.W ? __ldg(src) : 0.0f;
        v.y = x + 1 >= 0 && x + 1 < L.W ? __ldg(src + 1) : 0.0f;
        v.z = x + 2 >= 0 && x + 2 < L.W ? __ldg(src + 2) : 0.0f;
        v.w = x + 3 >= 0 && x + 3 < L.W ? __ldg(src + 3) : 0.0f;
      }
    }
    *reinterpret_cast<float4*>(tile + r * kTile + c) = v;
  }
  __syncthreads();

  const float th_hi = P.th_hi, th_lo = P.th_lo;
  const float* base = tile + (row0 + kHalo) * kTile + lane + kHalo;
  const int x = x0 + lane;
  const bool col_ok = x >= xlo && x < xhi;
  unsigned hi_bits = 0u, lo_bits = 0u;           // bit p: row p is a corner
  if (col_ok && y0 + row0 < yhi && y0 + row0 + kK1Rows > ylo) {
#pragma unroll
    for (int p = 0; p < kK1Rows; ++p) {
      const float* px = base + p * kTile;
      const float center = px[0];
      unsigned gt_hi = 0u, gt_lo = 0u, neg = 0u;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const float d = px[ring_dy(k) * kTile + ring_dx(k)] - center;
        const float a = fabsf(d);
        gt_hi = __funnelshift_l(__float_as_uint(th_hi - a), gt_hi, 1);
        gt_lo = __funnelshift_l(__float_as_uint(th_lo - a), gt_lo, 1);
        neg = __funnelshift_l(__float_as_uint(d), neg, 1);
      }
      const int y = y0 + row0 + p;
      const bool ok = y >= ylo && y < yhi;
      const bool c_hi = has_arc(gt_hi & ~neg) || has_arc(gt_hi & neg);
      const bool c_lo = has_arc(gt_lo & ~neg) || has_arc(gt_lo & neg);
      hi_bits |= static_cast<unsigned>(ok && c_hi) << p;
      lo_bits |= static_cast<unsigned>(ok && c_lo) << p;
    }
  }
  const bool use_hi = __syncthreads_or(hi_bits != 0u) != 0;
  const unsigned corners = use_hi ? hi_bits : lo_bits;
#pragma unroll
  for (int p = 0; p < kK1Rows; ++p) {
    if (((corners >> p) & 1u) == 0u) out[static_cast<size_t>(p) * L.Wc] = 0.0f;
  }
  // list the cell's corners: a warp scan of each thread's count, one
  // shared atomic a warp for the warp's place in the list
  const unsigned all = 0xffffffffu;
  const int count = __popc(corners);
  int incl = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(all, incl, d);
    if (lane >= d) incl += o;
  }
  int first = 0;
  if (lane == 31 && incl != 0) first = atomicAdd(&n_corners, incl);
  int at = __shfl_sync(all, first, 31) + incl - count;
  for (unsigned m = corners; m != 0u; m &= m - 1u) {
    corner_at[at++] = static_cast<unsigned short>((row0 + __ffs(m) - 1) * kCell + lane);
  }
  __syncthreads();

  const float th = use_hi ? th_hi : th_lo;
  for (int i = threadIdx.x; i < n_corners; i += kK1Threads) {
    const int r = corner_at[i] / kCell, c = corner_at[i] % kCell;
    const float* px = tile + (r + kHalo) * kTile + c + kHalo;
    const float center = px[0];
    float s_b = 0.0f, s_d = 0.0f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float d = px[ring_dy(k) * kTile + ring_dx(k)] - center;
      s_b = s_b + fmaxf(d - th, 0.0f);
      s_d = s_d + fmaxf(-d - th, 0.0f);
    }
    L.out[static_cast<size_t>(y0 + r) * L.Wc + x0 + c] = fmaxf(s_b, s_d);
  }
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

// [kb (7), kh (2r, 31), kv (2r, 31)]: channels [0, r) build m10, [r, 2r)
// m01. Set once per device by mcs_k2_set_taps, which also writes
// c_k2_lead, so that it is kept. ptxas reads a channel's taps (indexed by
// the channel, a loop variable) through the uniform datapath (ULDC) only
// when they are not the constant bank's first symbol; first, they took
// per-thread LDC and its address arithmetic (139 LDC and 74 ULDC against
// 77 and 136 in K2's SASS), and K2 0.1010 ms a frame against 0.0925
// (NVIDIA H100 80GB HBM3 at 700.00 W; tools/torch_fast_probe.py --only k2).
__constant__ float c_k2_lead[2];
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

// K1 over n levels in one launch: level i's image imgs[i] (H, W) f32 ->
// outs[i] (Hp, Wc) f32, dims[4i..4i+3] = H, W, Hp, Wc with Hp >= H,
// Wc >= W, both multiples of 32; 1 <= n <= 16; 0 <= th_lo, th_hi;
// border >= 4. The table goes to the kernel by value.
int mcs_masked_corner_score(int n, const float* const* imgs, float* const* outs,
                            const int* dims, float th_hi, float th_lo, int border,
                            void* stream) {
  if (n < 1 || n > kMaxLevels || border < kHalo || !(th_hi >= 0.0f) || !(th_lo >= 0.0f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  K1Levels P = {};
  P.n = n;
  P.th_hi = th_hi;
  P.th_lo = th_lo;
  P.border = border;
  int cells = 0;
  for (int i = 0; i < n; ++i) {
    const int H = dims[4 * i], W = dims[4 * i + 1], Hp = dims[4 * i + 2], Wc = dims[4 * i + 3];
    if (H < 1 || W < 1 || Hp < H || Wc < W || Hp % kCell != 0 || Wc % kCell != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    P.lv[i] = K1Level{imgs[i], outs[i], H, W, Wc, Wc / kCell, cells};
    cells += (Wc / kCell) * (Hp / kCell);
  }
  masked_corner_score_kernel<<<cells, kK1Threads, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// K2's taps [kb (7), kh (2r, 31), kv (2r, 31)] (host memory) into the
// current device's constant memory; r must be kRank. Synchronises the
// device, once per device before its first K2 launch.
int mcs_k2_set_taps(const float* taps, int n_taps, int rank) {
  if (rank != kRank || n_taps != kNTaps) return static_cast<int>(cudaErrorInvalidValue);
  const float lead[2] = {0.0f, 0.0f};
  cudaError_t e = cudaMemcpyToSymbol(c_k2_lead, lead, sizeof lead);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemcpyToSymbol(c_k2_taps, taps, sizeof(float) * kNTaps);
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
