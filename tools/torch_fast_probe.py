"""Level-by-level clocks and ablations of the port's K1 and K2 on the card.

Builds edited copies of motioncheck_ccm_slam_tpu_torch/csrc/fast.cu (or of
the file given with --source) under build/fast_probe/ and times them with
CUDA events (chip_smoke.cuda_ms) on the 8 pyramid levels of a rendered
EuRoC frame (chip_smoke.PlaneScene, 752x480, DEFAULT_CONFIG's pyramid):
each level alone and the whole frame, with the blocks of each level, the
blocks an SM holds at once (CUDA's occupancy query) and the waves that
makes, ptxas's registers, and each copy's worst error against the plain
version.

K1 (--only k1). The one-launch-a-level design (a 32x32 cell a block of
1024 threads, one pixel a thread, the four running sums beside the masks;
the csrc/fast.cu before K1's redesign, e.g. from ``git show
<commit>:motioncheck_ccm_slam_tpu_torch/csrc/fast.cu``) gets its kernel as
it is, level by level, and copies of its body over a table of levels
(PROBE_K1): the same 8 launches (table_8_launches, the copies' baseline),
all 8 levels in one launch (one_launch), 256 threads a cell with 4 pixels
a thread (threads_256), the four running sums dropped (masks_only: wrong
scores, timed only), and the three together. The one-launch design (a
level table, masks first, sums only where a pixel scores) gets the kernel
as it is and copies (K1_VARIANTS) with other rows a thread (so threads a
block), scalar staging, no skip of cells with no pixel inside the border,
or no second pass (wrong scores, timed only).

K2 (--only k2). The one-level design (one launch a level, a 32x32 tile a block of 1024
threads, the taps staged in shared memory; the csrc/fast.cu of the commit
before the multi-level redesign, e.g. from ``git show
<commit>:motioncheck_ccm_slam_tpu_torch/csrc/fast.cu``) gets three copies:

- as_is;
- unrolled_shared: the rank fixed at 9 and the tap and channel loops
  unrolled, the taps still read from shared memory;
- unrolled_constant: the same with the taps in __constant__ memory, so that
  each FMA takes its weight as a constant-bank operand.

The multi-level design (one launch a frame over a level table, the taps
in __constant__ memory) gets the kernel as it is and copies that change
one of its constants (MULTI_LEVEL_VARIANTS): the tile's height, each
thread's rows in the vertical passes (and so the threads a block), each
unit's columns in the horizontal passes, and a copy that asks for six
blocks an SM in its launch bounds. Each level is also timed alone, as the
one-level wrapper launches it.

Usage (on the card): python3 tools/torch_fast_probe.py [--only k1|k2] [--source PATH]
"""
import argparse
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402
from motioncheck_ccm_slam_tpu_torch.config import DEFAULT_CONFIG  # noqa: E402
from motioncheck_ccm_slam_tpu_torch.ops import cuda_build, fast_cuda  # noqa: E402
from motioncheck_ccm_slam_tpu_torch.ops import image as image_ops  # noqa: E402

# the one-level design's kernel: (text, the copy's text instead)
_UNROLL = [
    ("  const float* kv = kh + 2 * rank * kMomTaps;",
     "  const float* kv = kh + 2 * 9 * kMomTaps;"),
    ("      for (int t = 1; t < n; ++t) acc = acc + k[t] * src[t];",
     "#pragma unroll\n      for (int t = 1; t < n; ++t) acc = acc + k[t] * src[t];"),
    ("    for (; t < n; ++t) acc = acc + k[t] * mid[r0 + t][tx];",
     "#pragma unroll\n    for (; t < n; ++t) acc = acc + k[t] * mid[r0 + t][tx];"),
    ("  for (int c = 0; c < rank; ++c) {", "#pragma unroll\n  for (int c = 0; c < 9; ++c) {"),
    ("    hpass(kh + (rank + c) * kMomTaps,", "    hpass(kh + (9 + c) * kMomTaps,"),
    ("    a01 = vpass(kv + (rank + c) * kMomTaps,", "    a01 = vpass(kv + (9 + c) * kMomTaps,"),
]
_CONSTANT = [
    ("constexpr int kMaxRank = 16;                 // moment factor rank bound\n",
     "constexpr int kMaxRank = 16;                 // moment factor rank bound\n"
     "__constant__ float c_probe_taps[kBlurTaps + 2 * 2 * kMaxRank * kMomTaps];\n"),
    ("  __shared__ float tap_s[kBlurTaps + 2 * 2 * kMaxRank * kMomTaps];\n",
     "  const float* tap_s = c_probe_taps;\n"),
    ("  for (int i = tid; i < n_taps; i += kBT * kBT) tap_s[i] = taps[i];\n",
     "  (void)n_taps;\n  (void)taps;\n"),
    ('extern "C" {\n',
     'extern "C" {\nint probe_set_taps(const float* h, int n) {\n'
     '  return (int)cudaMemcpyToSymbol(c_probe_taps, h, n * sizeof(float));\n}\n'),
]
ONE_LEVEL_VARIANTS = {
    "as_is": [],
    "unrolled_shared": _UNROLL,
    "unrolled_constant": _UNROLL + _CONSTANT,
}
ONE_LEVEL_OCCUPANCY = (
    'extern "C" {\n',
    'extern "C" {\nint probe_blocks_per_sm(int* n) {\n'
    '  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, blur_and_moments_kernel,'
    ' kBT * kBT, 0);\n}\n')
# the multi-level design's constants: (text, the copy's text instead)
_TH = "constexpr int kTH = 64; "
_RV = "constexpr int kRV = 16; "
_RH = "constexpr int kRH = 16; "
MULTI_LEVEL_VARIANTS = {
    "as_is": [],
    "th96_rv24": [(_TH, _TH.replace("64", "96")), (_RV, _RV.replace("16", "24"))],
    "rv8_256_threads": [(_RV, _RV.replace("16", "8"))],
    "rh32": [(_RH, _RH.replace("16", "32"))],
    "rh8": [(_RH, _RH.replace("16", "8"))],
    "min_blocks_6": [("__launch_bounds__(kK2Threads)", "__launch_bounds__(kK2Threads, 6)")],
}
MULTI_LEVEL_OCCUPANCY = (
    'extern "C" {\n',
    'extern "C" {\nint probe_blocks_per_sm(int* n) {\n'
    '  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, blur_and_moments_kernel,'
    ' kK2Threads, 0);\n}\nint probe_tile_rows() { return kTH; }\n')


# PR 6's K1 body over a table of levels, kPPT rows a thread, with or
# without the four running sums; appended to the one-launch-a-level source
PROBE_K1 = r"""
namespace {
struct ProbeK1Level {
  const float* img;
  float* out;
  int H, W, Wc, cells_x, first_cell;
};
struct ProbeK1Levels {
  ProbeK1Level lv[kMaxLevels];
  int n;
};

template <int kPPT, bool kSums>
__global__ void __launch_bounds__(kCell * kCell / kPPT)
probe_k1_kernel(const ProbeK1Levels P, float th_hi, float th_lo, int border) {
  __shared__ float tile[kTile][kTile + 1];
  ProbeK1Level L = P.lv[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (i < P.n && static_cast<int>(blockIdx.x) >= P.lv[i].first_cell) L = P.lv[i];
  }
  const int cell = static_cast<int>(blockIdx.x) - L.first_cell;
  const int x0 = cell % L.cells_x * kCell, y0 = cell / L.cells_x * kCell;
  const int tx = threadIdx.x % kCell, ty0 = threadIdx.x / kCell * kPPT;
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int r = i / kTile, c = i % kTile;
    const int y = y0 - kHalo + r, x = x0 - kHalo + c;
    tile[r][c] = (y >= 0 && y < L.H && x >= 0 && x < L.W)
                     ? L.img[static_cast<size_t>(y) * L.W + x] : 0.0f;
  }
  __syncthreads();
  bool hi[kPPT], lo[kPPT];
  float vhi[kPPT], vlo[kPPT];
  bool any_hi = false;
#pragma unroll
  for (int p = 0; p < kPPT; ++p) {
    const int ty = ty0 + p;
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
      if (kSums) {
        s_hb = s_hb + fmaxf(d - th_hi, 0.0f);
        s_hd = s_hd + fmaxf(-d - th_hi, 0.0f);
        s_lb = s_lb + fmaxf(d - th_lo, 0.0f);
        s_ld = s_ld + fmaxf(-d - th_lo, 0.0f);
      }
    }
    const int y = y0 + ty, x = x0 + tx;
    const bool ok = y >= border && y < L.H - border && x >= border && x < L.W - border;
    hi[p] = (has_arc(m_hb) || has_arc(m_hd)) && ok;
    lo[p] = (has_arc(m_lb) || has_arc(m_ld)) && ok;
    vhi[p] = kSums ? fmaxf(s_hb, s_hd) : 1.0f;
    vlo[p] = kSums ? fmaxf(s_lb, s_ld) : 1.0f;
    any_hi |= hi[p];
  }
  const bool use_hi = __syncthreads_or(any_hi) != 0;
#pragma unroll
  for (int p = 0; p < kPPT; ++p) {
    const float v = use_hi ? (hi[p] ? vhi[p] : 0.0f) : (lo[p] ? vlo[p] : 0.0f);
    L.out[static_cast<size_t>(y0 + ty0 + p) * L.Wc + x0 + tx] = v;
  }
}

template <int kPPT, bool kSums>
int probe_k1_launch(int n, const float* const* imgs, float* const* outs, const int* dims,
                    float th_hi, float th_lo, int border, cudaStream_t s) {
  ProbeK1Levels P = {};
  P.n = n;
  int cells = 0;
  for (int i = 0; i < n; ++i) {
    const int H = dims[4 * i], W = dims[4 * i + 1], Hp = dims[4 * i + 2], Wc = dims[4 * i + 3];
    P.lv[i] = ProbeK1Level{imgs[i], outs[i], H, W, Wc, Wc / kCell, cells};
    cells += (Wc / kCell) * (Hp / kCell);
  }
  probe_k1_kernel<kPPT, kSums><<<cells, kCell * kCell / kPPT, 0, s>>>(P, th_hi, th_lo, border);
  return static_cast<int>(cudaGetLastError());
}

template <int kPPT, bool kSums>
int probe_k1_occupancy(int* n) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, probe_k1_kernel<kPPT, kSums>, kCell * kCell / kPPT, 0));
}
}  // namespace

extern "C" {
// variant 0: 1 row a thread with sums, 1: 4 rows with sums, 2: 1 row
// masks only, 3: 4 rows masks only
int probe_k1(int variant, int n, const float* const* imgs, float* const* outs,
             const int* dims, float th_hi, float th_lo, int border, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return probe_k1_launch<1, true>(n, imgs, outs, dims, th_hi, th_lo, border, s);
    case 1: return probe_k1_launch<4, true>(n, imgs, outs, dims, th_hi, th_lo, border, s);
    case 2: return probe_k1_launch<1, false>(n, imgs, outs, dims, th_hi, th_lo, border, s);
    case 3: return probe_k1_launch<4, false>(n, imgs, outs, dims, th_hi, th_lo, border, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
// blocks an SM of a variant; -1: the source's own kernel at 1024 threads
int probe_k1_blocks_per_sm(int variant, int* n) {
  switch (variant) {
    case -1:
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          n, masked_corner_score_kernel, kCell * kCell, 0));
    case 0: return probe_k1_occupancy<1, true>(n);
    case 1: return probe_k1_occupancy<4, true>(n);
    case 2: return probe_k1_occupancy<1, false>(n);
    case 3: return probe_k1_occupancy<4, false>(n);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
}  // extern "C"
"""
# (name, variant of probe_k1, levels a launch) of the one-launch-a-level
# design; variant -1 is the source's own entry point
ONE_LAUNCH_A_LEVEL_K1 = (
    ("as_is", -1, 1),
    ("table_8_launches", 0, 1),
    ("one_launch", 0, 8),
    ("threads_256", 1, 1),
    ("masks_only", 2, 1),
    ("one_launch_threads_256_masks_only", 3, 8),
)
# the one-launch design's constants: (text, the copy's text instead)
_K1_ROWS = "constexpr int kK1Rows = 8; "
K1_VARIANTS = {
    "as_is": [],
    "rows4_256_threads": [(_K1_ROWS, _K1_ROWS.replace("8", "4"))],
    "rows16_64_threads": [(_K1_ROWS, _K1_ROWS.replace("8", "16"))],
    "scalar_staging": [("      if (x >= 0 && x + 4 <= L.W && (reinterpret_cast",
                        "      if (false && x >= 0 && x + 4 <= L.W && (reinterpret_cast")],
    # every cell computed, also where no pixel lies inside the border
    "no_cell_skip": [("  if (ylo >= yhi || xlo >= xhi) {", "  if (false) {")],
    # no second pass: corners write nothing (wrong scores, timed only)
    "no_second_pass": [("  for (int i = threadIdx.x; i < n_corners; i += kK1Threads) {",
                        "  for (int i = threadIdx.x; i < 0; i += kK1Threads) {")],
}
K1_OCCUPANCY = (
    'extern "C" {\n',
    'extern "C" {\nint probe_blocks_per_sm(int* n) {\n'
    '  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, masked_corner_score_kernel,'
    ' kK1Threads, 0);\n}\n')


def k1_one_launch_a_level(src: str) -> bool:
    """Whether src has K1 as one launch a level of 1024-thread cells."""
    return "masked_corner_score_kernel(const float* __restrict__ img" in src


def print_ptxas(name: str, log: str, keys) -> None:
    """ptxas's lines for the kernels whose mangled names hold a key (one
    string or a tuple)."""
    keys = (keys,) if isinstance(keys, str) else keys
    show = False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            show = any(k in line for k in keys)
            if show:
                print(f"  {name}: {line.strip()}")
        elif show and ("registers" in line or "stack frame" in line):
            print(f"  {name}: {line.strip()}")


def k1_kwargs() -> dict:
    ex = DEFAULT_CONFIG.extractor
    return dict(th_hi=float(ex.ini_th_fast), th_lo=float(ex.min_th_fast),
                border=ex.edge_threshold)


def k1_table_args(levels, dev):
    """Outputs and the (n, imgs, outs, dims) table arrays of a K1 launch
    over levels; the arrays are kept alive by the returned tuple."""
    shapes = [fast_cuda.padded_shape(*lv.shape) for lv in levels]
    outs = [torch.empty(s, device=dev) for s in shapes]
    n = len(levels)
    imgs = (ctypes.c_void_p * n)(*(lv.data_ptr() for lv in levels))
    optr = (ctypes.c_void_p * n)(*(o.data_ptr() for o in outs))
    dims = (ctypes.c_int * (4 * n))(*[d for lv, s in zip(levels, shapes)
                                      for d in (*lv.shape, *s)])
    return outs, (n, imgs, optr, dims)


def k1_cells(lv) -> int:
    hp, wc = fast_cuda.padded_shape(*lv.shape)
    return (hp // 32) * (wc // 32)


def k1_one_launch_a_level_part(src: str, levels, dev) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    path = os.path.join(cuda_build.BUILD_DIR, "..", "fast_probe", "k1_one_launch_a_level.cu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(src + PROBE_K1)
    print_ptxas("k1", cuda_build.build(path), ("corner_score", "probe_k1"))
    lib = cuda_build.load(path, {"mcs_masked_corner_score": [p, i, i, p, i, i, f, f, i, p],
                                 "probe_k1": [i, i, p, p, p, f, f, i, p],
                                 "probe_k1_blocks_per_sm": [i, p]})
    kw = k1_kwargs()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    refs = [fast_cuda.masked_corner_score_ref(lv, **kw) for lv in levels]
    for name, variant, per_launch in ONE_LAUNCH_A_LEVEL_K1:
        if variant < 0:
            def launch(lvs):
                outs = []
                for lv in lvs:
                    h, w = lv.shape
                    hp, wc = fast_cuda.padded_shape(h, w)
                    out = torch.empty((hp, wc), device=dev)
                    cuda_build.check_launch(lib.mcs_masked_corner_score(
                        lv.data_ptr(), h, w, out.data_ptr(), hp, wc, kw["th_hi"], kw["th_lo"],
                        kw["border"], torch.cuda.current_stream().cuda_stream), "probe K1")
                    outs.append(out)
                return outs
        else:
            def launch(lvs, variant=variant, per_launch=per_launch):
                outs = []
                for j in range(0, len(lvs), per_launch):
                    o, (n, imgs, optr, dims) = k1_table_args(lvs[j:j + per_launch], dev)
                    cuda_build.check_launch(lib.probe_k1(
                        variant, n, ctypes.addressof(imgs), ctypes.addressof(optr),
                        ctypes.addressof(dims), kw["th_hi"], kw["th_lo"], kw["border"],
                        torch.cuda.current_stream().cuda_stream), "probe K1")
                    outs += o
                return outs
        outs = launch(levels)
        torch.cuda.synchronize()
        err = max(float((o - r).abs().max()) for o, r in zip(outs, refs))
        same = all(torch.equal(o, r) for o, r in zip(outs, refs))
        per_sm = ctypes.c_int(0)
        cuda_build.check_launch(lib.probe_k1_blocks_per_sm(variant, ctypes.byref(per_sm)),
                                "occupancy")
        slots = per_sm.value * n_sm
        cells = [k1_cells(lv) for lv in levels]
        waves = sum(-(-sum(cells[j:j + per_launch]) // slots)
                    for j in range(0, len(cells), per_launch))
        frame_ms = cs.cuda_ms(lambda: launch(levels), 50)
        parts = ""
        if per_launch == 1:
            parts = "; levels: " + "; ".join(
                f"{tuple(lv.shape)} {c} blocks {cs.cuda_ms(lambda: launch([lv]), 100):.4f} ms"
                for lv, c in zip(levels, cells))
        print(f"K1 {name}: {frame_ms:.4f} ms a frame in {-(-len(levels) // per_launch)} "
              f"launches of {sum(cells)} blocks; {per_sm.value} blocks an SM ({slots} slots), "
              f"{waves} waves; bitwise equal to the plain version {same} (max |d| {err:.3g})"
              + parts)


def k1_one_launch_part(src: str, levels, dev) -> None:
    p, f = ctypes.c_void_p, ctypes.c_float
    i = ctypes.c_int
    paths = build_all({f"k1_{n}": edited(edited(src, [K1_OCCUPANCY]), e)
                       for n, e in K1_VARIANTS.items()}, "corner_score")
    kw = k1_kwargs()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    refs = [fast_cuda.masked_corner_score_ref(lv, **kw) for lv in levels]
    cells = [k1_cells(lv) for lv in levels]
    for name, path in paths.items():
        lib = cuda_build.load(path, {"mcs_masked_corner_score": [i, p, p, p, f, f, i, p],
                                     "probe_blocks_per_sm": [p]})
        per_sm = ctypes.c_int(0)
        cuda_build.check_launch(lib.probe_blocks_per_sm(ctypes.byref(per_sm)), "occupancy")

        def launch(lvs):
            outs, (n, imgs, optr, dims) = k1_table_args(lvs, dev)
            cuda_build.check_launch(lib.mcs_masked_corner_score(
                n, ctypes.addressof(imgs), ctypes.addressof(optr), ctypes.addressof(dims),
                kw["th_hi"], kw["th_lo"], kw["border"],
                torch.cuda.current_stream().cuda_stream), "probe K1")
            return outs
        outs = launch(levels)
        torch.cuda.synchronize()
        err = max(float((o - r).abs().max()) for o, r in zip(outs, refs))
        same = all(torch.equal(o, r) for o, r in zip(outs, refs))
        frame_ms = cs.cuda_ms(lambda: launch(levels), 50)
        parts = "; ".join(f"{tuple(lv.shape)} {cs.cuda_ms(lambda: launch([lv]), 100):.4f} ms"
                          for lv in levels)
        print(f"{name}: {frame_ms:.4f} ms a frame in one launch of {sum(cells)} blocks; "
              f"{per_sm.value} blocks an SM ({per_sm.value * n_sm} slots); bitwise equal to "
              f"the plain version {same} (max |d| {err:.3g}); each level alone: {parts}")


def one_level_design(src: str) -> bool:
    """Whether src has K2 as one launch a level with its taps in shared memory."""
    return "tap_s[" in src


def edited(src: str, edits) -> str:
    for a, b in edits:
        if a not in src:
            raise RuntimeError(f"probe: {a!r} is not in the source")
        src = src.replace(a, b)
    return src


def build_all(sources: dict, key: str = "blur_and_moments") -> dict:
    """name -> built library path of each name -> source text, one nvcc
    each, started together; prints ptxas's lines for the kernels whose
    mangled names hold key."""
    out_dir = os.path.join(cuda_build.BUILD_DIR, "..", "fast_probe")
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for name, text in sources.items():
        paths[name] = os.path.join(out_dir, f"{name}.cu")
        with open(paths[name], "w") as f:
            f.write(text)
    with ThreadPoolExecutor(len(paths)) as pool:
        logs = list(pool.map(cuda_build.build, paths.values()))
    for name, log in zip(paths, logs):
        print_ptxas(name, log, key)
    return paths


def levels_of_frame(dev):
    cfg = DEFAULT_CONFIG
    scene = cs.PlaneScene(cfg.camera)
    img = torch.from_numpy(scene.render(1)).to(dev)
    return [lv.contiguous() for lv in
            image_ops.build_pyramid(img, cfg.extractor.n_levels, cfg.extractor.scale_factor)]


def worst_errors(outs, levels) -> list:
    err = [0.0, 0.0, 0.0]
    for out, lv in zip(outs, levels):
        for c, (o, r) in enumerate(zip(out, fast_cuda.blur_and_moments_ref(lv))):
            err[c] = max(err[c], float((o - r).abs().max()))
    return err


def one_level_part(paths: dict, levels, dev) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    host_taps, rank = fast_cuda.k2_taps()
    taps = torch.from_numpy(host_taps).to(dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, path in paths.items():
        sig = {"mcs_blur_and_moments": [p, i, i, p, i, p, p, p, i, i, p],
               "probe_blocks_per_sm": [p]}
        if "constant" in name:
            sig["probe_set_taps"] = [p, i]
        lib = cuda_build.load(path, sig)
        if "constant" in name:
            cuda_build.check_launch(
                lib.probe_set_taps(host_taps.ctypes.data, host_taps.size), "probe_set_taps")
        per_sm = ctypes.c_int(0)
        cuda_build.check_launch(lib.probe_blocks_per_sm(ctypes.byref(per_sm)), "occupancy")

        def launch(lv):
            h, w = lv.shape
            hp, wc = fast_cuda.padded_shape(h, w)
            out = torch.empty((3, hp, wc), device=dev)
            err = lib.mcs_blur_and_moments(lv.data_ptr(), h, w, taps.data_ptr(), rank,
                                           out[0].data_ptr(), out[1].data_ptr(),
                                           out[2].data_ptr(), hp, wc,
                                           torch.cuda.current_stream().cuda_stream)
            cuda_build.check_launch(err, "probe blur_and_moments")
            return out

        outs = [launch(lv) for lv in levels]
        torch.cuda.synchronize()
        errs = worst_errors(outs, levels)
        frame_ms = cs.cuda_ms(lambda: [launch(lv) for lv in levels], 50)
        slots = per_sm.value * n_sm
        parts = []
        waves = 0
        for lv in levels:
            hp, wc = fast_cuda.padded_shape(*lv.shape)
            blocks = (hp // 32) * (wc // 32)
            waves += -(-blocks // slots)
            ms = cs.cuda_ms(lambda: launch(lv), 100)
            parts.append(f"{tuple(lv.shape)} {blocks} blocks {ms:.4f} ms")
        print(f"{name}: {frame_ms:.4f} ms a frame; {per_sm.value} blocks an SM ({slots} "
              f"slots), {waves} waves in the frame's 8 launches; max |err| blur "
              f"{errs[0]:.3g}, m10 {errs[1]:.3g}, m01 {errs[2]:.3g}; levels: "
              + "; ".join(parts))


def multi_level_part(paths: dict, levels, dev) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    host_taps, rank = fast_cuda.k2_taps()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, path in paths.items():
        lib = cuda_build.load(path, {"mcs_k2_set_taps": [p, i, i],
                                     "mcs_blur_and_moments": [i, p, p, p, p],
                                     "probe_blocks_per_sm": [p], "probe_tile_rows": []})
        cuda_build.check_launch(lib.mcs_k2_set_taps(host_taps.ctypes.data, host_taps.size,
                                                    rank), "k2_set_taps")
        per_sm = ctypes.c_int(0)
        cuda_build.check_launch(lib.probe_blocks_per_sm(ctypes.byref(per_sm)), "occupancy")
        th = lib.probe_tile_rows()

        def launch(lvs):
            shapes = [fast_cuda.padded_shape(*lv.shape) for lv in lvs]
            outs = [torch.empty((3, hp, wc), device=dev) for hp, wc in shapes]
            n = len(lvs)
            imgs = (ctypes.c_void_p * n)(*(lv.data_ptr() for lv in lvs))
            optr = (ctypes.c_void_p * n)(*(o.data_ptr() for o in outs))
            dims = (ctypes.c_int * (4 * n))(*[d for lv, s in zip(lvs, shapes)
                                              for d in (*lv.shape, *s)])
            err = lib.mcs_blur_and_moments(n, ctypes.addressof(imgs), ctypes.addressof(optr),
                                           ctypes.addressof(dims),
                                           torch.cuda.current_stream().cuda_stream)
            cuda_build.check_launch(err, "probe blur_and_moments")
            return outs

        outs = launch(levels)
        torch.cuda.synchronize()
        errs = worst_errors(outs, levels)
        frame_ms = cs.cuda_ms(lambda: launch(levels), 50)
        tiles = sum(-(-fast_cuda.padded_shape(*lv.shape)[0] // th)
                    * (fast_cuda.padded_shape(*lv.shape)[1] // 32) for lv in levels)
        parts = [f"{tuple(lv.shape)} {cs.cuda_ms(lambda: launch([lv]), 100):.4f} ms"
                 for lv in levels]
        print(f"{name}: {frame_ms:.4f} ms a frame in one launch of {tiles} tiles "
              f"({th} rows each); {per_sm.value} blocks an SM ({per_sm.value * n_sm} slots); "
              f"max |err| blur {errs[0]:.3g}, m10 {errs[1]:.3g}, m01 {errs[2]:.3g}; each "
              "level alone: " + "; ".join(parts))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("k1", "k2"))
    ap.add_argument("--source", default=fast_cuda.SOURCE)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_fast_probe: needs an NVIDIA GPU")
    dev = torch.device("cuda:0")
    with open(a.source) as f:
        src = f.read()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    levels = levels_of_frame(dev)
    if a.only in (None, "k1"):
        if k1_one_launch_a_level(src):
            print(f"{smi}; source {a.source}, K1 one launch a level")
            k1_one_launch_a_level_part(src, levels, dev)
        else:
            print(f"{smi}; source {a.source}, K1 one launch a frame")
            k1_one_launch_part(src, levels, dev)
    if a.only == "k1":
        return
    if one_level_design(src):
        print(f"{smi}; source {a.source}, K2 one launch a level")
        paths = build_all({n: edited(edited(src, [ONE_LEVEL_OCCUPANCY]), e)
                           for n, e in ONE_LEVEL_VARIANTS.items()})
        one_level_part(paths, levels, dev)
    else:
        print(f"{smi}; source {a.source}, K2 one launch a frame")
        paths = build_all({n: edited(edited(src, [MULTI_LEVEL_OCCUPANCY]), e)
                           for n, e in MULTI_LEVEL_VARIANTS.items()})
        multi_level_part(paths, levels, dev)


if __name__ == "__main__":
    main()
