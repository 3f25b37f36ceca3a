"""Level-by-level clocks and ablations of the port's K2 (blur_and_moments) on the card.

Builds edited copies of motioncheck_ccm_slam_tpu_torch/csrc/fast.cu (or of
the file given with --source) under build/fast_probe/ and times them with
CUDA events (chip_smoke.cuda_ms) on the 8 pyramid levels of a rendered
EuRoC frame (chip_smoke.PlaneScene, 752x480, DEFAULT_CONFIG's pyramid):
each level alone and the whole frame, with the blocks of each level, the
blocks an SM holds at once (CUDA's occupancy query) and the waves that
makes, and each copy's worst error against the plain version.

The one-level design (one launch a level, a 32x32 tile a block of 1024
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

Usage (on the card): python3 tools/torch_fast_probe.py [--source PATH]
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


def one_level_design(src: str) -> bool:
    """Whether src has K2 as one launch a level with its taps in shared memory."""
    return "tap_s[" in src


def edited(src: str, edits) -> str:
    for a, b in edits:
        if a not in src:
            raise RuntimeError(f"probe: {a!r} is not in the source")
        src = src.replace(a, b)
    return src


def build_all(sources: dict) -> dict:
    """name -> built library path of each name -> source text, one nvcc
    each, started together."""
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
        for line in log.splitlines():
            if "blur_and_moments" in line or ("registers" in line and "smem" in line):
                print(f"  {name}: {line.strip()}")
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
