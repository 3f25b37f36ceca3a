"""One run of one cell of the port's benchmark.

    python3 slam_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. It loads the port (``motioncheck_ccm_slam_tpu_torch``), builds or
loads its CUDA kernels (cached under ``build/`` in the checkout), makes
the cell's inputs from the seed, warms up the cell's shapes, measures for
``--seconds``, compares what the window produced with the plain reference
under ``slam_bench/reference/``, and prints one JSON line last on
standard output. With ``--trace 0`` the line holds the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics and the device trace's
``breakdown``. Without a card, or with fewer than the cell asks for, it
exits with code 2 and prints no result; it never falls back to the CPU.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# one process with few threads: host work of the port and of the
# reference does not spread over every core of a shared host
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "4"
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["USE_FLAX"] = "0"


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=20)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else ""
    except (OSError, subprocess.TimeoutExpired):
        return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from slam_bench import bench

    spec = bench.cell_spec(args.workload)
    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"slam_bench: the cell asks for {chips} CUDA device(s), {n} visible; "
              "no result without them", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    out = bench.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device,
                         T_START, spec=spec)
    found = bench.forbidden_modules()
    if found:
        print(f"slam_bench: the run loaded {found}; the benchmark and the port run without "
              "JAX", file=sys.stderr)
        return 3
    line = bench.result_line(out, bool(args.trace), {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
        "memory_peak_bytes": out["memory_peak_bytes"], "power_limit": power_limit()})
    for name, c in line["compared"].items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
