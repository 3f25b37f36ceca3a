"""Readings of a cell's compared numbers, the program's and the precision
control's, over several seeds in one process.

    python3 slam_bench/control.py --workload <name> --seeds 1,2,3 --seconds 8 \
        [--fault <name>] [--dump <dir>]

For each seed it runs the cell at the cell's own load and sizes (the
window as long as ``--seconds``: the agent's trajectory number wants the
cell's own) and prints one JSON line: each compared number as the program
gave it, and as the control gave it (the plain reference computed in
bfloat16, the precision below the float32 that the configuration states,
put in the program's place). With ``--fault`` a fault of ``faults.py`` is
planted in the program first. With ``--dump`` each seed's trajectories are
written to ``<dir>/<workload>.<seed>.<i>.npz`` (``i`` its place in
``--seeds``). The limits in ``limits.json``
lie between the two readings; the benchmark's own runs never run the
control. It also runs the cells of ``held_cells.json``. Needs the card,
as a run does.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--fault", default="")
    ap.add_argument("--dump", default="")
    args = ap.parse_args(argv)
    import contextlib

    import numpy as np
    import torch

    from slam_bench import bench, faults

    if not torch.cuda.is_available():
        print("slam_bench control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with faults.FAULTS[args.fault]() if args.fault else contextlib.nullcontext():
            out = bench.run_cell(args.workload, seed, args.seconds, False,
                                 torch.device("cuda", 0), t0,
                                 spec=bench.cell_spec(args.workload, held=True),
                                 with_control=True)
        info = {k: v for k, v in out["info"].items() if k != "control"}
        print(json.dumps(bench.finite({
            "workload": args.workload, "seed": seed, "fault": args.fault,
            "program": {c["name"]: c["value"] for c in out["checks"]},
            "control": out["info"].get("control", {}), "correct": out["correct"],
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": {k: m["value"] for k, m in out["metrics"].items()}, "info": info,
            "seconds": time.perf_counter() - t0})), flush=True)
        if args.dump and out.get("raw"):
            os.makedirs(args.dump, exist_ok=True)
            tag = f"{args.workload}.{seed}.{i}" + (f".{args.fault}" if args.fault else "")
            np.savez(os.path.join(args.dump, tag + ".npz"), **out["raw"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
