"""The harness: finds a cell's parts by name and runs it once.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
configuration is ``configs/<name>.json``, the traffic ``traffic/<mix>.json``
(whose ``driver`` names the general generator and loop in
``drivers/<driver>.py`` that read it), each per-layer metric
``metrics/<name>.py`` (its unit, layer, the end-to-end metric it moves, its
reader, and the spans and counters of the port it reads, which the driver
puts around each unit of a traced run), and each compared number's limit
an entry of ``limits.json``. ``metrics/<stem>.py`` serves a metric
``<stem>.<kind>`` that has no file of its own, its ``MOVES`` a mapping by
kind. Adding a cell, a configuration, a traffic mix of an
existing driver or a per-layer metric adds files and entries only.

``run_cell`` is a run without the look for a card, so that tests can drive
it on the CPU at a small size; ``run.py`` looks for the card first.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "motioncheck_ccm_slam_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(held: bool = False) -> dict:
    """``BENCHMARK.json``; with ``held``, also the cells and metrics of
    ``held_cells.json``, which the program fails and the benchmark's own
    runs do not run (``control.py`` and the tests do)."""
    bench = load_json(ROOT, "BENCHMARK.json")
    if held:
        extra = load_json(BENCH_DIR, "held_cells.json")
        for key in ("workloads", "end_to_end", "per_layer"):
            bench[key] = bench[key] + extra[key]
    return bench


def cell_spec(name: str, bench: dict = None, held: bool = False) -> dict:
    bench = bench or benchmark(held)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json"
                         + (" or slam_bench/held_cells.json" if held else ""))
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return {"cell": cell, "config": load_json(ROOT, configs[cell["config"]]["file"]),
            "traffic": load_json(BENCH_DIR, "traffic", cell["traffic"] + ".json"),
            "end_to_end": [m for m in bench["end_to_end"]
                           if "workloads" not in m or name in m["workloads"]],
            "per_layer": [m for m in bench["per_layer"]
                          if "workloads" not in m or name in m["workloads"]]}


def metric_module(name: str):
    """``metrics/<name>.py`` (a name may hold dots), or ``metrics/<stem>.py``
    for ``<stem>.<kind>``, loaded by its path."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(BENCH_DIR, "metrics", name.rsplit(".", 1)[0] + ".py")
    spec = importlib.util.spec_from_file_location("slam_bench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_moves(name: str, mod=None) -> str:
    """The end-to-end metric that metric ``name`` moves, by its module."""
    moves = (mod or metric_module(name)).MOVES
    return moves[name.rsplit(".", 1)[1]] if isinstance(moves, dict) else moves


def instruments(spec: dict) -> tuple:
    """(spans, counters) that a traced run of the cell puts around each
    unit: the traffic's ``spans`` (which name the device's idle gaps) and
    every ``SPANS`` and ``COUNTERS`` of the cell's per-layer metrics, each
    a (module, attribute path, name) triple, without repeats."""
    spans = [tuple(s) for s in spec["traffic"].get("spans", [])]
    counters = []
    for m in spec["per_layer"]:
        mod = metric_module(m["name"])
        spans += [tuple(s) for s in getattr(mod, "SPANS", ())]
        counters += [tuple(c) for c in getattr(mod, "COUNTERS", ())]
    return list(dict.fromkeys(spans)), list(dict.fromkeys(counters))


def port_config(data: dict):
    """The port's Config with every group the configuration file gives."""
    from motioncheck_ccm_slam_tpu_torch import config as C

    groups = {"sys": C.SystemParams, "extractor": C.ExtractorParams,
              "tracking": C.TrackingParams, "mapping": C.MappingParams, "comm": C.CommParams,
              "placerec": C.PlaceRecParams, "opt": C.OptParams,
              "motion_check": C.MotionCheckParams, "camera": C.CameraParams,
              "capacity": C.CapacityParams}
    kw = {}
    for g, cls in groups.items():
        vals = dict(data[g])
        if "t_sc" in vals:
            vals["t_sc"] = tuple(vals["t_sc"])
        names = {f.name for f in dataclasses.fields(cls)}
        if set(vals) != names:
            raise ValueError(f"configuration group {g}: keys {sorted(set(vals) ^ names)} "
                             "missing or unknown")
        kw[g] = cls(**vals)
    return C.Config(**kw)


def percentile(values, q: float) -> float:
    """The q-th percentile by linear interpolation between order statistics."""
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


@dataclasses.dataclass
class Cell:
    """Everything a driver needs for one run."""

    name: str
    spec: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    config: object = None      # the port's Config
    limits: dict = None
    spans: list = dataclasses.field(default_factory=list)      # (module, attribute, name)
    counters: list = dataclasses.field(default_factory=list)   # (module, attribute, name)

    @property
    def traffic(self) -> dict:
        return self.spec["traffic"]

    @property
    def config_data(self) -> dict:
        return self.spec["config"]


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, spec: dict = None, with_control: bool = False) -> dict:
    """One run of a cell: set-up, the window, the comparison. Returns the
    result line's fields (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``checks`` and, traced, ``breakdown``)."""
    import torch

    spec = spec or cell_spec(name)
    cell = Cell(name=name, spec=spec, seed=int(seed), seconds=float(seconds), trace=bool(trace),
                device=torch.device(device), t_start=t_start,
                config=port_config(spec["config"]), limits=load_json(BENCH_DIR, "limits.json"))
    if trace:
        cell.spans, cell.counters = instruments(spec)
    driver = importlib.import_module("slam_bench.drivers." + spec["traffic"]["driver"])
    out = driver.run(cell, with_control=with_control)
    metrics = {}
    wanted = spec["per_layer"] if trace else spec["end_to_end"]
    if trace:
        for m in wanted:
            value = metric_module(m["name"]).read(out["trace"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in wanted:
            if m["name"] in out["end_to_end"]:
                metrics[m["name"]] = {"value": out["end_to_end"][m["name"]], "unit": m["unit"]}
    result = {"correct": all(c["value"] <= c["limit"] for c in out["checks"]) and out["checked"],
              "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics}
    if trace and out.get("profile"):
        from . import spans

        result["breakdown"] = spans.breakdown(out["profile"])
        result["profile"] = out["profile"]
    result["checks"] = out["checks"]
    result["checked"] = out["checked"]
    result["memory_peak_bytes"] = out["memory_peak_bytes"]
    result["info"] = out.get("info", {})
    result["raw"] = out.get("raw")
    return result


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def finite(x):
    """``x`` with every float that is not finite as None (valid JSON)."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, float) and (x != x or x in (float("inf"), float("-inf"))):
        return None
    return x


def result_line(out: dict, trace: bool, device: dict) -> dict:
    """The last line's object: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device`` (traced: with ``busy_s`` and ``window_s``, and
    ``breakdown``), ``info``, and last ``compared``: each number compared
    with its limit."""
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["metrics"], "device": dict(device)}
    if trace:
        prof = out.get("profile") or {}
        line["device"]["busy_s"] = prof.get("busy_s", 0.0)
        line["device"]["window_s"] = prof.get("window_s", 0.0)
        if "breakdown" in out:
            line["breakdown"] = out["breakdown"]
    line["info"] = finite(out["info"])
    line["compared"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in out["checks"]}
    if not out["checked"]:
        line["compared"]["nothing_to_compare"] = {"value": 1, "limit": 0}
    return line
