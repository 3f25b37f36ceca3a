"""The harness: BENCHMARK.json against the contract and the files it
names, the imports of every module, generators that repeat from a seed,
and the last line of a small CPU run."""
import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_cells
from slam_bench import bench, scene, server_map, spans
from slam_bench.drivers import server_gba

ROOT = bench.ROOT
BENCH = bench.benchmark()
HELD = bench.benchmark(held=True)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
ALL_CELLS = [w["name"] for w in HELD["workloads"]]
PER_LAYER = [m["name"] for m in HELD["per_layer"]]


def test_benchmark_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "slam_bench/run.py"]
    assert BENCH["paths"] == ["slam_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    e2e = {m["name"] for m in HELD["end_to_end"]}
    assert e2e == {"agent_frames_per_s", "agent_frame_ms_p95", "server_gba_s", "setup_s"}
    held = bench.load_json(bench.BENCH_DIR, "held_cells.json")
    assert not {w["name"] for w in held["workloads"]} & set(CELLS)
    for key in ("end_to_end", "per_layer"):
        for m in held[key]:
            assert set(m["workloads"]) <= {w["name"] for w in held["workloads"]}, m["name"]
    for m in HELD["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_cell_resolves(cell):
    spec = bench.cell_spec(cell, held=True)
    w = spec["cell"]
    for key in ("name", "config", "traffic"):
        assert NAME.match(w[key]), w[key]
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert os.path.exists(os.path.join(bench.BENCH_DIR, "drivers",
                                       spec["traffic"]["driver"] + ".py"))
    assert bench.port_config(spec["config"]) is not None
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and spec["per_layer"]
    for m in spec["per_layer"]:
        assert m["moves"] in names, (m["name"], m["moves"])


@pytest.mark.parametrize("metric", PER_LAYER)
def test_metric_resolves(metric):
    m = next(x for x in HELD["per_layer"] if x["name"] == metric)
    mod = bench.metric_module(metric)
    assert NAME.match(metric) and UNIT.match(m["unit"])
    assert (mod.UNIT, mod.LAYER, bench.metric_moves(metric, mod)) == (m["unit"], m["layer"],
                                                                       m["moves"])
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert mod.read({"units": []}) is None
    for module, path, name in getattr(mod, "SPANS", ()) + getattr(mod, "COUNTERS", ()):
        owner, attr = spans.resolve(module, path)
        assert hasattr(owner, attr) and NAME.match(name), (module, path)


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_traced_units_carry_what_metrics_read(cell):
    spec = bench.cell_spec(cell, held=True)
    declared_spans, declared_counters = bench.instruments(spec)
    assert len({(m, p) for m, p, _ in declared_spans}) == len(declared_spans)
    for module, path, _ in declared_spans + declared_counters:
        assert hasattr(*spans.resolve(module, path)), (module, path)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file(config):
    c = next(x for x in BENCH["configs"] if x["name"] == config)
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("slam_bench/") and NAME.match(config)
    data = bench.load_json(ROOT, c["file"])
    assert data["name"] == config and data["reduced"] == c["reduced"]
    assert any(w["config"] == config for w in BENCH["workloads"])
    assert all(w["config"] in {c["name"] for c in BENCH["configs"]} for w in HELD["workloads"])


def test_limits_cover_every_number():
    limits = bench.load_json(bench.BENCH_DIR, "limits.json")
    for name, entry in limits.items():
        assert entry["limit"] >= 0, name


def _modules():
    for dirpath, _, files in os.walk(bench.BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _top_level_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    names = set(_top_level_imports(path))
    assert not names & set(bench.FORBIDDEN), names & set(bench.FORBIDDEN)
    if os.sep + "reference" + os.sep in path:
        assert "motioncheck_ccm_slam_tpu_torch" not in names


def test_render_repeats_from_seed():
    tr = bench.load_json(bench.BENCH_DIR, "traffic", "agent_stream.json")
    cam = dict(bench.load_json(bench.BENCH_DIR, "configs", "euroc_mav.json")["camera"])
    cam.update(width=96, height=64, cx=48.0, cy=32.0)
    def frames(seed):
        sc = scene.Scene(tr, cam, seed, "cpu")
        return sc.render(np.stack([sc.pose(k) for k in (0, 7)]))

    a, b, c = frames(2 ** 33 + 5), frames(2 ** 33 + 5), frames(2 ** 33 + 6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0 and float(a.max()) <= 255


def test_server_map_repeats_from_seed():
    tr = bench.load_json(bench.BENCH_DIR, "traffic", "server_gba_honest.json")
    cam = bench.load_json(bench.BENCH_DIR, "configs", "euroc_mav.json")["camera"]
    a = server_map.build(tr["map"], cam, 64, 2048, 64, 2 ** 40 + 3, "cpu")
    b = server_map.build(tr["map"], cam, 64, 2048, 64, 2 ** 40 + 3, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert int((a.mp_idx >= 0).sum()) > 0.9 * a.mp_idx.numel()
    d1 = server_gba.draws(2 ** 40 + 3, 50, 4, 15)
    assert np.array_equal(d1, server_gba.draws(2 ** 40 + 3, 50, 4, 15))
    assert d1.max() <= 15 and all(not np.array_equal(p, q) for p, q in zip(d1, d1[1:]))


def test_last_line_shape(monkeypatch):
    out = bench_cells.run("euroc-server-gba", 3.0, monkeypatch)
    line = bench.result_line(out, False, {"platform": "gpu", "kind": "x", "count": 1,
                                          "memory_peak_bytes": 0})
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["attempted"] >= 1
    assert set(line["metrics"]) == {"server_gba_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    json.loads(json.dumps(line, allow_nan=False))


def test_run_without_a_card_prints_nothing():
    r = subprocess.run([sys.executable, os.path.join(ROOT, "slam_bench", "run.py"),
                        "--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_run_refuses_a_held_cell():
    held = sorted(set(ALL_CELLS) - set(CELLS))
    r = subprocess.run([sys.executable, os.path.join(ROOT, "slam_bench", "run.py"),
                        "--workload", held[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(cell, card):
    r = subprocess.run([sys.executable, os.path.join(ROOT, "slam_bench", "run.py"),
                        "--workload", cell, "--seed", "4200000001", "--seconds", "5",
                        "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["correct"] is True
