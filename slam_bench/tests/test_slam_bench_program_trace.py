"""The metrics that read the port's own spans and counters
(``program_trace.py``): a traced small CPU run of ``euroc-server-gba``
reads all six, each inside the benchmark's synchronizing span around the
same work; every entry of the port's registry is read by some metric; a
port without the registry gives no counters and no readings."""
import math

from motioncheck_ccm_slam_tpu_torch.utils import trace as registry

import bench_cells
from slam_bench import bench, program_trace
from slam_bench.drivers import server_gba

HELD = bench.benchmark(held=True)
PROGRAM_METRICS = ("gba_host_syncs", "gba_plan_host_s", "pcg_host_s", "pcg_wait_s",
                   "mc_passes_s", "mc_steps_per_gba")


def _registry_readers() -> dict:
    """Registry entry -> the per-layer metrics whose COUNTERS read it."""
    readers = {}
    for m in HELD["per_layer"]:
        for module, path, name in getattr(bench.metric_module(m["name"]), "COUNTERS", ()):
            if module == program_trace.MODULE:
                assert path.split(".", 1)[1] == name, path
                readers.setdefault(name, set()).add(m["name"])
    return readers


def test_traced_run_reads_the_program_spans(monkeypatch):
    seen = {}
    real = server_gba.run

    def run(cell, **kw):
        out = real(cell, **kw)
        seen["units"] = out["trace"]["units"]
        return out

    monkeypatch.setattr(server_gba, "run", run)
    out = bench_cells.run("euroc-server-gba", 3.0, monkeypatch, trace=True)
    assert out["correct"] is True
    for name in PROGRAM_METRICS:
        assert math.isfinite(out["metrics"][name]["value"]), name
    assert out["metrics"]["gba_host_syncs"]["value"] > 0
    assert out["metrics"]["mc_steps_per_gba"]["value"] > 0
    for u in seen["units"]:
        c, s = u["counters"], u["spans"]
        # pcg_host_s + pcg_wait_s is the span pcg, inside the solver's call
        assert 0 < c["pcg_exit_read"] <= c["pcg"] <= s["gba.solver"]
        assert 0 < c["tile_plan_read"] <= c["tile_plan"] <= s["gba.plan"]
        assert 0 < c["mc_passes"] <= s["mc"]


def test_every_registry_entry_is_read():
    readers = _registry_readers()
    assert set(readers) == set(registry.SPANS) | set(registry.COUNTERS)
    for e in registry.TABLE:
        assert readers[e.name] == set(e.read_by), e.name


def test_without_the_registry_nothing_is_read(monkeypatch):
    monkeypatch.setattr(program_trace, "MODULE", "motioncheck_ccm_slam_tpu_torch.utils.absent")
    assert program_trace.counters("seconds.pcg") == ()
    units = {"units": [{"counters": {"s_apply": 3}, "spans": {}}]}
    for name in PROGRAM_METRICS:
        assert bench.metric_module(name).read(units) is None, name
