"""The port's span and counter registry (``utils/trace.py``).

The registry's own behaviour (host seconds, a record-function range only
under a profiler, totals zeroed in place, every row present at import),
then one MC-gated GBA on the tile route at a CPU size (``entry``'s server
scene cut to 4 x 32 keyframes of 64 features and 2048 landmarks) under
``torch.profiler``: each span's ranges lie inside its declared parent's,
``mc_steps`` counts the steps ``motion_violates`` tests, ``pcg_exit_read`` the
PCG exit tests, and ``host_syncs`` at least those.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from motioncheck_ccm_slam_tpu_torch import entry
from motioncheck_ccm_slam_tpu_torch.models import gba, motion_check
from motioncheck_ccm_slam_tpu_torch.parallel import sharded_ba
from motioncheck_ccm_slam_tpu_torch.utils import trace

import torch_one_thread  # noqa: F401 (torch on one thread)


def test_span_adds_host_seconds():
    before = trace.seconds.pcg
    with trace.span("pcg"):
        time.sleep(0.01)
    assert 0.01 <= trace.seconds.pcg - before < 1.0


def test_span_opens_a_range_only_under_the_profiler(monkeypatch):
    opened = []
    real = trace._range

    def counted_range(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(trace, "_range", counted_range)
    with trace.span("tile_plan"):
        pass
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("tile_plan"):
            pass
    assert opened == ["tile_plan"]
    # on the host's timeline only: no annotation of the span on a device's
    ranges = [e for e in prof.profiler.kineto_results.events() if e.name() == "tile_plan"]
    assert [e.device_type() for e in ranges] == [torch.autograd.DeviceType.CPU]


def test_reset_zeroes_in_place():
    seconds, counts = trace.seconds, trace.counts
    trace.count("host_syncs", 3)
    with trace.span("mc_passes"):
        pass
    trace.reset()
    assert trace.seconds is seconds and trace.counts is counts
    assert all(getattr(seconds, n) == 0.0 for n in trace.SPANS)
    assert all(getattr(counts, n) == 0 for n in trace.COUNTERS)


def test_every_row_exists_at_import():
    names = [e.name for e in trace.TABLE]
    assert len(set(names)) == len(names)
    for e in trace.TABLE:
        assert e.name.isidentifier() and e.kind in ("span", "counter") and e.read_by
        owner = trace.seconds if e.kind == "span" else trace.counts
        assert isinstance(getattr(owner, e.name), float if e.kind == "span" else int)
        assert e.parent is None or e.parent in trace.SPANS
    assert set(trace.SPANS) | set(trace.COUNTERS) == set(names)
    with pytest.raises(AttributeError):
        trace.count("no_such_counter")


# the spans a GBA opens (the loop closer's lie outside a GBA)
GBA_SPANS = ("tile_plan", "tile_plan_read", "pcg", "pcg_exit_read", "mc_passes")


def _small_config():
    """The server configuration at 4 x 32 keyframes of 64 features over
    2048 landmarks."""
    base = entry.SERVER_CONFIG
    cfg = dataclasses.replace(
        base, capacity=dataclasses.replace(base.capacity, server_max_kfs=128,
                                           server_max_mps=2048),
        extractor=dataclasses.replace(base.extractor, max_features=64))
    return cfg


def test_small_gba_spans_nest_and_counters_count(monkeypatch):
    cfg = _small_config()
    monkeypatch.setattr(entry, "SERVER_CONFIG", cfg)
    monkeypatch.setattr(gba, "DENSE_W_MAX_BYTES", 1024)     # the tile route, as at capacity
    m = entry.server_map(entry.server_scene.__wrapped__(7), "cpu")   # not the scene's cache

    steps, exits = [0], [0]
    violates, all_true = motion_check.motion_violates, sharded_ba.Shards.all_true

    def counted_violates(step_post, *a, **kw):
        steps[0] += int(np.prod(np.shape(step_post)[:-1]))      # one step a row
        return violates(step_post, *a, **kw)

    def counted_all_true(self, flag):
        exits[0] += 1
        return all_true(self, flag)

    monkeypatch.setattr(motion_check, "motion_violates", counted_violates)
    monkeypatch.setattr(sharded_ba.Shards, "all_true", counted_all_true)
    c0 = {n: getattr(trace.counts, n) for n in trace.COUNTERS}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = gba.run_gba(m, cfg, iterations=2, chunk=1)
    d = {n: getattr(trace.counts, n) - c0[n] for n in trace.COUNTERS}
    assert not res.reverted and res.n_deleted_kfs == 0

    ranges = {n: [] for n in GBA_SPANS}
    for e in prof.events():
        if e.name in ranges:
            ranges[e.name].append((e.time_range.start, e.time_range.end))
    assert all(ranges.values()), {n: len(r) for n, r in ranges.items()}
    for e in trace.TABLE:
        if e.kind == "span" and e.parent is not None and e.name in ranges:
            for a, b in ranges[e.name]:
                assert any(pa <= a and b <= pb for pa, pb in ranges[e.parent]), e.name

    assert steps[0] > 0 and d["mc_steps"] == steps[0]
    assert exits[0] > 0 and len(ranges["pcg_exit_read"]) == exits[0]
    assert len(ranges["pcg"]) == 2 and len(ranges["tile_plan"]) == 1
    assert d["host_syncs"] >= exits[0]
