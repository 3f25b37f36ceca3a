"""The port's spans and counters: one registry, declared at import.

Each row of ``TABLE`` names a span or a counter, the span it lies in, what
it measures and the benchmark metrics that read it (``slam_bench/metrics``).
``seconds`` and ``counts`` hold the running totals, one attribute a row,
all of them there from import on: a reader resolves ``seconds.<name>`` or
``counts.<name>`` once and reads its change over a unit of work, so
``reset`` zeroes them in place and the two objects are never replaced.

``span(name)`` adds the host seconds spent inside it on every call, waits
at blocking reads included (``time.perf_counter``, ~1 us a span). While
``torch.profiler`` runs it also opens a record-function range of its name,
which lands on the profiler's host timeline on the kernels' clock; with no
profiler running it opens none. The range is of function scope
(``RecordFunctionFast``), not ``torch.profiler.record_function``'s user
scope: for a user-scope range Kineto also lays an annotation of the same
name over the device's timeline, which a reader of device intervals
counts as device work. A span never synchronizes the device: its seconds
are the host thread's, not device time. ``count(name, n)`` adds to a
counter.

It grew out of the ``PhaseTimer`` that the JAX package's
``utils/watchdog.py`` keeps, the counterpart of the reference's ad-hoc
``std::chrono`` phase timers.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch


class Entry(NamedTuple):
    name: str               # a Python identifier: read as an attribute path
    kind: str               # "span" or "counter"
    parent: Optional[str]   # the span it lies in, if any
    what: str
    read_by: tuple          # the benchmark's metrics that read it


TABLE = (
    Entry("tile_plan", "span", None,
          "sharded_ba.build_tile_plan: the tile plan of a GBA's observations, built on the host",
          ("gba_plan_host_s",)),
    Entry("tile_plan_read", "span", "tile_plan",
          "the plan's three reads of the observation arrays to the host",
          ("gba_plan_host_s",)),
    Entry("pcg", "span", None,
          "sharded_ba._pcg: one PCG solve, its sweeps issued by the host",
          ("pcg_host_s",)),
    Entry("pcg_exit_read", "span", "pcg",
          "each sweep's exit test, decide(rz > thresh), read to the host",
          ("pcg_host_s", "pcg_wait_s")),
    Entry("mc_passes", "span", None,
          "motion_check.run_motion_check: the forward and reverse passes and the run count, "
          "on the host copies",
          ("mc_passes_s",)),
    Entry("host_syncs", "counter", None,
          "points where the GBA path makes the host wait on the device: reads to the host, "
          "uploads from pageable memory, boolean-mask indexing",
          ("gba_host_syncs",)),
    Entry("mc_steps", "counter", "mc_passes",
          "step tests of both passes, one a KF tested",
          ("mc_steps_per_gba",)),
    Entry("loop_detect", "span", None,
          "loop_closing.LoopCloser.detect: the BoW query and the covisibility consistency",
          ("loop_detect_s",)),
    Entry("loop_sim3", "span", None,
          "LoopCloser.compute_sim3: mutual matching, Sim3 RANSAC, the guided refinement",
          ("loop_sim3_s",)),
    Entry("loop_correct", "span", None,
          "LoopCloser.correct_loop up to the essential graph: covisibility reads, the "
          "correction's propagation and landmark fusion",
          ("loop_correct_s",)),
    Entry("ess_graph", "span", None,
          "LoopCloser._optimize_essential_graph: edge assembly on the host, the Sim3 pose "
          "graph's LM and the landmarks' correction",
          ("ess_graph_s",)),
    Entry("ess_graph_jac", "span", "ess_graph",
          "pose_graph._edge_jacobians: the edges' forward-mode Jacobians, once an LM iteration",
          ("ess_graph_jac_s",)),
    Entry("ess_graph_edges", "counter", "ess_graph",
          "edges of each essential graph handed to pose_graph.optimize_pose_graph",
          ("ess_graph_edges",)),
)

SPANS = tuple(e.name for e in TABLE if e.kind == "span")
COUNTERS = tuple(e.name for e in TABLE if e.kind == "counter")


def _totals(cls_name: str, names: tuple):
    """An object with one attribute a name, and no room for another."""
    return type(cls_name, (), {"__slots__": names})()


seconds = _totals("Seconds", SPANS)
counts = _totals("Counts", COUNTERS)


def reset() -> None:
    """Zeroes every total in place (readers hold ``seconds`` and ``counts``)."""
    for name in SPANS:
        setattr(seconds, name, 0.0)
    for name in COUNTERS:
        setattr(counts, name, 0)


reset()

_profiling = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast
_clock = time.perf_counter


class span:
    """``with span(name):`` adds the block's host seconds to
    ``seconds.<name>``, and marks it for the profiler while one runs."""

    __slots__ = ("name", "t0", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _profiling():
            self.range = _range(self.name)
            self.range.__enter__()
        else:
            self.range = None
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        setattr(seconds, self.name, getattr(seconds, self.name) + (_clock() - self.t0))
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to ``counts.<name>``."""
    setattr(counts, name, getattr(counts, name) + n)
