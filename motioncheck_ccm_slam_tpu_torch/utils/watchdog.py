"""Liveness watchdog + phase timing.

A copy of ``motioncheck_ccm_slam_tpu/utils/watchdog.py`` (which imports no
JAX either), so the port imports nothing of the JAX package. It replaces
the reference's ``estd::mylog`` watchdog thread (include/cslam/estd.h:
206-400: each module stamps a progress line; a monitor flags modules silent
beyond a timeout, a deadlock/liveness detector) and its ad-hoc
``std::chrono`` phase timers (output_MC_MAPtime.txt etc.).
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Tuple


class Watchdog:
    """Module heartbeat registry with a silence detector."""

    def __init__(self, timeout_s: float = 30.0):
        self.timeout_s = timeout_s
        self._last: Dict[str, Tuple[float, str]] = {}
        self._lock = threading.Lock()

    def beat(self, module: str, note: str = ""):
        with self._lock:
            self._last[module] = (time.monotonic(), note)

    def silent_modules(self) -> List[Tuple[str, float, str]]:
        """Modules that haven't reported within the timeout."""
        now = time.monotonic()
        with self._lock:
            return [
                (mod, now - t, note)
                for mod, (t, note) in self._last.items()
                if now - t > self.timeout_s
            ]

    def report(self) -> str:
        lines = []
        now = time.monotonic()
        with self._lock:
            for mod, (t, note) in sorted(self._last.items()):
                age = now - t
                flag = " !!SILENT!!" if age > self.timeout_s else ""
                lines.append(f"{mod}: {age:.1f}s ago ({note}){flag}")
        return "\n".join(lines)


class PhaseTimer:
    """Accumulating wall-clock timers per phase (GBA, MC, comm, ...)."""

    def __init__(self):
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)

    class _Ctx:
        def __init__(self, timer: "PhaseTimer", name: str):
            self.timer = timer
            self.name = name

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            dt = time.perf_counter() - self.t0
            self.timer.totals[self.name] += dt
            self.timer.counts[self.name] += 1
            return False

    def phase(self, name: str) -> "PhaseTimer._Ctx":
        return PhaseTimer._Ctx(self, name)

    def summary(self) -> str:
        return "\n".join(
            f"{name}: total={self.totals[name]:.3f}s n={self.counts[name]} "
            f"mean={self.totals[name] / max(self.counts[name], 1) * 1e3:.1f}ms"
            for name in sorted(self.totals)
        )
