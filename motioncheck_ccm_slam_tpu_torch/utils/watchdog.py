"""Liveness watchdog.

The ``Watchdog`` of ``motioncheck_ccm_slam_tpu/utils/watchdog.py`` (which
imports no JAX either), so the port imports nothing of the JAX package. It
replaces the reference's ``estd::mylog`` watchdog thread
(include/cslam/estd.h:206-400: each module stamps a progress line; a
monitor flags modules silent beyond a timeout, a deadlock/liveness
detector). Spans and counters are ``utils/trace.py``'s.
"""
from __future__ import annotations

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
