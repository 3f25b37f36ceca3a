"""The port's own spans and counters, read by the per-layer metrics.

The port keeps one registry, ``motioncheck_ccm_slam_tpu_torch.utils.trace``:
``seconds.<span>`` (host seconds inside each span, no synchronize added)
and ``counts.<counter>``. A metric declares what it reads as ``COUNTERS``
triples, which a traced run reads as their change over each unit (a GBA),
so a span's seconds arrive as that GBA's. A port without the registry gives
no triples, and its metrics read None: the line leaves them out.
"""
from __future__ import annotations

import importlib.util

MODULE = "motioncheck_ccm_slam_tpu_torch.utils.trace"


def counters(*paths) -> tuple:
    """(module, path, name) triples for registry paths such as
    ``"seconds.pcg"`` (named ``pcg``), or () without the registry."""
    if importlib.util.find_spec(MODULE) is None:
        return ()
    return tuple((MODULE, p, p.split(".", 1)[1]) for p in paths)


def mean(trace: dict, names, fn):
    """The mean over the window's units of ``fn(values)``, ``values`` the
    unit's counters ``names``; None where no unit carries them."""
    vals = [fn(*(u["counters"][n] for n in names)) for u in trace["units"]
            if all(n in u["counters"] for n in names)]
    return sum(vals) / len(vals) if vals else None
