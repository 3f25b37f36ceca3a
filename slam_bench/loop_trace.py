"""The port's loop-closing spans and counter, declared only where the port
has them.

``program_trace.counters`` declares a registry path wherever the registry
exists; a port whose registry predates the loop path's rows would then
fail to resolve them. ``counters`` here declares the paths only when every
named row is in the registry's ``TABLE``, else nothing, so that the
metrics read None there and the line leaves them out.
"""
from __future__ import annotations

import importlib

from slam_bench import program_trace


def counters(*paths) -> tuple:
    """``program_trace.counters(*paths)``, or () if the port lacks a row."""
    triples = program_trace.counters(*paths)
    if not triples:
        return ()
    registry = importlib.import_module(program_trace.MODULE)
    rows = {e.name for e in getattr(registry, "TABLE", ())}
    return triples if all(name in rows for _, _, name in triples) else ()
