"""Faults planted in the port under the benchmark, each a context manager:
the tests run a small cell with one planted and see ``correct`` come out
false, and ``control.py --fault <name>`` reads a cell's numbers with one
planted at the cell's own size.

- ``halve_matches``: the tracker's projection search keeps the matches of
  half of the landmark slots, a fixed random half (half of the batch left
  out; the slots' parity would not halve them, since the map allocates
  them unevenly).
"""
from __future__ import annotations

import contextlib
import types

import torch


@contextlib.contextmanager
def halve_matches():
    from motioncheck_ccm_slam_tpu_torch.models import tracking

    real = tracking.matching

    def search(*a, **kw):
        m = real.search_by_projection(*a, **kw)
        gen = torch.Generator().manual_seed(0)
        half = torch.rand(m.ok.shape[0], generator=gen) < 0.5
        return m._replace(ok=m.ok & half.to(m.ok.device))

    proxy = types.SimpleNamespace(**{k: getattr(real, k) for k in dir(real)
                                     if not k.startswith("__")})
    proxy.search_by_projection = search
    tracking.matching = proxy
    try:
        yield
    finally:
        tracking.matching = real


FAULTS = {"halve_matches": halve_matches}
