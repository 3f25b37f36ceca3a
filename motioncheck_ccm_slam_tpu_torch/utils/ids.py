"""Global entity-id plumbing.

A copy of ``motioncheck_ccm_slam_tpu/utils/ids.py`` (which imports no JAX
either), so the port imports nothing of the JAX package. The reference keys every map entity by ``idpair = (id, client_id)`` with
sentinel ranges for wire compression (reference: include/cslam/estd.h:47-108).
We keep the same scheme: keyframe ids fit u16, map-point ids u32, map ids u8;
the server additionally assigns each entity a globally unique monotonically
increasing uid (``UniqueIdDispenser``).
"""
from __future__ import annotations

import itertools
import threading
from typing import NamedTuple

# Sentinel ranges (wire compression bounds, reference estd.h:47-53).
KF_RANGE = 2**16 - 1   # keyframe ids fit uint16
MP_RANGE = 2**32 - 1   # map point ids fit uint32
MAP_RANGE = 2**8 - 1   # map / client ids fit uint8

#: "no entity" sentinel used in device-side index tables.
INVALID = -1


class IdPair(NamedTuple):
    """(id, client_id) — globally unique entity key across agents."""

    id: int
    client_id: int

    def __str__(self) -> str:  # pragma: no cover - debug aid
        return f"{self.id}|{self.client_id}"


def defpair() -> IdPair:
    """The reference's defpair sentinel (estd.h uses (max,max))."""
    return IdPair(KF_RANGE, MAP_RANGE)


class UniqueIdDispenser:
    """Server-global monotonically increasing uid source.

    Thread-safe like the reference (estd.h:83-108); starts at 1 so 0 can be
    reserved for "unset".
    """

    def __init__(self, start: int = 1):
        self._counter = itertools.count(start)
        self._lock = threading.Lock()
        self._last = start - 1

    def fetch(self) -> int:
        with self._lock:
            self._last = next(self._counter)
            return self._last

    @property
    def last(self) -> int:
        return self._last
