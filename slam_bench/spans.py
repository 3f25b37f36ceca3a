"""The benchmark's own spans and the device trace of a traced run.

Spans wrap calls into the port from outside (an attribute of a module or
an object is swapped for a timed wrapper, then put back): with tracing on,
each call is preceded and followed by a device synchronize, timed on the
host clock and marked for the profiler with ``record_function``, so its
seconds include the device work it queued. With tracing off nothing is
wrapped. ``Profile`` runs ``torch.profiler`` over a few units of the
window and reduces its raw events to busy seconds, device seconds by
kernel name and idle gaps named by the span that was open on the host.
"""
from __future__ import annotations

import collections
import contextlib
import importlib
import time

import torch


def resolve(module: str, path: str) -> tuple:
    """(owner, attribute name) of the dotted attribute ``path`` of
    ``module``, e.g. ``("...models.tracking", "Tracker.process")``."""
    owner = importlib.import_module(module)
    *parents, attr = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, attr


class Counters:
    """The port's counters, each read as its change over one unit."""

    def __init__(self, declared):
        self.items = [(name, *resolve(module, path)) for module, path, name in declared]
        self.base = self._now()

    def _now(self) -> dict:
        return {name: getattr(owner, attr) for name, owner, attr in self.items}

    def take(self) -> dict:
        now = self._now()
        out = {n: v - self.base[n] for n, v in now.items()}
        self.base = now
        return out


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Per-unit sums of span seconds (a unit is a frame or a GBA)."""

    def __init__(self, enabled: bool, device):
        self.enabled, self.device = enabled, device
        self.current = collections.defaultdict(float)
        self.names = set()
        self._saved = []

    def timed(self, name: str, fn):
        self.names.add(name)

        def call(*a, **kw):
            sync(self.device)
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = fn(*a, **kw)
                sync(self.device)
            self.current[name] += time.perf_counter() - t0
            return out
        return call

    def wrap(self, owner, attr: str, name: str) -> None:
        """Swap ``owner.attr`` for its timed wrapper while tracing."""
        if self.enabled:
            original = getattr(owner, attr)
            self._saved.append((owner, attr, original, attr in vars(owner)))
            setattr(owner, attr, self.timed(name, original))

    def wrap_declared(self, declared) -> None:
        """``wrap`` each (module, attribute path, name) triple."""
        for module, path, name in declared:
            self.wrap(*resolve(module, path), name)

    def take(self) -> dict:
        out = dict(self.current)
        self.current.clear()
        return out

    def restore(self) -> None:
        for owner, attr, original, own in reversed(self._saved):
            if own:
                setattr(owner, attr, original)
            else:
                delattr(owner, attr)
        self._saved.clear()


class Profile:
    """torch.profiler over a sub-window; ``result`` after ``stop``."""

    def __init__(self, device, span_names):
        self.device, self.span_names = device, set(span_names)
        self.prof = None
        self.result = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        sync(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> float:
        """Ends the profile; returns the seconds its reading took, which the
        caller leaves out of its window."""
        sync(self.device)
        t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.result = reduce_events(self.prof.profiler.kineto_results.events(), t1 - self.t0,
                                    self.span_names)
        self.prof = None
        return time.perf_counter() - t1


def reduce_events(events, window_s: float, span_names) -> dict:
    """Busy seconds (the union of device intervals), device seconds and
    counts by kernel name, and idle seconds by the innermost benchmark
    span open on the host when each gap began."""
    dev, spans = [], []
    for e in events:
        if e.name() in span_names:
            # record_function marks the host range and, on the device's
            # timeline, an annotation of the same name: only the first counts
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                spans.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((e.start_ns(), e.end_ns(), e.name()))
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for a, b, n in dev:
        by_name[n][0] += (b - a) * 1e-9
        by_name[n][1] += 1
    dev.sort()
    busy_ns, gaps = 0, collections.defaultdict(float)
    cur_a = cur_b = None
    for a, b, _ in dev:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy_ns += cur_b - cur_a
                gaps[_open_span(spans, cur_b, a)] += (a - cur_b) * 1e-9
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy_ns += cur_b - cur_a
    return {"busy_s": busy_ns * 1e-9, "window_s": window_s,
            "kernels": {n: (v[0], v[1]) for n, v in by_name.items()},
            "idle_by_span": dict(gaps), "n_device_ops": len(dev)}


def _open_span(spans, t0: int, t1: int) -> str:
    """The shortest benchmark span that covers the gap's start."""
    best, best_len = "between spans", None
    for a, b, n in spans:
        if a <= t0 <= b and (best_len is None or b - a < best_len):
            best, best_len = n, b - a
    return best


def breakdown(result: dict) -> dict:
    ops = sorted(result["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(result["idle_by_span"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, (s, _) in ops], "idle_gaps": [[n, s] for n, s in gaps]}


@contextlib.contextmanager
def swapped(owner, attr: str, fn):
    """``owner.attr`` replaced by ``fn(original)`` within the block."""
    original = getattr(owner, attr)
    own = attr in vars(owner)
    setattr(owner, attr, fn(original))
    try:
        yield
    finally:
        if own:
            setattr(owner, attr, original)
        else:
            delattr(owner, attr)
