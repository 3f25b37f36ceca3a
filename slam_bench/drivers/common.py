"""What the drivers share: a compared number beside its limit, the
device's peak memory, and freeing the program's state before the
reference runs."""
from __future__ import annotations

import gc
import math

import torch


def check(name: str, value, limits: dict) -> dict:
    """A compared number with its limit from ``limits.json``; a number that
    is not finite reads as 1e30, above every limit."""
    value = float(value)
    if not math.isfinite(value):
        value = 1e30
    return {"name": name, "value": value, "limit": float(limits[name]["limit"])}


def capture_peak(device) -> int:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free_device(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
