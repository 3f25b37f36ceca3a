"""Map checkpoint save/load.

Counterpart of ``motioncheck_ccm_slam_tpu/persistence.py`` (the
reference's cereal-based ``Map::SaveMap`` / ``LoadMap`` src/Map.cpp:347-634,
exposed as the ``ccmslam_savemap`` service, src/server/ServerSystem.cpp:36):
the SoA map state serializes to one compressed npz of the device blocks,
keyed ``kf_<field>`` / ``mp_<field>``, plus the host allocator index in
``<path>.index.json``. The files are the JAX package's: descriptors are
stored as uint32 (``convert.desc_to_numpy``), every other field in its own
dtype, so a map saved by either package loads in the other. Slot indices
are stable across save/load; no pointer fixup is needed.
"""
from __future__ import annotations

import json
import os
import types

import numpy as np
import torch

from . import convert
from .config import Config
from .models import map_state as ms


def save_map(m: ms.MapState, path: str) -> None:
    """Write the full map state to ``path`` (.npz) + ``path``.index.json.
    Each field comes to the host with one ``.cpu()``."""
    arrays = {}
    for name, arr in convert.kf_block_to_numpy(m.kf)._asdict().items():
        arrays[f"kf_{name}"] = arr
    for name, arr in convert.mp_block_to_numpy(m.mp)._asdict().items():
        arrays[f"mp_{name}"] = arr
    np.savez_compressed(path, **arrays)
    index = {
        "next_kf_slot": int(m.next_kf_slot),
        "next_mp_slot": int(m.next_mp_slot),
        "kf_slots": [[int(k[0]), int(k[1]), int(v)] for k, v in m.kf_slot_by_id.items()],
        "mp_slots": [[int(k[0]), int(k[1]), int(v)] for k, v in m.mp_slot_by_id.items()],
    }
    with open(path + ".index.json", "w") as f:
        json.dump(index, f)


def load_map(path: str, config: Config, device: torch.device | str = "cuda") -> ms.MapState:
    """Rebuild a MapState on ``device`` from a checkpoint. Capacities come
    from the file (they may differ from the config's current capacities)."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    kf = types.SimpleNamespace(**{k[3:]: v for k, v in data.items() if k.startswith("kf_")})
    mp = types.SimpleNamespace(**{k[3:]: v for k, v in data.items() if k.startswith("mp_")})
    m = ms.MapState(kf=convert.kf_block_from_numpy(kf, device),
                    mp=convert.mp_block_from_numpy(mp, device), config=config)
    idx_path = (path if path.endswith(".index.json")
                else (path + ".index.json" if os.path.exists(path + ".index.json")
                      else os.path.splitext(path)[0] + ".npz.index.json"))
    if os.path.exists(idx_path):
        with open(idx_path) as f:
            index = json.load(f)
        m.next_kf_slot = index["next_kf_slot"]
        m.next_mp_slot = index["next_mp_slot"]
        m.kf_slot_by_id = {(a, b): c for a, b, c in index["kf_slots"]}
        m.mp_slot_by_id = {(a, b): c for a, b, c in index["mp_slots"]}
    else:
        m.sync_host_index()
    return m
