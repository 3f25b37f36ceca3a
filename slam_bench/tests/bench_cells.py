"""Small cells for the CPU tests: the cells' own traffic and configuration
at sizes a CPU run holds (the agent at 512 features on 4 levels with a
24-keyframe map, the server at 256 keyframes of 256 features and 8192
landmarks on the tile GBA's route)."""
import copy
import time

from slam_bench import bench


def spec(name: str, frames: int = 80) -> dict:
    s = copy.deepcopy(bench.cell_spec(name, held=True))
    c, t = s["config"], s["traffic"]
    if t["driver"] == "server_gba":
        c["capacity"].update(server_max_kfs=256, server_max_mps=8192)
        c["extractor"].update(max_features=256)
        if t["kick"]:
            t["kick"].update(first_kf=20, count=16)
    else:
        c["extractor"].update(max_features=512, n_features=500, n_levels=4)
        c["capacity"].update(client_max_kfs=24, client_max_mps=2048)
        t["frames"] = frames
    return s


def run(name: str, seconds: float, monkeypatch, trace: bool = False, with_control: bool = False,
        seed: int = 4100000001, frames: int = 80) -> dict:
    """One CPU run of ``name`` at the small size; below the server's dense-W
    size the driver takes the tile GBA, as at capacity."""
    from motioncheck_ccm_slam_tpu_torch.models import gba

    monkeypatch.setattr(gba, "DENSE_W_MAX_BYTES", 1024)
    return bench.run_cell(name, seed, seconds, trace, "cpu", time.perf_counter(),
                          spec=spec(name, frames), with_control=with_control)
