"""The share of the profiled units' wall time (frames or a GBA) in which no
operation ran on the device (the union of the profiler's device
intervals). One reader for both cell kinds: ``device_idle_pct.agent`` and
``device_idle_pct.server`` differ only in the end-to-end metric they
move."""

UNIT = "%"
LAYER = "Device"
MOVES = {"agent": "agent_frames_per_s", "server": "server_gba_s"}


def read(trace: dict):
    if not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
