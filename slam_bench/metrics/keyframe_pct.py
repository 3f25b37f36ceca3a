"""The share of the window's frames in which the mapper made a keyframe."""

UNIT = "%"
LAYER = "Local mapping and local BA"
MOVES = "agent_frame_ms_p95"


def read(trace: dict):
    units = trace["units"]
    return 100.0 * sum(1 for u in units if u["keyframe"]) / len(units) if units else None
