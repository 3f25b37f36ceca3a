"""The median over the window's frames of ``Tracker.process`` (ORB extraction,
undistortion, the two-pass projection tracking and pose optimisation), a
span around the call with a device synchronize on both sides."""

import statistics

UNIT = "ms"
LAYER = "Tracking"
MOVES = "agent_frames_per_s"
SPANS = (("motioncheck_ccm_slam_tpu_torch.models.tracking", "Tracker.process", "track"),)


def read(trace: dict):
    vals = [u["spans"]["track"] * 1e3 for u in trace["units"] if "track" in u["spans"]]
    return statistics.median(vals) if vals else None
