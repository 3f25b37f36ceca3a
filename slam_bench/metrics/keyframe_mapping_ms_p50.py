"""The median over the window's keyframe frames of ``LocalMapper.process_keyframe``
(insertion, culling, triangulation, fusion, descriptor refresh, trimming
and the local BA), a span around the call with a device synchronize on
both sides."""

import statistics

UNIT = "ms"
LAYER = "Local mapping and local BA"
MOVES = "agent_frame_ms_p95"
SPANS = (("motioncheck_ccm_slam_tpu_torch.models.mapping", "LocalMapper.process_keyframe", "map"),)


def read(trace: dict):
    vals = [u["spans"]["map"] * 1e3 for u in trace["units"] if u["keyframe"] and "map" in u["spans"]]
    return statistics.median(vals) if vals else None
