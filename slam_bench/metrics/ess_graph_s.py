"""The essential graph: the port's span ``ess_graph``
(``LoopCloser._optimize_essential_graph``: edge assembly on the host, the
Sim3 pose graph's LM on the route ``optimize_pose_graph`` picks, the
landmarks' correction); host seconds. A mean over the window's loops."""
from slam_bench import loop_trace, program_trace

UNIT = "s"
LAYER = "Loop closing"
MOVES = "server_gba_s"
COUNTERS = loop_trace.counters("seconds.ess_graph")


def read(trace: dict):
    return program_trace.mean(trace, ("ess_graph",), lambda v: v)
