"""The essential graph's size: the port's counter ``ess_graph_edges``, the edges
handed to ``pose_graph.optimize_pose_graph``. A mean over the window's
loops."""
from slam_bench import loop_trace, program_trace

UNIT = "edges"
LAYER = "Loop closing"
MOVES = "server_gba_s"
COUNTERS = loop_trace.counters("counts.ess_graph_edges")


def read(trace: dict):
    return program_trace.mean(trace, ("ess_graph_edges",), lambda v: v)
