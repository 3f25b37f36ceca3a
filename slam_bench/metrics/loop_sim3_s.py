"""The loop's Sim3: the port's span ``loop_sim3`` (``LoopCloser.compute_sim3``:
mutual matching, Sim3 RANSAC, the Sim3-guided search and refinement); host
seconds. A mean over the window's loops."""
from slam_bench import loop_trace, program_trace

UNIT = "s"
LAYER = "Loop closing"
MOVES = "server_gba_s"
COUNTERS = loop_trace.counters("seconds.loop_sim3")


def read(trace: dict):
    return program_trace.mean(trace, ("loop_sim3",), lambda v: v)
