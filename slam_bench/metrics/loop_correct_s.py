"""The loop's correction: the port's span ``loop_correct`` (``LoopCloser.correct_loop``
up to the essential graph: the (NK, NK) covisibility read, the
correction's propagation over the current keyframe's group and landmark
fusion); host seconds. A mean over the window's loops."""
from slam_bench import loop_trace, program_trace

UNIT = "s"
LAYER = "Loop closing"
MOVES = "server_gba_s"
COUNTERS = loop_trace.counters("seconds.loop_correct")


def read(trace: dict):
    return program_trace.mean(trace, ("loop_correct",), lambda v: v)
