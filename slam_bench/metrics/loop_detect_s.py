"""The loop closer's detection a loop: the port's span ``loop_detect``
(``LoopCloser.detect``: the BoW query over the keyframe database and the
covisibility consistency), over every arriving keyframe of the unit; host
seconds, no synchronize added. A mean over the window's loops."""
from slam_bench import loop_trace, program_trace

UNIT = "s"
LAYER = "Loop closing"
MOVES = "server_gba_s"
COUNTERS = loop_trace.counters("seconds.loop_detect")


def read(trace: dict):
    return program_trace.mean(trace, ("loop_detect",), lambda v: v)
