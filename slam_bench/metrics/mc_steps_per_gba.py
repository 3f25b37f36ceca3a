"""Motion Check's step tests a GBA: the port's counter ``mc_steps``, one
``motion_check.motion_violates`` call, over both passes of every client it
checked. A mean over the window's GBAs."""
from slam_bench import program_trace

UNIT = "steps"
LAYER = "Motion Check"
MOVES = "server_gba_s"
COUNTERS = program_trace.counters("counts.mc_steps")


def read(trace: dict):
    return program_trace.mean(trace, ("mc_steps",), lambda n: n)
