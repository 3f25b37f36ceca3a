"""Motion Check's Python passes a GBA: the port's span ``mc_passes`` (the
forward and reverse passes and the run count of
``motion_check.run_motion_check``, for every client, after its inputs are
on the host). A mean over the window's GBAs."""
from slam_bench import program_trace

UNIT = "s"
LAYER = "Motion Check"
MOVES = "server_gba_s"
COUNTERS = program_trace.counters("seconds.mc_passes")


def read(trace: dict):
    return program_trace.mean(trace, ("mc_passes",), lambda s: s)
