"""The host's own seconds of a GBA's tile plan: the port's span
``tile_plan`` (``sharded_ba.build_tile_plan``) less its child
``tile_plan_read`` (the observation arrays' reads to the host), so the
host sort and ``build_schur_plan`` loop with the plan's uploads; no
synchronize added. A mean over the window's GBAs."""
from slam_bench import program_trace

UNIT = "s"
LAYER = "GBA driver"
MOVES = "server_gba_s"
COUNTERS = program_trace.counters("seconds.tile_plan", "seconds.tile_plan_read")


def read(trace: dict):
    return program_trace.mean(trace, ("tile_plan", "tile_plan_read"), lambda a, b: a - b)
