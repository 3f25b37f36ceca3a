"""The host's seconds issuing PCG sweeps in a GBA: the port's span ``pcg``
(``sharded_ba._pcg``) less its child ``pcg_exit_read`` (each sweep's exit
test read to the host), the time in which the device can run dry while
the host launches the next sweep. A mean over the window's GBAs."""
from slam_bench import program_trace

UNIT = "s"
LAYER = "Tile GBA"
MOVES = "server_gba_s"
COUNTERS = program_trace.counters("seconds.pcg", "seconds.pcg_exit_read")


def read(trace: dict):
    return program_trace.mean(trace, ("pcg", "pcg_exit_read"), lambda a, b: a - b)
