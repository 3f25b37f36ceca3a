"""The host's seconds blocked on the PCG sweeps' device work in a GBA: the
port's span ``pcg_exit_read``, each sweep's exit test read to the host. A
mean over the window's GBAs."""
from slam_bench import program_trace

UNIT = "s"
LAYER = "Tile GBA"
MOVES = "server_gba_s"
COUNTERS = program_trace.counters("seconds.pcg_exit_read")


def read(trace: dict):
    return program_trace.mean(trace, ("pcg_exit_read",), lambda s: s)
