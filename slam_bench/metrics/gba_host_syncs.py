"""The points a GBA makes the host wait on the device (reads to the host,
uploads from pageable memory, boolean-mask indexing), counted by the port
at each site (``utils/trace``'s ``host_syncs``), a mean over the window's
GBAs."""
from slam_bench import program_trace

UNIT = "syncs"
LAYER = "GBA driver"
MOVES = "server_gba_s"
COUNTERS = program_trace.counters("counts.host_syncs")


def read(trace: dict):
    return program_trace.mean(trace, ("host_syncs",), lambda n: n)
