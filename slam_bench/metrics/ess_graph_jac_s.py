"""The essential graph's edge Jacobians: the port's span ``ess_graph_jac``
(``pose_graph._edge_jacobians``, two forward-mode ``torch.func.jvp`` an LM
iteration), inside ``ess_graph``; host seconds. A mean over the window's
loops."""
from slam_bench import loop_trace, program_trace

UNIT = "s"
LAYER = "Loop closing"
MOVES = "server_gba_s"
COUNTERS = loop_trace.counters("seconds.ess_graph_jac")


def read(trace: dict):
    return program_trace.mean(trace, ("ess_graph_jac",), lambda v: v)
