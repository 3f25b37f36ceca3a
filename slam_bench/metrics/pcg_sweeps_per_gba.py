"""K4 (``schur_cuda.s_apply``) launches a GBA, one a PCG sweep: the port's
own launch counter read around each GBA."""

UNIT = "sweeps"
LAYER = "Tile GBA"
MOVES = "server_gba_s"
COUNTERS = (("motioncheck_ccm_slam_tpu_torch.ops.schur_cuda", "s_apply.launches", "s_apply"),)


def read(trace: dict):
    vals = [u["counters"]["s_apply"] for u in trace["units"]]
    return sum(vals) / len(vals) if vals else None
