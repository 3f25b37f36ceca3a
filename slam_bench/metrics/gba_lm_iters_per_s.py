"""LM iterations over the tile GBA's seconds without its host plan: the
solver's span (the driver's own, around the chunks' calls of the solver it
hands to ``run_gba``) less the plan's, summed over the window's GBAs."""

UNIT = "iters/s"
LAYER = "Tile GBA"
MOVES = "server_gba_s"
SPANS = (("motioncheck_ccm_slam_tpu_torch.parallel.sharded_ba", "build_tile_plan", "gba.plan"),)


def read(trace: dict):
    units = trace["units"]
    t = sum(u["spans"].get("gba.solver", 0.0) - u["spans"].get("gba.plan", 0.0) for u in units)
    its = sum(u["iterations"] for u in units)
    return its / t if t > 0 else None
