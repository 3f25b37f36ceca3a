"""The host-built tile plan's seconds a GBA (``sharded_ba.build_tile_plan``,
built anew for each GBA's observations), a span with a device synchronize
on both sides."""

UNIT = "s"
LAYER = "GBA driver"
MOVES = "server_gba_s"
SPANS = (("motioncheck_ccm_slam_tpu_torch.parallel.sharded_ba", "build_tile_plan", "gba.plan"),)


def read(trace: dict):
    vals = [u["spans"].get("gba.plan", 0.0) for u in trace["units"]]
    return sum(vals) / len(vals) if vals else None
