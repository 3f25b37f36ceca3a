"""Motion Check's seconds a GBA (``motion_check.check_after_gba`` and
``apply_verdict`` for every client), spans with a device synchronize on
both sides."""

UNIT = "s"
LAYER = "Motion Check"
MOVES = "server_gba_s"
SPANS = (("motioncheck_ccm_slam_tpu_torch.models.motion_check", "check_after_gba", "mc"),
         ("motioncheck_ccm_slam_tpu_torch.models.motion_check", "apply_verdict", "mc"))


def read(trace: dict):
    vals = [u["spans"].get("mc", 0.0) for u in trace["units"]]
    return sum(vals) / len(vals) if vals else None
