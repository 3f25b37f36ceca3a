"""K1 and K2 (``ops/fast_cuda``) against their roofline over the profiled
frames: the sum of each launch's bound (``roofline.fast_bound_s``, from the
level shapes and the pixels that score) over the device seconds of
``masked_corner_score_kernel`` and ``blur_and_moments_kernel``."""

UNIT = "%"
LAYER = "Kernels"
MOVES = "agent_frames_per_s"


def read(trace: dict):
    r = trace.get("roofline")
    if not r or r["kernel_s"] <= 0 or r["bound_s"] <= 0:
        return None
    return 100.0 * r["bound_s"] / r["kernel_s"]
