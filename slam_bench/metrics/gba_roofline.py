"""K3-K7 (``ops/schur_cuda``) against their roofline over the profiled GBA:
the sum of each launch's bound (``roofline.schur_bound_s``, from the GBA's
tile plan) over the device seconds of the five kernels and their camera
sum pass."""

UNIT = "%"
LAYER = "Kernels"
MOVES = "server_gba_s"


def read(trace: dict):
    r = trace.get("roofline")
    if not r or r["kernel_s"] <= 0 or r["bound_s"] <= 0:
        return None
    return 100.0 * r["bound_s"] / r["kernel_s"]
