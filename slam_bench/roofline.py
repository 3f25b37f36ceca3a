"""The least time the card could take for each of the port's kernels.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the full
700 W): 3.35 TB/s of HBM and 67 TFLOP/s in float32 outside the tensor
cores. A launch's bound is the larger of its bytes over the first and its
float32 operations over the second; each input is counted as read once and
each output as written once, whatever the kernel reads again. The counts
are those the repository's card gate (``chip_smoke.py``) uses, copied here
so that they stay the same whatever implements the kernel:

- K1 (``masked_corner_score_levels``): 4 B in and 4 B out a pixel; 16 ring
  taps x 9 operations an output pixel, plus 16 x 3 for each of the two
  sums of the chosen threshold on each pixel that scores;
- K2 (``blur_and_moments_levels``): 4 B in and 3 x 4 B out a pixel; the
  7+7-tap blur and 2r separable moment channels of 31+31 taps (r = 9);
- K3-K7 (``schur_cuda``): per slot of the tile plan and per camera and
  padded landmark as counted from ``csrc/schur.cu`` (K3 ~350 operations on
  a valid slot and ~150 elsewhere; K4 72 a slot and 15 a landmark; K5 216;
  K6 and K7 36); every valid observation is counted as a slot with a
  non-zero weight and W row.
"""
from __future__ import annotations

PEAK_BYTES_PER_S, PEAK_F32_PER_S = 3.35e12, 67e12
K2_RANK = 9
F32 = 4

# the port's launch counters of the counted kernels (``ops/fast_cuda``,
# ``ops/schur_cuda``)
FAST_KERNELS = ("masked_corner_score_levels", "blur_and_moments_levels")
SCHUR_KERNELS = ("d1_assemble", "s_apply", "d2_precond", "apply_a_raw", "apply_b_raw")
# kernel name as the profiler reports it -> the counted kernels
FAST_SYMBOLS = ("masked_corner_score_kernel", "blur_and_moments_kernel")
# camera_sum_kernel is the finishing pass of K3, K4, K5 and K7 (their time)
SCHUR_SYMBOLS = ("d1_assemble_kernel", "s_apply_kernel", "d2_precond_kernel",
                 "apply_a_kernel", "apply_b_kernel", "camera_sum_kernel")


def bound_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_PER_S)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def fast_bound_s(level_shapes, n_scoring: int) -> dict:
    """K1's and K2's bound seconds for one frame's pyramid (one launch each)."""
    px_in = sum(h * w for h, w in level_shapes)
    px_out = sum(_round_up(h, 64) * _round_up(w, 32) for h, w in level_shapes)
    return {
        "masked_corner_score_levels": bound_s(F32 * (px_in + px_out),
                                              16 * 9 * px_out + 2 * 16 * 3 * n_scoring),
        "blur_and_moments_levels": bound_s(F32 * (px_in + 3 * px_out),
                                           (28 + 2 * K2_RANK * 62 * 2) * px_out),
    }


def schur_bound_s(kernel: str, ntl: int, TP: int, L_pad: int, C: int, n_valid: int) -> float:
    """One launch's bound seconds of a K3-K7 wrapper on a tile plan."""
    OP = ntl * TP
    slot_in = OP * (8 + 72)
    f = F32
    work = {
        "d1_assemble": (n_valid * 28 + (OP - n_valid) * 4 + OP * (72 + 12)
                        + C * (12 + 27) * f + L_pad * (3 + 12) * f + 16,
                        n_valid * 350 + (OP - n_valid) * 150),
        "s_apply": (slot_in + C * 12 * f + L_pad * 9 * f, n_valid * 72 + L_pad * 15),
        "d2_precond": (slot_in + C * 21 * f + L_pad * 9 * f, n_valid * 216),
        "apply_a_raw": (slot_in + C * 6 * f + L_pad * 12 * f, n_valid * 36 + L_pad * 15),
        "apply_b_raw": (slot_in + C * 6 * f + L_pad * 3 * f, n_valid * 36),
    }
    return bound_s(*work[kernel])
