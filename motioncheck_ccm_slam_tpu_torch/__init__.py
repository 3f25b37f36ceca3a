"""motioncheck_ccm_slam_tpu_torch — the PyTorch/CUDA port for one NVIDIA H100.

A second package beside ``motioncheck_ccm_slam_tpu`` (the JAX reference),
with the same layout and module names, so each function has a counterpart
to be held against. It imports ``torch`` and never ``jax``.

- ``ops``      — Lie groups, projective geometry, image pyramid, ORB
                 extraction with the FAST kernels K1/K2 written in CUDA C++
                 for Hopper (``ops/fast_cuda.py``, ``csrc/fast.cu``),
                 descriptor matching, and the GBA kernels K3-K9
                 (``ops/schur_cuda.py``, ``csrc/schur.cu``).
- ``solvers``  — BA building blocks, motion-only pose optimization, the
                 dense-W bundle adjustment.
- ``parallel`` — the server GBA solvers on one device: tile-stream and
                 dual-layout matrix-free.
- ``models``   — the map state, frames, the tracking step, Motion Check and
                 the Motion-Check-gated GBA driver.
- ``convert``  — numpy <-> torch state conversion; ``entry`` — the main
                 paths as ``(fn, example_args)``.

Each kernel wrapper launches its kernel for a CUDA tensor and runs its
plain torch version only for a CPU tensor (tests and CPU runs).
"""

__version__ = "0.1.0"
