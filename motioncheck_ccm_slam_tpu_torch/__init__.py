"""motioncheck_ccm_slam_tpu_torch — the PyTorch/CUDA port for one NVIDIA H100.

A second package beside ``motioncheck_ccm_slam_tpu`` (the JAX reference),
with the same layout and module names, so each function has a counterpart
to be held against. It imports ``torch`` and never ``jax``.

- ``ops``      — Lie groups (SE3, Sim3), projective geometry, image
                 pyramid, ORB extraction with the FAST kernels K1/K2
                 written in CUDA C++ for Hopper (``ops/fast_cuda.py``,
                 ``csrc/fast.cu``), descriptor matching, RANSAC (two-view
                 init, PnP, Sim3), and the GBA kernels K3-K9
                 (``ops/schur_cuda.py``, ``csrc/schur.cu``).
- ``solvers``  — BA building blocks, motion-only pose optimization, the
                 dense-W bundle adjustment.
- ``parallel`` — the server GBA solvers on one device: tile-stream and
                 dual-layout matrix-free.
- ``models``   — the map state, frames, tracking (initialization,
                 relocalization), local mapping, Motion Check and the
                 Motion-Check-gated GBA driver.
- ``system``   — the agent: ``ClientSystem`` (tracking + local mapping).
- ``utils``    — the liveness watchdog, trajectory export and the ATE.
- ``convert``  — numpy <-> torch state conversion; ``entry`` — the main
                 paths as ``(fn, example_args)``.

Each kernel wrapper launches its kernel for a CUDA tensor and runs its
plain torch version only for a CPU tensor (tests and CPU runs).
"""

__version__ = "0.1.0"
