"""The benchmark of ``motioncheck_ccm_slam_tpu_torch``; see README.md."""
