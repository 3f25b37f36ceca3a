"""Torch on one thread for the whole test process; every port test module
(``test_torch_*``) imports this module, so collecting any of them sets the
pin before a fixture or test runs.

Torch's intra-op threads wait in spinning OpenMP barriers: with the suite's
parallel workers sharing the cores, the port's thousands of small ops ran
>10x slower on 8 threads than on 1. One thread also keeps the port's float32
sums independent of the core count.
"""
import torch

torch.set_num_threads(1)
