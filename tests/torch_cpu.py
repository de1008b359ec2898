"""One intra-op thread for torch on the CPU, for the port's tests.

The port's tests run its plain versions eagerly on small tensors (a few
thousand values per operation), several test processes side by side.  With
torch's default of one OpenMP thread per core, an element-wise operation on
4,096 float64 values (``torch.exp``) took 6.5 ms instead of 6.5 us on the
CPU the tests run on, whenever it crossed into the parallel path: the MOST
solve of a 256-column land model ran 1.1 s with 8 threads against 0.19 s
with one.  Every ``tests/test_torch_*.py`` module imports this one; results
are those of torch's single-threaded kernels.
"""

import torch

torch.set_num_threads(1)
