"""The CPU setting of the PyTorch port's tests: torch's intra-op pool at
one thread.  The suite runs in several worker processes at once on a few
cores, and a worker's OpenMP threads spin between parallel regions on the
cores its neighbours need: six concurrent copies of one serving test took
518 s each with the default pool and 10 s with one thread.  The port's
tensors here are small int32 columns, so one thread loses nothing."""

import torch

torch.set_num_threads(1)
