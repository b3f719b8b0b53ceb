"""antrea_tpu_torch: the PyTorch/CUDA port of the tpuflow datapath.

A second package beside the JAX one, laid out the same way so every module
has an obvious counterpart:

  apis/, utils/ip.py, compiler/, packet.py, simulator/
               host-side numpy code, kept as this package's own copies
  ops/         the classifier with its aggregate-pruned walk (match.py),
               the FNV hashes (hashing.py) and the wrappers of the
               hand-written CUDA kernels: B1 (consumer.py), B2
               (pruned_consumer.py) and B3 (onepass.py)
  models/      the synchronous, v4 pipeline step, staged or one-pass
               (pipeline.py)
  csrc/        CUDA C++ sources for sm_90a, built on first use by _build.py
  utils/timing.py
               CUDA-event timing

Every tensor on the datapath is an int32 word; u32 tables are kept as int32
tensors with identical bits.  Entry points run on the card unless the caller
passes device="cpu"; on CPU tensors the kernel wrappers run their plain
PyTorch versions.
"""

__version__ = "0.1.0"
