"""antrea_tpu_torch: the PyTorch/CUDA port of the tpuflow datapath.

A second package beside the JAX one, laid out the same way so every module
has an obvious counterpart:

  apis/, utils/ip.py, compiler/, packet.py, simulator/
               host-side numpy code, kept as this package's own copies
  ops/         the classifier with its aggregate-pruned walk (match.py),
               the FNV hashes (hashing.py) and the wrappers of the
               hand-written CUDA kernels: B1 (consumer.py), B2
               (pruned_consumer.py), B3 (onepass.py) and the cold-path
               study's S1 (consumer2.py)
  models/      the v4 pipeline step, staged or one-pass, with its phase
               masks and maintenance scans (pipeline.py), and the phase
               profiler (profile.py)
  csrc/        CUDA C++ sources for sm_90a, built on first use by _build.py
  utils/timing.py
               CUDA-event timing (device_time, device_loop_time)
  datapath/    the engine (tpuflow.py) with its planes, tenant worlds
               included, and the scalar twin engine (oracle_dp.py)
  serving/     the serving batcher in front of step_tenants
  native/      the journaled config store (ovsdb_lite.cc, built with g++
               on first use) that persist_dir's round journal uses

Every tensor on the datapath is an int32 word; u32 tables are kept as int32
tensors with identical bits.  Entry points run on the card unless the caller
passes device="cpu"; on CPU tensors the kernel wrappers run their plain
PyTorch versions.
"""

__version__ = "0.1.0"
