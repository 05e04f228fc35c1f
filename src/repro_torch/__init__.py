"""repro_torch: the PyTorch/CUDA port of the multicast-crossbar serving stack.

A second package beside the JAX reference (``repro``): the same module
names, plain PyTorch around hand-written CUDA kernels for Hopper
(``csrc/``).  It imports neither JAX nor the reference package.
"""
