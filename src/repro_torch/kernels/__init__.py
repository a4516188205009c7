"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``) with their plain
torch versions and the public wrappers (counterpart of ``repro.kernels``)."""
