"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``) with their plain
torch versions and the public wrappers (counterpart of ``repro.kernels``).

Importing the package declares every kernel to :mod:`.build`, so its one
``LAUNCHES`` record and ``build_kernels()`` cover K1-K6, the attention
backward K5b and RWKV6's WKV recurrence forward and backward (K7, K7b);
nothing is compiled until a kernel is first launched or built.
"""

from . import bitonic, build, decode_attention, flash_attention, flash_attention_bwd, ops, wkv  # noqa: F401
