"""Hand-written Hopper kernels for the compute hot spots.

csrc/<name>.cu -- CUDA C++ for sm_90a, one plain C entry point per kernel
<name>.py      -- the kernel's wrapper (checks, allocation, launch count)
build.py       -- nvcc build into build/kernels/, loaded with ctypes
ops.py         -- public entry points: kernel on the card, plain on the CPU
ref.py         -- plain PyTorch versions (CPU path and parity targets)
"""
from repro_torch.kernels import ops, ref  # noqa: F401
