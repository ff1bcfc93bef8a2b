"""Scientific workloads (paper apps 7-9): circuit, stencil, pennant proxy."""
from repro_torch.science import circuit, pennant, stencil2d  # noqa: F401
