"""Mapple on PyTorch and CUDA: the port of ``repro`` to one NVIDIA H100.

The Mapple front end (DSL, processor spaces, mappers, decompose, volume
models) is carried over unchanged; the SPMD programs of the nine paper
apps run on a mesh of virtual ranks on one device
(``repro_torch.core.spmd``), their local block products and stencil
sweeps through hand-written CUDA kernels (``repro_torch.kernels``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
