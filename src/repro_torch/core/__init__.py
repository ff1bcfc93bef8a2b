"""Mapple core: processor-space algebra, decompose solver, translation, SPMD."""
from repro_torch.core.tuples import Tup
from repro_torch.core.pspace import ProcSpace, Processor
from repro_torch.core.machine import (
    Machine, MachineSpec, GPU, TPU, CPU, FBMEM, ZCMEM, SYSMEM,
    V5E_POD, V5E_TWO_PODS, PAPER_CLUSTER,
)
from repro_torch.core.decompose import (
    optimal_factorization,
    greedy_factorization,
    enumerate_factorizations,
    halo_objective,
    transpose_objective,
)
from repro_torch.core.commvolume import (
    halo_surface_volume,
    aniso_halo_volume,
    transpose_volume,
    MatmulProblem,
)
from repro_torch.core.mapper import (
    Mapper,
    block_mapper,
    cyclic_mapper,
    block_cyclic_mapper,
    linear_cyclic_mapper,
    hierarchical_block_mapper,
    linearize_cyclic_mapper,
    special_linearize3d_mapper,
    conditional_linearize3d_mapper,
)
from repro_torch.core.translate import (
    MappingPlan, LayoutSpec, Sharding, mesh_from_mapper, to_spmd,
)
from repro_torch.core.spmd import Mesh, P, shard_map, placement
from repro_torch.core import dsl, spmd

__all__ = [
    "Tup", "ProcSpace", "Processor", "Machine", "MachineSpec",
    "GPU", "TPU", "CPU", "FBMEM", "ZCMEM", "SYSMEM",
    "V5E_POD", "V5E_TWO_PODS", "PAPER_CLUSTER",
    "optimal_factorization", "greedy_factorization",
    "enumerate_factorizations", "halo_objective", "transpose_objective",
    "halo_surface_volume", "aniso_halo_volume", "transpose_volume",
    "MatmulProblem",
    "Mapper", "block_mapper", "cyclic_mapper", "block_cyclic_mapper",
    "linear_cyclic_mapper", "hierarchical_block_mapper",
    "linearize_cyclic_mapper", "special_linearize3d_mapper",
    "conditional_linearize3d_mapper",
    "MappingPlan", "LayoutSpec", "Sharding", "mesh_from_mapper", "to_spmd",
    "Mesh", "P", "shard_map", "placement", "dsl", "spmd",
]
