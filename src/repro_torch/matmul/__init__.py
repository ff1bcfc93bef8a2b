"""Six distributed matmul algorithms, mapped by Mapple mappers (paper Sec. 6)."""
from repro_torch.core.mapper import Mapper
from repro_torch.core.pspace import ProcSpace
from repro_torch.core.tuples import Tup

from repro_torch.matmul import cannon, cosma, johnson, pumma, solomonik, summa  # noqa: F401
from repro_torch.matmul.common import MatmulGrid, build_grid, make_inputs  # noqa: F401

ALGORITHMS = {
    "cannon": cannon,
    "summa": summa,
    "pumma": pumma,
    "johnson": johnson,
    "solomonik": solomonik,
    "cosma": cosma,
}


def runtime_heuristic_mapper(machine: ProcSpace) -> Mapper:
    """The Fig. 13 strawman: the runtime round-robins iteration points over
    the GPUs of a node instead of honoring the algorithm's distribution
    (modeling 'assign to the least-loaded GPU')."""
    nodes, gpus = machine.shape[0], machine.shape[-1]

    def fn(ipoint: Tup, ispace: Tup):
        linear = ipoint.linearize(ispace)
        return machine[(linear // gpus % nodes, linear % gpus)]

    return Mapper("runtime_heuristic", fn)
