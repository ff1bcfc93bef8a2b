"""Mapper autotuner: cost-model-driven search over mapper IR programs.

``repro_torch.search.space`` enumerates candidate mapper programs (grid
factorizations x distribution choices x transform orderings, as mapping
IR); ``repro_torch.search.tuner`` scores them with the unified
:class:`~repro_torch.core.commvolume.CostModel` objectives, prunes with a
beam, evaluates survivors through the vectorized ``assignment_grid``
batch path, and reports the winning Mapple program;
``repro_torch.search.pipeline`` streams the tuner's pricing phase.

The counterpart of ``repro.search``, without the fault remapper
(``repro.search.remap``).
"""
from repro_torch.search.space import (
    BLOCK_CYCLIC,
    CYCLIC_BLOCK,
    Candidate,
    CandidateProgram,
    SearchSpace,
    build_program,
    node_split,
    render_source,
)
from repro_torch.search.tuner import (
    ScoredCandidate,
    TuningReport,
    cross_node_fraction,
    report_lines,
    tune_app,
    tune_registry,
)
from repro_torch.search import pipeline

__all__ = [
    "BLOCK_CYCLIC",
    "CYCLIC_BLOCK",
    "Candidate",
    "CandidateProgram",
    "SearchSpace",
    "ScoredCandidate",
    "TuningReport",
    "build_program",
    "cross_node_fraction",
    "node_split",
    "pipeline",
    "render_source",
    "report_lines",
    "tune_app",
    "tune_registry",
]
