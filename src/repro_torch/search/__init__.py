"""Mapper autotuner: cost-model-driven search over mapper IR programs.

``repro_torch.search.space`` enumerates candidate mapper programs (grid
factorizations x distribution choices x transform orderings, as mapping
IR); ``repro_torch.search.tuner`` scores them with the unified
:class:`~repro_torch.core.commvolume.CostModel` objectives, prunes with a
beam, evaluates survivors through the vectorized ``assignment_grid``
batch path, and reports the winning Mapple program;
``repro_torch.search.pipeline`` streams the tuner's pricing phase, and
``repro_torch.search.remap`` warm-starts a tuned plan onto the
processors that survive a failure.

The counterpart of ``repro.search``.
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
from repro_torch.search.remap import (
    RemapResult,
    degraded_from_failures,
    remap_plan,
    submachine_options,
)
from repro_torch.search import pipeline

__all__ = [
    "BLOCK_CYCLIC",
    "CYCLIC_BLOCK",
    "Candidate",
    "CandidateProgram",
    "RemapResult",
    "SearchSpace",
    "ScoredCandidate",
    "TuningReport",
    "build_program",
    "cross_node_fraction",
    "degraded_from_failures",
    "node_split",
    "pipeline",
    "remap_plan",
    "render_source",
    "report_lines",
    "submachine_options",
    "tune_app",
    "tune_registry",
]
