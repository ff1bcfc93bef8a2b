"""Unified registry + end-to-end pipeline for the nine paper applications.

    from repro_torch.apps import get, iter_apps, names

    app = get("summa")
    plan = app.spmd_plan(procs=64)         # parse -> map -> translate
    volume = app.comm_volume(64)           # closed-form comm model

CLI: ``python -m repro_torch.apps.run --app summa --procs 64`` (or ``--all``).
"""
from repro_torch.apps.registry import (  # noqa: F401
    MATMUL,
    SCIENCE,
    Application,
    count_python_loc,
    get,
    iter_apps,
    names,
    register,
)
from repro_torch.apps import definitions  # noqa: F401  (registers the nine apps)
from repro_torch.apps.definitions import PAPER_APPS  # noqa: F401
