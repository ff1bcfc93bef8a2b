"""``tools/perf_iterations.py`` against ``benchmarks/perf_iterations.py``:
the same cells and knob steps, one reduced step of each cell counted on
the production mesh (meta device) with the reference's row keys, and
``run()`` on a recorded file."""
import dataclasses
import importlib.util
import json
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
# The keys of a row that benchmarks/perf_iterations.py::main writes.
ROW_KEYS = {"cell", "step", "status", "compute_s", "memory_s", "collective_s",
            "bottleneck", "useful", "temp_gib", "collective_bytes", "error"}


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tool():
    return _load(REPO / "tools" / "perf_iterations.py", "perf_iterations_torch")


@pytest.fixture(scope="module")
def ref():
    return _load(REPO / "benchmarks" / "perf_iterations.py", "perf_iterations_ref")


def test_same_cells_and_knob_steps_as_the_reference(tool, ref):
    mine, want = tool.experiments(), ref.experiments()
    assert [e["cell"] for e in mine] == [e["cell"] for e in want]
    for a, b in zip(mine, want):
        assert [n for n, _ in a["steps"]] == [n for n, _ in b["steps"]]
        for (_, ka), (_, kb) in zip(a["steps"], b["steps"]):
            assert dataclasses.asdict(ka) == dataclasses.asdict(kb)


@pytest.fixture(scope="module")
def rows(tool):
    return [tool.step_row(e["cell"], *e["steps"][0], layers=2) for e in tool.experiments()]


@pytest.mark.parametrize("i", range(3))
def test_reduced_first_step_of_each_cell(rows, i):
    row = rows[i]
    assert set(row) == ROW_KEYS
    assert row["status"] == "ok", row["error"]
    assert row["compute_s"] > 0 and row["collective_s"] > 0 and row["memory_s"] > 0
    assert row["bottleneck"] in ("compute", "memory", "collective")
    assert row["temp_gib"] is None                  # meta: no peak measured


def test_run_summarizes_a_recorded_file(tool, rows, tmp_path):
    later = [dict(r, step="later", compute_s=r["compute_s"] / 2, memory_s=r["memory_s"] / 2,
                  collective_s=r["collective_s"] / 2) for r in rows]
    path = tmp_path / "perf.json"
    path.write_text(json.dumps([rows[0], later[0], rows[1], later[1], rows[2], later[2]]))
    lines = []
    out = tool.run(report=lines.append, path=path)
    assert out["cells"] == 3 and out["rows"] == 6
    assert out["speedups"] == pytest.approx([2.0, 2.0, 2.0])
    assert any("rwkv6-3b" in line for line in lines)
    with pytest.raises(FileNotFoundError):
        tool.run(report=lines.append, path=tmp_path / "absent.json")
