"""The port's mapper autotuner against the JAX package's, on the CPU.

The time-domain tune on the torch engine (``batched-torch``, CPU, the
``segment_rowmax`` kernel's plain version) must pick ``repro``'s winners
on the NumPy engine (``batched``) at 64 processors for all nine apps, with
the same leaderboard order and placed seconds within 1e-6 relative (the
pricer's parity gate). The volume tune is host code in both packages and
must print the same report. The runner's ``--tune --time --backend torch``
mode runs with ``--device cpu`` and refuses to run without a card
otherwise.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro import apps as japps
from repro.search.tuner import report_lines as j_report_lines
from repro.search.tuner import tune_app as j_tune_app
from repro.sim.cost import time_tuned_app as j_time_tuned_app
from repro_torch import apps as tapps
from repro_torch.search.tuner import report_lines as t_report_lines
from repro_torch.search.tuner import tune_app as t_tune_app
from repro_torch.sim.cost import time_tuned_app as t_time_tuned_app

SRC = str(Path(__file__).resolve().parent.parent / "src")
PROCS = 64
PLACED_RTOL = 1e-6
APPS = list(tapps.PAPER_APPS)


def _untimed(lines):
    """Report lines without the tune's wall time."""
    return [re.sub(r"\(\d+\.\d ms\)", "(- ms)", ln) for ln in lines]


@pytest.mark.parametrize("name", APPS)
def test_time_tune_on_torch_engine_matches_repro(name):
    theirs = j_tune_app(j_time_tuned_app(japps.get(name)), PROCS)
    mine = t_tune_app(t_time_tuned_app(tapps.get(name), engine="batched-torch",
                                       device="cpu"), PROCS)
    assert mine.best.candidate.describe() == theirs.best.candidate.describe()
    assert mine.best_ir == theirs.best_ir and mine.verified
    # Same leaderboard order, up to candidates whose placed seconds tie in
    # NumPy and differ by round-off on the torch engine: the placed
    # seconds rank by rank agree within the gate, and each candidate's own
    # placed seconds too.
    assert sorted(s.candidate.describe() for s in mine.leaderboard) == \
        sorted(s.candidate.describe() for s in theirs.leaderboard)
    by_name = {s.candidate.describe(): s.placed_cost for s in theirs.leaderboard}
    for rank, (a, b) in enumerate(zip(mine.leaderboard, theirs.leaderboard)):
        if a.candidate.describe() != b.candidate.describe():
            assert a.placed_cost == pytest.approx(b.placed_cost,
                                                  rel=PLACED_RTOL), rank
        want = by_name[a.candidate.describe()]
        assert (a.placed_cost is None) == (want is None)
        if want is not None:
            assert a.placed_cost == pytest.approx(want, rel=PLACED_RTOL)


@pytest.mark.parametrize("name", APPS)
def test_volume_tune_report_is_identical(name):
    theirs = j_tune_app(japps.get(name), PROCS)
    mine = t_tune_app(tapps.get(name), PROCS)
    assert _untimed(t_report_lines(mine)) == _untimed(j_report_lines(theirs))


def test_streamed_and_barrier_tunes_agree():
    """Phase 3 streamed (the default for the torch engine) and as a
    barrier give the same report."""
    app = t_time_tuned_app(tapps.get("summa"), engine="batched-torch",
                           device="cpu")
    streamed = t_tune_app(app, PROCS)
    barrier = t_tune_app(app, PROCS, pipeline=False)
    assert _untimed(t_report_lines(streamed)) == _untimed(t_report_lines(barrier))


def _cli(*args, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.apps.run", *args],
        capture_output=True, text=True, timeout=300, env=env,
    )


def test_cli_time_tune_on_cpu_and_refusal_without_a_card():
    proc = _cli("--tune", "--time", "--backend", "torch", "--device", "cpu",
                "--all", "--procs", str(PROCS))
    assert proc.returncode == 0, proc.stderr
    assert "torch backend: platform=cpu" in proc.stdout
    assert "tuned 9 of 9 app(s)" in proc.stdout
    refused = _cli("--tune", "--time", "--backend", "torch", "--all",
                   "--procs", str(PROCS), env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert refused.returncode == 2
    assert "GPU" in refused.stderr and "--device cpu" in refused.stderr
    assert "tuned" not in refused.stdout


def test_cli_simulate_and_volume_tune_print_what_repro_prints(tmp_path):
    """``--simulate`` and the volume ``--tune --json`` are host code: the
    port prints the JAX package's timelines and writes its results."""
    env = {"JAX_PLATFORMS": "cpu"}
    args = ("--simulate", "--all", "--procs", "16")
    mine = _cli(*args)
    theirs = subprocess.run(
        [sys.executable, "-m", "repro.apps.run", *args], capture_output=True,
        text=True, timeout=300,
        env={**os.environ, **env,
             "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", "")})
    assert mine.returncode == 0 == theirs.returncode, mine.stderr + theirs.stderr
    assert mine.stdout == theirs.stdout
    out = tmp_path / "tune.json"
    proc = _cli("--tune", "--app", "cannon", "--procs", "16", "--json", str(out))
    assert proc.returncode == 0, proc.stderr
    rows = json.loads(out.read_text())["apps"]
    assert [r["app"] for r in rows] == ["cannon"] and rows[0]["verified"]
