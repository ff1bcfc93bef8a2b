"""The port's runtime resilience and mesh planner against the JAX package's.

Mirrors ``tests/test_resilience.py`` on ``repro_torch.runtime``
(FailureInjector fire-once semantics, Supervisor restart policy corners,
StragglerMonitor degenerate inputs, fault-aware restore through
``remap_fn``), running each scenario through both packages where a
result can be compared. Then holds ``repro_torch.core.autosharder``'s
``plan_mesh``, ``mesh_search_space`` and ``plan_report``, and
``elastic_plan``, to ``repro``'s for dense and MoE workloads and several
chip and survivor counts. All host code: nothing here needs a card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.core import autosharder as j_autosharder
from repro.runtime import resilience as j_resilience
from repro.search.tuner import feasible_procs as j_feasible_procs
from repro_torch.core import autosharder
from repro_torch.runtime import (
    FailureInjector,
    SimulatedFailure,
    StragglerMonitor,
    Supervisor,
    elastic_plan,
)
from repro_torch.search.tuner import feasible_procs


class FakeCheckpoints:
    """Dict-backed stand-in for CheckpointManager (state is any object)."""

    def __init__(self):
        self.saved: dict[int, object] = {}

    def save(self, step, state, extra=None):
        self.saved[step] = state

    def latest_step(self):
        return max(self.saved) if self.saved else None

    def restore(self, step):
        return step, self.saved[step], {}


def counting_step(log):
    def step_fn(step, state):
        log.append(step)
        return state + 1, {"loss": float(state)}
    return step_fn


def _both(run):
    """``run(module)`` through the port's resilience module and repro's;
    the two must agree. Returns the port's result."""
    mine, theirs = run(_PORT), run(j_resilience)
    assert mine == theirs
    return mine


class _PORT:
    FailureInjector = FailureInjector
    SimulatedFailure = SimulatedFailure
    StragglerMonitor = StragglerMonitor
    Supervisor = Supervisor


# ------------------------------------------------------------------ injector
def test_injector_fires_each_step_at_most_once():
    inj = FailureInjector(fail_at_steps=(3, 5))
    with pytest.raises(SimulatedFailure):
        inj.check(3)
    inj.check(3)                       # replayed after restore: no re-raise
    with pytest.raises(SimulatedFailure):
        inj.check(5)
    inj.check(5)
    assert inj.fired == 2


def test_injector_max_failures_caps_distinct_steps():
    inj = FailureInjector(fail_at_steps=(1, 2, 3), max_failures=2)
    for step in (1, 2):
        with pytest.raises(SimulatedFailure):
            inj.check(step)
    inj.check(3)                       # budget spent
    assert inj.fired == 2


def test_restart_from_no_checkpoint_does_not_loop():
    """A failure before the first checkpoint restarts from the initial
    state, replays the failing step, and must NOT re-fire — one restart,
    then clean completion."""
    def run(mod):
        sup = mod.Supervisor(FakeCheckpoints(), max_restarts=3)
        log = []
        state, history = sup.run(
            state=0, start_step=0, n_steps=6, step_fn=counting_step(log),
            save_every=100,                # never checkpoints
            injector=mod.FailureInjector(fail_at_steps=(2,)),
        )
        return sup.restarts, state, history, log

    restarts, _, history, log = _both(run)
    assert restarts == 1
    events = [h for h in history if "event" in h]
    assert len(events) == 1 and events[0]["event"].startswith("restart")
    # steps 0..5 all completed; 0 and 1 replayed once after the restart
    assert log == [0, 1, 0, 1, 2, 3, 4, 5]


def test_supervisor_exceeding_max_restarts_reraises():
    def run(mod):
        sup = mod.Supervisor(FakeCheckpoints(), max_restarts=2)
        log = []
        with pytest.raises(mod.SimulatedFailure):
            sup.run(
                state=0, start_step=0, n_steps=8, step_fn=counting_step(log),
                save_every=1,
                injector=mod.FailureInjector(fail_at_steps=(1, 2, 3)),
            )
        return sup.restarts, log

    restarts, _ = _both(run)
    assert restarts == 3               # third failure exceeded the budget


def test_supervisor_restores_latest_checkpoint():
    def run(mod):
        sup = mod.Supervisor(FakeCheckpoints(), max_restarts=3)
        return sup.run(
            state=0, start_step=0, n_steps=10, step_fn=counting_step([]),
            save_every=4,
            injector=mod.FailureInjector(fail_at_steps=(6,)),
        )

    state, history = _both(run)
    assert state == 10
    restored = [h for h in history if "event" in h]
    assert len(restored) == 1 and restored[0]["event"].startswith("restored")
    assert restored[0]["step"] == 4    # rewound to the step-4 checkpoint


def test_supervisor_remap_fn_swaps_step_function():
    """Fault-aware restore: remap_fn's plan replaces the step function and
    is recorded in the history (minus the callable)."""
    def run(mod):
        sup = mod.Supervisor(FakeCheckpoints(), max_restarts=3)
        before, after = [], []

        def remap_fn(exc):
            assert isinstance(exc, mod.SimulatedFailure)
            return {"step_fn": counting_step(after), "mesh": {"data": 6},
                    "usable_chips": 6}

        state, history = sup.run(
            state=0, start_step=0, n_steps=6, step_fn=counting_step(before),
            save_every=2,
            injector=mod.FailureInjector(fail_at_steps=(3,)),
            remap_fn=remap_fn,
        )
        return state, history, before, after

    state, history, before, after = _both(run)
    assert state == 6
    remaps = [h for h in history if h.get("event") == "remapped"]
    assert len(remaps) == 1
    assert remaps[0]["plan"] == {"mesh": {"data": 6}, "usable_chips": 6}
    assert "step_fn" not in remaps[0]["plan"]
    assert before == [0, 1, 2] and after == [2, 3, 4, 5]


def test_supervisor_remap_fn_none_keeps_plan():
    def run(mod):
        sup = mod.Supervisor(FakeCheckpoints(), max_restarts=3)
        return sup.run(
            state=0, start_step=0, n_steps=4, step_fn=counting_step([]),
            save_every=2,
            injector=mod.FailureInjector(fail_at_steps=(2,)),
            remap_fn=lambda exc: None,
        )

    state, history = _both(run)
    assert state == 4
    assert not [h for h in history if h.get("event") == "remapped"]


# ----------------------------------------------------------------- straggler
def _observe(n, times, rounds):
    def run(mod):
        mon = mod.StragglerMonitor(n_replicas=n)
        for _ in range(rounds):
            report = mon.observe(np.asarray(times, dtype=np.float64))
        return report
    return _both(run)


def test_straggler_monitor_single_replica_emits_no_plan():
    report = _observe(1, [1.0], 20)
    assert report["stragglers"] == []
    assert report["plan"] is None
    assert report["max_over_median"] == pytest.approx(1.0)


def test_straggler_monitor_all_equal_emits_no_plan():
    report = _observe(8, np.full(8, 2.5), 20)
    assert report["stragglers"] == []
    assert report["plan"] is None


def test_straggler_monitor_zero_times_no_div_by_zero():
    report = _observe(4, np.zeros(4), 1)
    assert report["plan"] is None
    assert np.isfinite(report["max_over_median"])


def test_straggler_monitor_flags_a_slow_replica_as_repro_does():
    times = np.ones(8)
    times[5] = 3.0
    report = _observe(8, times, 3)
    assert report["stragglers"] == [5]
    assert report["plan"]["action"] == "rebalance"


# ------------------------------------------------------------ mesh planning
WORKLOADS = {
    # tests/test_system.py's 7.6B dense decoder (28 heads over 4 KV heads).
    "dense-7b": dict(global_batch=256, seq_len=4096, d_model=3584, n_layers=28,
                     n_heads=28, n_kv_heads=4, param_count=7.6e9),
    # tests/test_training.py's 2B decoder, and its 240-sample batch.
    "dense-2b": dict(global_batch=256, seq_len=4096, d_model=2048, n_layers=24,
                     n_heads=32, n_kv_heads=8, param_count=2e9),
    "dense-2b-b240": dict(global_batch=240, seq_len=4096, d_model=2048,
                          n_layers=24, n_heads=32, n_kv_heads=8,
                          param_count=2e9),
    # A routed-expert model: 64 experts, top-6, every layer MoE.
    "moe-64e": dict(global_batch=64, seq_len=2048, d_model=2048, n_layers=16,
                    n_heads=16, n_kv_heads=16, param_count=1.5e10, n_experts=64,
                    n_moe_layers=16, topk=6, ffn_mult_bytes=2e10),
}


def _workloads(name):
    return (autosharder.LMWorkload(**WORKLOADS[name]),
            j_autosharder.LMWorkload(**WORKLOADS[name]))


@pytest.mark.parametrize("name", sorted(WORKLOADS))
@pytest.mark.parametrize("chips", [1, 8, 16, 48, 256, 512])
def test_plan_mesh_matches_repro(name, chips):
    mine_wl, their_wl = _workloads(name)
    try:
        theirs = j_autosharder.plan_mesh(chips, their_wl)
    except ValueError as exc:
        with pytest.raises(ValueError, match="no feasible"):
            autosharder.plan_mesh(chips, mine_wl)
        assert "no feasible" in str(exc)
        return
    mine = autosharder.plan_mesh(chips, mine_wl)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.dp * mine.tp == chips
    assert mine_wl.global_batch % mine.dp == 0
    assert mine.tp == 1 or mine_wl.n_heads % mine.tp == 0
    assert autosharder.plan_report(chips, mine_wl) == \
        j_autosharder.plan_report(chips, their_wl)


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_mesh_search_space_feasibility_matches_repro(name):
    mine_wl, their_wl = _workloads(name)
    mine = autosharder.mesh_search_space(mine_wl, max_tp=16)
    theirs = j_autosharder.mesh_search_space(their_wl, max_tp=16)
    counts = range(1, 300)
    assert [feasible_procs(mine, n) for n in counts] == \
        [j_feasible_procs(theirs, n) for n in counts]
    assert [mine.grids(n) for n in (12, 64, 240)] == \
        [theirs.grids(n) for n in (12, 64, 240)]


@pytest.mark.parametrize("name,survivors", [
    ("dense-2b", 509), ("dense-2b", 255), ("dense-2b-b240", 12),
    ("dense-2b-b240", 7), ("dense-7b", 100), ("moe-64e", 61), ("moe-64e", 3),
])
def test_elastic_plan_matches_repro(name, survivors):
    mine_wl, their_wl = _workloads(name)
    mine = elastic_plan(survivors, mine_wl)
    assert mine == j_resilience.elastic_plan(survivors, their_wl)
    assert mine["usable_chips"] + mine["idle_chips"] == survivors
    assert mine["mesh"]["data"] * mine["mesh"]["model"] == mine["usable_chips"]
    if (name, survivors) == ("dense-2b", 509):
        assert mine["usable_chips"] == 256     # 509 is prime: nearest feasible
    if (name, survivors) == ("dense-2b-b240", 12):
        assert mine["usable_chips"] == 12 and mine["idle_chips"] == 0


def test_mesh_cost_model_refuses_infeasible_grids():
    wl, _ = _workloads("dense-7b")
    model = autosharder.MeshCostModel(model=wl.comm_model(), wl=wl, max_tp=8)
    for grid, why in (((1, 16), "max_tp"), ((3, 1), "does not divide batch"),
                      ((32, 8), "heads"), ((2, 2, 2), "expected")):
        with pytest.raises(ValueError, match=why):
            model.cost(grid)
