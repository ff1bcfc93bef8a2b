"""The port's tuning service (``repro_torch.serving.mapsvc`` + plan cache)
against the JAX package's, on the CPU.

Mirrors ``tests/test_mapsvc.py`` on ``repro_torch``, with the service
pricing on the torch engine (``batched-torch``, ``device="cpu"``: the
``segment_rowmax`` kernel's plain version). Where a test resolves a plan,
it is held to ``repro``'s service on the NumPy engine for the same
request: the same winner, placed seconds within 1e-6 relative (the
pricer's parity gate). The plan cache's on-disk format is ``repro``'s,
byte for byte. Entry points run with ``--device cpu`` and never reach a
card; without one, the torch engine is refused and the service answers
``Rejected("error")``.
"""
import json
import os
import subprocess
import sys
import threading
import zlib
from pathlib import Path

import pytest

from repro.serving.mapsvc import MappingService as JService
from repro.serving.mapsvc import TuneRequest as JRequest
from repro.serving.plan_cache import PlanCache as JPlanCache
from repro.serving.plan_cache import plan_key as j_plan_key
from repro_torch.serving.mapsvc import (
    MappingPlan,
    MappingService,
    Rejected,
    RemapRequest,
    TuneRequest,
    load_trace,
    plan_key_for,
    replay,
    value_tag,
)
from repro_torch.serving.plan_cache import _CRC, _HEAD, _MAGIC, PlanCache, plan_key
from repro_torch.sim.collectives import cache_stats, clear_caches

REPO = Path(__file__).resolve().parent.parent
SRC = str(REPO / "src")
PLACED_RTOL = 1e-6
TORCH = dict(engine="batched-torch", device="cpu")


def _svc(root, **kw):
    """A service pricing on the torch engine on the CPU."""
    return MappingService(root, **{**TORCH, **kw})


def _essence(res):
    """Provenance/timing-independent plan content for identity checks."""
    assert isinstance(res, MappingPlan), res
    return (res.app, res.procs, json.dumps(res.candidate, sort_keys=True),
            res.placed_cost, res.source,
            json.dumps(res.leaderboard, sort_keys=True))


def _assert_matches_repro(res, app, procs=None):
    """``res`` is what ``repro``'s service on the NumPy engine answers for
    the same request: winner, source and IR; the same leaderboard, in the
    same order up to candidates whose placed seconds tie in NumPy and
    differ by round-off on the torch engine; placed seconds within the
    pricer's gate, rank by rank and candidate by candidate."""
    with JService(None, workers=0) as svc:
        theirs = svc.map(JRequest(app, procs))
    assert isinstance(res, MappingPlan), res
    assert (res.app, res.procs, list(res.machine_shape)) == \
        (theirs.app, theirs.procs, list(theirs.machine_shape))
    assert res.candidate == theirs.candidate
    assert (res.source, res.ir, res.verified) == \
        (theirs.source, theirs.ir, theirs.verified)
    by_name = {r["candidate"]: r["placed_cost"] for r in theirs.leaderboard}
    assert sorted(by_name) == sorted(r["candidate"] for r in res.leaderboard)
    for mine, want in zip(res.leaderboard, theirs.leaderboard):
        if mine["candidate"] != want["candidate"]:
            assert mine["placed_cost"] == pytest.approx(want["placed_cost"],
                                                        rel=PLACED_RTOL)
        expect = by_name[mine["candidate"]]
        assert (mine["placed_cost"] is None) == (expect is None)
        if expect is not None:
            assert mine["placed_cost"] == pytest.approx(expect, rel=PLACED_RTOL)
    assert res.placed_cost == pytest.approx(theirs.placed_cost, rel=PLACED_RTOL)
    assert res.value_tag == "torch-f64" and theirs.value_tag == "numpy-f64"


# --------------------------------------------------------------- plan cache
def test_plan_cache_round_trip_and_idempotent_put(tmp_path):
    cache = PlanCache(tmp_path / "mine")
    key = plan_key("cannon", 4, "spec", "torch-f64", (6, 3, 4))
    assert key == j_plan_key("cannon", 4, "spec", "torch-f64", (6, 3, 4))
    assert cache.get(key) is None
    payload = {"app": "cannon", "procs": 4, "candidate": {"grid": [2, 2]}}
    cache.put(key, payload)
    cache.put(key, payload)           # duplicate: no second record
    assert cache.get(key) == payload
    assert cache.stats() == {"hits": 1, "misses": 1, "writes": 1,
                             "dropped": 0, "plans": 1}
    # One on-disk format: repro's cache writes the same bytes, and reads
    # the port's file.
    theirs = JPlanCache(tmp_path / "theirs")
    theirs.put(key, payload)
    assert theirs.path.read_bytes() == cache.path.read_bytes()
    assert JPlanCache(tmp_path / "mine").get(key) == payload


def test_plan_cache_memory_only_without_root():
    cache = PlanCache(None)
    key = plan_key("a", 1, "s", "torch-f64")
    cache.put(key, {"x": 1})
    assert cache.get(key) == {"x": 1}
    assert cache.path is None
    cache.clear()
    assert cache.get(key) is None     # nothing on disk to reload


def test_plan_cache_nearest_ranks_by_log_scale(tmp_path):
    cache = PlanCache(tmp_path)
    for procs in (4, 16, 64, 1024):
        cache.put(plan_key("app", procs, "s", "t"),
                  {"app": "app", "procs": procs})
    near = cache.nearest("app", 20, count=2)
    assert [p["procs"] for p in near] == [16, 64]
    excl = cache.nearest("app", 16, count=1,
                         exclude=plan_key("app", 16, "s", "t"))
    assert excl[0]["procs"] in (4, 64)


def test_plan_cache_corrupt_tail_drops_cleanly(tmp_path):
    cache = PlanCache(tmp_path)
    keys = [plan_key("app", p, "s", "t") for p in (2, 4, 8)]
    for k, p in zip(keys, (2, 4, 8)):
        cache.put(k, {"app": "app", "procs": p})
    path = cache.path
    blob = bytearray(path.read_bytes())
    blob[-2] ^= 0xFF                  # flip a CRC byte of the last record
    path.write_bytes(bytes(blob))

    fresh = PlanCache(tmp_path)
    assert fresh.get(keys[0]) is not None
    assert fresh.get(keys[1]) is not None
    assert fresh.get(keys[2]) is None            # torn tail dropped
    assert fresh.stats()["dropped"] == 1

    # The next write heals the file whole: all intact records survive.
    fresh.put(keys[2], {"app": "app", "procs": 8})
    healed = PlanCache(tmp_path)
    assert all(healed.get(k) is not None for k in keys)
    assert healed.stats()["dropped"] == 0


def test_plan_cache_truncated_record_drops(tmp_path):
    cache = PlanCache(tmp_path)
    key = plan_key("app", 2, "s", "t")
    cache.put(key, {"app": "app", "procs": 2})
    path = cache.path
    path.write_bytes(path.read_bytes()[:-3])     # torn mid-CRC
    fresh = PlanCache(tmp_path)
    assert fresh.get(key) is None
    assert fresh.stats()["dropped"] == 1


def test_plan_cache_foreign_file_treated_as_empty(tmp_path):
    root = tmp_path / "plans"
    root.mkdir()
    (root / "plans.log").write_bytes(b"not a plan store")
    cache = PlanCache(root)
    key = plan_key("app", 2, "s", "t")
    assert cache.get(key) is None
    cache.put(key, {"app": "app", "procs": 2})   # rewrites the file whole
    assert PlanCache(root).get(key) is not None


def test_plan_cache_record_framing_crc_covers_key_and_payload(tmp_path):
    cache = PlanCache(tmp_path)
    key = plan_key("app", 2, "s", "t")
    cache.put(key, {"z": 1})
    blob = cache.path.read_bytes()
    assert blob.startswith(_MAGIC)
    k, size = _HEAD.unpack_from(blob, len(_MAGIC))
    raw = blob[len(_MAGIC) + _HEAD.size:len(_MAGIC) + _HEAD.size + size]
    (crc,) = _CRC.unpack_from(blob, len(_MAGIC) + _HEAD.size + size)
    assert k == key and json.loads(raw) == {"z": 1}
    assert crc == zlib.crc32(key + raw)


def test_plan_cache_registered_with_collectives(tmp_path):
    cache = PlanCache(tmp_path)
    cache.put(plan_key("a", 1, "s", "t"), {"app": "a", "procs": 1})
    assert cache_stats()["plan_cache"]["plans"] >= 1
    clear_caches()
    assert cache.stats()["plans"] == 0
    # Disk store survives the clear and reloads on next access.
    assert cache.get(plan_key("a", 1, "s", "t")) is not None


# ------------------------------------------------------------ service basics
def test_exact_repeat_hits_plan_cache(tmp_path):
    with _svc(tmp_path, workers=0) as svc:
        first = svc.map(TuneRequest("cannon"))
        second = svc.map(TuneRequest("cannon"))
    assert first.provenance == "cold"
    assert second.provenance == "cache"
    assert _essence(first) == _essence(second)
    assert svc.stats.cache_hits == 1 and svc.stats.searches == 1
    _assert_matches_repro(first, "cannon")


def test_plan_survives_to_second_service_instance(tmp_path):
    with _svc(tmp_path, workers=0) as svc:
        cold = svc.map(TuneRequest("stencil"))
    clear_caches()
    with _svc(tmp_path, workers=0) as svc2:
        warm = svc2.map(TuneRequest("stencil"))
    assert warm.provenance == "cache"
    assert svc2.stats.searches == 0
    assert _essence(cold) == _essence(warm)


def test_second_process_gets_plan_cache_hits(tmp_path):
    snippet = f"""
import sys; sys.path.insert(0, {SRC!r})
from repro_torch.serving.mapsvc import MappingService, TuneRequest
with MappingService({str(tmp_path)!r}, workers=0, engine="batched-torch",
                    device="cpu") as svc:
    plan = svc.map(TuneRequest("cannon", procs=16))
    print(plan.provenance)
"""
    out = subprocess.run([sys.executable, "-c", snippet], check=True,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.strip() == "cold"
    with _svc(tmp_path, workers=0) as svc:
        plan = svc.map(TuneRequest("cannon", procs=16))
    assert plan.provenance == "cache"
    _assert_matches_repro(plan, "cannon", 16)


def test_plan_payload_round_trips(tmp_path):
    with _svc(tmp_path, workers=0) as svc:
        plan = svc.map(TuneRequest("summa"))
    back = MappingPlan.from_payload(plan.payload(), provenance="cache")
    assert _essence(back) == _essence(plan)
    assert back.verified and back.value_tag == "torch-f64"
    _assert_matches_repro(plan, "summa")


def test_coalescing_identical_requests_search_once(tmp_path):
    svc = _svc(tmp_path, workers=0, coalesce=8)
    tickets = [svc.submit(TuneRequest("cannon")) for _ in range(4)]
    svc.drain()
    results = [t.result(5.0) for t in tickets]
    assert all(isinstance(r, MappingPlan) for r in results)
    assert svc.stats.searches == 1
    assert svc.stats.coalesced == 3
    assert len({_essence(r) for r in results}) == 1
    svc.close()


def test_batch_prices_across_requests_in_one_pass(tmp_path):
    svc = _svc(tmp_path, workers=0, coalesce=8)
    tickets = [svc.submit(TuneRequest(name, procs)) for name, procs in
               (("cannon", None), ("stencil", None), ("summa", 16))]
    svc.drain()
    # Three distinct searches, one shared cross-request pricing sweep.
    assert svc.stats.searches == 3
    assert svc.stats.shared_pricing_passes == 1
    for ticket in tickets:
        _assert_matches_repro(ticket.result(), ticket.request.app,
                              ticket.request.procs)
    svc.close()


# ------------------------------------------------------- concurrency == serial
def test_concurrent_submitters_match_serial_plans(tmp_path):
    trace = [TuneRequest(a, p) for a, p in
             (("cannon", None), ("stencil", None), ("cannon", 16),
              ("summa", None), ("cannon", None), ("stencil", 16))]
    with _svc(tmp_path / "serial", workers=0, warm_start=False) as svc:
        serial = [svc.map(r) for r in trace]

    clear_caches()
    with _svc(tmp_path / "conc", workers=3, warm_start=False) as svc:
        tickets = [None] * len(trace)

        def submit(i):
            tickets[i] = svc.submit(trace[i])

        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(len(trace))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
        assert not any(t.is_alive() for t in threads)
        concurrent = [t.result(60.0) for t in tickets]

    assert [_essence(r) for r in serial] == [_essence(r) for r in concurrent]


def test_launch_counters_and_exports_survive_concurrent_pricing():
    """The kernels' launch counters and the torch engine's export registry
    are shared by the service's worker threads: under a tiny switch
    interval and more threads than cores, no count is lost and one
    schedule gets one export."""
    from repro_torch import apps
    from repro_torch.kernels import ops
    from repro_torch import tracing
    from repro_torch.sim import torch_backend as tb
    from repro_torch.sim.cost import time_search_space

    n_threads, per_thread = 4 * (os.cpu_count() or 1) + 1, 2000
    space = time_search_space(apps.get("summa"), **TORCH)
    eng = space.cost_model(16, dict(space.default_options)).batch((4, 4))
    clear_caches()
    before = ops.launch_counts()["segment_rowmax"]
    exports, start = [], threading.Barrier(n_threads)

    def work():
        start.wait(timeout=30.0)
        exports.append(tb._export_for(eng.schedule, eng.topology))
        for _ in range(per_thread):
            tracing.count("kernel.segment_rowmax.launches")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    try:
        assert ops.launch_counts()["segment_rowmax"] - before == n_threads * per_thread
        assert len({id(e) for e in exports}) == 1
        assert cache_stats()["torch_exports"]["misses"] == 1
    finally:
        tracing.count("kernel.segment_rowmax.launches",
                      before - ops.launch_counts()["segment_rowmax"])


# --------------------------------------------------------------- rejections
def test_queue_full_returns_typed_rejection(tmp_path):
    svc = _svc(tmp_path, workers=0, queue_limit=2)
    t1 = svc.submit(TuneRequest("cannon"))
    t2 = svc.submit(TuneRequest("stencil"))
    t3 = svc.submit(TuneRequest("summa"))
    assert t3.done
    shed = t3.result()
    assert isinstance(shed, Rejected) and shed.reason == "queue-full"
    svc.drain()
    assert isinstance(t1.result(), MappingPlan)
    assert isinstance(t2.result(), MappingPlan)
    assert svc.stats.rejected == {"queue-full": 1}
    assert svc.stats.shed == 1
    svc.close()


def test_expired_deadline_sheds_at_dispatch(tmp_path):
    svc = _svc(tmp_path, workers=0)
    ticket = svc.submit(TuneRequest("cannon", deadline_s=-1.0))
    svc.drain()
    res = ticket.result()
    assert isinstance(res, Rejected) and res.reason == "deadline"
    assert svc.stats.searches == 0
    svc.close()


def test_timeout_budget_rejects_but_still_caches(tmp_path):
    svc = _svc(tmp_path, workers=0)
    res = svc.map(TuneRequest("cannon", timeout_s=0.0))
    assert isinstance(res, Rejected) and res.reason == "timeout"
    # The plan was cached regardless: the repeat answers from cache.
    repeat = svc.map(TuneRequest("cannon"))
    assert isinstance(repeat, MappingPlan)
    assert repeat.provenance == "cache"
    svc.close()


def test_unknown_app_returns_error_rejection(tmp_path):
    svc = _svc(tmp_path, workers=0)
    res = svc.map(TuneRequest("nosuchapp"))
    assert isinstance(res, Rejected) and res.reason == "error"
    assert "nosuchapp" in res.detail
    svc.close()


def test_torch_engine_without_a_card_rejects_with_error(tmp_path, monkeypatch):
    """``device="cuda"`` (the default) without a card: the torch engine
    refuses, and the service answers ``Rejected("error")`` for tunes and
    remaps alike; nothing is priced on the CPU or on the NumPy engine,
    and nothing is cached."""
    from repro_torch.sim import torch_backend as tb

    monkeypatch.setattr(tb.torch.cuda, "is_available", lambda: False)
    with MappingService(tmp_path, engine="batched-torch", workers=1) as svc:
        tune = svc.submit(TuneRequest("stencil"))
        remap = svc.submit(RemapRequest(app="stencil", failures=[3], procs=8))
        results = [tune.result(60.0), remap.result(60.0)]
    for res in results:
        assert isinstance(res, Rejected) and res.reason == "error"
        assert "no CUDA card" in res.detail
    assert svc.stats.searches == 0 and svc.plans.stats()["plans"] == 0


def test_submit_after_close_rejects_closed(tmp_path):
    svc = _svc(tmp_path, workers=0)
    svc.close()
    res = svc.submit(TuneRequest("cannon")).result()
    assert isinstance(res, Rejected) and res.reason == "closed"


def test_priority_orders_dispatch(tmp_path):
    svc = _svc(tmp_path, workers=0, coalesce=1)
    low = svc.submit(TuneRequest("cannon", priority=5))
    high = svc.submit(TuneRequest("stencil", priority=0))
    svc.drain()
    # coalesce=1 -> one batch each; the high-priority request resolved
    # first even though it was submitted second.
    assert high.result().elapsed_s < low.result().elapsed_s or (
        svc.stats.completed == 2)
    assert isinstance(high.result(), MappingPlan)
    svc.close()


# ------------------------------------------------------------------- stats
def test_service_stats_summary_shape(tmp_path):
    with _svc(tmp_path, workers=0) as svc:
        svc.map(TuneRequest("cannon"))
        svc.map(TuneRequest("cannon"))
        svc.submit(TuneRequest("cannon", deadline_s=-1.0))
        svc.drain()
        s = svc.stats.summary()
    assert s["submitted"] == 3
    assert s["completed"] == 2
    assert s["cache_hits"] == 1 and s["cold"] == 1
    assert s["rejected"] == {"deadline": 1} and s["shed"] == 1
    assert s["requests_per_s"] > 0
    for block in (s["latency"], s["stages"]["wait"], s["stages"]["cache"],
                  s["stages"]["search"]):
        assert set(block) == {"p50_s", "p95_s", "p99_s"}
    json.dumps(s)                       # the surface must be JSON-clean


def test_warm_provenance_and_never_worse(tmp_path):
    """A near-miss scale seeded from the cache must never rank worse
    than the cold search at that scale."""
    with _svc(tmp_path, workers=0) as svc:
        svc.map(TuneRequest("pennant"))
        seeded = svc.map(TuneRequest("pennant", procs=64))
    clear_caches()
    with _svc(tmp_path / "coldroot", workers=0, warm_start=False) as svc2:
        cold = svc2.map(TuneRequest("pennant", procs=64))
    assert isinstance(seeded, MappingPlan) and isinstance(cold, MappingPlan)
    assert seeded.placed_cost <= cold.placed_cost
    if seeded.warm_seeds:
        assert seeded.provenance == "warm"
    _assert_matches_repro(cold, "pennant", 64)


# --------------------------------------------------------------------- misc
def test_value_tag_matches_cost_model():
    from repro_torch.sim.collectives import CollectivePattern
    from repro_torch.sim.cost import SimulatedTimeCostModel, spec_for

    pattern = CollectivePattern(kind="shift")
    for engine, dtype, tag in (("batched", "float64", "numpy-f64"),
                               ("batched-torch", "float64", "torch-f64"),
                               ("batched-torch", "float32", "torch-f32"),
                               ("event", "float64", "event-f64")):
        model = SimulatedTimeCostModel(
            pattern=pattern, spec=spec_for((2, 2)), step_flops=1.0,
            engine=engine, dtype=dtype, device="cpu")
        assert value_tag(engine, dtype) == model.value_tag == tag


def test_value_tags_isolate_engine_families(tmp_path):
    """A plan cached under ``numpy-f64`` is never served to a torch-engine
    request on the same cache directory, nor the other way round."""
    with MappingService(tmp_path, workers=0) as svc:
        numpy_plan = svc.map(TuneRequest("cannon"))
    clear_caches()
    with _svc(tmp_path, workers=0) as svc:
        torch_plan = svc.map(TuneRequest("cannon"))
        assert svc.map(TuneRequest("cannon")).provenance == "cache"
    clear_caches()
    with MappingService(tmp_path, workers=0) as svc:
        again = svc.map(TuneRequest("cannon"))
    assert numpy_plan.provenance == torch_plan.provenance == "cold"
    assert (numpy_plan.value_tag, torch_plan.value_tag) == ("numpy-f64", "torch-f64")
    assert again.provenance == "cache" and again.value_tag == "numpy-f64"
    assert len(PlanCache(tmp_path / "plans").nearest("cannon", 4, count=8)) == 2


def test_plan_key_for_matches_report_procs():
    from repro_torch import apps
    from repro_torch.sim.cost import time_tuned_app

    tuned = time_tuned_app(apps.get("cannon"), **TORCH)
    n, key, tag = plan_key_for(tuned, None, engine="batched-torch")
    assert n == tuned.default_procs
    assert tag == "torch-f64"
    n2, key2, _ = plan_key_for(tuned, 16, engine="batched-torch")
    assert n2 == 16 and key2 != key
    _, numpy_key, _ = plan_key_for(tuned, None, engine="batched")
    assert numpy_key != key


def test_load_trace_parses_jsonl(tmp_path):
    path = tmp_path / "trace.jsonl"
    path.write_text(
        "# comment\n"
        '{"app": "cannon"}\n'
        "\n"
        '{"app": "stencil", "procs": 16, "priority": 1,'
        ' "machine_shape": [4, 4]}\n'
    )
    reqs = load_trace(path)
    assert [r.app for r in reqs] == ["cannon", "stencil"]
    assert reqs[1].procs == 16 and reqs[1].machine_shape == (4, 4)


def test_replay_resolves_in_submission_order(tmp_path):
    trace = [TuneRequest("cannon"), TuneRequest("cannon"),
             TuneRequest("badname")]
    with _svc(tmp_path, workers=0) as svc:
        results = replay(svc, trace)
    assert isinstance(results[0], MappingPlan)
    # The identical repeat either coalesced into the same batch's search
    # ("cold", zero extra searches) or hit the plan cache.
    assert isinstance(results[1], MappingPlan)
    assert _essence(results[0]) == _essence(results[1])
    assert svc.stats.searches == 1
    assert isinstance(results[2], Rejected)


def _serve_cli(*args, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.serving.serve", *args],
        capture_output=True, text=True, timeout=300, env=env)


def test_serve_cli_demo_smoke(tmp_path, capsys):
    from repro_torch.serving.serve import main

    rc = main(["--demo", "4", "--cache-dir", str(tmp_path), "--workers", "0",
               "--backend", "torch", "--device", "cpu", "--json"])
    out = capsys.readouterr().out
    assert rc == 0
    assert '"submitted": 4' in out
    rows = [json.loads(line) for line in out.splitlines()
            if line.startswith('{"app"')]
    assert len(rows) == 4 and {r["value_tag"] for r in rows} == {"torch-f64"}


def test_serve_cli_torch_backend_refuses_without_a_card():
    """The CLI on the torch engine with the default ``--device cuda`` and
    no card: every request is an ``error`` rejection and the exit code is
    1; the NumPy engine needs no card."""
    no_card = {"CUDA_VISIBLE_DEVICES": ""}
    refused = _serve_cli("--demo", "2", "--backend", "torch", "--json",
                         env_extra=no_card)
    assert refused.returncode == 1, refused.stderr
    rows = [json.loads(line) for line in refused.stdout.splitlines()
            if line.startswith('{"app"')]
    assert len(rows) == 2 and all(r["rejected"] == "error" for r in rows)
    assert all("no CUDA card" in r["detail"] for r in rows)
    host = _serve_cli("--demo", "2", "--backend", "numpy", env_extra=no_card)
    assert host.returncode == 0, host.stderr


# ------------------------------------------------------------------- remap
def test_remap_request_resolves_with_recovery_facts(tmp_path):
    from repro.search.remap import remap_plan as j_remap_plan
    from repro import apps as japps

    with _svc(tmp_path, workers=0) as svc:
        svc.map(TuneRequest("stencil", procs=8))     # cache the healthy plan
        res = svc.map(RemapRequest(app="stencil", failures=[3], procs=8))
        assert isinstance(res, MappingPlan)
        assert res.provenance == "remap"
        facts = res.remap
        assert facts is not None
        assert 3 not in facts["proc_map"]
        placed = {p for row in facts["placement"] for p in
                  (row if isinstance(row, list) else [row])}
        assert 3 not in placed
        # stale plan touched the dead proc -> impossible; remap is finite
        assert facts["stale_step_s"] == float("inf")
        assert facts["degraded_step_s"] < float("inf")
        assert svc.stats.remaps == 1
        assert json.dumps(res.summary())             # serializable surface
    # repro's remap of repro's healthy plan on the NumPy engine.
    with JService(None, workers=0) as jsvc:
        stale = jsvc.map(JRequest("stencil", procs=8))
    theirs = j_remap_plan(japps.get("stencil"), stale.payload(), [3], procs=8)
    assert res.leaderboard[0]["candidate"] == theirs.report.best.candidate.describe()
    assert facts["sub_shape"] == list(theirs.sub_shape)
    assert facts["placement"] == theirs.placement.tolist()
    assert facts["degraded_step_s"] == pytest.approx(theirs.degraded_step_s,
                                                     rel=PLACED_RTOL)


def test_remap_outranks_queued_tunes(tmp_path):
    svc = _svc(tmp_path, workers=0, coalesce=1)
    tune = svc.submit(TuneRequest("cannon", priority=0))
    remap = svc.submit(RemapRequest(app="stencil", failures=[0], procs=8))
    svc.drain()
    # default remap priority -1 dispatches before the priority-0 tune
    assert isinstance(remap.result(), MappingPlan)
    assert remap.result().elapsed_s <= tune.result().elapsed_s or (
        svc.stats.completed == 2)
    svc.close()


def test_remap_bad_failures_returns_typed_error(tmp_path):
    with _svc(tmp_path, workers=0) as svc:
        res = svc.map(RemapRequest(app="stencil", failures=list(range(8)),
                                   procs=8))
    assert isinstance(res, Rejected) and res.reason == "error"


# ------------------------------------------------------------ worker crash
def test_worker_crash_requeues_batch_once(tmp_path, monkeypatch):
    svc = _svc(tmp_path, workers=0)
    real_process = svc._process
    crashes = {"n": 0}

    def crashing(batch):
        if crashes["n"] == 0:
            crashes["n"] += 1
            raise RuntimeError("worker died")
        real_process(batch)

    monkeypatch.setattr(svc, "_process", crashing)
    ticket = svc.submit(TuneRequest("cannon"))
    svc.drain()
    res = ticket.result()
    assert isinstance(res, MappingPlan)              # requeued, then served
    assert svc.stats.worker_crashes == 1
    assert svc.stats.summary()["worker_crashes"] == 1
    svc.close()


def test_worker_crash_twice_rejects_instead_of_hanging(tmp_path, monkeypatch):
    svc = _svc(tmp_path, workers=0)
    monkeypatch.setattr(
        svc, "_process",
        lambda batch: (_ for _ in ()).throw(RuntimeError("dead again")))
    ticket = svc.submit(TuneRequest("cannon"))
    svc.drain()
    res = ticket.result()
    assert isinstance(res, Rejected) and res.reason == "error"
    assert "twice" in res.detail
    assert svc.stats.worker_crashes == 2
    svc.close()


def test_worker_thread_crash_requeues_with_live_workers(tmp_path):
    """End to end through real worker threads: the first batch attempt
    dies inside the worker, the ticket is requeued and still resolves."""
    svc = _svc(tmp_path, workers=2)
    real_process = svc._process
    lock = threading.Lock()
    crashed = {"done": False}

    def crash_once(batch):
        with lock:
            first = not crashed["done"]
            crashed["done"] = True
        if first:
            raise RuntimeError("simulated worker death")
        real_process(batch)

    svc._process = crash_once
    ticket = svc.submit(TuneRequest("stencil"))
    res = ticket.result(timeout=60.0)
    assert isinstance(res, MappingPlan)
    assert svc.stats.worker_crashes == 1
    svc.close()


# ------------------------------------------------------------ batch runner
def test_runner_warm_start_from_matches_repro(tmp_path):
    """``apps.run --tune --time --warm-start-from DIR`` at 64 processors:
    the port (torch engine on the CPU) seeds from and stores into a plan
    cache as repro's runner does (NumPy engine), and prints the same
    winners; a second run finds its own plans."""
    from repro.apps.run import main as j_main
    from repro_torch.apps.run import main as main

    def run(fn, root, *extra):
        out = tmp_path / f"{root}.json"
        rc = fn(["--tune", "--time", "--all", "--procs", "64", "--json", str(out),
                 "--warm-start-from", str(tmp_path / root), *extra])
        assert rc == 0
        return {r["app"]: r for r in json.loads(out.read_text())["apps"]}

    with MappingService(tmp_path / "mine", **TORCH, workers=0) as svc:
        svc.map(TuneRequest("pennant"))              # a seed near 64
    with JService(tmp_path / "theirs", workers=0) as svc:
        svc.map(JRequest("pennant"))
    mine = run(main, "mine", "--backend", "torch", "--device", "cpu")
    theirs = run(j_main, "theirs")
    assert sorted(mine) == sorted(theirs)
    for name, row in mine.items():
        assert row["best"]["candidate"] == theirs[name]["best"]["candidate"], name
        assert row["best"]["placed_cost"] == pytest.approx(
            theirs[name]["best"]["placed_cost"], rel=PLACED_RTOL)
        assert row["warm_seeds"] == theirs[name]["warm_seeds"], name
    stored = PlanCache(tmp_path / "mine" / "plans")
    assert len(stored.nearest("pennant", 64, count=8)) == 2
    assert stored.stats()["plans"] == 1 + len(mine)
    with pytest.raises(SystemExit):
        main(["--tune", "--app", "cannon", "--warm-start-from", str(tmp_path)])
