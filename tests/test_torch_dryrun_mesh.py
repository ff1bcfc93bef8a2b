"""The port's dry run on the production meshes against the JAX package's.

The reference compiles each cell for 256 or 512 fake CPU devices
(``python -m repro.launch.dryrun``, one child process a cell, run side
by side); the port counts rank (0, ...)'s share of the same cell on a
fake process group (``launch/dryrun.py::run_mesh_cell``, meta device).
Four cells: smollm-135m train_4k (fsdp) and qwen2-moe-a2.7b prefill_32k
(tp, the expert-parallel all-to-all) on the single mesh, rwkv6-3b
decode_32k on the multi mesh, hymba-1.5b long_500k on the single mesh;
and one skipped cell.

Held equal: ``n_chips``, ``sharding_mode``, ``model_flops``, the
argument and output bytes (fixed by the specs) and the skip reason.
Per-device FLOPs and collective bytes are each partitioner's choices
(XLA's, DTensor's): FLOPs are held within a factor 2 of the
reference's and at least the one-card count over ``n_chips``; the
collectives to the reference's five kinds; ``sp_attention``'s K/V
all-gathers to a hand count, and a train step's FSDP all-gathers to at
least the parameters they gather.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import get_config
from repro_torch.launch import dryrun, flops
from repro_torch.launch.knobs import Knobs
from repro_torch.models.config import SHAPES
from repro_torch.models.params import param_count
from repro_torch.models.registry import build

REPO = Path(__file__).resolve().parent.parent
CELLS = [("smollm-135m", "train_4k", "single"), ("qwen2-moe-a2.7b", "prefill_32k", "single"),
         ("rwkv6-3b", "decode_32k", "multi"), ("hymba-1.5b", "long_500k", "single")]
SKIPPED = ("smollm-135m", "long_500k", "single")
KINDS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute"}
KNOBS = Knobs(wkv_impl="chunked")              # the CLI's default knobs, as the reference's


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's record of each cell, its CLI run in a child process
    (all side by side)."""
    out = tmp_path_factory.mktemp("ref")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    procs = {}
    for cell in CELLS + [SKIPPED]:
        arch, shape, mesh = cell
        path = out / f"{arch}-{shape}-{mesh}.json"
        procs[cell] = (path, subprocess.Popen(
            [sys.executable, "-m", "repro.launch.dryrun", "--arch", arch, "--shape", shape,
             "--mesh", mesh, "--out", str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
            cwd=str(out)))
    recs = {}
    for cell, (path, proc) in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stdout[-2000:] + stderr[-2000:]
        (recs[cell],) = json.loads(path.read_text())
    return recs


@pytest.fixture(scope="module")
def port():
    return {cell: dryrun.run_mesh_cell(*cell, knobs=KNOBS, verbose=False)
            for cell in CELLS + [SKIPPED]}


@pytest.mark.parametrize("cell", CELLS, ids="-".join)
def test_cell_keeps_the_references_fixed_numbers(ref, port, cell):
    mine, want = port[cell], ref[cell]
    assert mine["status"] == "ok", mine.get("error", "") + mine.get("traceback", "")
    assert mine["n_chips"] == want["n_chips"]
    assert mine["sharding_mode"] == want["sharding_mode"]
    assert mine["roofline"]["model_flops"] == want["roofline"]["model_flops"]
    for key in ("argument_size_in_bytes", "output_size_in_bytes"):
        assert mine["memory_analysis"][key] == want["memory_analysis"][key], key
    assert mine["memory_analysis"]["temp_size_in_bytes"] is None        # meta


def test_skipped_cell_gives_the_references_reason(ref, port):
    assert port[SKIPPED]["status"] == ref[SKIPPED]["status"] == "skipped"
    assert port[SKIPPED]["reason"] == ref[SKIPPED]["reason"]


@pytest.mark.parametrize("cell", CELLS, ids="-".join)
def test_per_device_flops_near_the_reference(ref, port, cell):
    """Within 2x of XLA's per-device FLOPs, and no less than one card's
    count of the same global cell split over the chips."""
    arch, shape, _ = cell
    mine, want = port[cell], ref[cell]
    ratio = mine["flops"] / want["flops"]
    assert 0.5 <= ratio <= 2.0, (ratio, mine["flops"], want["flops"])
    one_card = flops.count_cell(get_config(arch), SHAPES[shape]).flops
    assert mine["flops"] >= one_card / mine["n_chips"] * (1 - 1e-9), (mine["flops"], one_card)


@pytest.mark.parametrize("cell", CELLS, ids="-".join)
def test_collectives_are_the_references_kinds(port, cell):
    rec = port[cell]
    assert set(rec["collectives"]["bytes"]) <= KINDS
    assert set(rec["collectives"]["counts"]) == set(rec["collectives"]["bytes"])
    assert rec["collective_bytes"] == pytest.approx(sum(rec["collectives"]["bytes"].values()))
    assert all(row[0].split()[0] in KINDS for row in rec["collectives"]["ops"])


def test_expert_parallel_all_to_all_is_booked_as_such(port):
    rec = port[("qwen2-moe-a2.7b", "prefill_32k", "single")]
    assert rec["collectives"]["bytes"]["all-to-all"] > 0


def test_sp_attention_gathers_match_a_hand_count(port):
    """smollm-135m train_4k: each layer's sp_attention all-gathers K and V
    (local B x S x kv heads x head dim, bf16) once in the forward and once
    in the remat recompute; their backward reduce-scatters."""
    cfg = get_config("smollm-135m")
    shape = SHAPES["train_4k"]
    rec = port[("smollm-135m", "train_4k", "single")]
    b_local = shape.global_batch // 16
    per_gather = b_local * shape.seq_len * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    want = 2 * per_gather * cfg.n_layers * 2
    got = 0.0
    for sig, nbytes in rec["collectives"]["ops"]:
        # the operator gathers along dim 0 (the port moves the blocks to
        # the sequence dim after), so a gather is told by its size
        kind, dims, firings = sig.split()[0], sig[sig.index("["):sig.index("]") + 1], sig.split()[-1]
        shape_ = json.loads(dims)
        if kind == "all-gather" and shape_[-2:] == [cfg.n_kv_heads, cfg.resolved_head_dim] \
                and nbytes == per_gather and "bfloat16" in sig:
            got += nbytes * float(firings)
    assert got == want, (got, want, rec["collectives"]["ops"])


def test_fsdp_gathers_at_least_the_parameters(port):
    """A train step under FSDP gathers every layer's weights at least once."""
    cfg = get_config("smollm-135m")
    rec = port[("smollm-135m", "train_4k", "single")]
    assert rec["sharding_mode"] == "fsdp"
    gathered = param_count(build(cfg).schema) * 4
    assert rec["collectives"]["bytes"]["all-gather"] >= gathered
