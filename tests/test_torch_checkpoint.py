"""The port's checkpoints, restarts and training launcher on the CPU.

A checkpoint either package writes restores in the other, array for array
with its ``extra``; the Supervisor and the launcher restart from one after
an injected failure, as the reference's tests and CLI do.
"""
import contextlib
import io
import json
import pathlib
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_config
from repro.models import build as jax_build
from repro.training import AdamWConfig as JaxAdamWConfig
from repro.training import init_state as jax_init_state
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import make_pipeline
from repro_torch.launch import train as train_cli
from repro_torch.models import build
from repro_torch.models.params import tree_leaves
from repro_torch.runtime import FailureInjector, Supervisor
from repro_torch.training import AdamWConfig, TrainState, init_state, make_train_step


def test_checkpoint_roundtrip_and_gc():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        tree = {"a": torch.arange(6.0).reshape(2, 3), "n": {"b": torch.ones(4)}}
        for s in (10, 20, 30):
            mgr.save(s, tree, {"cursor": s})
        assert mgr.all_steps() == [20, 30]        # keep=2 GC'd step 10
        step, restored, extra = mgr.restore(device="cpu")
        assert step == 30 and extra["cursor"] == 30
        assert torch.equal(restored["a"], tree["a"])
        assert torch.equal(restored["n"]["b"], tree["n"]["b"])
        assert mgr.latest_step() == 30


def test_checkpoint_detects_corruption():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(1, {"w": torch.ones(8)})
        path = pathlib.Path(d) / "step_1"
        z = dict(np.load(path / "arrays.npz"))
        z["w"] = z["w"] + 1
        np.savez(path / "arrays.npz", **z)
        with pytest.raises(IOError):
            mgr.restore(1)


def test_checkpoint_async_save_copies_before_returning():
    """An async save keeps the values of its call: the train step updates
    the tensors in place while the writer thread runs."""
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, async_save=True)
        w = torch.ones(16)
        mgr.save(5, {"w": w})
        w.add_(1.0)
        mgr.wait()
        assert mgr.latest_step() == 5
        _, restored, _ = mgr.restore()
        assert torch.equal(restored["w"], torch.ones(16))
        assert restored["w"].device.type == "cpu"


def _jax_train_tree():
    cfg = jax_config("smollm-135m").reduced()
    st = jax_init_state(jax_build(cfg), jax.random.key(1), JaxAdamWConfig(),
                        compress_grads=True)
    st.opt = st.opt._replace(step=jnp.int32(7))
    return st.as_tree()


def test_reference_checkpoints_restore_in_the_port():
    tree = _jax_train_tree()
    with tempfile.TemporaryDirectory() as d:
        JaxCheckpointManager(d).save(7, tree, {"cursor": 7, "note": "ref"})
        step, restored, extra = CheckpointManager(d).restore(device="cpu")
    assert step == 7 and extra == {"cursor": 7, "note": "ref"}
    ref = jax.tree_util.tree_leaves(tree)
    mine = tree_leaves(restored)
    assert len(ref) == len(mine)
    for r, m in zip(ref, mine):
        assert m.dtype == getattr(torch, str(np.asarray(r).dtype))
        np.testing.assert_array_equal(m.numpy(), np.asarray(r))
    state = TrainState.from_tree(restored)
    assert int(state.opt.step) == 7 and state.opt.step.dtype == torch.int32
    assert state.error is not None


def test_port_checkpoints_restore_in_the_reference():
    model = build(get_config("smollm-135m").reduced())
    state = init_state(model, torch.Generator().manual_seed(2), AdamWConfig(),
                       device="cpu", compress_grads=True)
    tree = state.as_tree()
    with tempfile.TemporaryDirectory() as d:
        CheckpointManager(d).save(3, tree, {"cursor": 3})
        step, restored, extra = JaxCheckpointManager(d).restore()
        manifest = json.loads((pathlib.Path(d) / "step_3" / "manifest.json").read_text())
    assert step == 3 and extra == {"cursor": 3}
    assert {v["dtype"] for v in manifest["arrays"].values()} == {"float32", "int32"}
    ref = jax.tree_util.tree_leaves(restored)
    mine = tree_leaves(tree)
    assert len(ref) == len(mine)
    for r, m in zip(ref, mine):
        np.testing.assert_array_equal(np.asarray(r), m.numpy())


def _supervised(n_steps, fail_at, save_every, seq, batch, lr):
    cfg = get_config("smollm-135m").reduced()
    model = build(cfg)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=3, total_steps=40)
    state = init_state(model, torch.Generator().manual_seed(0), opt_cfg, device="cpu")
    pipe = make_pipeline(cfg, seq_len=seq, global_batch=batch, device="cpu")
    step = make_train_step(model, opt_cfg)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=3)

        def step_fn(i, tree):
            st, metrics = step(TrainState.from_tree(tree), pipe.batch(i))
            return st.as_tree(), {k: float(v) for k, v in metrics.items()}

        sup = Supervisor(mgr, max_restarts=2)
        _, history = sup.run(
            state=state.as_tree(), start_step=0, n_steps=n_steps, step_fn=step_fn,
            save_every=save_every,
            injector=FailureInjector(fail_at_steps=(fail_at,), max_failures=1))
    return sup, history


def test_supervisor_restores_after_failure():
    sup, history = _supervised(12, 7, 5, 16, 4, 1e-3)
    events = [h for h in history if "event" in h]
    assert len(events) == 1 and "restored" in events[0]["event"]
    assert max(h["step"] for h in history if "loss" in h) == 11
    assert sup.restarts == 1


def test_train_checkpoint_restart_cycle():
    """tests/test_system.py's cycle on the port: a restore after the
    failure, and the loss falls over the run."""
    _, hist = _supervised(20, 12, 5, 32, 8, 2e-3)
    losses = [h["loss"] for h in hist if "loss" in h]
    assert any("restored" in str(h.get("event", "")) for h in hist)
    assert losses[-1] < losses[0]


# ------------------------------------------------------------ the launcher
def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train_cli.main(argv)
    return rc, out.getvalue().strip().splitlines()


def test_train_cli_needs_a_card_or_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    assert train_cli.main(["--arch", "smollm-135m", "--steps", "2"]) == 2


def test_train_cli_runs_on_the_cpu():
    rc, lines = _run(["--arch", "smollm-135m", "--device", "cpu", "--steps", "6",
                      "--batch", "4", "--seq", "16"])
    assert rc == 0
    row = json.loads(lines[-1])
    assert set(row) == {"first_loss", "last_loss", "steps", "wall_s", "steps_per_s"}
    assert row["steps"] == 6 and np.isfinite(row["first_loss"])


def test_train_cli_restart_repeats_the_uninterrupted_losses():
    """--fail-at 9 with checkpoints every 4 steps: one restart, from step
    8, and the restarted steps' losses equal an uninterrupted run's (eager
    steps on the same seed have no randomness)."""
    common = ["--arch", "smollm-135m", "--device", "cpu", "--steps", "12",
              "--batch", "4", "--seq", "16", "--save-every", "4"]
    whole, _ = train_cli.train(train_cli.parse_args(common))
    with tempfile.TemporaryDirectory() as d:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            after, summary = train_cli.train(train_cli.parse_args(
                common + ["--ckpt-dir", d, "--fail-at", "9"]))
        assert sorted(p.name for p in pathlib.Path(d).glob("step_*")) == [
            "step_12", "step_4", "step_8"]
    assert out.getvalue().count("restarting from latest checkpoint") == 1
    assert [h["step"] for h in after] == [8, 9, 10, 11]
    by_step = {h["step"]: h["loss"] for h in whole}
    for h in after:
        assert h["loss"] == pytest.approx(by_step[h["step"]], rel=1e-6)
    assert summary["steps"] == 4
