"""Import hygiene: the port needs neither JAX nor the JAX package.

In a child process where ``import jax`` and ``import repro`` fail, every
module of ``repro_torch`` and ``chip_smoke.py`` must import.
"""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SNIPPET = r"""
import importlib, importlib.util, pkgutil, sys
for blocked in ("jax", "jaxlib", "repro"):
    sys.modules[blocked] = None          # any import of them now fails
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("imported", len(names))
"""


def test_port_and_chip_smoke_import_without_jax_or_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    proc = subprocess.run(
        [sys.executable, "-c", SNIPPET, str(REPO / "chip_smoke.py")],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(REPO),
    )
    assert proc.returncode == 0, proc.stderr
    count = int(proc.stdout.split()[-1])
    assert count >= 25, proc.stdout
