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
for needed in sys.argv[2:]:
    assert needed in names, needed
print("imported", len(names))
"""

# The LM serving stack (MoE and MLA included), the tuner's service and
# fault layers, the training path, the dry run and the mesh layer: every
# module must be among those imported.
LM_MODULES = [
    "repro_torch.configs", "repro_torch.configs.hymba_1_5b",
    "repro_torch.models", "repro_torch.models.config",
    "repro_torch.models.params", "repro_torch.models.layers",
    "repro_torch.models.transformer", "repro_torch.models.hymba",
    "repro_torch.models.registry", "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.mamba_scan", "repro_torch.launch.steps",
    "repro_torch.configs.rwkv6_3b", "repro_torch.models.rwkv6",
    "repro_torch.kernels.wkv6",
    "repro_torch.launch.serve", "repro_torch.serving.scheduler",
    "repro_torch.serving.stats",
    "repro_torch.serving", "repro_torch.serving.plan_cache",
    "repro_torch.serving.mapsvc", "repro_torch.serving.serve",
    "repro_torch.search.remap", "repro_torch.core.autosharder",
    "repro_torch.runtime", "repro_torch.runtime.resilience",
    "repro_torch.models.moe", "repro_torch.models.sharding",
    "repro_torch.configs.qwen2_moe_a2_7b", "repro_torch.configs.deepseek_v2_lite_16b",
    "repro_torch.training", "repro_torch.training.optimizer", "repro_torch.training.loop",
    "repro_torch.data", "repro_torch.data.pipeline", "repro_torch.checkpoint",
    "repro_torch.checkpoint.manager", "repro_torch.runtime.compression",
    "repro_torch.launch.train",
    "repro_torch.models.loops", "repro_torch.launch.knobs", "repro_torch.launch.specs",
    "repro_torch.launch.roofline", "repro_torch.launch.flops", "repro_torch.launch.dryrun",
    "repro_torch.launch.mesh", "repro_torch.launch.policy", "repro_torch.training.pipeline",
    "repro_torch.core.spmd", "repro_torch.core.world",
]


def test_port_and_chip_smoke_import_without_jax_or_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    proc = subprocess.run(
        [sys.executable, "-c", SNIPPET, str(REPO / "chip_smoke.py"), *LM_MODULES],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(REPO),
    )
    assert proc.returncode == 0, proc.stderr
    count = int(proc.stdout.split()[-1])
    assert count >= 72, proc.stdout
