"""Three-term roofline from a dry-run count (the port of
``repro.launch.roofline``):

    compute    = FLOPs       / peak_FLOP/s          (per chip)
    memory     = bytes       / HBM_bw               (per chip)
    collective = coll_bytes  / (links x link_bw)    (per chip)

The reference takes its FLOPs and bytes from the compiled HLO
(``hlo_cost.py``); the port counts them on the meta device
(``launch/flops.py``), where the bytes are the unfused operators' inputs
and outputs, so the memory term is an upper bound. MODEL_FLOPS = 6*N*D
(dense) or 6*N_active*D (MoE) checks how much of the counted compute is
useful (remat / dispatch overhead shows up here).

``terms`` takes the peak, the HBM rate and the link rate as arguments.
Their defaults are the machine model's (``core/machine.py``, the
reference's TPU v5e constants), so that ``terms`` equals the
reference's on the same cost dict; whatever runs on the card passes
``H100`` instead.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import machine as hw
from repro_torch.models.config import ModelConfig, ShapeConfig

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at the 700 W
# limit): bf16 peak, HBM3 rate (and its 80 GB), and NVLink 4's 18 links of 25 GB/s a
# direction. One card moves no collective bytes, so the last is unused
# until the multi-card slice.
H100 = {"peak_flops": 989e12, "hbm_bw": 3.35e12, "link_bw": 450e9}
H100_HBM_BYTES = 80e9


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops: float
    flops_ratio: float          # MODEL_FLOPS / (HLO_FLOPs * n_chips)
    bottleneck: str
    n_chips: int

    def row(self) -> str:
        return (
            f"{self.arch:22s} {self.shape:12s} {self.mesh:7s} "
            f"{self.compute_s:10.3e} {self.memory_s:10.3e} "
            f"{self.collective_s:10.3e} {self.bottleneck:10s} "
            f"{self.flops_ratio:6.2f}"
        )


def active_params(cfg: ModelConfig) -> float:
    """Active (per-token) parameter count: dense params + top-k experts."""
    from repro_torch.models.registry import build

    total = build(cfg).n_params
    if cfg.n_experts == 0:
        return float(total)
    d, f = cfg.d_model, cfg.moe_d_ff
    n_moe_layers = cfg.n_layers - cfg.first_dense_layers
    routed_all = n_moe_layers * cfg.padded_experts * (3 * d * f)
    routed_active = n_moe_layers * cfg.topk * (3 * d * f)
    return float(total - routed_all + routed_active)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6*N_active*D for training; 2*N_active*D_tokens for inference."""
    n_active = active_params(cfg)
    tokens = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


def terms(
    arch: str,
    shape: ShapeConfig,
    cfg: ModelConfig,
    mesh_name: str,
    n_chips: int,
    cost: dict,
    collective_bytes: float,
    *,
    peak_flops: float = hw.PEAK_FLOPS_BF16,
    hbm_bw: float = hw.HBM_BW,
    link_bw: float | None = None,
) -> RooflineTerms:
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes accessed", 0.0))
    compute_s = flops / peak_flops
    memory_s = bytes_accessed / hbm_bw
    # Innermost-level port bandwidth of the canonical pod (the per-chip
    # ICI aggregate) via the per-level MachineSpec tuple, so the roofline
    # and the simulator (repro_torch.sim) share one fabric description.
    if link_bw is None:
        link_bw = hw.V5E_POD.link_bw(len(hw.V5E_POD.shape) - 1)
    collective_s = collective_bytes / link_bw
    mf = model_flops(cfg, shape)
    ratio = mf / max(flops * n_chips, 1.0)
    terms_map = {
        "compute": compute_s, "memory": memory_s, "collective": collective_s,
    }
    bottleneck = max(terms_map, key=terms_map.get)  # type: ignore[arg-type]
    return RooflineTerms(
        arch=arch, shape=shape.name, mesh=mesh_name,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        hlo_flops=flops, hlo_bytes=bytes_accessed,
        collective_bytes=collective_bytes, model_flops=mf,
        flops_ratio=ratio, bottleneck=bottleneck, n_chips=n_chips,
    )


HEADER = (
    f"{'arch':22s} {'shape':12s} {'mesh':7s} "
    f"{'compute_s':>10s} {'memory_s':>10s} {'collect_s':>10s} "
    f"{'bound':10s} {'useful':>6s}"
)
