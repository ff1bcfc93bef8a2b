"""Decompose-driven mesh planning for LM training/serving (beyond-paper).

The paper's Sec. 7.2 observation — *only the objective changes, the same
enumerator applies* — is exactly what a production LM framework needs to
pick its parallelism factorization. This module reuses the paper's optimal
enumerator (`enumerate_factorizations`) with a communication objective built
from the LM step (DP grad all-reduce, TP activation collectives, EP
all-to-all), subject to hardware-integrality constraints (tp | heads,
ep | experts, dp | batch).

This is the "Mapple as a first-class feature" integration: the launcher
asks the planner for a `MeshPlan`, the same way the matmul benchmarks ask
`decompose` for a processor grid. The counterpart of
``repro.core.autosharder``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.commvolume import LMCommModel, LMStepCostModel
from repro_torch.core.decompose import enumerate_factorizations


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A chosen factorization of the chip count into parallelism axes."""

    dp: int
    tp: int
    ep: int = 1
    step_comm_bytes: float = 0.0
    candidates_considered: int = 0

    @property
    def shape(self) -> tuple[int, int]:
        return (self.dp, self.tp)


@dataclasses.dataclass(frozen=True)
class LMWorkload:
    """Iteration-space description of one LM step, for the planner."""

    global_batch: int
    seq_len: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    param_count: float
    dtype_bytes: int = 2
    n_experts: int = 0            # routed experts (0 = dense)
    n_moe_layers: int = 0
    topk: int = 0
    ffn_mult_bytes: float = 0.0   # routed expert param bytes

    def comm_model(self) -> LMCommModel:
        act = self.global_batch * self.seq_len * self.d_model * self.dtype_bytes
        moe_tok = (
            self.global_batch * self.seq_len * self.topk * self.d_model
            * self.dtype_bytes
        )
        return LMCommModel(
            param_bytes=self.param_count * 4.0,   # fp32 grads all-reduced
            act_bytes_per_layer=float(act),
            n_layers=self.n_layers,
            moe_param_bytes=self.ffn_mult_bytes,
            moe_tokens_bytes=float(moe_tok),
            n_moe_layers=self.n_moe_layers,
        )


@dataclasses.dataclass(frozen=True)
class MeshCostModel(LMStepCostModel):
    """:func:`plan_mesh`'s objective *and* its feasibility constraints on
    the :class:`~repro_torch.core.commvolume.CostModel` protocol: an infeasible
    ``(dp, tp)`` raises ``ValueError`` instead of silently pricing, so the
    tuner's enumerative machinery (``feasible_procs`` /
    ``nearest_feasible_procs``) answers "can ``n`` chips host this
    workload?" the same way it answers it for the registry apps."""

    wl: LMWorkload = None
    max_tp: int = 64
    use_ep: bool | None = None
    name = "lm_mesh"

    @property
    def moe(self) -> bool:
        return self.wl.n_experts > 0 if self.use_ep is None else self.use_ep

    def ep_for(self, tp: int) -> int:
        return tp if (self.moe and self.wl.n_experts % tp == 0) else 1

    def cost(self, factors: Sequence[int]) -> float:
        if len(factors) != 2:
            raise ValueError(f"expected a (dp, tp) grid, got {tuple(factors)}")
        dp, tp = (int(x) for x in factors)
        wl = self.wl
        if tp > self.max_tp:
            raise ValueError(f"tp={tp} exceeds max_tp={self.max_tp}")
        if dp > wl.global_batch or wl.global_batch % dp != 0:
            raise ValueError(f"dp={dp} does not divide batch {wl.global_batch}")
        if tp > 1 and (wl.n_heads % tp != 0 or wl.d_model % tp != 0):
            raise ValueError(f"tp={tp} does not shard heads/d_model evenly")
        return super().cost((dp, tp, self.ep_for(tp)))


def mesh_search_space(wl: LMWorkload, *, max_tp: int = 64,
                      use_ep: bool | None = None):
    """The ``(dp, tp)`` mesh as a tuner :class:`~repro_torch.search.space.SearchSpace`
    — :func:`repro_torch.runtime.resilience.elastic_plan` routes survivor-count
    feasibility through this instead of a power-of-two shortcut."""
    from repro_torch.search.space import SearchSpace

    model = MeshCostModel(model=wl.comm_model(), wl=wl, max_tp=max_tp,
                          use_ep=use_ep)
    return SearchSpace(rank=2, cost_model=lambda procs, opts: model)


def plan_mesh(
    n_chips: int,
    wl: LMWorkload,
    *,
    use_ep: bool | None = None,
    max_tp: int = 64,
) -> MeshPlan:
    """Pick (dp, tp[, ep]) minimizing modeled step communication.

    Constraints (integrality, the paper's l_m/w_m in N analogue):
      * dp divides global_batch;
      * tp divides n_kv_heads (so KV heads shard evenly) and d_model;
      * ep divides n_experts; ep and tp share the 'model' axis here, so
        we require ep == tp for MoE archs when use_ep (experts ride the
        model axis — one-axis EP, the deployment-standard layout).
    """
    objective = MeshCostModel(model=wl.comm_model(), wl=wl, max_tp=max_tp,
                              use_ep=use_ep)
    best: tuple[float, tuple[int, ...]] | None = None
    considered = 0
    for f in enumerate_factorizations(n_chips, 2):
        considered += 1
        try:
            cost = objective.cost(f)
        except ValueError:
            continue
        key = (cost, f)
        if best is None or key < best:
            best = key
    if best is None:
        raise ValueError(f"no feasible (dp, tp) factorization of {n_chips}")
    dp, tp = best[1]
    return MeshPlan(dp=dp, tp=tp, ep=objective.ep_for(tp),
                    step_comm_bytes=best[0],
                    candidates_considered=considered)


def plan_report(n_chips: int, wl: LMWorkload) -> str:
    """Human-readable planning table (used by examples/)."""
    objective = LMStepCostModel(wl.comm_model())
    rows = []
    for f in sorted(enumerate_factorizations(n_chips, 2)):
        dp, tp = f
        if wl.global_batch % dp or (tp > 1 and wl.n_heads % tp):
            continue
        ep = tp if wl.n_experts and wl.n_experts % tp == 0 else 1
        rows.append((objective((dp, tp, ep)), dp, tp, ep))
    rows.sort()
    lines = [f"{'bytes/step':>14}  {'dp':>5} {'tp':>4} {'ep':>4}"]
    for cost, dp, tp, ep in rows[:12]:
        lines.append(f"{cost:14.3e}  {dp:5d} {tp:4d} {ep:4d}")
    return "\n".join(lines)
