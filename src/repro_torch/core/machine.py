"""Hierarchical machine model — the Mapple ``Machine(GPU)`` abstraction.

The paper models a machine as a multi-dimensional processor space
(e.g. nodes x GPUs-per-node). On TPU the analogous hierarchy is
pods x chips (with chips arranged in an ICI torus inside a pod and a
slower DCI fabric between pods). :func:`Machine` returns the *root*
:class:`~repro.core.pspace.ProcSpace` on which all transformation
primitives operate.

Hardware constants are TPU v5e per the assignment:
  197 TFLOP/s bf16 per chip, 819 GB/s HBM, ~50 GB/s/link ICI.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.pspace import ProcSpace

# ----------------------------------------------------------------- constants
PEAK_FLOPS_BF16 = 197e12        # per chip, bf16
HBM_BW = 819e9                  # bytes/s per chip
ICI_BW_PER_LINK = 50e9          # bytes/s per link (intra-pod)
ICI_LINKS_PER_CHIP = 4          # 2D torus in v5e pods
DCI_BW_PER_CHIP = 6.0e9         # bytes/s per chip cross-pod (modeled)
HBM_BYTES = 16 * 2**30          # 16 GiB per v5e chip

# Processor "kinds" (the paper's Machine(GPU) / Machine(CPU)).
GPU = "tpu"     # accelerator chips -- named GPU for paper fidelity
TPU = "tpu"
CPU = "cpu"     # host cores (offload target)

# Memory kinds (paper's FBMEM / ZCMEM / SYSMEM -> TPU memory spaces).
FBMEM = "device"         # HBM
ZCMEM = "pinned_host"    # host memory visible to the device
SYSMEM = "unpinned_host"


@dataclasses.dataclass(frozen=True)
class MachineSpec:
    """Physical description of the target machine.

    ``link_bws`` is the per-level interconnect bandwidth tuple, outermost
    level first: bytes/s one *port* (an endpoint's injection path) can
    push through that level's fabric. When omitted it is derived from the
    legacy two-fabric constants: the outermost level of a multi-level
    machine gets ``dci_bw`` (one NIC), every other level the per-chip
    ICI aggregate ``ici_bw * ici_links``.
    """

    shape: tuple[int, ...]                 # e.g. (2, 256) pods x chips
    level_names: tuple[str, ...]           # e.g. ("pod", "chip")
    kind: str = TPU
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    ici_bw: float = ICI_BW_PER_LINK
    ici_links: int = ICI_LINKS_PER_CHIP
    dci_bw: float = DCI_BW_PER_CHIP
    hbm_bytes: int = HBM_BYTES
    link_bws: tuple[float, ...] | None = None   # per-level, outermost first

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.level_names):
            raise ValueError(
                f"shape {self.shape} and level_names {self.level_names} "
                f"must have the same rank"
            )
        if self.link_bws is not None:
            if len(self.link_bws) != len(self.shape):
                raise ValueError(
                    f"link_bws needs one bandwidth per level: got "
                    f"{len(self.link_bws)} for {len(self.shape)} levels"
                )
            if any(bw <= 0 for bw in self.link_bws):
                raise ValueError(f"link bandwidths must be > 0: {self.link_bws}")

    @property
    def nprocs(self) -> int:
        out = 1
        for s in self.shape:
            out *= s
        return out

    @property
    def level_strides(self) -> tuple[int, ...]:
        """Row-major flat-id stride per level, outermost first: dividing a
        flat processor id by ``level_strides[L]`` yields the flat index of
        the level-(L+1) subtree containing it — the port id the simulator
        charges for a level-L crossing."""
        strides = []
        acc = 1
        for extent in reversed(self.shape):
            strides.append(acc)
            acc *= extent
        return tuple(reversed(strides))

    @property
    def level_ports(self) -> tuple[int, ...]:
        """Number of ports at each level, outermost first: one port per
        level-(L+1) subtree, so ``nprocs // level_strides[L]``. Level 0 of
        a (nodes, gpus) machine has ``nodes`` NICs, not ``nprocs``."""
        n = self.nprocs
        return tuple(n // s for s in self.level_strides)

    @property
    def level_bws(self) -> tuple[float, ...]:
        """Per-level port bandwidth, outermost first (always full-rank)."""
        if self.link_bws is not None:
            return self.link_bws
        k = len(self.shape)
        chip = self.ici_bw * self.ici_links
        if k == 1:
            return (chip,)
        return (self.dci_bw,) + (chip,) * (k - 1)

    def link_bw(self, level: int) -> float:
        """Port bandwidth of the interconnect at level (0 = outermost)."""
        if not 0 <= level < len(self.shape):
            raise ValueError(
                f"level {level} out of range for a {len(self.shape)}-level "
                f"machine {self.shape}"
            )
        return self.level_bws[level]


@dataclasses.dataclass(frozen=True)
class DegradedMachine:
    """A degraded *view* over a :class:`MachineSpec`: dead processors plus
    per-level port contention.

    ``dead_procs`` are flat processor ids (row-major over ``spec.shape``)
    that are unplaceable — a plan that puts work on one is invalid and the
    simulator refuses to price it. ``contention`` is one tuple per level
    (outermost first), one slowdown factor per *port* at that level
    (``spec.level_ports``): a factor ``c >= 1`` means background traffic is
    stealing that port's bandwidth, so bytes drain ``c`` times slower.
    Message latency (alpha) is unaffected — contention is a bandwidth
    phenomenon. ``contention=None`` means every factor is exactly 1.0.

    A trivial view (no dead procs, all factors 1.0) must price
    bit-identically to the healthy machine; ``Topology.from_spec``
    normalizes it to ``None`` to guarantee that.
    """

    spec: MachineSpec
    dead_procs: tuple[int, ...] = ()
    contention: tuple[tuple[float, ...], ...] | None = None

    def __post_init__(self) -> None:
        dead = tuple(sorted({int(p) for p in self.dead_procs}))
        object.__setattr__(self, "dead_procs", dead)
        n = self.spec.nprocs
        for p in dead:
            if not 0 <= p < n:
                raise ValueError(f"dead proc {p} out of range for {n} procs")
        if len(dead) >= n:
            raise ValueError("cannot kill every processor")
        if self.contention is not None:
            ports = self.spec.level_ports
            if len(self.contention) != len(ports):
                raise ValueError(
                    f"contention needs one tuple per level: got "
                    f"{len(self.contention)} for {len(ports)} levels"
                )
            norm = []
            for lvl, (row, nport) in enumerate(zip(self.contention, ports)):
                row = tuple(float(c) for c in row)
                if len(row) != nport:
                    raise ValueError(
                        f"contention level {lvl} needs {nport} port factors, "
                        f"got {len(row)}"
                    )
                if any(c < 1.0 for c in row):
                    raise ValueError(
                        f"contention factors must be >= 1.0 (level {lvl}: {row})"
                    )
                norm.append(row)
            object.__setattr__(self, "contention", tuple(norm))

    # ------------------------------------------------------------- queries
    @property
    def is_trivial(self) -> bool:
        """True when this view prices identically to the healthy machine."""
        if self.dead_procs:
            return False
        if self.contention is None:
            return True
        return all(c == 1.0 for row in self.contention for c in row)

    @property
    def n_alive(self) -> int:
        return self.spec.nprocs - len(self.dead_procs)

    def alive_procs(self) -> tuple[int, ...]:
        dead = set(self.dead_procs)
        return tuple(p for p in range(self.spec.nprocs) if p not in dead)

    def port_contention(self, level: int) -> tuple[float, ...]:
        """Per-port slowdown factors at ``level`` (all 1.0 when unset)."""
        nport = self.spec.level_ports[level]
        if self.contention is None:
            return (1.0,) * nport
        return self.contention[level]

    # -------------------------------------------------------- constructors
    @classmethod
    def healthy(cls, spec: MachineSpec) -> "DegradedMachine":
        return cls(spec=spec)

    @classmethod
    def fail_procs(cls, spec: MachineSpec,
                   procs: Sequence[int]) -> "DegradedMachine":
        return cls(spec=spec, dead_procs=tuple(int(p) for p in procs))

    @classmethod
    def fail_nodes(cls, spec: MachineSpec, level: int,
                   nodes: Sequence[int]) -> "DegradedMachine":
        """Kill whole level-``level`` subtrees (e.g. full nodes): every
        processor whose flat id falls inside one of the named subtrees."""
        stride = spec.level_strides[level]
        nport = spec.level_ports[level]
        dead = []
        for node in nodes:
            node = int(node)
            if not 0 <= node < nport:
                raise ValueError(
                    f"level-{level} subtree {node} out of range "
                    f"(machine has {nport})"
                )
            dead.extend(range(node * stride, (node + 1) * stride))
        return cls(spec=spec, dead_procs=tuple(dead))

    @classmethod
    def contend(cls, spec: MachineSpec, level: int,
                factors: dict[int, float]) -> "DegradedMachine":
        """Background traffic on specific ports of one level:
        ``factors[port] = c`` slows that port's byte drain by ``c``x."""
        rows = []
        for lvl, nport in enumerate(spec.level_ports):
            row = [1.0] * nport
            if lvl == level:
                for port, c in factors.items():
                    port = int(port)
                    if not 0 <= port < nport:
                        raise ValueError(
                            f"port {port} out of range for level {lvl} "
                            f"({nport} ports)"
                        )
                    row[port] = float(c)
            rows.append(tuple(row))
        return cls(spec=spec, contention=tuple(rows))

    def merged(self, other: "DegradedMachine") -> "DegradedMachine":
        """Compose two degradations of the same machine: union of dead
        procs, product of per-port contention factors."""
        if other.spec != self.spec:
            raise ValueError("cannot merge degradations of different machines")
        dead = tuple(set(self.dead_procs) | set(other.dead_procs))
        if self.contention is None and other.contention is None:
            cont = None
        else:
            a = [self.port_contention(lvl)
                 for lvl in range(len(self.spec.shape))]
            b = [other.port_contention(lvl)
                 for lvl in range(len(self.spec.shape))]
            cont = tuple(
                tuple(x * y for x, y in zip(ra, rb)) for ra, rb in zip(a, b)
            )
        return DegradedMachine(spec=self.spec, dead_procs=dead, contention=cont)


def modeled_step_time(flops_total: float, comm_elems: float, chips: int,
                      *, elem_bytes: int = 4,
                      spec: "MachineSpec | None" = None) -> float:
    """Modeled step time on a FLAT fabric: compute and communication
    overlap, the shorter leg costs a 10% tax. The single time model behind
    the Table 2 speedups (benchmarks/mapper_tuning.py) and the
    heuristic-gap margins (benchmarks/heuristic_gap.py) — shared so the
    two harnesses can never drift onto different fabric assumptions.

    This is the documented fast-path fallback of the discrete-event
    simulator (``repro.sim``): it equals the simulator's flat-topology
    special case (all processors on one level, uniform all-to-neighbour
    traffic) up to the 10% overlap tax — asserted by
    ``tests/test_sim.py::test_flat_topology_matches_modeled_step_time``.
    Hierarchy-aware questions (inter-node vs intra-node bytes) go to the
    simulator; this stays the cheap single-formula answer. ``spec`` routes
    the bandwidth through the per-level ``MachineSpec.link_bw`` tuple
    (innermost level); the default keeps the legacy v5e flat fabric.
    """
    if spec is None:
        link = ICI_BW_PER_LINK * ICI_LINKS_PER_CHIP
        peak = PEAK_FLOPS_BF16
    else:
        link = spec.link_bw(len(spec.shape) - 1)
        peak = spec.peak_flops
    compute = flops_total / (chips * peak)
    comm = comm_elems * elem_bytes / (chips * link)
    return max(compute, comm) + 0.1 * min(compute, comm)


# Canonical machines used across the repo.
V5E_POD = MachineSpec(shape=(16, 16), level_names=("data", "model"))
V5E_TWO_PODS = MachineSpec(shape=(2, 16, 16), level_names=("pod", "data", "model"))
PAPER_CLUSTER = MachineSpec(
    shape=(2, 4), level_names=("node", "gpu"), kind=GPU,
)  # the paper's running example: 2 nodes x 4 V100s


def Machine(kind: str = TPU, spec: MachineSpec | None = None,
            shape: Sequence[int] | None = None) -> ProcSpace:
    """The paper's ``Machine(GPU)`` entry point.

    Returns the root processor space. Defaults to the paper's running
    2-node x 4-GPU example so DSL snippets from the paper run verbatim;
    production code passes an explicit spec or shape.
    """
    if shape is not None:
        shp = tuple(int(s) for s in shape)
    elif spec is not None:
        shp = spec.shape
    else:
        shp = PAPER_CLUSTER.shape
    return ProcSpace(shp, shp)
