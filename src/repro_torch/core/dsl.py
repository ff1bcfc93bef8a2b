"""Textual front-end for the Mapple DSL (paper Fig. 1a / Fig. 18 grammar).

Parses declarative Mapple programs such as::

    m = Machine(GPU)
    m1 = m.merge(0, 1).split(0, 4)

    def block2d(Tuple ipoint, Tuple ispace):
        idx = ipoint * m.size / ispace
        return m[*idx]

    IndexTaskMap loop0 block2d
    TaskMap task_small CPU
    Region task_init arg0 GPU FBMEM
    Layout task_finish arg1 CPU C_order align=128
    GarbageCollect systolic arg2
    Backpressure systolic 1

Mapping-function bodies are Python-ish with tuple arithmetic (the paper's
``Tuple`` type) plus the C ternary ``cond ? a : b`` which we desugar. They
are compiled with an empty ``__builtins__`` and a whitelisted namespace
(Machine, Tuple, declared spaces, helper primitives) — the DSL is *not*
general Python.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable

from repro_torch.core import machine as machine_mod
from repro_torch.core.mapper import (
    Mapper,
    block_primitive,
    cyclic_primitive,
)
from repro_torch.core.pspace import ProcSpace
from repro_torch.core.translate import LayoutSpec
from repro_torch.core.tuples import Tup

_TERNARY = re.compile(r"(?P<c>[^?\n=]+)\?(?P<a>[^:\n]+):(?P<b>.+)")
_SIG_TYPE = re.compile(r"\b(Tuple|int|float)\s+(\w+)")
_STAR_SUB = re.compile(r"\[\s*\*\s*(\w+)\s*\]")

DIRECTIVES = (
    "IndexTaskMap", "TaskMap", "Region", "Layout",
    "GarbageCollect", "Backpressure",
)


@dataclasses.dataclass
class MapperProgram:
    """Parse result: declared spaces, mapping functions, and directives."""

    spaces: dict[str, ProcSpace] = dataclasses.field(default_factory=dict)
    mappers: dict[str, Mapper] = dataclasses.field(default_factory=dict)
    index_task_maps: dict[str, str] = dataclasses.field(default_factory=dict)
    task_maps: dict[str, str] = dataclasses.field(default_factory=dict)
    regions: dict[tuple[str, str], tuple[str, str]] = dataclasses.field(
        default_factory=dict
    )
    layouts: dict[tuple[str, str], LayoutSpec] = dataclasses.field(
        default_factory=dict
    )
    garbage_collect: set[tuple[str, str]] = dataclasses.field(default_factory=set)
    backpressure: dict[str, int] = dataclasses.field(default_factory=dict)
    source: str = ""

    def loc(self) -> int:
        """Non-blank, non-comment lines — the paper's Table 1 metric."""
        return sum(
            1
            for ln in self.source.splitlines()
            if ln.strip() and not ln.strip().startswith("#")
        )


def _desugar_ternary(line: str) -> str:
    """`x = c ? a : b`  ->  `x = (a) if (c) else (b)` (rhs only)."""
    if "?" not in line or ":" not in line.split("?", 1)[1]:
        return line
    if "=" in line:
        lhs, rhs = line.split("=", 1)
    else:
        lhs, rhs = None, line
    m = _TERNARY.fullmatch(rhs.strip())
    if not m:
        return line
    py = f"({m.group('a').strip()}) if ({m.group('c').strip()}) else ({m.group('b').strip()})"
    return f"{lhs}= {py}" if lhs is not None else py


def _clean_signature(line: str) -> str:
    """Strip C-style parameter types: def f(Tuple a, int b): -> def f(a, b):"""
    return _SIG_TYPE.sub(r"\2", line)


def _desugar_star_subscript(line: str) -> str:
    """`m[*idx]` -> `m[tuple(idx)]` — starred subscripts (the paper's tuple
    unpacking idiom) only became Python syntax in 3.11; ProcSpace accepts
    the equivalent tuple/Tup index directly."""
    return _STAR_SUB.sub(r"[tuple(\1)]", line)


class _SafeNamespace(dict):
    """Evaluation namespace: whitelisted names only, no builtins."""

    ALLOWED_GLOBALS: dict[str, Any] = {
        "Machine": machine_mod.Machine,
        "Tuple": Tup,
        "GPU": machine_mod.GPU,
        "TPU": machine_mod.TPU,
        "CPU": machine_mod.CPU,
        "block_primitive": block_primitive,
        "cyclic_primitive": cyclic_primitive,
        "tuple": tuple,
        "range": range,
        "len": len,
        "min": min,
        "max": max,
        "abs": abs,
    }

    def __init__(self) -> None:
        super().__init__(self.ALLOWED_GLOBALS)
        self["__builtins__"] = {}


def parse(source: str, *,
          machine_factory: Callable[..., ProcSpace] | None = None) -> MapperProgram:
    """Parse a Mapple program into a :class:`MapperProgram`.

    ``machine_factory`` overrides ``Machine`` so the same program text can
    target different physical machines (the paper's tuning workflow).
    """
    prog = MapperProgram(source=source)
    ns = _SafeNamespace()
    if machine_factory is not None:
        ns["Machine"] = machine_factory

    lines = source.splitlines()
    i = 0
    while i < len(lines):
        raw = lines[i]
        line = raw.strip()
        if not line or line.startswith("#"):
            i += 1
            continue

        head = line.split()[0]
        if head in DIRECTIVES:
            _parse_directive(prog, line)
            i += 1
            continue

        if line.startswith("def "):
            block = [_clean_signature(_desugar_ternary(raw))]
            i += 1
            while i < len(lines) and (
                lines[i].startswith((" ", "\t")) or not lines[i].strip()
            ):
                block.append(_desugar_star_subscript(_desugar_ternary(lines[i])))
                i += 1
            _compile_mapping_fn(prog, ns, "\n".join(block))
            continue

        if "=" in line:
            # Space declaration / transformation chain.
            name, expr = (s.strip() for s in line.split("=", 1))
            value = eval(  # noqa: S307 - restricted namespace, no builtins
                expr, ns
            )
            ns[name] = value
            if isinstance(value, ProcSpace):
                prog.spaces[name] = value
            i += 1
            continue

        raise SyntaxError(f"unrecognized Mapple statement: {line!r}")
    return prog


def _compile_mapping_fn(prog: MapperProgram, ns: _SafeNamespace, block: str) -> None:
    code = compile(block, "<mapple>", "exec")
    exec(code, ns)  # noqa: S102 - restricted namespace
    fn_name = block.split("(")[0].split()[-1]
    raw_fn = ns[fn_name]

    def fn(ipoint: Tup, ispace: Tup):
        return raw_fn(ipoint, ispace)

    # Snapshot the spaces declared so far: the mapper body closes over them,
    # and they carry the transformation IR that Mapper.describe() prints.
    # The compiled body also runs unchanged on a batched Tup (vectorized
    # grid evaluation) because all Tup/ProcSpace operations broadcast.
    prog.mappers[fn_name] = Mapper(fn_name, fn, spaces=dict(prog.spaces))


def _parse_directive(prog: MapperProgram, line: str) -> None:
    parts = line.split()
    head, rest = parts[0], parts[1:]
    if head == "IndexTaskMap":
        task, mapper = rest
        if mapper not in prog.mappers:
            raise NameError(f"IndexTaskMap references unknown mapper {mapper!r}")
        prog.index_task_maps[task] = mapper
    elif head == "TaskMap":
        task, kind = rest
        prog.task_maps[task] = kind.lower()
    elif head == "Region":
        task, arg, _proc_kind, memkind = rest
        mem = {
            "FBMEM": machine_mod.FBMEM,
            "ZCMEM": machine_mod.ZCMEM,
            "SYSMEM": machine_mod.SYSMEM,
        }.get(memkind.upper(), memkind.lower())
        prog.regions[(task, arg)] = (_proc_kind.lower(), mem)
    elif head == "Layout":
        task, arg, _proc, order, *opts = rest
        align = 128
        soa = True
        for opt in opts:
            if opt.startswith("align="):
                align = int(opt.split("=", 1)[1])
            elif opt in ("SoA", "soa"):
                soa = True
            elif opt in ("AoS", "aos"):
                soa = False
        prog.layouts[(task, arg)] = LayoutSpec(
            order="F" if order.upper().startswith("F") else "C",
            alignment=align,
            soa=soa,
        )
    elif head == "GarbageCollect":
        task, arg = rest
        prog.garbage_collect.add((task, arg))
    elif head == "Backpressure":
        task, depth = rest
        prog.backpressure[task] = int(depth)
    else:  # pragma: no cover - guarded by caller
        raise SyntaxError(f"unknown directive {head}")
