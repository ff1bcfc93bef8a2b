"""Persistent cross-run pricing cache: placements priced once, ever.

The tuner's Phase 3 re-prices the same placements constantly — across
repeat invocations (the service loop of the ASI proposer/evaluator
cycle re-tunes the same (app, grid, machine) point per proposal), across
processes, and across engines that share arithmetic. Pricing is a pure
function of ``(schedule, machine, placement)``, and the placement enters
only through its isomorphism class (`repro_torch.sim.batch
.canonical_assignment`), so the result is cacheable under a compact
digest key — no schedule build, no device dispatch, just a dict lookup
backed by an append-only file.

Layout: one file per *table* under the cache root, where a table is the
digest of everything that determines a step time except the placement —
pattern, grid, machine spec, payload width, compute leg, backpressure,
steps, and the pricing engine's value tag (``numpy-f64`` / ``torch-f64`` /
``torch-f32``: engines agree to tolerance but not bit-for-bit, and the
cache promises bit-stability, so each tag owns its rows). Rows are fixed
28-byte records::

    [16-byte blake2b of the canonical assignment][f64 seconds][crc32]

after a 8-byte ``RPRICE01`` header. The CRC covers digest+value, so a
torn or bit-flipped record is detected and the load stops there — the
intact prefix stays usable, the damaged tail re-prices live (counted in
``stats()["dropped"]``). A file with the wrong magic or version is
treated as empty and overwritten on the next write. Records are
append-only and idempotent (a duplicate digest just re-asserts the same
value), so crashed runs never corrupt earlier rows.

``clear_caches()``/``cache_stats()`` in :mod:`repro_torch.sim.collectives`
cover every live :class:`PriceCache` (registered weakly): clearing drops
the in-memory tables — the disk store survives, that is the point — and
stats aggregate hit/miss/write/dropped counters.
"""
from __future__ import annotations

import struct
import weakref
import zlib
from hashlib import blake2b
from pathlib import Path
from typing import Iterable

from repro_torch.sim.collectives import register_cache

_MAGIC = b"RPRICE01"
_REC = struct.Struct("<16sdI")

#: Digest width of table keys and row keys (blake2b truncated).
DIGEST_BYTES = 16

_INSTANCES: "weakref.WeakSet[PriceCache]" = weakref.WeakSet()
_STAT_KEYS = ("hits", "misses", "writes", "dropped")


def digest(*parts: bytes) -> bytes:
    """16-byte blake2b over length-framed parts (framing keeps
    ``(b"ab", b"c")`` and ``(b"a", b"bc")`` distinct)."""
    h = blake2b(digest_size=DIGEST_BYTES)
    for part in parts:
        h.update(len(part).to_bytes(8, "little"))
        h.update(part)
    return h.digest()


def _crc(row: bytes, value: float) -> int:
    return zlib.crc32(row + struct.pack("<d", value))


class PriceCache:
    """Append-only on-disk store of ``row digest -> step seconds``,
    sharded into per-table files and mirrored in memory once touched.

    ``get``/``put`` take the 16-byte table and row digests directly —
    build them with :func:`digest` (the cost model's
    ``SimulatedTimeCostModel.price_table_key`` assembles the table side).
    Writes go through to disk immediately; reads load a table's file
    lazily on first access and serve from memory after.
    """

    def __init__(self, root: str | Path) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._tables: dict[bytes, dict[bytes, float]] = {}
        #: Tables whose file carried damage at load time: appending past
        #: a tear would be unreadable (loads stop there), so the next
        #: write rewrites these files whole — self-healing.
        self._damaged: set[bytes] = set()
        self.stats_counters = {k: 0 for k in _STAT_KEYS}
        _INSTANCES.add(self)

    # ------------------------------------------------------------------ io
    def _path(self, table: bytes) -> Path:
        return self.root / f"{table.hex()}.price"

    def _load(self, table: bytes) -> dict[bytes, float]:
        rows = self._tables.get(table)
        if rows is not None:
            return rows
        rows = self._tables[table] = {}
        path = self._path(table)
        try:
            blob = path.read_bytes()
        except OSError:
            return rows
        if not blob.startswith(_MAGIC):
            # Stale version or foreign file: ignore it wholesale; the
            # next write re-creates it under the current format.
            self.stats_counters["dropped"] += 1
            self._damaged.add(table)
            return rows
        body = blob[len(_MAGIC):]
        for off in range(0, len(body) - len(body) % _REC.size, _REC.size):
            row, value, crc = _REC.unpack_from(body, off)
            if crc != _crc(row, value):
                # Torn/corrupt record: keep the intact prefix, drop the
                # rest (fixed-size framing cannot re-synchronize past a
                # tear) — those placements simply re-price live.
                self.stats_counters["dropped"] += 1
                self._damaged.add(table)
                break
            rows[row] = value
        else:
            if len(body) % _REC.size:
                self.stats_counters["dropped"] += 1
                self._damaged.add(table)
        return rows

    # -------------------------------------------------------------- access
    def get(self, table: bytes, row: bytes) -> float | None:
        """The cached seconds for one placement digest, or None."""
        value = self._load(table).get(row)
        if value is None:
            self.stats_counters["misses"] += 1
        else:
            self.stats_counters["hits"] += 1
        return value

    def put(self, table: bytes, row: bytes, value: float) -> None:
        self.put_many(table, [(row, value)])

    def put_many(self, table: bytes,
                 items: Iterable[tuple[bytes, float]]) -> None:
        """Insert rows and append them to the table's file in one write
        (the tuner prices in groups; one append per group, not per
        placement). Already-present digests are skipped — append-only
        files never restate a row."""
        rows = self._load(table)
        fresh = [(row, float(value)) for row, value in items
                 if row not in rows]
        if not fresh:
            return
        path = self._path(table)
        rows.update(fresh)
        if table in self._damaged:
            # Appending past a tear would be unreadable (loads stop at
            # the damage), so rewrite the file whole from the intact
            # rows — the write heals the table.
            blob = _MAGIC + b"".join(
                _REC.pack(row, value, _crc(row, value))
                for row, value in rows.items())
            path.write_bytes(blob)
            self._damaged.discard(table)
        else:
            header = b"" if path.exists() else _MAGIC
            blob = b"".join(_REC.pack(row, value, _crc(row, value))
                            for row, value in fresh)
            with open(path, "ab") as fh:
                fh.write(header + blob)
        self.stats_counters["writes"] += len(fresh)

    # ------------------------------------------------------------ lifecycle
    def clear(self) -> None:
        """Drop the in-memory mirror and zero counters; the disk store
        is untouched (the next ``get`` reloads it — that persistence is
        the cache's reason to exist)."""
        self._tables.clear()
        for k in self.stats_counters:
            self.stats_counters[k] = 0

    def stats(self) -> dict:
        """Counters plus the loaded in-memory population."""
        return {
            **self.stats_counters,
            "tables": len(self._tables),
            "rows": sum(len(t) for t in self._tables.values()),
        }


def _caches_clear() -> None:
    for cache in list(_INSTANCES):
        cache.clear()


def _caches_stats() -> dict:
    out = {k: 0 for k in _STAT_KEYS}
    out.update(tables=0, rows=0)
    for cache in list(_INSTANCES):
        for k, v in cache.stats().items():
            out[k] += v
    return out


register_cache("price_cache", _caches_clear, _caches_stats)

__all__ = ["DIGEST_BYTES", "PriceCache", "digest"]
