"""Persistent plan cache: tuned mapping plans stored once, served forever.

The tuning service's unit of work — "map this app on this machine at
this scale" — is a pure function of ``(app, scale, machine spec, pricing
value-tag, search knobs)``, so its winner is cacheable the same way the
:class:`~repro_torch.sim.price_cache.PriceCache` caches placement prices:
under a compact blake2b digest key, in an append-only file whose torn
tail drops cleanly.

Records are variable-length (a plan payload is a JSON document: winner
candidate, rendered Mapple source, IR, full leaderboard, provenance),
framed as::

    [16-byte key digest][u32 payload length][payload utf-8][crc32]

after an 8-byte ``RPLANS01`` magic, all in one file (``plans.log``)
under the cache root. The CRC covers key+payload, so a torn or
bit-flipped record is detected and the load stops there — the intact
prefix stays usable, the damaged tail re-tunes live, and the next write
rewrites the file whole from the intact records (self-healing, same
contract as the price cache). Duplicate keys are idempotent re-asserts.

Besides exact ``get(key)`` hits, the cache keeps a per-app index of
``(procs, key)`` pairs so :meth:`nearest` can surface the plans closest
in scale to a near-miss request — the seeds of the service's
warm-started beam search (``tune_app(warm_start=...)``).

A cache built with ``root=None`` is memory-only (a service without
``--cache-dir`` still dedupes within its own lifetime). Every live
instance is registered with :func:`repro_torch.sim.collectives.register_cache`
so ``clear_caches()`` / ``cache_stats()`` cover plan caches alongside
schedule memos, the torch engine's exports and price caches: clearing drops the
in-memory mirror (the disk store survives and reloads on next access —
that persistence is the point), stats aggregate hit/miss/write/dropped
counters.
"""
from __future__ import annotations

import json
import math
import struct
import threading
import weakref
import zlib
from pathlib import Path

from repro_torch.sim.collectives import register_cache
from repro_torch.sim.price_cache import DIGEST_BYTES, digest

_MAGIC = b"RPLANS01"
_HEAD = struct.Struct(f"<{DIGEST_BYTES}sI")     # key digest + payload length
_CRC = struct.Struct("<I")

_INSTANCES: "weakref.WeakSet[PlanCache]" = weakref.WeakSet()
_STAT_KEYS = ("hits", "misses", "writes", "dropped")


def plan_key(app: str, procs: int, spec_repr: str, value_tag: str,
             knobs: tuple = ()) -> bytes:
    """The canonical plan-cache key digest: application name, processor
    count, the machine spec's repr (the same spec digest the price cache
    tables use), the pricing engine's bit-stability tag, and whatever
    search knobs change the result (beam width, sim steps, ...)."""
    return digest(
        app.encode(),
        repr(int(procs)).encode(),
        spec_repr.encode(),
        value_tag.encode(),
        repr(tuple(knobs)).encode(),
    )


class PlanCache:
    """Append-only on-disk store of ``plan key -> payload dict``.

    Payloads must be JSON-serializable dicts; payloads carrying ``app``
    (str) and ``procs`` (int) fields additionally join the per-app
    nearest-scale index behind :meth:`nearest`.
    """

    def __init__(self, root: str | Path | None) -> None:
        self.root = Path(root) if root is not None else None
        if self.root is not None:
            self.root.mkdir(parents=True, exist_ok=True)
        self._plans: dict[bytes, dict] = {}
        self._by_app: dict[str, list[tuple[int, bytes]]] = {}
        self._loaded = self.root is None
        self._damaged = False
        self._lock = threading.Lock()
        self.stats_counters = {k: 0 for k in _STAT_KEYS}
        _INSTANCES.add(self)

    # ------------------------------------------------------------------ io
    @property
    def path(self) -> Path | None:
        return None if self.root is None else self.root / "plans.log"

    def _index(self, key: bytes, payload: dict) -> None:
        app, procs = payload.get("app"), payload.get("procs")
        if isinstance(app, str) and isinstance(procs, int):
            self._by_app.setdefault(app, []).append((procs, key))

    def _ensure_loaded(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        try:
            blob = self.path.read_bytes()
        except OSError:
            return
        if not blob.startswith(_MAGIC):
            # Foreign file or stale format: treated as empty, rewritten
            # whole on the next put.
            self.stats_counters["dropped"] += 1
            self._damaged = bool(blob)
            return
        off = len(_MAGIC)
        while off < len(blob):
            if off + _HEAD.size > len(blob):
                self.stats_counters["dropped"] += 1
                self._damaged = True
                return
            key, size = _HEAD.unpack_from(blob, off)
            end = off + _HEAD.size + size + _CRC.size
            if size > len(blob) or end > len(blob):
                self.stats_counters["dropped"] += 1
                self._damaged = True
                return
            raw = blob[off + _HEAD.size:off + _HEAD.size + size]
            (crc,) = _CRC.unpack_from(blob, off + _HEAD.size + size)
            if crc != zlib.crc32(key + raw):
                # Torn/corrupt record: keep the intact prefix, drop the
                # rest — those keys simply re-tune live.
                self.stats_counters["dropped"] += 1
                self._damaged = True
                return
            try:
                payload = json.loads(raw.decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError):
                self.stats_counters["dropped"] += 1
                self._damaged = True
                return
            if key not in self._plans:
                self._plans[key] = payload
                self._index(key, payload)
            off = end

    @staticmethod
    def _record(key: bytes, payload: dict) -> bytes:
        raw = json.dumps(payload, sort_keys=True).encode("utf-8")
        return (_HEAD.pack(key, len(raw)) + raw
                + _CRC.pack(zlib.crc32(key + raw)))

    # -------------------------------------------------------------- access
    def get(self, key: bytes) -> dict | None:
        """The cached plan payload for one key digest, or None."""
        with self._lock:
            self._ensure_loaded()
            payload = self._plans.get(key)
            if payload is None:
                self.stats_counters["misses"] += 1
                return None
            self.stats_counters["hits"] += 1
            return dict(payload)

    def put(self, key: bytes, payload: dict) -> None:
        """Insert one plan and append it to disk (idempotent: an
        already-present key is a no-op — append-only files never restate
        a record)."""
        with self._lock:
            self._ensure_loaded()
            if key in self._plans:
                return
            payload = dict(payload)
            self._plans[key] = payload
            self._index(key, payload)
            self.stats_counters["writes"] += 1
            if self.path is None:
                return
            if self._damaged:
                # Appending past a tear would be unreadable (loads stop
                # at the damage), so rewrite the file whole from the
                # intact records — the write heals the store.
                blob = _MAGIC + b"".join(
                    self._record(k, p) for k, p in self._plans.items())
                self.path.write_bytes(blob)
                self._damaged = False
            else:
                header = b"" if self.path.exists() else _MAGIC
                with open(self.path, "ab") as fh:
                    fh.write(header + self._record(key, payload))

    def nearest(self, app: str, procs: int, *, count: int = 2,
                exclude: bytes | None = None) -> list[dict]:
        """The ``count`` cached plans for ``app`` nearest in scale to
        ``procs`` (log-ratio distance, ties to the smaller scale) —
        warm-start seed material for a near-miss request. ``exclude``
        drops one key (the requester's own, already known to miss)."""
        with self._lock:
            self._ensure_loaded()
            entries = self._by_app.get(app, ())
            ranked = sorted(
                (abs(math.log(max(p, 1) / max(procs, 1))), p, key)
                for p, key in entries
                if exclude is None or key != exclude
            )
            return [dict(self._plans[key]) for _, _, key in ranked[:count]]

    # ------------------------------------------------------------ lifecycle
    def clear(self) -> None:
        """Drop the in-memory mirror and zero counters; the disk store is
        untouched (the next access reloads it). A memory-only cache
        loses its plans — it has no disk to reload from."""
        with self._lock:
            self._plans.clear()
            self._by_app.clear()
            self._loaded = self.root is None
            self._damaged = False
            for k in self.stats_counters:
                self.stats_counters[k] = 0

    def stats(self) -> dict:
        with self._lock:
            return {**self.stats_counters, "plans": len(self._plans)}


def _caches_clear() -> None:
    for cache in list(_INSTANCES):
        cache.clear()


def _caches_stats() -> dict:
    out = {k: 0 for k in _STAT_KEYS}
    out["plans"] = 0
    for cache in list(_INSTANCES):
        for k, v in cache.stats().items():
            out[k] += v
    return out


register_cache("plan_cache", _caches_clear, _caches_stats)

__all__ = ["PlanCache", "plan_key"]
