"""Plan-result cache: terminal-op results memoized by content identity.

Mirrors :mod:`repro.core.plancache`.  Repeated interactive analysis re-runs
the same terminal ops over the same traces, and for an out-of-core handle
every re-run is a full re-read of the stream.  This cache memoizes
terminal-op results keyed by a digest of

    (trace content identity, fused plan steps, op identity, args, kwargs)

so a repeated call returns the stored result object without touching the
data or launching a kernel.  Entries are shared process-wide: two handles
opened on the same files hit the same entry.

The port's ops run on a device, and a result the card computed has other
last bits than the CPU's plain versions: the resolved device is part of
every key (the query terminal passes it among the op's ``kwargs``, and
:func:`_norm` digests a ``torch.device`` by its name), so a card result
never answers a CPU call or the reverse.

Content identity is what makes this safe:

* **streaming / scan sources**: the (path, size, mtime_ns, inode) of every
  input file, or a pack's stored content id, plus the handle's read
  configuration and its ``fold`` mode (a fold result is within the gate
  of a buffered one, not its bits, so one never answers the other).  On
  by default (``Trace.open(..., streaming=True, cache=False)`` or a
  per-call ``op(..., cache=False)`` opts out).
* **in-memory traces**: a SHA-256 over the trace's base event columns,
  O(N) per call, so **opt-in** per call (``trace.query().flat_profile(
  cache=True)``).

Anything without an exact digest (callables, custom plan steps, exotic
values) bypasses the cache rather than risking a wrong hit.  ``clear()``
is the explicit invalidation; ``configure(enabled=False)`` turns the layer
off.  Hits return the *same object* that was stored: treat cached results
as read-only.

The live store (:func:`live_lookup` / :func:`live_store` /
:func:`live_invalidate`) keeps a live handle's running aggregation state
across growth (:mod:`repro_torch.core.streaming`, ``LiveTrace``).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["lookup", "store", "plan_key", "clear", "configure", "stats",
           "live_lookup", "live_store", "live_invalidate", "live_plan_key"]

_MAX_ENTRIES = 128
_ENABLED = True
_TENANT_QUOTA: Optional[int] = None  # max entries per tenant; None = no cap
_CACHE: "OrderedDict[str, Any]" = OrderedDict()
_OWNER: Dict[str, str] = {}          # key -> tenant (tagged entries only)
_TENANT_KEYS: Dict[str, "OrderedDict[str, None]"] = {}  # tenant -> key LRU
_HITS = 0
_MISSES = 0
_EVICTIONS = 0
_TENANT_STATS: Dict[str, Dict[str, int]] = {}

# Live incremental partials, keyed by live_plan_key: a re-query after the
# trace grows folds only the new rows into the stored partial.  Validity is
# checked against per-path prefix fingerprints stored inside the entry, not
# by the key: the same key matches across growth.  An entry holds an
# aggregator's record buffer (millions of records at 10M events), so the
# store is small.
_LIVE: "OrderedDict[str, Any]" = OrderedDict()
_LIVE_MAX = 32
_LIVE_HITS = 0
_LIVE_MISSES = 0
_LIVE_INVALIDATIONS = 0

# One reentrant lock guards every counter and index map: the trace-query
# service looks up and stores from lane threads while its event loop reads
# stats().
_LOCK = threading.RLock()


class _Undigestable(Exception):
    """A key component has no exact digest; bypass the cache."""


def _tenant_stats(tenant: str) -> Dict[str, int]:
    st = _TENANT_STATS.get(tenant)
    if st is None:
        st = _TENANT_STATS[tenant] = {"entries": 0, "hits": 0, "misses": 0,
                                      "evictions": 0}
    return st


def _forget(key: str) -> None:
    """Drop ``key``'s tenant bookkeeping (the caller popped _CACHE)."""
    tenant = _OWNER.pop(key, None)
    if tenant is not None:
        keys = _TENANT_KEYS.get(tenant)
        if keys is not None:
            keys.pop(key, None)
        st = _tenant_stats(tenant)
        st["entries"] = max(st["entries"] - 1, 0)
        st["evictions"] += 1


def _evict_oldest() -> None:
    global _EVICTIONS
    key, _ = _CACHE.popitem(last=False)
    _forget(key)
    _EVICTIONS += 1


def configure(enabled: Optional[bool] = None,
              max_entries: Optional[int] = None,
              tenant_quota: Optional[int] = None) -> None:
    """Adjust the cache globally (``enabled=False`` disables lookups and
    stores; ``max_entries`` bounds the LRU; ``tenant_quota`` caps the
    entries one tenant tag may hold, 0 or less removes the cap)."""
    global _ENABLED, _MAX_ENTRIES, _TENANT_QUOTA
    with _LOCK:
        if enabled is not None:
            _ENABLED = bool(enabled)
        if max_entries is not None:
            _MAX_ENTRIES = max(int(max_entries), 1)
            while len(_CACHE) > _MAX_ENTRIES:
                _evict_oldest()
        if tenant_quota is not None:
            _TENANT_QUOTA = int(tenant_quota) if tenant_quota > 0 else None
            if _TENANT_QUOTA is not None:
                for tenant in list(_TENANT_KEYS):
                    _shrink_tenant(tenant)


def _shrink_tenant(tenant: str) -> None:
    global _EVICTIONS
    keys = _TENANT_KEYS.get(tenant)
    if keys is None or _TENANT_QUOTA is None:
        return
    while len(keys) > _TENANT_QUOTA:
        key, _ = keys.popitem(last=False)
        _CACHE.pop(key, None)
        _OWNER.pop(key, None)
        st = _tenant_stats(tenant)
        st["entries"] = max(st["entries"] - 1, 0)
        st["evictions"] += 1
        _EVICTIONS += 1


def clear() -> None:
    """Drop every cached result, live partials included.  Counters and
    per-tenant tallies survive; only the entries go."""
    with _LOCK:
        _CACHE.clear()
        _OWNER.clear()
        _TENANT_KEYS.clear()
        _LIVE.clear()
        for st in _TENANT_STATS.values():
            st["entries"] = 0


def stats() -> dict:
    """Cache counters: entries, hits, misses, evictions, limits, the live
    store's, and per-tenant usage of tagged entries (the service's)."""
    with _LOCK:
        return {"entries": len(_CACHE), "hits": _HITS, "misses": _MISSES,
                "evictions": _EVICTIONS, "max_entries": _MAX_ENTRIES,
                "enabled": _ENABLED, "tenant_quota": _TENANT_QUOTA,
                "live_entries": len(_LIVE), "live_hits": _LIVE_HITS,
                "live_misses": _LIVE_MISSES,
                "live_invalidations": _LIVE_INVALIDATIONS,
                "tenants": {t: dict(st) for t, st in _TENANT_STATS.items()}}


def live_lookup(key: str) -> Any:
    """The stored incremental partial for ``key``, or None.  The caller
    checks its validity (the prefix fingerprints live in the entry)."""
    global _LIVE_HITS, _LIVE_MISSES
    with _LOCK:
        ent = _LIVE.get(key)
        if ent is not None:
            _LIVE.move_to_end(key)
            _LIVE_HITS += 1
            return ent
        _LIVE_MISSES += 1
        return None


def live_store(key: str, entry: Any) -> None:
    with _LOCK:
        _LIVE[key] = entry
        _LIVE.move_to_end(key)
        while len(_LIVE) > _LIVE_MAX:
            _LIVE.popitem(last=False)


def live_invalidate(key: Optional[str] = None) -> None:
    """Drop one live partial (or all of them): a shard's committed prefix
    stopped extending the folded one (a file was replaced or truncated),
    or the caller asked."""
    global _LIVE_INVALIDATIONS
    with _LOCK:
        if key is None:
            _LIVE_INVALIDATIONS += len(_LIVE)
            _LIVE.clear()
        elif _LIVE.pop(key, None) is not None:
            _LIVE_INVALIDATIONS += 1


def lookup(key: str, tenant: Optional[str] = None) -> Tuple[bool, Any]:
    """(hit, value) for ``key``; a hit refreshes LRU order.  ``tenant``
    attributes the hit or miss to that tenant's counters."""
    global _HITS, _MISSES
    with _LOCK:
        if key in _CACHE:
            _CACHE.move_to_end(key)
            if tenant is not None:
                keys = _TENANT_KEYS.get(tenant)
                if keys is not None and key in keys:
                    keys.move_to_end(key)
                _tenant_stats(tenant)["hits"] += 1
            _HITS += 1
            return True, _CACHE[key]
        _MISSES += 1
        if tenant is not None:
            _tenant_stats(tenant)["misses"] += 1
        return False, None


def store(key: str, value: Any, tenant: Optional[str] = None) -> None:
    """Insert ``key``.  With a ``tenant`` tag the entry counts toward that
    tenant's quota (its oldest tagged entry goes beyond it); untagged
    entries face only the global LRU bound."""
    with _LOCK:
        if key in _CACHE:
            _CACHE[key] = value
            _CACHE.move_to_end(key)
            return
        _CACHE[key] = value
        if tenant is not None:
            _OWNER[key] = tenant
            _TENANT_KEYS.setdefault(tenant, OrderedDict())[key] = None
            _tenant_stats(tenant)["entries"] += 1
            _shrink_tenant(tenant)
        while len(_CACHE) > _MAX_ENTRIES:
            _evict_oldest()


# ---------------------------------------------------------------------------
# key construction
# ---------------------------------------------------------------------------

def _norm(v) -> Any:
    """One argument value as a deterministic, repr-stable token; raises
    _Undigestable for anything without an exact digest.  A
    ``torch.device`` digests as its name (``cuda``, ``cuda:0``, ``cpu``)."""
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return v
    if isinstance(v, torch.device):
        return ("device", str(v))
    if isinstance(v, (np.integer, np.floating, np.bool_)):
        return v.item()
    if isinstance(v, (list, tuple)):
        return tuple(_norm(x) for x in v)
    if isinstance(v, (set, frozenset)):
        return tuple(sorted((_norm(x) for x in v), key=repr))
    if isinstance(v, dict):
        return tuple(sorted(((str(k), _norm(x)) for k, x in v.items())))
    if isinstance(v, range):
        return ("range", v.start, v.stop, v.step)
    if isinstance(v, np.ndarray) and v.size <= 4096:
        return ("ndarray", v.dtype.str, v.shape, v.tobytes())
    raise _Undigestable(type(v).__name__)


def _filter_token(f) -> tuple:
    from .filters import Filter, _And, _Not, _Or
    if isinstance(f, _And):
        return ("and", _filter_token(f.a), _filter_token(f.b))
    if isinstance(f, _Or):
        return ("or", _filter_token(f.a), _filter_token(f.b))
    if isinstance(f, _Not):
        return ("not", _filter_token(f.a))
    if type(f) is not Filter:
        raise _Undigestable(type(f).__name__)  # user Filter subclass
    return ("leaf", f.field, f.operator, _norm(f.value),
            getattr(f, "_trim", None))


def _steps_token(steps) -> tuple:
    from .query import FilterStep, ProcessStep, SliceTimeStep
    out = []
    for step in steps:
        if type(step) is FilterStep:
            out.append(("filter", _filter_token(step.filter)))
        elif type(step) is SliceTimeStep:
            out.append(("slice", float(step.start), float(step.end),
                        step.trim))
        elif type(step) is ProcessStep:
            out.append(("procs", tuple(int(p) for p in step.procs)))
        else:
            raise _Undigestable(type(step).__name__)
    return tuple(out)


def _stat_token(path: str) -> tuple:
    """A pack by its stored content id (copies and faithful rewrites share
    an entry, a re-pack with other content never hits a stale one), any
    other file by (path, size, mtime, inode)."""
    import os

    from ..readers.pack import content_id
    st = os.stat(path)
    cid = content_id(path)
    if cid is not None:
        return ("pipitpack", cid)
    return (path, st.st_size, st.st_mtime_ns, st.st_ino)


def _paths_token(paths) -> tuple:
    import os
    out = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in sorted(os.walk(p)):
                out.extend(_stat_token(os.path.join(root, f))
                           for f in sorted(files))
        else:
            out.append(_stat_token(p))
    return tuple(out)


def _content_token(trace) -> tuple:
    """SHA-256 over the trace's base (non-derived) event columns."""
    from .frame import Categorical
    from .query import _strip
    ev = _strip(trace.events)
    h = hashlib.sha256()
    for name in ev.columns:
        col = ev.column(name)
        h.update(name.encode())
        if isinstance(col, Categorical):
            h.update(np.ascontiguousarray(col.codes).tobytes())
            h.update("\x00".join(map(str, col.categories)).encode())
        else:
            arr = np.asarray(col)
            if arr.dtype.kind == "O":
                raise _Undigestable(f"object column {name}")
            h.update(arr.dtype.str.encode())
            h.update(np.ascontiguousarray(arr).tobytes())
    return ("mem", len(ev), h.hexdigest())


def _source_token(source, cache_flag: Optional[bool]):
    """Identity token for a plan source, or None when this source is not
    cached under the per-call flag."""
    from .query import _ScanSource, _StreamSource, _TraceSource
    if isinstance(source, _StreamSource):
        h = source.handle
        if getattr(h, "is_live", False):
            # a live handle runs over a pinned committed-prefix snapshot:
            # a stat-keyed entry would go stale as soon as another handle
            # pins a newer one.  Live handles use the live store instead
            return None
        if cache_flag is None and not h.cache:
            return None
        return ("stream", _paths_token(h.paths), h.format, h.chunk_rows,
                h.executor, h.processes, h.fold, _norm(h.reader_kwargs),
                _steps_token(h._steps))
    if isinstance(source, _ScanSource):
        return ("scan", _paths_token(source.paths), source.format)
    if isinstance(source, _TraceSource):
        # hashing an in-memory trace costs a full pass: only on request
        if not cache_flag:
            return None
        return _content_token(source.trace)
    return None  # unknown source kinds are never cached


def _op_token(spec) -> tuple:
    fn = spec.fn
    return (spec.name,
            f"{getattr(fn, '__module__', '')}."
            f"{getattr(fn, '__qualname__', '')}" if fn is not None else "")


def plan_key(source, steps, spec, args: tuple, kwargs: dict,
             cache_flag: Optional[bool]) -> Optional[str]:
    """Digest of one terminal-op execution, or None to bypass the cache.

    ``kwargs`` are the op's own, the resolved ``device`` among them.
    ``cache_flag`` is the per-call ``cache=``: False bypasses, True opts
    an in-memory trace in, None applies the defaults (streaming and scan
    sources cached, in-memory not)."""
    if not _ENABLED or cache_flag is False:
        return None
    try:
        src = _source_token(source, cache_flag)
        if src is None:
            return None
        token = (src, _steps_token(steps), _op_token(spec), _norm(args),
                 _norm(kwargs))
    except (_Undigestable, OSError):
        return None
    return hashlib.sha256(repr(token).encode()).hexdigest()


def live_plan_key(handle, steps, spec, args: tuple, kwargs: dict
                  ) -> Optional[str]:
    """Digest naming one live plan *across growth*: the handle's paths,
    read configuration and ``fold`` mode, the plan, op and arguments (the
    device among them), and deliberately no stat or content token, so the
    key survives the files growing.  Whether the new prefix extends the
    folded one is checked against fingerprints inside the entry.  None
    when a component has no exact digest."""
    import os
    if not _ENABLED:
        return None
    try:
        rk = {k: v for k, v in handle.reader_kwargs.items()
              if k not in ("live", "upto_rows", "report")}
        token = ("live",
                 tuple(os.path.abspath(p) for p in handle.paths),
                 handle.format, handle.chunk_rows, handle.processes,
                 handle.fold, _norm(rk), _steps_token(handle._steps),
                 _steps_token(steps), _op_token(spec), _norm(args),
                 _norm(kwargs))
    except (_Undigestable, OSError):
        return None
    return hashlib.sha256(repr(token).encode()).hexdigest()
