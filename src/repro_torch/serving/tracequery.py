"""Multi-tenant trace-query service: an asyncio server over pack-backed
trace handles whose ops run on the card.

Mirrors :mod:`repro.serving.tracequery`.  One long-lived process holds a
pool of open :class:`~repro_torch.core.trace.Trace` /
:class:`~repro_torch.core.streaming.StreamingTrace` /
:class:`~repro_torch.core.streaming.LiveTrace` handles (pack maps stay
warm), runs client-submitted plans against them on the device the
service was started with, and returns columnar results over a JSON/HTTP
protocol that needs only the standard library
(:mod:`repro_torch.serving.protocol`).  Three mechanisms make it
multi-tenant:

* **handle pool**: handles are keyed by their open spec and revalidated by
  *content identity* (a pack's content id, ``(path, size, mtime, inode)``
  otherwise) on every request, LRU-bounded; a pack rewritten on disk is
  reopened at the next query.
* **single-flight coalescing**: identical in-flight plans (same source
  identity, steps, op, arguments, device) run **once**; concurrent
  duplicates await the same future.  The key also keys the shared
  :mod:`~repro_torch.core.plancache`: the first request runs, concurrent
  ones coalesce, later ones hit the cache and launch nothing.
* **admission control**: a bounded number of requests at once, a
  concurrency limit and a plan-cache quota per tenant, and execution
  threads from the shared :class:`~repro_torch.core.scheduler.Scheduler`
  lanes: interactive (windowed) queries run on reserved threads a bulk
  full scan can never occupy.  Saturation is an immediate HTTP 429.

Lane threads launch the ops' kernels on the card themselves: a thread that
cannot (no card, a failed build, a launch error) fails its request with a
500; nothing moves to the CPU behind the caller's back.

The HTTP surface (``asyncio.start_server`` and hand-written HTTP/1.1 with
keep-alive): ``POST /query`` and ``POST /setquery`` (a ``TraceSet``
opened with ``mode: "set"``, for the comparison ops) run plans, ``POST
/diagnose`` runs the detector suite (sugar over ``/query`` that forces the
``diagnose`` terminal), ``POST /live`` polls a watermarked live session
over still-growing shards (429 ``watermark_stalled`` when the watermark
has not advanced; 206 partial responses naming the missing ranks of a
degraded fleet), ``GET /stats``, ``GET /ops``, ``GET /health`` and ``POST
/shutdown`` (a graceful drain).  A set member may be one path or a list
of per-rank shard paths, as ``TraceSet.open`` takes them.  An open
spec's ``"fold"`` (``"once"``, the default, or ``"chunks"``; streaming,
set of streaming members, live and liveset specs) is the handle's
``fold=``: part of the handle pool's key and of every request key.
:mod:`repro_torch.serving.client` wraps the protocol in the library's own
query-chain API.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import threading
import time
import traceback
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from ..core import plancache, registry
from ..core.accel import resolve_device
from ..core.cancellation import CancelToken, cancel_scope
from ..core.scheduler import Scheduler, get_scheduler
from ..core.streaming import FOLD_MODES
from . import protocol
from .protocol import ProtocolError, canonical_json

__all__ = ["ServiceError", "HandlePool", "TraceService", "TraceServer",
           "serve"]

_JSON_HEADERS = "Content-Type: application/json\r\n"


class ServiceError(Exception):
    """A request the service refuses; carries the HTTP status and a stable
    machine-readable code clients can branch on.  ``extra`` (optional
    dict) is merged into the wire error body — e.g. ``retry_after_ms`` on
    a live-session stall."""

    def __init__(self, status: int, code: str, message: str,
                 extra: Optional[dict] = None):
        super().__init__(message)
        self.status = status
        self.code = code
        self.extra = extra or {}


# ---------------------------------------------------------------------------
# handle pool
# ---------------------------------------------------------------------------

class _Handle:
    """One open trace source: the handle object plus the bookkeeping the
    pool and the executor need (identity for staleness checks, a lock for
    sources whose lazy materialization mutates shared state)."""

    def __init__(self, key: str, kind: str, obj, ident: tuple):
        self.key = key
        self.kind = kind    # "trace" | "stream" | "set" | "live" | "liveset"
        self.obj = obj
        self.ident = ident          # _paths_token at open time
        self.lock = threading.Lock()
        self.opened_at = time.time()
        self.uses = 0

    def query(self):
        return self.obj.query()

    @property
    def serialized(self) -> bool:
        """Whether executions on this handle must hold :attr:`lock`.

        Eager traces materialize derived structure *in place* on first
        use, and set preparation does the same per member: concurrent runs
        would race those writes.  Streaming handles only carry idempotent
        caches (chunk stats, work-unit plans), so concurrent plans over one
        pack handle are safe — that is what lets the interactive lane make
        progress while bulk scans hammer the same pack.  Live handles serialize too: ``refresh()`` moves the pinned
        snapshot and the incremental fold mutates a running aggregate.
        """
        return self.kind != "stream"


def _normalize_open(spec: Any, live: bool = False) -> dict:
    """Validate and normalize a wire ``open`` spec into canonical form;
    ``live`` (``/live``) reads a bare ``"trace"`` spec as ``"live"``.
    ``"fold"`` is always written (``"once"`` when absent), so an absent
    key and ``"once"`` key one handle."""
    if isinstance(spec, str):
        spec = {"path": spec}
    if not isinstance(spec, dict):
        raise ProtocolError(f"open spec must be a path or object, "
                            f"got {type(spec).__name__}")
    paths = spec.get("paths")
    if paths is None:
        p = spec.get("path")
        if p is None:
            raise ProtocolError('open spec needs "path" or "paths"')
        paths = [p]
    mode = spec.get("mode", "trace")
    if mode not in ("trace", "set", "live", "liveset"):
        raise ProtocolError(f'open mode must be "trace", "set", "live" or '
                            f'"liveset", got {mode!r}')
    if live and mode == "trace":
        mode = "live"   # a bare path on /live means live

    def member(p) -> bool:
        # a set member may be one path or a list of per-rank shards
        if mode == "set" and isinstance(p, (list, tuple)):
            return bool(p) and all(isinstance(q, str) for q in p)
        return isinstance(p, str)

    if (not isinstance(paths, (list, tuple)) or not paths
            or not all(member(p) for p in paths)):
        raise ProtocolError(f'open spec "paths" must be a non-empty list '
                            f'of strings, got {paths!r}')
    if mode == "liveset" and len(paths) != 1:
        raise ProtocolError('mode "liveset" takes exactly one path: the '
                            'shard directory')
    fold = spec.get("fold", "once")
    if fold not in FOLD_MODES:
        raise ProtocolError(f'"fold" must be one of {list(FOLD_MODES)}, '
                            f'got {fold!r}')
    streaming = bool(spec.get("streaming", False))
    if fold != "once" and mode in ("trace", "set") and not streaming:
        raise ProtocolError('"fold" only applies to a streaming or live '
                            'spec ("streaming": true, or mode "live" or '
                            '"liveset")')
    labels = spec.get("labels")
    if labels is not None and (not isinstance(labels, (list, tuple))
                               or len(labels) != len(paths)):
        raise ProtocolError('"labels" must match "paths" in length')
    out = {
        "mode": mode,
        "paths": [str(p) if isinstance(p, str) else [str(q) for q in p]
                  for p in paths],
        "format": str(spec.get("format", "auto")),
        "streaming": streaming,
        "fold": fold,
        "chunk_rows": (int(spec["chunk_rows"])
                       if spec.get("chunk_rows") is not None else None),
        "processes": (int(spec["processes"])
                      if spec.get("processes") is not None else None),
        "executor": str(spec.get("executor", "auto")),
        "labels": [str(x) for x in labels] if labels is not None else None,
    }
    if mode == "liveset":
        out["pattern"] = str(spec.get("pattern", "rank_*.pack"))
        out["lag_timeout"] = float(spec.get("lag_timeout", 2.0))
        out["dead_timeout"] = float(spec.get("dead_timeout", 10.0))
    return out


class HandlePool:
    """LRU pool of open trace handles keyed by open spec + content
    identity, every handle on ``device``.

    ``get()`` revalidates the stored identity (pack content id / stat
    token) on every call — a handle whose backing files changed on disk
    is silently reopened, so long-lived services never serve stale mmaps.
    Opens run under the pool lock (they mutate the LRU); callers should
    invoke ``get()`` off the event loop for sources with slow opens.
    """

    def __init__(self, max_handles: int = 8, breaker_threshold: int = 3,
                 breaker_cooldown: float = 30.0, device="cuda"):
        self.device = resolve_device(device)
        self.max_handles = max(int(max_handles), 1)
        self.breaker_threshold = max(int(breaker_threshold), 1)
        self.breaker_cooldown = float(breaker_cooldown)
        self._lock = threading.Lock()
        self._handles: "OrderedDict[str, _Handle]" = OrderedDict()
        self._fails: Dict[str, dict] = {}  # key -> consecutive open failures
        self.opens = 0
        self.reopens = 0
        self.evictions = 0
        self.breaker_trips = 0
        self.breaker_fastfails = 0

    def _ident(self, paths: List) -> tuple:
        from ..core.plancache import _paths_token
        return _paths_token([q for p in paths
                             for q in ([p] if isinstance(p, str) else p)])

    def _open(self, spec: dict):
        from ..core.diff import TraceSet
        from ..core.trace import Trace
        dev = self.device
        if spec["mode"] == "live":
            from ..core.streaming import DEFAULT_CHUNK_ROWS, LiveTrace
            return "live", LiveTrace(
                spec["paths"], format=spec["format"],
                chunk_rows=spec["chunk_rows"] or DEFAULT_CHUNK_ROWS,
                processes=spec["processes"], executor=spec["executor"],
                device=dev, fold=spec["fold"])
        if spec["mode"] == "liveset":
            from ..core.liveset import LiveTraceSet
            return "liveset", LiveTraceSet(
                spec["paths"][0], pattern=spec["pattern"],
                lag_timeout=spec["lag_timeout"],
                dead_timeout=spec["dead_timeout"],
                chunk_rows=spec["chunk_rows"],
                processes=spec["processes"], executor=spec["executor"],
                device=dev, fold=spec["fold"])
        if spec["mode"] == "set":
            return "set", TraceSet.open(
                spec["paths"], format=spec["format"],
                processes=spec["processes"], labels=spec["labels"],
                streaming=spec["streaming"], chunk_rows=spec["chunk_rows"],
                device=dev,
                fold=spec["fold"] if spec["streaming"] else None)
        if spec["streaming"]:
            src = (spec["paths"][0] if len(spec["paths"]) == 1
                   else spec["paths"])
            return "stream", Trace.open(
                src, format=spec["format"], streaming=True,
                chunk_rows=spec["chunk_rows"], processes=spec["processes"],
                executor=spec["executor"], device=dev, fold=spec["fold"])
        if len(spec["paths"]) > 1:
            return "trace", Trace.open(spec["paths"],
                                       format=spec["format"],
                                       processes=spec["processes"],
                                       device=dev)
        return "trace", Trace.open(spec["paths"][0], format=spec["format"],
                                   device=dev)

    def _salvage_hint(self, spec: dict) -> str:
        p = spec["paths"][0] if spec["paths"] else "<path>"
        return (f"if the source is a damaged pack, inspect it with "
                f"`python -m repro_torch.launch.pack --verify {p}` and "
                f"recover with `--repair`, or reopen with "
                f"on_error=\"salvage\"")

    def get(self, spec: dict) -> _Handle:
        """The live handle for ``spec`` (opening or reopening as needed).

        Repeatedly-failing opens trip a per-spec circuit breaker: after
        ``breaker_threshold`` consecutive failures, requests fast-fail
        with 422 ``source_corrupt`` (and a salvage hint) for
        ``breaker_cooldown`` seconds instead of re-burning a lane thread
        on a source that cannot open.  One probe is admitted when the
        cooldown lapses; a successful open resets the breaker."""
        key = hashlib.sha256(canonical_json(spec).encode()).hexdigest()
        try:
            ident = self._ident(spec["paths"])
        except OSError as e:
            if spec.get("mode") in ("live", "liveset"):
                # a live shard that hasn't appeared yet reads as empty —
                # not an error; identity settles once data arrives
                ident = ("live-pending",) + tuple(spec["paths"])
            else:
                raise ServiceError(404, "no_such_trace",
                                   f"cannot stat trace source: {e}") \
                    from None
        with self._lock:
            b = self._fails.get(key)
            if (b is not None and b["fails"] >= self.breaker_threshold
                    and time.time() < b["until"]):
                self.breaker_fastfails += 1
                raise ServiceError(
                    422, "source_corrupt",
                    f"open failed {b['fails']} consecutive times "
                    f"(last: {b['last']}); circuit open for another "
                    f"{b['until'] - time.time():.1f}s — "
                    + self._salvage_hint(spec))
            h = self._handles.get(key)
            if h is not None and (h.ident == ident
                                  or h.kind in ("live", "liveset")):
                # live handles are never reopened on identity drift — the
                # backing shards *grow by design*; the live() path calls
                # obj.refresh() to advance the pinned snapshot in place,
                # which preserves the incremental aggregate state a
                # reopen would discard
                self._handles.move_to_end(key)
                h.uses += 1
                h.ident = ident
                self._fails.pop(key, None)
                return h
            stale = h is not None
            try:
                kind, obj = self._open(spec)
            except (OSError, ValueError) as e:
                b = self._fails.setdefault(
                    key, {"fails": 0, "until": 0.0, "last": ""})
                b["fails"] += 1
                b["last"] = f"{type(e).__name__}: {e}"
                b["until"] = time.time() + self.breaker_cooldown
                if b["fails"] == self.breaker_threshold:
                    self.breaker_trips += 1
                if b["fails"] >= self.breaker_threshold:
                    raise ServiceError(
                        422, "source_corrupt",
                        f"open failed {b['fails']} consecutive times "
                        f"(last: {b['last']}) — "
                        + self._salvage_hint(spec)) from None
                raise ServiceError(404, "open_failed",
                                   f"cannot open trace source: {e}") from None
            self._fails.pop(key, None)
            h = _Handle(key, kind, obj, ident)
            h.uses = 1
            self._handles[key] = h
            self._handles.move_to_end(key)
            self.opens += 1
            if stale:
                self.reopens += 1
            while len(self._handles) > self.max_handles:
                self._handles.popitem(last=False)
                self.evictions += 1
            return h

    def stats(self) -> dict:
        with self._lock:
            now = time.time()
            return {"open": len(self._handles),
                    "max_handles": self.max_handles,
                    "device": str(self.device),
                    "opens": self.opens, "reopens": self.reopens,
                    "evictions": self.evictions,
                    "breaker_trips": self.breaker_trips,
                    "breaker_fastfails": self.breaker_fastfails,
                    "breaker_open": sum(
                        1 for b in self._fails.values()
                        if b["fails"] >= self.breaker_threshold
                        and now < b["until"]),
                    "handles": [{"kind": h.kind, "uses": h.uses,
                                 "key": h.key[:12]}
                                for h in self._handles.values()]}

    def clear(self) -> None:
        with self._lock:
            self._handles.clear()
            self._fails.clear()


# ---------------------------------------------------------------------------
# the service (transport-independent core)
# ---------------------------------------------------------------------------

class _Flight:
    """One in-flight execution other requests can coalesce onto."""

    def __init__(self, future: "asyncio.Future"):
        self.future = future
        self.waiters = 0


class TraceService:
    """Decodes wire requests, admits them, and executes plans over pooled
    handles whose ops run on ``device`` (the card unless the caller asks
    for the CPU).  Transport-independent: :class:`TraceServer` feeds it
    parsed JSON bodies; tests can call :meth:`query` directly."""

    def __init__(self, *, device="cuda",
                 scheduler: Optional[Scheduler] = None,
                 max_handles: int = 8, max_active: int = 32,
                 per_tenant: int = 4, tenant_quota: Optional[int] = None,
                 cache_entries: Optional[int] = None,
                 default_tenant: str = "public",
                 default_deadline: Optional[float] = None,
                 breaker_threshold: int = 3,
                 breaker_cooldown: float = 30.0):
        self.device = resolve_device(device)
        self.scheduler = scheduler or get_scheduler()
        self.handles = HandlePool(max_handles=max_handles,
                                  breaker_threshold=breaker_threshold,
                                  breaker_cooldown=breaker_cooldown,
                                  device=self.device)
        #: seconds allowed per request when the client sends no
        #: ``deadline_ms``; None = unbounded (the historical behavior)
        self.default_deadline = default_deadline
        self.max_active = max(int(max_active), 1)
        self.per_tenant = max(int(per_tenant), 1)
        self.default_tenant = default_tenant
        if tenant_quota is not None or cache_entries is not None:
            plancache.configure(max_entries=cache_entries,
                                tenant_quota=tenant_quota)
        self.draining = False
        self._active = 0
        self._idle = asyncio.Event()
        self._idle.set()
        self._flights: Dict[str, _Flight] = {}
        self._tenant_sems: Dict[str, asyncio.Semaphore] = {}
        self._tenant_waiting: Dict[str, int] = {}
        #: live polling sessions: (tenant, handle key, session id) →
        #: {rows, served_at, polls, stalls} — the watermark each session
        #: last saw, for min-advance admission / backpressure
        self._live_sessions: Dict[tuple, dict] = {}
        self.counters: Dict[str, int] = {
            "requests": 0, "executed": 0, "coalesced": 0, "cache_hits": 0,
            "rejected": 0, "errors": 0, "interactive": 0, "bulk": 0,
            "live_polls": 0, "live_stalled": 0, "live_partial": 0}
        self.tenant_counters: Dict[str, Dict[str, int]] = {}

    # -- bookkeeping -------------------------------------------------------
    def _tenant(self, payload: dict) -> str:
        t = payload.get("tenant")
        if t is not None and not isinstance(t, str):
            raise ProtocolError(f"tenant must be a string, got {t!r}")
        return t or self.default_tenant

    def _count(self, tenant: str, field: str) -> None:
        self.counters[field] = self.counters.get(field, 0) + 1
        st = self.tenant_counters.setdefault(
            tenant, {"requests": 0, "executed": 0, "coalesced": 0,
                     "cache_hits": 0, "rejected": 0, "errors": 0})
        st[field] = st.get(field, 0) + 1

    def _sem(self, tenant: str) -> asyncio.Semaphore:
        sem = self._tenant_sems.get(tenant)
        if sem is None:
            sem = self._tenant_sems[tenant] = asyncio.Semaphore(
                self.per_tenant)
        return sem

    # -- request decoding --------------------------------------------------
    def _decode(self, payload: dict, set_scope: bool = False):
        if not isinstance(payload, dict):
            raise ProtocolError("request body must be a JSON object")
        raw = payload.get("open")
        if set_scope:
            # /setquery opens a set whatever mode the spec names
            if isinstance(raw, str):
                raw = {"path": raw}
            if isinstance(raw, dict):
                raw = dict(raw, mode="set")
        open_spec = _normalize_open(raw)
        if not set_scope and open_spec["mode"] == "set":
            raise ProtocolError('mode "set" plans go to /setquery')
        if open_spec["mode"] in ("live", "liveset"):
            raise ProtocolError(
                f'mode {open_spec["mode"]!r} plans go to /live')
        op = payload.get("op")
        if not isinstance(op, str):
            raise ProtocolError('request needs an "op" name')
        spec = registry.get_op(op)
        if spec is None:
            raise ProtocolError(f"unknown analysis op {op!r}; registered: "
                                f"{registry.list_ops()}")
        if spec.scope == "set" and open_spec["mode"] != "set":
            raise ProtocolError(
                f"{op!r} is a multi-trace comparison op; submit it to "
                f"/setquery with a set open spec")
        steps = protocol.decode_steps(payload.get("steps") or [])
        args = tuple(protocol.decode_value(x)
                     for x in (payload.get("args") or []))
        kwargs_wire = payload.get("kwargs") or {}
        if not isinstance(kwargs_wire, dict):
            raise ProtocolError('"kwargs" must be an object')
        kwargs = {str(k): protocol.decode_value(v)
                  for k, v in kwargs_wire.items()}
        cache_flag = payload.get("cache")
        if cache_flag is not None and not isinstance(cache_flag, bool):
            raise ProtocolError('"cache" must be true/false/null')
        lane = payload.get("lane")
        if lane is None:
            # heuristic: windowed plans are interactive, full scans bulk
            lane = ("interactive"
                    if any(s.get("k") in ("slice_time", "restrict_processes")
                           for s in steps) else "bulk")
        if lane not in ("interactive", "bulk"):
            raise ProtocolError(f'lane must be "interactive" or "bulk", '
                                f'got {lane!r}')
        digest_only = bool(payload.get("digest_only", False))
        return open_spec, op, spec, steps, args, kwargs, cache_flag, \
            lane, digest_only

    def _wire_key(self, open_spec: dict, steps, op: str, payload: dict,
                  digest_only: bool) -> Optional[str]:
        """Single-flight + service-cache key: a digest of the request, the
        service's device and the *content identity* of its sources.  None when the sources
        cannot be identified (key construction already raised 404 in
        ``handles.get`` for missing files; this is only for exotic
        failures) — such requests execute uncoalesced and uncached."""
        try:
            ident = self.handles._ident(open_spec["paths"])
        except OSError:
            return None
        body = canonical_json({"open": open_spec, "ident": repr(ident),
                               "device": str(self.device),
                               "steps": steps, "op": op,
                               "args": payload.get("args") or [],
                               "kwargs": payload.get("kwargs") or {},
                               "digest_only": digest_only})
        return "serve:" + hashlib.sha256(body.encode()).hexdigest()

    # -- execution ---------------------------------------------------------
    def _execute(self, handle: _Handle, op: str, steps, args, kwargs,
                 cache_flag, digest_only: bool) -> dict:
        """Runs on a scheduler lane thread: build the plan over the pooled
        handle, execute, encode."""
        q = protocol.apply_steps(handle.query(), steps)
        kw = dict(kwargs)
        if handle.kind != "set" and cache_flag is not None:
            # forward the client's cache choice to the library-level plan
            # cache (streaming sources participate by default)
            kw["cache"] = cache_flag
        t0 = time.perf_counter()
        if handle.serialized:
            with handle.lock:
                value = q.run(op, *args, **kw)
        else:
            value = q.run(op, *args, **kw)
        elapsed = time.perf_counter() - t0
        out = {"ok": True, "digest": protocol.result_digest(value),
               "elapsed_ms": round(elapsed * 1e3, 3)}
        if not digest_only:
            out["result"] = protocol.encode_value(value)
        return out

    async def query(self, payload: dict, set_scope: bool = False) -> dict:
        """Execute one wire request; returns the JSON-able response body.
        Raises :class:`ServiceError` for refusals and
        :class:`ProtocolError` for malformed requests."""
        tenant = self._tenant(payload if isinstance(payload, dict) else {})
        self._count(tenant, "requests")
        if self.draining:
            self._count(tenant, "rejected")
            raise ServiceError(503, "draining",
                               "service is draining; no new queries")
        (open_spec, op, spec, steps, args, kwargs, cache_flag, lane,
         digest_only) = self._decode(payload, set_scope)
        deadline = payload.get("deadline_ms")
        if deadline is not None:
            if not isinstance(deadline, (int, float)) or deadline <= 0:
                raise ProtocolError(
                    f'"deadline_ms" must be a positive number, '
                    f'got {deadline!r}')
            deadline = float(deadline) / 1e3
        else:
            deadline = self.default_deadline
        self.counters[lane] += 1
        key = self._wire_key(open_spec, steps, op, payload, digest_only)

        # 1. shared plan cache (service layer: keyed by content identity)
        if key is not None and cache_flag is not False:
            hit, value = plancache.lookup(key, tenant=tenant)
            if hit:
                self._count(tenant, "cache_hits")
                return dict(value, cached=True, tenant=tenant)

        # 2. single-flight: identical in-flight plan → await its future
        if key is not None:
            flight = self._flights.get(key)
            if flight is not None:
                flight.waiters += 1
                self._count(tenant, "coalesced")
                result = await asyncio.shield(flight.future)
                return dict(result, coalesced=True, tenant=tenant)

        # 3. admission: global bound, then per-tenant concurrency
        if self._active >= self.max_active:
            self._count(tenant, "rejected")
            raise ServiceError(429, "saturated",
                               f"service at max_active={self.max_active}; "
                               f"retry later")
        waiting = self._tenant_waiting.get(tenant, 0)
        if waiting >= self.per_tenant * 4:
            self._count(tenant, "rejected")
            raise ServiceError(429, "tenant_saturated",
                               f"tenant {tenant!r} has {waiting} queued "
                               f"requests (limit {self.per_tenant * 4})")
        self._tenant_waiting[tenant] = waiting + 1
        try:
            await self._sem(tenant).acquire()
        finally:
            self._tenant_waiting[tenant] -= 1

        # the semaphore may have parked this task: an identical plan could
        # have taken off in the meantime — re-check before executing
        if key is not None:
            flight = self._flights.get(key)
            if flight is not None:
                self._sem(tenant).release()
                flight.waiters += 1
                self._count(tenant, "coalesced")
                result = await asyncio.shield(flight.future)
                return dict(result, coalesced=True, tenant=tenant)

        loop = asyncio.get_running_loop()
        future: "asyncio.Future" = loop.create_future()
        if key is not None:
            self._flights[key] = _Flight(future)
        self._active += 1
        self._idle.clear()
        self._count(tenant, "executed")
        token = CancelToken("request deadline exceeded")
        t_start = time.monotonic()

        async def _bounded(fn):
            """Run ``fn`` on the lane thread within the remaining deadline
            budget.  On expiry the 504 goes out immediately; the lane
            thread sees the cancelled token at its next chunk boundary
            and frees itself cooperatively."""
            aw = loop.run_in_executor(self.scheduler.lane(lane), fn)
            if deadline is None:
                return await aw
            remaining = deadline - (time.monotonic() - t_start)
            try:
                if remaining <= 0:
                    raise asyncio.TimeoutError
                return await asyncio.wait_for(aw, remaining)
            except asyncio.TimeoutError:
                token.cancel()
                aw.cancel()  # drop the abandoned wrapper (thread exits at
                # its next token check; its late result/exception is
                # discarded instead of logged)
                self.counters["deadline_exceeded"] = \
                    self.counters.get("deadline_exceeded", 0) + 1
                raise ServiceError(
                    504, "deadline_exceeded",
                    f"deadline of {deadline * 1e3:.0f} ms exceeded; "
                    f"execution cancelled at the next chunk boundary"
                ) from None

        def _exec(handle):
            with cancel_scope(token):
                return self._execute(handle, op, steps, args, kwargs,
                                     cache_flag, digest_only)

        try:
            handle = await _bounded(lambda: self.handles.get(open_spec))
            result = await _bounded(lambda: _exec(handle))
            if key is not None and cache_flag is not False:
                plancache.store(key, result, tenant=tenant)
            future.set_result(result)
            return dict(result, tenant=tenant)
        except BaseException as e:
            self._count(tenant, "errors")
            if not future.done():
                future.set_exception(e)
            # a coalesced waiter consuming the exception keeps it from
            # being flagged "never retrieved"
            future.exception()
            raise
        finally:
            if key is not None:
                self._flights.pop(key, None)
            self._sem(tenant).release()
            self._active -= 1
            if self._active == 0:
                self._idle.set()

    # -- live sessions -----------------------------------------------------
    def _decode_live(self, payload: dict):
        if not isinstance(payload, dict):
            raise ProtocolError("request body must be a JSON object")
        open_spec = _normalize_open(payload.get("open"), live=True)
        if open_spec["mode"] not in ("live", "liveset"):
            raise ProtocolError('/live takes mode "live" or "liveset"; '
                                'finalized sources go to /query')
        op = payload.get("op")
        if not isinstance(op, str):
            raise ProtocolError('request needs an "op" name')
        spec = registry.get_op(op)
        if spec is None:
            raise ProtocolError(f"unknown analysis op {op!r}; registered: "
                                f"{registry.list_ops()}")
        if spec.scope == "set":
            raise ProtocolError(
                f"{op!r} is a set-scoped op; live sessions execute "
                f"single-scope ops over the (combined) committed prefix")
        steps = protocol.decode_steps(payload.get("steps") or [])
        args = tuple(protocol.decode_value(x)
                     for x in (payload.get("args") or []))
        kwargs_wire = payload.get("kwargs") or {}
        if not isinstance(kwargs_wire, dict):
            raise ProtocolError('"kwargs" must be an object')
        kwargs = {str(k): protocol.decode_value(v)
                  for k, v in kwargs_wire.items()}
        min_advance = payload.get("min_advance_rows", 1)
        if not isinstance(min_advance, int) or min_advance < 0:
            raise ProtocolError('"min_advance_rows" must be a '
                                'non-negative integer')
        session = str(payload.get("session", "default"))
        digest_only = bool(payload.get("digest_only", False))
        return open_spec, op, steps, args, kwargs, min_advance, session, \
            digest_only

    def _poll_live(self, open_spec: dict, op: str, steps, args, kwargs,
                   min_advance: int, skey: tuple,
                   digest_only: bool) -> dict:
        """Lane-thread body of one /live poll: refresh the pinned snapshot,
        admit by watermark advance, execute over the committed prefix."""
        handle = self.handles.get(open_spec)
        with handle.lock:
            if handle.kind == "liveset":
                cov = handle.obj.refresh()
                wm = handle.obj.watermark
                if wm is None:
                    raise ServiceError(
                        503, "no_survivors",
                        f"every rank under {open_spec['paths'][0]!r} is "
                        f"dead or absent — refusing to serve an empty "
                        f"result as healthy",
                        extra={"coverage": cov.as_dict()})
                lt = handle.obj.trace()
            else:
                cov = None
                wm = handle.obj.refresh()
                lt = handle.obj
            sess = self._live_sessions.get(skey)
            prev_rows = sess["rows"] if sess is not None else None
            advanced = wm.rows - (prev_rows or 0)
            if (sess is not None and min_advance > 0
                    and wm.rows - sess["rows"] < min_advance
                    and not wm.finalized):
                # tenant polls faster than the writers commit: push back
                # instead of re-serving (and re-encoding) the same prefix
                sess["polls"] += 1
                sess["stalls"] += 1
                raise ServiceError(
                    429, "watermark_stalled",
                    f"watermark advanced {wm.rows - sess['rows']} row(s) "
                    f"since this session's last poll "
                    f"(min_advance_rows={min_advance}); poll slower",
                    extra={"retry_after_ms": 250,
                           "watermark": wm.as_dict()})
            q = protocol.apply_steps(lt.query(), steps)
            t0 = time.perf_counter()
            value = q.run(op, *args, **kwargs)
            elapsed = time.perf_counter() - t0
            if sess is None:
                sess = self._live_sessions[skey] = {
                    "rows": 0, "polls": 0, "stalls": 0, "served_at": 0.0}
            sess["rows"] = wm.rows
            sess["polls"] += 1
            sess["served_at"] = time.time()
            out = {"ok": True, "watermark": wm.as_dict(),
                   "advanced_rows": advanced, "session": skey[2],
                   "partial": False,
                   "digest": protocol.result_digest(value),
                   "elapsed_ms": round(elapsed * 1e3, 3)}
            if cov is not None:
                out["coverage"] = cov.as_dict()
                if cov.degraded:
                    # 206-style partial result: the missing ranks are
                    # named in the response, never silently dropped
                    out["partial"] = True
                    out["missing_ranks"] = list(cov.missing)
            if not digest_only:
                out["result"] = protocol.encode_value(value)
            return out

    async def live(self, payload: dict) -> dict:
        """One poll of a live session: refresh the committed prefix,
        enforce min-watermark-advance backpressure, execute the op over
        the survivors, and annotate the result with watermark + coverage.
        Degraded liveset coverage comes back ``partial: True`` (wire
        status 206)."""
        tenant = self._tenant(payload if isinstance(payload, dict) else {})
        self._count(tenant, "requests")
        if self.draining:
            self._count(tenant, "rejected")
            raise ServiceError(503, "draining",
                               "service is draining; no new queries")
        (open_spec, op, steps, args, kwargs, min_advance, session,
         digest_only) = self._decode_live(payload)
        if self._active >= self.max_active:
            self._count(tenant, "rejected")
            raise ServiceError(429, "saturated",
                               f"service at max_active={self.max_active}; "
                               f"retry later")
        waiting = self._tenant_waiting.get(tenant, 0)
        if waiting >= self.per_tenant * 4:
            self._count(tenant, "rejected")
            raise ServiceError(429, "tenant_saturated",
                               f"tenant {tenant!r} has {waiting} queued "
                               f"requests (limit {self.per_tenant * 4})")
        self._tenant_waiting[tenant] = waiting + 1
        try:
            await self._sem(tenant).acquire()
        finally:
            self._tenant_waiting[tenant] -= 1
        self._active += 1
        self._idle.clear()
        self._count(tenant, "live_polls")
        # the session key pins continuity to the open spec, not the pool
        # object: a pool eviction must not reset a tenant's watermark
        skey = (tenant,
                hashlib.sha256(canonical_json(open_spec).encode())
                .hexdigest(), session)
        loop = asyncio.get_running_loop()
        try:
            result = await loop.run_in_executor(
                self.scheduler.lane("interactive"),
                lambda: self._poll_live(open_spec, op, steps, args, kwargs,
                                        min_advance, skey, digest_only))
            self._count(tenant, "executed")
            if result.get("partial"):
                self._count(tenant, "live_partial")
            return dict(result, tenant=tenant)
        except ServiceError as e:
            if e.code == "watermark_stalled":
                self._count(tenant, "live_stalled")
            else:
                self._count(tenant, "errors")
            raise
        except BaseException:
            self._count(tenant, "errors")
            raise
        finally:
            self._sem(tenant).release()
            self._active -= 1
            if self._active == 0:
                self._idle.set()

    # -- introspection / lifecycle ----------------------------------------
    def ops(self) -> dict:
        out = []
        for name in registry.list_ops():
            s = registry.get_op(name)
            out.append({"name": name, "scope": s.scope,
                        "streaming": s.streaming is not None,
                        "parallel_safe": bool(s.parallel_safe),
                        "needs_structure": bool(s.needs_structure),
                        "needs_messages": bool(s.needs_messages)})
        return {"ok": True, "device": str(self.device), "ops": out}

    def stats(self) -> dict:
        return {"ok": True, "device": str(self.device),
                "service": dict(self.counters, active=self._active,
                                draining=self.draining,
                                max_active=self.max_active,
                                per_tenant=self.per_tenant,
                                in_flight_plans=len(self._flights),
                                live_sessions=len(self._live_sessions)),
                "tenants": {t: dict(c)
                            for t, c in self.tenant_counters.items()},
                "plancache": plancache.stats(),
                "scheduler": self.scheduler.stats(),
                "handles": self.handles.stats()}

    async def drain(self, timeout: Optional[float] = None) -> bool:
        """Refuse new queries and wait for in-flight ones to finish.
        Returns True when the service went idle within ``timeout``."""
        self.draining = True
        try:
            await asyncio.wait_for(self._idle.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return False


# ---------------------------------------------------------------------------
# HTTP transport
# ---------------------------------------------------------------------------

_MAX_BODY = 64 * 1024 * 1024


async def _read_request(reader: asyncio.StreamReader):
    """(method, path, headers, body) for one HTTP/1.1 request, or None on
    clean EOF."""
    try:
        line = await reader.readline()
    except (ConnectionError, asyncio.LimitOverrunError):
        return None
    if not line:
        return None
    try:
        method, path, _version = line.decode("latin-1").split(None, 2)
    except ValueError:
        raise ServiceError(400, "bad_request", "malformed request line")
    headers: Dict[str, str] = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        if b":" in line:
            k, v = line.decode("latin-1").split(":", 1)
            headers[k.strip().lower()] = v.strip()
    length = int(headers.get("content-length", "0") or "0")
    if length > _MAX_BODY:
        raise ServiceError(413, "too_large",
                           f"body of {length} bytes exceeds {_MAX_BODY}")
    body = await reader.readexactly(length) if length else b""
    return method.upper(), path, headers, body


def _response(status: int, body: dict) -> bytes:
    payload = json.dumps(body).encode()
    reason = {200: "OK", 206: "Partial Content", 400: "Bad Request",
              404: "Not Found",
              405: "Method Not Allowed", 413: "Payload Too Large",
              422: "Unprocessable Entity", 429: "Too Many Requests",
              500: "Internal Server Error", 503: "Service Unavailable",
              504: "Gateway Timeout"}.get(status, "Error")
    head = (f"HTTP/1.1 {status} {reason}\r\n{_JSON_HEADERS}"
            f"Content-Length: {len(payload)}\r\n"
            f"Connection: keep-alive\r\n\r\n")
    return head.encode("latin-1") + payload


class TraceServer:
    """The asyncio HTTP server around a :class:`TraceService`.

    ``await start()`` binds (port 0 picks a free port; see :attr:`port`),
    ``await shutdown()`` drains gracefully, ``serve_forever()`` blocks
    until shutdown.  All handler work runs on the event loop except plan
    execution, which the service pushes onto scheduler lane threads.
    """

    def __init__(self, service: Optional[TraceService] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 drain_timeout: float = 30.0):
        self.service = service or TraceService()
        self.host = host
        self._port = port
        self.drain_timeout = drain_timeout
        self._server: Optional[asyncio.AbstractServer] = None
        self._stopped = asyncio.Event()
        self._shutdown_task: Optional["asyncio.Task"] = None

    @property
    def port(self) -> int:
        if self._server is not None:
            return self._server.sockets[0].getsockname()[1]
        return self._port

    async def start(self) -> "TraceServer":
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self._port)
        return self

    async def _route(self, method: str, path: str, body: bytes) -> \
            Tuple[int, dict]:
        svc = self.service
        if method == "GET":
            if path == "/health":
                return 200, {"ok": True, "draining": svc.draining}
            if path == "/ops":
                return 200, svc.ops()
            if path == "/stats":
                return 200, svc.stats()
            return 404, {"ok": False, "error": {"code": "not_found",
                                                "message": path}}
        if method != "POST":
            return 405, {"ok": False, "error": {"code": "method",
                                                "message": method}}
        if path == "/shutdown":
            try:
                payload = json.loads(body or b"{}")
            except ValueError:
                payload = {}
            self._shutdown_task = asyncio.get_running_loop().create_task(
                self.shutdown(float(payload.get(
                    "grace", self.drain_timeout))))
            return 200, {"ok": True, "draining": True}
        if path not in ("/query", "/setquery", "/diagnose", "/live"):
            return 404, {"ok": False, "error": {"code": "not_found",
                                                "message": path}}
        try:
            payload = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            return 400, {"ok": False, "error": {"code": "bad_json",
                                                "message": str(e)}}
        try:
            if path == "/live":
                result = await svc.live(payload)
                # a degraded-coverage result is correct but incomplete:
                # 206 tells the client which ranks are missing
                return (206 if result.get("partial") else 200), result
            if path == "/diagnose":
                # sugar over /query: force the diagnose terminal so clients
                # can POST just {"open": ..., "detectors": [...]}; it
                # coalesces and caches like any other plan
                payload = dict(payload)
                payload["op"] = "diagnose"
                detectors = payload.pop("detectors", None)
                if detectors is not None:
                    kwargs = dict(payload.get("kwargs") or {})
                    kwargs["detectors"] = detectors
                    payload["kwargs"] = kwargs
            result = await svc.query(payload,
                                     set_scope=(path == "/setquery"))
            return 200, result
        except ProtocolError as e:
            return 400, {"ok": False, "error": {"code": "protocol",
                                                "message": str(e)}}
        except ServiceError as e:
            err = {"code": e.code, "message": str(e)}
            err.update(e.extra)
            return e.status, {"ok": False, "error": err}
        except Exception as e:  # op raised: report, keep serving
            return 500, {"ok": False, "error": {
                "code": "op_failed", "message": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc(limit=8)}}

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    req = await _read_request(reader)
                except ServiceError as e:
                    writer.write(_response(e.status, {
                        "ok": False,
                        "error": {"code": e.code, "message": str(e)}}))
                    await writer.drain()
                    break
                except asyncio.IncompleteReadError:
                    break
                if req is None:
                    break
                method, path, headers, body = req
                status, out = await self._route(method, path, body)
                writer.write(_response(status, out))
                await writer.drain()
                if headers.get("connection", "").lower() == "close":
                    break
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def shutdown(self, grace: Optional[float] = None) -> None:
        """Graceful stop: drain the service (in-flight queries finish; new
        ones get 503), then close the listener."""
        await self.service.drain(grace if grace is not None
                                 else self.drain_timeout)
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self._stopped.set()

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        await self._stopped.wait()


def serve(host: str = "127.0.0.1", port: int = 0,
          announce: bool = False, **service_kwargs) -> None:
    """Blocking entry point: build a service (``device=`` among
    ``service_kwargs``, the card by default), bind, serve until drained.

    ``announce=True`` prints one ``SERVING {json}`` line with the bound
    host, port and device once the socket is live, for a caller that
    started a port-0 server to find it.
    """

    async def _main():
        server = TraceServer(TraceService(**service_kwargs),
                             host=host, port=port)
        await server.start()
        if announce:
            print("SERVING " + json.dumps(
                {"host": host, "port": server.port,
                 "device": str(server.service.device)}), flush=True)
        await server.serve_forever()

    asyncio.run(_main())
