"""Client for the trace-query service: the library's query API, remote.

Mirrors :mod:`repro.serving.client`.  A script written against the
library,

    trace = Trace.open("run.pipitpack", streaming=True)
    prof = trace.query().slice_time(t0, t1).flat_profile()

points at a running :mod:`~repro_torch.serving.tracequery` server with a
one-line change::

    client = ServiceClient("127.0.0.1", 8731, tenant="alice")
    trace = client.open("run.pipitpack", streaming=True)
    prof = trace.query().slice_time(t0, t1).flat_profile()

:class:`RemoteQuery` mirrors the ``TraceQuery`` builder (``filter`` /
``slice_time`` / ``restrict_processes`` and every registered terminal op,
resolved through the same :mod:`~repro_torch.core.registry`), but nothing
runs locally: the plan is serialized with
:mod:`~repro_torch.serving.protocol`, runs on the server's device against
its pooled handle, and the columnar result is decoded back into the
``EventFrame`` / ndarray types a library call returns.  Per-call
``cache=`` / ``lane=`` / ``digest_only=`` map onto the service's cache,
admission lanes and digest-only responses.  ``open_set`` is a remote
``TraceSet`` (its plans go to ``/setquery``) and ``RemoteTrace.diagnose``
runs the detector suite through ``/diagnose``.

Transport is the standard library's ``http.client`` over one keep-alive
connection; a lock serializes requests on it, so one client may be shared
between threads.
"""

from __future__ import annotations

import http.client
import json
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from ..core import registry
from ..core.filters import Filter
from . import protocol

__all__ = ["RemoteError", "ServiceClient", "RemoteTrace", "RemoteTraceSet",
           "RemoteLiveTrace", "RemoteQuery"]


class RemoteError(RuntimeError):
    """A non-2xx service response; carries the HTTP status, the service's
    machine-readable error code, and any extra error fields (``extra``)
    the service attached — e.g. ``retry_after_ms`` on a live-session
    stall."""

    def __init__(self, status: int, code: str, message: str,
                 extra: Optional[dict] = None):
        super().__init__(f"[{status} {code}] {message}")
        self.status = status
        self.code = code
        self.extra = extra or {}


#: request targets whose handlers are idempotent: re-sending after a
#: connection fault cannot change service state beyond what one send
#: does.  GETs always qualify; the plan-execution POSTs qualify because
#: a replayed plan coalesces/caches onto the same digest-keyed result.
_IDEMPOTENT_POSTS = ("/query", "/setquery", "/diagnose", "/live")


class ServiceClient:
    """One connection to a trace-query server (see module docstring).

    Transport faults on **idempotent** requests (every GET, plus the
    plan-execution POSTs — replaying a plan is digest-idempotent) are
    retried up to ``retries`` times with jittered exponential backoff
    (``backoff * 2^attempt``, capped at ``backoff_max``, each delay
    uniformly jittered to 50–100%), covering both connection resets at
    send time and resets *mid-response*.  Non-idempotent requests
    (``/shutdown``) keep only the classic single stale-keep-alive retry:
    they are replayed only when the failure hit a **reused** connection,
    where the overwhelmingly likely cause is the server having closed an
    idle socket before the request arrived.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 8731,
                 tenant: Optional[str] = None, timeout: float = 120.0,
                 retries: int = 2, backoff: float = 0.05,
                 backoff_max: float = 2.0,
                 deadline_ms: Optional[float] = None):
        self.host = host
        self.port = int(port)
        self.tenant = tenant
        self.timeout = timeout
        self.retries = max(int(retries), 0)
        self.backoff = float(backoff)
        self.backoff_max = float(backoff_max)
        #: default per-request server-side deadline (ms) attached to every
        #: plan execution; per-call ``deadline_ms`` overrides
        self.deadline_ms = deadline_ms
        self._lock = threading.Lock()
        self._conn: Optional[http.client.HTTPConnection] = None
        #: response metadata of the most recent query (digest, cached,
        #: coalesced, elapsed_ms) — handy in tests and benchmarks
        self.last_meta: Dict[str, Any] = {}
        #: transport retries performed over this client's lifetime
        self.retry_count = 0

    # -- transport ---------------------------------------------------------
    def _request(self, method: str, path: str,
                 payload: Optional[dict] = None) -> dict:
        body = json.dumps(payload).encode() if payload is not None else None
        idempotent = (method == "GET" or path in _IDEMPOTENT_POSTS)
        attempts = (self.retries + 1) if idempotent else 2
        with self._lock:
            for attempt in range(attempts):
                reused = self._conn is not None
                if self._conn is None:
                    self._conn = http.client.HTTPConnection(
                        self.host, self.port, timeout=self.timeout)
                try:
                    self._conn.request(
                        method, path, body=body,
                        headers={"Content-Type": "application/json"})
                    resp = self._conn.getresponse()
                    data = resp.read()
                    break
                except (http.client.HTTPException, ConnectionError,
                        BrokenPipeError, OSError):
                    self._close_locked()
                    if not idempotent and not reused:
                        # fresh connection: the server may have received
                        # and acted on the request — never replay
                        raise
                    if attempt + 1 >= attempts:
                        raise
                    self.retry_count += 1
                    if idempotent:
                        delay = min(self.backoff * (2 ** attempt),
                                    self.backoff_max)
                        time.sleep(delay * (0.5 + random.random() * 0.5))
        try:
            out = json.loads(data.decode("utf-8"))
        except ValueError:
            raise RemoteError(resp.status, "bad_response",
                              f"non-JSON response ({len(data)} bytes)")
        if resp.status >= 400 or not out.get("ok", False):
            err = out.get("error") or {}
            extra = {k: v for k, v in err.items()
                     if k not in ("code", "message")}
            raise RemoteError(resp.status, err.get("code", "error"),
                              err.get("message", "request failed"),
                              extra=extra)
        return out

    def _close_locked(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    def __enter__(self) -> "ServiceClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- service surface ---------------------------------------------------
    def health(self) -> dict:
        return self._request("GET", "/health")

    def stats(self) -> dict:
        return self._request("GET", "/stats")

    def ops(self) -> List[dict]:
        return self._request("GET", "/ops")["ops"]

    def shutdown(self, grace: Optional[float] = None) -> dict:
        payload = {} if grace is None else {"grace": grace}
        return self._request("POST", "/shutdown", payload)

    def open(self, path, format: str = "auto", streaming: bool = False,
             chunk_rows: Optional[int] = None,
             processes: Optional[int] = None,
             executor: str = "auto", fold: str = "once") -> "RemoteTrace":
        """A remote handle over ``path`` — the signature of
        ``Trace.open``, minus reader kwargs.  Nothing opens until the
        first query; the server pools the actual handle."""
        paths = ([str(p) for p in path]
                 if isinstance(path, (list, tuple)) else [str(path)])
        spec = {"mode": "trace", "paths": paths, "format": format,
                "streaming": streaming, "chunk_rows": chunk_rows,
                "processes": processes, "executor": executor, "fold": fold}
        return RemoteTrace(self, spec)

    def open_live(self, path, chunk_rows: Optional[int] = None,
                  processes: Optional[int] = None,
                  executor: str = "auto",
                  fold: str = "once") -> "RemoteLiveTrace":
        """A remote live handle over still-growing pack shard(s): polls go
        to ``/live`` and come back watermarked (see
        :meth:`RemoteLiveTrace.poll`)."""
        paths = ([str(p) for p in path]
                 if isinstance(path, (list, tuple)) else [str(path)])
        spec = {"mode": "live", "paths": paths, "format": "auto",
                "streaming": False, "chunk_rows": chunk_rows,
                "processes": processes, "executor": executor, "fold": fold}
        return RemoteLiveTrace(self, spec)

    def open_liveset(self, root: str, pattern: str = "rank_*.pack",
                     lag_timeout: float = 2.0, dead_timeout: float = 10.0,
                     chunk_rows: Optional[int] = None,
                     processes: Optional[int] = None,
                     executor: str = "auto",
                     fold: str = "once") -> "RemoteLiveTrace":
        """A remote rank-failure-tolerant live handle over an N-rank shard
        directory: results carry a coverage report, and degraded coverage
        comes back as a 206 partial response naming the missing ranks."""
        spec = {"mode": "liveset", "paths": [str(root)],
                "pattern": pattern, "lag_timeout": float(lag_timeout),
                "dead_timeout": float(dead_timeout), "format": "auto",
                "streaming": False, "chunk_rows": chunk_rows,
                "processes": processes, "executor": executor, "fold": fold}
        return RemoteLiveTrace(self, spec)

    def open_set(self, paths: Sequence, format: str = "auto",
                 processes: Optional[int] = None,
                 labels: Optional[Sequence[str]] = None,
                 streaming: bool = False,
                 chunk_rows: Optional[int] = None,
                 fold: str = "once") -> "RemoteTraceSet":
        """A remote ``TraceSet`` over per-run paths (for the diff /
        regression comparison ops); a member may be one path or a list
        of per-rank shard paths."""
        members = [str(p) if isinstance(p, (str, os.PathLike))
                   else [str(q) for q in p] for p in paths]
        spec = {"mode": "set", "paths": members, "format": format,
                "processes": processes,
                "labels": list(labels) if labels is not None else None,
                "streaming": streaming, "chunk_rows": chunk_rows,
                "fold": fold}
        return RemoteTraceSet(self, spec)

    # -- execution ---------------------------------------------------------
    def _run(self, open_spec: dict, steps: List[dict], op: str, args,
             kwargs, *, cache: Optional[bool], lane: Optional[str],
             digest_only: bool,
             deadline_ms: Optional[float] = None) -> Any:
        payload = {
            "open": open_spec,
            "steps": steps,
            "op": op,
            "args": [protocol.encode_value(a) for a in args],
            "kwargs": {str(k): protocol.encode_value(v)
                       for k, v in kwargs.items()},
        }
        if self.tenant is not None:
            payload["tenant"] = self.tenant
        if cache is not None:
            payload["cache"] = cache
        if lane is not None:
            payload["lane"] = lane
        if digest_only:
            payload["digest_only"] = True
        if deadline_ms is None:
            deadline_ms = self.deadline_ms
        if deadline_ms is not None:
            payload["deadline_ms"] = float(deadline_ms)
        endpoint = "/setquery" if open_spec["mode"] == "set" else "/query"
        out = self._request("POST", endpoint, payload)
        self.last_meta = {k: out.get(k) for k in
                          ("digest", "cached", "coalesced", "elapsed_ms",
                           "tenant")}
        if digest_only:
            return out["digest"]
        return protocol.decode_value(out["result"])

    def live_poll(self, open_spec: dict, op: str, args=(), kwargs=None,
                  *, steps: Optional[List[dict]] = None,
                  session: str = "default", min_advance_rows: int = 1,
                  digest_only: bool = False) -> dict:
        """One ``/live`` poll.  Returns the response dict with ``result``
        decoded in place: ``{value, watermark, coverage?, partial,
        missing_ranks?, advanced_rows, digest, session}``.  A stalled
        watermark raises :class:`RemoteError` with ``code
        "watermark_stalled"`` and ``extra["retry_after_ms"]``; a degraded
        liveset answer arrives as a 206 with ``partial: True`` — a
        *successful* response here, not an error."""
        payload: Dict[str, Any] = {
            "open": open_spec, "op": op,
            "steps": list(steps or []),
            "args": [protocol.encode_value(a) for a in args],
            "kwargs": {str(k): protocol.encode_value(v)
                       for k, v in (kwargs or {}).items()},
            "session": session, "min_advance_rows": int(min_advance_rows),
        }
        if self.tenant is not None:
            payload["tenant"] = self.tenant
        if digest_only:
            payload["digest_only"] = True
        out = self._request("POST", "/live", payload)
        self.last_meta = {k: out.get(k) for k in
                          ("digest", "elapsed_ms", "tenant", "partial",
                           "advanced_rows")}
        res = dict(out)
        res["value"] = (protocol.decode_value(out["result"])
                        if "result" in out else None)
        return res


class RemoteQuery:
    """A lazy plan executed server-side, with the builder surface of
    ``TraceQuery`` (and of ``SetQuery`` when built from a remote set)."""

    def __init__(self, client: ServiceClient, open_spec: dict,
                 steps: Optional[List[dict]] = None):
        self._client = client
        self._open = open_spec
        self._steps: List[dict] = list(steps or [])

    def _with(self, step: dict) -> "RemoteQuery":
        return RemoteQuery(self._client, self._open, self._steps + [step])

    def filter(self, f: Filter) -> "RemoteQuery":
        return self._with({"k": "filter", "filter": protocol.encode_filter(f)})

    def slice_time(self, start: float, end: float,
                   trim: str = "overlap") -> "RemoteQuery":
        return self._with({"k": "slice_time", "start": float(start),
                           "end": float(end), "trim": trim})

    def restrict_processes(self, procs: Sequence[int]) -> "RemoteQuery":
        return self._with({"k": "restrict_processes",
                           "procs": [int(p) for p in procs]})

    filter_processes = restrict_processes

    def run(self, op_name: str, *args: Any, cache: Optional[bool] = None,
            lane: Optional[str] = None, digest_only: bool = False,
            deadline_ms: Optional[float] = None, **kwargs: Any) -> Any:
        """Execute a registered terminal op server-side; returns the
        decoded result (or its digest with ``digest_only=True``).
        ``deadline_ms`` bounds server-side execution for this call
        (overriding the client default); past it the service answers 504
        and cancels the plan at the next chunk boundary."""
        return self._client._run(self._open, self._steps, op_name, args,
                                 kwargs, cache=cache, lane=lane,
                                 digest_only=digest_only,
                                 deadline_ms=deadline_ms)

    def __getattr__(self, name: str):
        return registry.terminal_op(name, self.run, "RemoteQuery")

    def __repr__(self) -> str:  # pragma: no cover
        return (f"RemoteQuery({self._open['mode']}, "
                f"{len(self._steps)} step(s))")


class RemoteTrace:
    """Remote stand-in for an opened ``Trace``/``StreamingTrace``."""

    def __init__(self, client: ServiceClient, open_spec: dict):
        self._client = client
        self._open = open_spec

    def query(self) -> RemoteQuery:
        return RemoteQuery(self._client, self._open)

    def diagnose(self, detectors: Optional[Sequence[str]] = None,
                 cache: Optional[bool] = None) -> Any:
        """Run the diagnostics suite server-side through the ``/diagnose``
        endpoint; returns the decoded, ranked Findings frame (the same as
        ``query().diagnose(...)``, which goes through ``/query``: both
        coalesce and cache as one plan)."""
        payload: Dict[str, Any] = {"open": self._open, "steps": []}
        if detectors is not None:
            payload["detectors"] = [str(d) for d in detectors]
        if self._client.tenant is not None:
            payload["tenant"] = self._client.tenant
        if cache is not None:
            payload["cache"] = cache
        out = self._client._request("POST", "/diagnose", payload)
        self._client.last_meta = {k: out.get(k) for k in
                                  ("digest", "cached", "coalesced",
                                   "elapsed_ms", "tenant")}
        return protocol.decode_value(out["result"])

    def __repr__(self) -> str:  # pragma: no cover
        return f"RemoteTrace({self._open['paths']!r})"


class RemoteLiveTrace:
    """Remote stand-in for a live (still-growing) trace or rank fleet.

    ``poll("flat_profile")`` executes over the committed prefix and
    returns the watermarked (and, for livesets, coverage-annotated)
    response; ``steps=`` (wire steps, as :mod:`~repro_torch.serving.
    protocol` encodes them) windows the poll."""

    def __init__(self, client: ServiceClient, open_spec: dict):
        self._client = client
        self._open = open_spec

    def poll(self, op_name: str, *args: Any, session: str = "default",
             min_advance_rows: int = 1, digest_only: bool = False,
             steps: Optional[List[dict]] = None, **kwargs: Any) -> dict:
        return self._client.live_poll(
            self._open, op_name, args, kwargs, steps=steps,
            session=session, min_advance_rows=min_advance_rows,
            digest_only=digest_only)

    def __repr__(self) -> str:  # pragma: no cover
        return f"RemoteLiveTrace({self._open['paths']!r})"


class RemoteTraceSet:
    """Remote stand-in for a ``TraceSet`` (the comparison ops)."""

    def __init__(self, client: ServiceClient, open_spec: dict):
        self._client = client
        self._open = open_spec

    def query(self) -> RemoteQuery:
        return RemoteQuery(self._client, self._open)

    def __repr__(self) -> str:  # pragma: no cover
        return f"RemoteTraceSet({self._open['paths']!r})"
