"""Chrome Trace Format reader (paper's Nsight-Systems / PyTorch-profiler path).

Mirrors :mod:`repro.readers.chrome`.  CTF is the JSON envelope both the
PyTorch profiler and Nsight exports emit: ``{"traceEvents": [{"ph":
"B"|"E"|"X"|"i", "ts": us, "dur": us, "pid": .., "tid": .., "name": ..,
"args": {..}}, ...]}``.  ``X`` (complete) events are split into
Enter/Leave pairs; ``pid``→Process (densified to 0..N-1 in pid order),
``tid``→Thread.  Message / flow events (``ph`` in s/t/f) become
MpiSend/MpiRecv instants so the comm ops work on GPU traces too — a
``torch.profiler`` export's ``ac2g`` flows (CPU launch → GPU kernel)
included.

Unlike the reference, pids that are not all integers are ordered: a
``torch.profiler`` export writes string pids (``"Spans"``, ``"Traces"``)
beside the integer ones, and the reference's plain ``sorted`` raises a
bare ``TypeError`` on them.  :func:`_pid_key` orders numbers first, by
value, then every other pid by its string, so an all-integer trace keeps
the reference's dense ids.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, List, Optional

import numpy as np

from ..core.constants import (ENTER, ET, INSTANT, LEAVE, MPI_RECV, MPI_SEND,
                              MSG_SIZE, NAME, PARTNER, PROC, TAG, THREAD, TS)
from ..core.errors import (IngestReport, TraceReadError, check_on_error,
                           require_nonempty)
from ..core.frame import Categorical, EventFrame, optimize_dtypes
from ..core.registry import (PlanHints, ProcSpan, even_groups,
                             register_chunked, register_reader,
                             register_units)
from ..core.trace import Trace

__all__ = ["read_chrome", "iter_chunks_chrome", "plan_units_chrome",
           "write_chrome"]

_ET_CATS = np.asarray([ENTER, LEAVE, INSTANT])


def _pid_key(pid) -> tuple:
    """Sort key of a raw pid: numbers by value, then every other pid by its
    string, so pids of mixed types order (and densify) deterministically."""
    if isinstance(pid, (int, float)) and not isinstance(pid, bool):
        return (0, pid, "")
    return (1, 0, str(pid))


def _dense_pids(pids) -> tuple:
    """The sorted raw pids (:func:`_pid_key` order); a pid's index here is
    its Process id."""
    return tuple(sorted(pids, key=_pid_key))


def _sniff_chrome(path: str, head: str) -> bool:
    h = head.lstrip()
    if not h.startswith(("{", "[")):
        return False
    if '"traceEvents"' in head:
        return True
    return h.startswith("[") and '"ph"' in head


def _dispatch_event(e: dict, emit) -> None:
    """The single CTF phase-code switch: decode one event object into row
    emissions.  Shared by the whole-file and chunked readers so a new
    ``ph`` mapping can never land in only one path.  ``emit(t_us, code,
    name, pid, tid, size=..., partner=..., tag=...)`` receives the *raw*
    pid — callers densify/filter."""
    ph = e.get("ph", "X")
    name = str(e.get("name", ""))
    pid = e.get("pid", 0)
    tid = int(e.get("tid", 0) or 0)
    t = float(e.get("ts", 0.0))
    args = e.get("args") or {}
    if ph == "X":
        dur = float(e.get("dur", 0.0))
        emit(t, 0, name, pid, tid)
        emit(t + dur, 1, name, pid, tid)
    elif ph == "B":
        emit(t, 0, name, pid, tid)
    elif ph == "E":
        emit(t, 1, name, pid, tid)
    elif ph in ("i", "I", "n"):
        emit(t, 2, name, pid, tid)
    elif ph == "s":  # flow start == send
        emit(t, 2, MPI_SEND, pid, tid, size=float(args.get("size", 0.0)),
             partner=int(args.get("partner", -1)), tag=int(e.get("id", 0)))
    elif ph in ("t", "f"):  # flow step/finish == recv
        emit(t, 2, MPI_RECV, pid, tid, size=float(args.get("size", 0.0)),
             partner=int(args.get("partner", -1)), tag=int(e.get("id", 0)))
    # metadata events (ph == "M") are folded into definitions


@register_reader("chrome", extensions=(".json",), sniff=_sniff_chrome,
                 priority=20)
def read_chrome(path_or_buf, label: Optional[str] = None,
                on_error: str = "strict",
                report: Optional[IngestReport] = None,
                device="cuda") -> Trace:
    """Read a whole Chrome trace (a path or a text file object) into a
    Trace whose ops run on ``device``."""
    check_on_error(on_error, ("strict", "skip"))
    rpt = report if report is not None else IngestReport()
    is_path = isinstance(path_or_buf, str)
    src = path_or_buf if is_path else "<buffer>"
    if is_path:
        require_nonempty(path_or_buf, os.path.getsize(path_or_buf),
                         what="chrome trace")
        label = label or path_or_buf
    rpt.begin(src)
    events = None
    try:
        if is_path:
            with open(path_or_buf) as f:
                doc = json.load(f)
        else:
            doc = json.load(path_or_buf)
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        if not isinstance(events, list):
            raise ValueError("traceEvents is not an array")
    except (ValueError, KeyError) as e:
        if on_error == "strict":
            locus = (f"line {e.lineno}"
                     if isinstance(e, json.JSONDecodeError) else None)
            reason = ("no traceEvents array" if isinstance(e, KeyError)
                      else f"invalid JSON ({e})")
            raise TraceReadError(src, reason, locus=locus) from e
        events = None
    if events is None:
        # skip mode on a damaged document: salvage the longest valid event
        # prefix with the incremental decoder (the same machinery the
        # chunked reader uses, so both paths keep identical survivors)
        if is_path:
            events = list(_iter_array_items(path_or_buf, on_error="skip",
                                            report=rpt))
        else:
            try:
                path_or_buf.seek(0)
                events = list(_iter_array_items_f(
                    path_or_buf, src, on_error="skip", report=rpt))
            except (OSError, ValueError, AttributeError):
                events = []

    # normalize pids to dense process ids (non-dict entries can't carry one;
    # the dispatch loop below raises/skips them with a per-event locus)
    pids = list(_dense_pids({e.get("pid", 0) for e in events
                             if isinstance(e, dict)}))
    pid_of = {p: i for i, p in enumerate(pids)}

    ts, et, names, procs, threads = [], [], [], [], []
    sizes, partners, tags = [], [], []
    has_msg = False

    def emit(t, code, name, pid, tid, size=np.nan, partner=-1, tag=0):
        # round, don't truncate: CTF timestamps are float µs, and ns values
        # that went through a /1000 round-trip sit epsilon below the integer
        nonlocal has_msg
        p = pid_of.get(pid, 0)  # before any append — emits stay atomic
        if not np.isnan(size):  # only flow (message) events carry a size
            has_msg = True
        ts.append(round(t * 1000))  # us -> ns
        et.append(code)
        names.append(name)
        procs.append(p)
        threads.append(tid)
        sizes.append(size)
        partners.append(partner)
        tags.append(tag)

    for i, e in enumerate(events):
        try:
            if not isinstance(e, dict):
                raise ValueError("not an object")
            _dispatch_event(e, emit)
        except (ValueError, TypeError) as exc:
            if on_error == "strict":
                raise TraceReadError(src, f"malformed trace event ({exc})",
                                     locus=f"event {i}") from exc
            rpt.skip(src, 1, f"event {i}", str(exc))
    rpt.add_rows(src, len(ts))
    ev = EventFrame({
        TS: np.asarray(ts, np.int64),
        ET: Categorical.from_codes(np.asarray(et, np.int32), _ET_CATS),
        NAME: np.asarray(names, dtype=object),
        PROC: np.asarray(procs, np.int64),
        THREAD: np.asarray(threads, np.int64),
    })
    if has_msg:
        ev[MSG_SIZE] = np.asarray(sizes)
        ev[PARTNER] = np.asarray(partners, np.int64)
        ev[TAG] = np.asarray(tags, np.int64)
    defs = {"pids": pids}
    t = Trace(optimize_dtypes(ev), label=label, device=device,
              definitions=defs)
    t._ingest = rpt
    return t


# ---------------------------------------------------------------------------
# chunked (out-of-core) reading
# ---------------------------------------------------------------------------

def _iter_array_items(path: str, block: int = 1 << 16,
                      on_error: str = "strict",
                      report: Optional[IngestReport] = None
                      ) -> Iterator[dict]:
    """Incrementally decode the JSON array of trace events in ``path``
    without loading the document: scan to the ``traceEvents`` array (or a
    bare top-level array), then ``raw_decode`` one object at a time from a
    bounded text buffer.

    A damaged tail (truncation mid-event, bit-flipped body, appended
    garbage) raises :class:`TraceReadError` under ``on_error="strict"``;
    under ``"skip"`` the valid prefix is yielded and the undecodable
    remainder is recorded as ``bytes_lost`` in ``report``.

    ``errors="replace"`` keeps non-UTF-8 garbage from raising out of the
    raw ``read()``: the replacement characters fail ``raw_decode`` instead,
    which routes through ``damaged()`` with a byte locus under both
    policies."""
    with open(path, errors="replace") as f:
        yield from _iter_array_items_f(f, path, block, on_error, report)


def _iter_array_items_f(f, path: str, block: int = 1 << 16,
                        on_error: str = "strict",
                        report: Optional[IngestReport] = None
                        ) -> Iterator[dict]:
    dec = json.JSONDecoder()

    def damaged(reason: str, lost: int) -> None:
        locus = f"byte ~{max(f.tell() - lost, 0)}"
        if on_error == "strict":
            raise TraceReadError(path, reason, locus=locus)
        if report is not None:
            report.lose_bytes(path, lost, locus, reason)

    buf = f.read(block)
    key = '"traceEvents"'
    if buf.lstrip().startswith("["):
        start = buf.find("[")
    else:
        # scan to the key with a bounded sliding window (keep only a
        # key-length tail across reads — a large metadata prefix must
        # not accumulate in the reader that exists to bound RSS)...
        while True:
            k = buf.find(key)
            if k >= 0:
                buf = buf[k + len(key):]
                break
            buf = buf[-len(key):]
            nxt = f.read(block)
            if not nxt:
                damaged("no traceEvents array found", 0)
                return
            buf += nxt
        # ...then to the opening bracket (only ':' and whitespace can
        # sit between the key and its array)
        while True:
            start = buf.find("[")
            if start >= 0:
                break
            nxt = f.read(block)
            if not nxt:
                damaged("traceEvents key with no array (truncated file?)",
                        len(buf))
                return
            buf = nxt
    buf = buf[start + 1:]
    pos = 0
    while True:
        # skip separators
        while True:
            stripped = buf[pos:].lstrip()
            pos = len(buf) - len(stripped)
            if stripped.startswith(","):
                pos += 1
                continue
            break
        if pos < len(buf) and buf[pos] == "]":
            return
        try:
            obj, end = dec.raw_decode(buf, pos)
        except ValueError:
            nxt = f.read(block)
            if not nxt:
                lost = len(buf) - pos
                if lost:
                    damaged("truncated or corrupt traceEvents array "
                            f"({lost} undecodable bytes at end of data)",
                            lost)
                else:
                    # clean cut between events: nothing undecodable, but
                    # the closing bracket never arrived
                    damaged("truncated traceEvents array "
                            "(missing closing bracket)", 0)
                return
            buf = buf[pos:] + nxt
            pos = 0
            continue
        yield obj
        pos = end
        if pos > block:
            buf = buf[pos:]
            pos = 0


def _decode_batch(batch: List[dict], hints: Optional[PlanHints],
                  pid_of: dict, path: str = "<buffer>",
                  on_error: str = "strict",
                  report: Optional[IngestReport] = None,
                  base_idx: int = 0) -> Optional[EventFrame]:
    """One uniform-column EventFrame from a batch of CTF event objects,
    with pids densified through ``pid_of`` — the same sorted-dense mapping
    the whole-file reader builds, so chunked and in-memory reads agree.
    Malformed event objects follow the reader ``on_error`` contract; the
    skip decision precedes pushdown, so survivors match the eager read."""
    tw = hints.time_window if hints is not None else None
    check_proc = hints is not None and (hints.procs is not None
                                        or hints.proc_bounds is not None)
    ts, et, names, procs, threads = [], [], [], [], []
    sizes, partners, tags = [], [], []

    def emit(t, code, name, pid, tid, size=np.nan, partner=-1, tag=0):
        p = pid_of.get(pid, 0)
        if check_proc and not hints.admits_proc(p):
            return
        v = round(t * 1000)
        if tw is not None and not (tw[0] <= v <= tw[1]):
            return
        ts.append(v)
        et.append(code)
        names.append(name)
        procs.append(p)
        threads.append(tid)
        sizes.append(size)
        partners.append(partner)
        tags.append(tag)

    for i, e in enumerate(batch):
        try:
            if not isinstance(e, dict):
                raise ValueError("not an object")
            _dispatch_event(e, emit)
        except (ValueError, TypeError) as exc:
            if on_error == "strict":
                raise TraceReadError(path, f"malformed trace event ({exc})",
                                     locus=f"event {base_idx + i}") from exc
            if report is not None:
                report.skip(path, 1, f"event {base_idx + i}", str(exc))
    if report is not None:
        report.add_rows(path, len(ts))
    if not ts:
        return None
    ev = EventFrame({
        TS: np.asarray(ts, np.int64),
        ET: Categorical.from_codes(np.asarray(et, np.int32), _ET_CATS),
        NAME: np.asarray(names, dtype=object),
        PROC: np.asarray(procs, np.int64),
        THREAD: np.asarray(threads, np.int64),
        MSG_SIZE: np.asarray(sizes),
        PARTNER: np.asarray(partners, np.int64),
        TAG: np.asarray(tags, np.int64),
    })
    return optimize_dtypes(ev)


@register_chunked("chrome")
def iter_chunks_chrome(path: str, chunk_rows: int,
                       hints: Optional[PlanHints] = None,
                       label: Optional[str] = None,
                       known_pids: Optional[tuple] = None,
                       on_error: str = "strict",
                       report: Optional[IngestReport] = None
                       ) -> Iterator[EventFrame]:
    """Stream a Chrome trace in bounded chunks via incremental JSON array
    decoding (an ``X`` event expands to two rows, so chunks may slightly
    exceed ``chunk_rows``).

    A cheap pre-pass collects the pid set so pids densify to exactly the
    sorted 0..N-1 mapping the whole-file reader uses — Process ids (and
    therefore pushdown and per-process results) are identical either way,
    at the cost of decoding the stream twice; memory stays bounded.
    ``known_pids`` (the sorted raw pid tuple) skips that pre-pass — the
    parallel unit planner runs it once and shares the table with every
    worker.  ``on_error="skip"`` salvages the valid event prefix of a
    damaged file (losses counted in ``report``); the pre-pass runs with
    the same policy but stays silent so counts reflect one pass.
    ``label`` (the handle's, as in the reference) names no column: a
    chunk is a bare frame, and the executor's per-chunk trace carries it.
    """
    check_on_error(on_error, ("strict", "skip"))
    require_nonempty(path, os.path.getsize(path), what="chrome trace")
    if report is not None:
        report.begin(path)
    if known_pids is not None:
        pids = set(known_pids)
    else:
        pids = set()
        for obj in _iter_array_items(path, on_error=on_error):
            if isinstance(obj, dict):
                pids.add(obj.get("pid", 0))
    pid_of = {p: i for i, p in enumerate(_dense_pids(pids))}
    batch: List[dict] = []
    seen = 0
    for obj in _iter_array_items(path, on_error=on_error, report=report):
        batch.append(obj)
        if len(batch) >= max(chunk_rows // 2, 1):
            ev = _decode_batch(batch, hints, pid_of, path, on_error,
                               report, seen)
            seen += len(batch)
            if ev is not None:
                yield ev
            batch = []
    if batch:
        ev = _decode_batch(batch, hints, pid_of, path, on_error,
                           report, seen)
        if ev is not None:
            yield ev


@register_units("chrome")
def plan_units_chrome(path: str, n_units: int):
    """Per-pid work units: one pid pre-pass (paid once, in the planner)
    yields the dense process table; units are contiguous groups of dense
    process ids, each carrying the shared pid table so workers skip their
    own pre-pass.  Workers still each decode the JSON stream — the win is
    in row assembly and aggregation, not the decode."""
    pids = set()
    try:
        for obj in _iter_array_items(path):
            if isinstance(obj, dict):
                pids.add(obj.get("pid", 0))
    except TraceReadError:
        # damaged file: no parallel plan — the serial path owns the
        # strict-raise / skip-salvage decision
        return None
    raw = _dense_pids(pids)
    n = max(min(int(n_units), len(raw)), 1)
    if n <= 1:
        return None
    extra = (("known_pids", raw),)
    return [ProcSpan(path, procs, extra)
            for procs in even_groups(range(len(raw)), n)]


def write_chrome(trace_or_events, path: str) -> None:
    """Serialize a trace to Chrome Trace Format (inverse of
    :func:`read_chrome`): B/E phase events preserve exact event order,
    flow events carry the message instants."""
    ev = getattr(trace_or_events, "events", trace_or_events)
    cols = ev.columns
    ts = np.asarray(ev[TS], np.int64)
    et = ev[ET]
    names = ev[NAME]
    procs = np.asarray(ev[PROC], np.int64)
    threads = (np.asarray(ev[THREAD], np.int64) if THREAD in cols
               else np.zeros(len(ev), np.int64))
    sizes = np.asarray(ev[MSG_SIZE], np.float64) if MSG_SIZE in cols else None
    partners = np.asarray(ev[PARTNER], np.int64) if PARTNER in cols else None
    tags = np.asarray(ev[TAG], np.int64) if TAG in cols else None
    with open(path, "w") as f:
        f.write('{"traceEvents": [\n')
        first = True
        for i in range(len(ev)):
            e = et[i]
            nm = str(names[i])
            d = {"name": nm, "pid": int(procs[i]), "tid": int(threads[i]),
                 "ts": ts[i] / 1000.0}
            if e == ENTER:
                d["ph"] = "B"
            elif e == LEAVE:
                d["ph"] = "E"
            elif nm == MPI_SEND and partners is not None:
                d["ph"] = "s"
                d["id"] = int(tags[i])
                d["args"] = {"size": float(np.nan_to_num(sizes[i])),
                             "partner": int(partners[i])}
            elif nm == MPI_RECV and partners is not None:
                d["ph"] = "f"
                d["id"] = int(tags[i])
                d["args"] = {"size": float(np.nan_to_num(sizes[i])),
                             "partner": int(partners[i])}
            else:
                d["ph"] = "i"
            f.write(("" if first else ",\n") + json.dumps(d))
            first = False
        f.write("\n]}\n")

