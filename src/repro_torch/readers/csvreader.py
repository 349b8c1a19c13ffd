"""CSV trace reader — the paper's Fig. 1 format.

Mirrors :mod:`repro.readers.csvreader`.  Header names are matched
case-insensitively after stripping; a timestamp header of ``Timestamp
(s)`` / ``(ms)`` / ``(us)`` is converted to ns.  Extra columns are kept
verbatim (numeric when they parse as floats).  The chunked reader streams
bounded chunks, or one byte span of the file
(:func:`plan_units_csv` plans :class:`~repro_torch.core.registry.ByteSpan`
units for the parallel executor); :func:`write_csv` is its inverse.
"""

from __future__ import annotations

import itertools
import os
from typing import Iterator, List, Optional

import numpy as np

from ..core.constants import ET, MSG_SIZE, NAME, PARTNER, PROC, TAG, THREAD, TS
from ..core.errors import (IngestReport, TraceReadError, check_on_error,
                           require_nonempty)
from ..core.frame import Categorical, EventFrame, optimize_dtypes
from ..core.registry import (ByteSpan, PlanHints, even_edges,
                             rank_shard_procs, register_chunked,
                             register_reader, register_units)
from ..core.trace import Trace

__all__ = ["read_csv", "iter_chunks_csv", "plan_units_csv", "write_csv"]

_UNIT = {"(s)": 1e9, "(ms)": 1e6, "(us)": 1e3, "(ns)": 1.0}

_CANON = {
    "timestamp": TS, "time": TS, "event type": ET, "event": ET, "name": NAME,
    "function": NAME, "process": PROC, "rank": PROC, "thread": THREAD,
    "msg size": MSG_SIZE, "size": MSG_SIZE, "partner": PARTNER, "tag": TAG,
}


def _canon_header(h: str):
    h = h.strip()
    scale = 1.0
    low = h.lower()
    for u, s in _UNIT.items():
        if low.endswith(u):
            low = low[: -len(u)].strip()
            scale = s
    return _CANON.get(low, h), scale


def _sniff_csv(path: str, head: str) -> bool:
    line = head.splitlines()[0] if head else ""
    if line.count(",") < 2:
        return False
    toks = [_canon_header(t)[0] for t in line.split(",")]
    return TS in toks and (ET in toks or NAME in toks)


def _parse_header(line: str):
    headers, scales = [], []
    for h in line.split(","):
        name, scale = _canon_header(h)
        headers.append(name)
        scales.append(scale)
    return headers, scales


#: canonical columns whose values must be numeric — a non-numeric value in
#: one of these is a malformed *row*, never a license to silently retype
#: the whole column as categorical (the pre-fault-tolerance behavior)
_NUMERIC_CANON = (TS, PROC, THREAD, MSG_SIZE, PARTNER, TAG)


def _row_fault(parts: List[str], num_idx: List[tuple]) -> Optional[str]:
    """Why this data row is malformed, or None when it is well-formed."""
    for i, h in num_idx:
        v = parts[i] if i < len(parts) else ""
        if not v:
            continue
        try:
            float(v)
        except ValueError:
            return f"column {h!r} value {v!r} is not numeric"
    return None


def _validate_rows(numbered_rows, headers: List[str], path: str,
                   on_error: str, report: Optional[IngestReport],
                   origin: str = "") -> List[List[str]]:
    """Filter ``(lineno, parts)`` pairs down to well-formed rows.  Strict
    raises :class:`TraceReadError` with file:line context at the first bad
    row; skip drops it and counts it in ``report``.  The decision is per
    physical row, so eager / chunked / byte-span reads of one damaged file
    keep identical survivors."""
    num_idx = [(i, h) for i, h in enumerate(headers) if h in _NUMERIC_CANON]
    out: List[List[str]] = []
    for lineno, parts in numbered_rows:
        fault = _row_fault(parts, num_idx)
        if fault is None:
            out.append(parts)
            continue
        locus = f"{origin}line {lineno}"
        if on_error == "strict":
            raise TraceReadError(path, f"malformed CSV row ({fault})",
                                 locus=locus)
        if report is not None:
            report.skip(path, 1, locus, fault)
    return out


def _rows_to_frame(headers: List[str], scales: List[float],
                   rows: List[List[str]],
                   decisions: Optional[List[str]] = None):
    """Build a frame from parsed rows; returns ``(frame, decisions)`` where
    ``decisions[i]`` records each column's inferred type ("num" / "cat").
    Passing previous ``decisions`` pins them — chunked reads must not let a
    column's dtype flip between chunks (a chunk whose string column happens
    to be all-numeric would otherwise silently diverge from the whole-file
    read)."""
    ncol = len(headers)
    cols = [[] for _ in range(ncol)]
    for parts in rows:
        if len(parts) < ncol:
            parts = parts + [""] * (ncol - len(parts))
        for i in range(ncol):
            cols[i].append(parts[i])
    ev = EventFrame()
    out_dec: List[str] = []
    for i, h in enumerate(headers):
        vals = cols[i]
        arr: object
        want = decisions[i] if decisions is not None else None
        if want == "cat":
            arr = None
        else:
            try:
                arr = np.asarray([float(v) if v else np.nan for v in vals])
                if h == TS:
                    arr = (arr * scales[i]).astype(np.int64)
                elif h in (PROC, THREAD, PARTNER, TAG):
                    arr = np.nan_to_num(arr, nan=-1).astype(np.int64)
            except ValueError:
                if want == "num":
                    from ..core.streaming import StreamingUnsupported
                    raise StreamingUnsupported(
                        f"CSV column {h!r} was typed numeric (by an "
                        f"earlier chunk's values, or by its canonical "
                        f"name under a parallel byte-range read) but "
                        f"holds non-numeric values; the whole-file read "
                        f"types columns over all rows — open with "
                        f"streaming=False") from None
                arr = None
        if arr is None:
            arr = Categorical.from_values(
                np.asarray(vals, dtype=object).astype(str))
            out_dec.append("cat")
        else:
            out_dec.append("num")
        ev[h] = arr
    return ev, out_dec


def _infer_decisions(headers: List[str], rows: List[List[str]],
                     prev: Optional[List[str]]) -> List[str]:
    """Per-column num/cat decisions from (unfiltered) chunk rows, merged
    with earlier chunks': cat is sticky; num -> cat means an earlier chunk
    was already yielded with the wrong dtype, which the whole-file read
    would have typed differently — fail loudly."""
    out: List[str] = []
    for i, h in enumerate(headers):
        dec = "num"
        for parts in rows:
            v = parts[i] if i < len(parts) else ""
            if not v:
                continue
            try:
                float(v)
            except ValueError:
                dec = "cat"
                break
        if prev is not None:
            if prev[i] == "cat":
                dec = "cat"
            elif prev[i] == "num" and dec == "cat":
                from ..core.streaming import StreamingUnsupported
                raise StreamingUnsupported(
                    f"CSV column {h!r} parsed as numeric in an earlier "
                    f"chunk but holds non-numeric values later; the "
                    f"whole-file read types columns over all rows — open "
                    f"with streaming=False")
        out.append(dec)
    return out


@register_reader("csv", extensions=(".csv",), sniff=_sniff_csv,
                 shard_procs=rank_shard_procs)
def read_csv(path_or_buf, label: Optional[str] = None,
             on_error: str = "strict",
             report: Optional[IngestReport] = None,
             device="cuda") -> Trace:
    """Read a whole CSV trace (a path or a file object) into a Trace whose
    ops run on ``device``."""
    check_on_error(on_error, ("strict", "skip"))
    rpt = report if report is not None else IngestReport()
    if isinstance(path_or_buf, str):
        require_nonempty(path_or_buf, os.path.getsize(path_or_buf),
                         what="csv trace")
        with open(path_or_buf, "rb") as f:
            lines = f.read().splitlines()
        label = label or path_or_buf
    else:
        lines = path_or_buf.read().splitlines()
    src = path_or_buf if isinstance(path_or_buf, str) else "<buffer>"
    rpt.begin(src)
    numbered = []
    for i, ln in enumerate(lines):
        if isinstance(ln, bytes):
            try:
                ln = ln.decode("utf-8")
            except UnicodeDecodeError as e:
                # the undecodable unit is the physical line — same skip
                # granularity as a malformed row, so every execution mode
                # drops the identical line set
                if on_error == "strict":
                    raise TraceReadError(
                        src, f"undecodable bytes — not UTF-8 ({e})",
                        locus=f"line {i + 1}") from e
                rpt.skip(src, 1, f"line {i + 1}",
                         "undecodable bytes (not UTF-8)")
                continue
        if ln.strip():
            numbered.append((i + 1, ln))
    if not numbered:
        t = Trace(EventFrame(), label=label, device=device)
        t._ingest = rpt
        return t
    headers, scales = _parse_header(numbered[0][1])
    data = [(no, [p.strip() for p in ln.split(",")])
            for no, ln in numbered[1:]]
    rows = _validate_rows(data, headers, src, on_error, rpt)
    rpt.add_rows(src, len(rows))
    ev, _ = _rows_to_frame(headers, scales, rows)
    t = Trace(optimize_dtypes(ev), label=label, device=device)
    t._ingest = rpt
    return t


def _decode_header(raw: bytes, path: str) -> str:
    """The header is the anchor (it types every column): undecodable bytes
    there are fatal under every policy, with the file named."""
    try:
        return raw.decode("utf-8")
    except UnicodeDecodeError as e:
        raise TraceReadError(path, f"undecodable bytes in CSV header — "
                                   f"not UTF-8 ({e})", locus="line 1") from e


def _decoded_lines(blines, path: str, on_error: str,
                   report: Optional[IngestReport], origin: str = "",
                   first_line: int = 2) -> Iterator[str]:
    """Per-line UTF-8 decode with the reader's error policy: strict raises
    with file:line context, skip drops exactly that physical line (counted
    in ``report``) — the same granularity as a malformed row, so serial,
    chunked and span-parallel reads keep identical survivors."""
    n = first_line
    for bln in blines:
        try:
            yield bln.decode("utf-8")
        except UnicodeDecodeError as e:
            locus = f"{origin}line {n}"
            if on_error == "strict":
                raise TraceReadError(path, f"undecodable bytes — not "
                                           f"UTF-8 ({e})", locus=locus) from e
            if report is not None:
                report.skip(path, 1, locus, "undecodable bytes (not UTF-8)")
        n += 1


@register_chunked("csv")
def iter_chunks_csv(path: str, chunk_rows: int,
                    hints: Optional[PlanHints] = None,
                    label: Optional[str] = None,
                    byte_range: Optional[tuple] = None,
                    on_error: str = "strict",
                    report: Optional[IngestReport] = None
                    ) -> Iterator[EventFrame]:
    """Stream a CSV trace in bounded chunks, with process/time pushdown
    applied per row before the columns are built.  ``byte_range=(lo, hi)``
    restricts the read to data lines starting inside the span (parallel
    work units); the header is always parsed.  ``on_error="skip"`` drops
    malformed rows (non-numeric values in canonical numeric columns) with
    exact counts in ``report``.  Caveat: extra-column num/cat type
    decisions are made per span — ambiguous columns that the whole-file
    read types over all rows should use serial streaming.  ``label`` (the
    handle's, as in the reference) names no column: a chunk is a bare
    frame, and the executor's per-chunk trace carries it."""
    check_on_error(on_error, ("strict", "skip"))
    require_nonempty(path, os.path.getsize(path), what="csv trace")
    if report is not None and byte_range is None:
        report.begin(path)
    if byte_range is not None:
        from .jsonl import iter_lines_range
        # Decoding per complete line is split-safe — multi-byte characters
        # never straddle a line boundary — and per-line policy keeps the
        # surviving rows identical across serial / chunked / span reads.
        with open(path, "rb") as f:
            header = _decode_header(f.readline(), path)
            if not header.strip():
                return
            headers, scales = _parse_header(header)
            # a span's rows cannot type columns (value inference over a
            # slice can disagree with the whole-file read — e.g. a span
            # whose Name values all look numeric); pin every canonical
            # column by NAME instead, which is what the unit planner's
            # canonical-only guard guarantees is possible
            fixed = [("cat" if h in (ET, NAME) else "num")
                     for h in headers]
            lo = max(int(byte_range[0]), f.tell())
            src = _decoded_lines(
                iter_lines_range(f, lo, int(byte_range[1])), path,
                on_error, report, origin=f"span@{lo}+")
            yield from _iter_csv_lines(src, headers, scales, hints,
                                       chunk_rows, fixed_decisions=fixed,
                                       path=path, on_error=on_error,
                                       report=report,
                                       origin=f"span@{lo}+")
        return
    with open(path, "rb") as f:
        header = _decode_header(f.readline(), path)
        if not header.strip():
            return
        headers, scales = _parse_header(header)
        yield from _iter_csv_lines(
            _decoded_lines(f, path, on_error, report), headers, scales,
            hints, chunk_rows, path=path, on_error=on_error, report=report)


def _iter_csv_lines(f, headers, scales, hints, chunk_rows,
                    fixed_decisions: Optional[List[str]] = None,
                    path: str = "<buffer>", on_error: str = "strict",
                    report: Optional[IngestReport] = None,
                    origin: str = "") -> Iterator[EventFrame]:
    try:
        p_i = headers.index(PROC)
    except ValueError:
        p_i = None
    try:
        t_i = headers.index(TS)
    except ValueError:
        t_i = None
    tw = hints.time_window if hints is not None else None
    check_proc = (hints is not None and p_i is not None
                  and (hints.procs is not None
                       or hints.proc_bounds is not None))
    decisions = None
    lineno = 1 if not origin else 0  # serial mode: header was line 1
    while True:
        lines = list(itertools.islice(f, chunk_rows))
        if not lines:
            break
        numbered = []
        for ln in lines:
            lineno += 1
            if not ln.strip():
                continue
            numbered.append((lineno, [p.strip() for p in ln.split(",")]))
        # malformed rows are resolved *first* (strict raises, skip drops)
        # so type decisions and pushdown only ever see well-formed rows —
        # identical to the whole-file read's order of operations
        all_rows = _validate_rows(numbered, headers, path, on_error,
                                  report, origin)
        rows = []
        for parts in all_rows:
            if check_proc and len(parts) > p_i:
                try:
                    if not hints.admits_proc(int(float(parts[p_i]))):
                        continue
                except ValueError:
                    pass
            if tw is not None and t_i is not None and len(parts) > t_i:
                try:
                    t = float(parts[t_i]) * scales[t_i]
                    if not (tw[0] <= t <= tw[1]):
                        continue
                except ValueError:
                    pass
            rows.append(parts)
        if report is not None:
            report.add_rows(path, len(rows))
        # type decisions must come from the *unfiltered* (but validated)
        # rows: the whole-file read types columns over every surviving
        # row, and pushdown may drop exactly the rows whose values are
        # non-numeric.  A byte-range read pins them by column name.
        if fixed_decisions is not None:
            decisions = fixed_decisions
        elif all_rows:
            decisions = _infer_decisions(headers, all_rows, decisions)
        if rows:
            ev, _ = _rows_to_frame(headers, scales, rows, decisions)
            yield optimize_dtypes(ev)


_CANONICAL = (TS, ET, NAME, PROC, THREAD, MSG_SIZE, PARTNER, TAG)


@register_units("csv")
def plan_units_csv(path: str, n_units: int):
    """Split the data region (past the header line) into ~equal byte
    spans; the chunked reader aligns spans to line boundaries.

    Only files whose header holds canonical columns are split: canonical
    columns are typed by *name*, so byte-range workers agree with the
    whole-file read by construction.  Extra columns are typed by value
    inference over rows — per-span inference could silently diverge from
    serial streaming, so such files stay one (serial-semantics) unit.

    Canonical columns holding non-canonical *content* (every Name numeric,
    a letter in Process, ...) are malformed traces: one mode fails loudly
    where the other succeeds, but results never diverge silently.
    """
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        header = f.readline().decode("utf-8", errors="replace")
        start = f.tell()
    headers, _scales = _parse_header(header)
    if any(h not in _CANONICAL for h in headers):
        return None
    n = max(min(int(n_units), size - start), 1)
    if n <= 1 or start >= size:
        return None
    edges = even_edges(start, size, n)
    return [ByteSpan(path, lo, hi)
            for lo, hi in zip(edges[:-1], edges[1:]) if hi > lo]


def write_csv(trace_or_events, path: str) -> None:
    """Serialize a trace to the canonical-header CSV format (inverse of
    :func:`read_csv`; used by the cross-reader conformance suite)."""
    ev = getattr(trace_or_events, "events", trace_or_events)
    cols = ev.columns
    ts = np.asarray(ev[TS], np.int64)
    mats = {c: ev[c] for c in cols if c != TS}
    with open(path, "w") as f:
        f.write(",".join([TS] + [c for c in cols if c != TS]) + "\n")
        names = [c for c in cols if c != TS]
        for i in range(len(ev)):
            parts = [str(int(ts[i]))]
            for c in names:
                v = mats[c][i]
                if isinstance(v, (float, np.floating)) and np.isnan(v):
                    parts.append("")
                else:
                    parts.append(str(v))
            f.write(",".join(parts) + "\n")

