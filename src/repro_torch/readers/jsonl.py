"""Pipit-native JSON-lines format: one event object per line.

Mirrors :mod:`repro.readers.jsonl`.  Keys: ``ts`` (ns), ``et``
(Enter/Leave/Instant), ``name``, ``proc``, ``thread``, and for messages
``size``/``partner``/``tag``.  Function names are interned while parsing
and remapped onto a sorted category table; integer id columns are downcast
to the narrowest safe dtype.  The chunked reader (``iter_chunks``, which
the streaming executor drives) never holds more than ``chunk_rows`` events
and can read one byte span of a file.  The reference's parse pushdown
(``PlanHints``) and parallel work-unit planner are not ported yet
(ROADMAP §A.3).
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from ..core.constants import (ENTER, ET, INSTANT, LEAVE, MSG_SIZE, NAME,
                              PARTNER, PROC, TAG, THREAD, TS)
from ..core.errors import (IngestReport, TraceReadError, check_on_error,
                           require_nonempty)
from ..core.frame import Categorical, EventFrame, optimize_dtypes
from ..core.registry import register_chunked, register_reader
from ..core.trace import Trace

__all__ = ["read_jsonl", "write_jsonl"]

_ET_CODE = {ENTER: 0, LEAVE: 1, INSTANT: 2}
_ET_CATS = np.asarray([ENTER, LEAVE, INSTANT])


def _sniff_jsonl(path: str, head: str) -> bool:
    for line in head.splitlines():
        line = line.strip()
        if not line:
            continue
        if not line.startswith("{"):
            return False
        try:
            d = json.loads(line)
        except ValueError:
            # head is a fixed-size prefix: an event line longer than the
            # sniff window arrives truncated mid-JSON; accept only when the
            # extension also claims jsonl
            return (len(line) >= 4096 and path.lower().endswith(".jsonl")
                    and '"ts"' in line[:256])
        return isinstance(d, dict) and "ts" in d
    return False


class _JsonlParser:
    """Line-batch parser of one file: names are interned into a per-file
    table in first-seen order, so codes stay stable across the chunks of
    one file.  ``on_error="strict"`` raises :class:`TraceReadError` with
    file:line on the first malformed line; ``"skip"`` drops and counts it
    — per physical line, so whole-file and chunked reads of one damaged
    file keep the same rows."""

    def __init__(self, path: str, on_error: str, report: IngestReport,
                 line_origin: str = ""):
        self.path = path
        self.on_error = on_error
        self.report = report
        self._origin = line_origin  # "span@<byte>+" for byte-range reads
        self._name_code = {}
        self._names = []
        self._line = 0

    def parse(self, lines) -> Optional[EventFrame]:
        """One EventFrame for the lines (None when none survived), in the
        uniform column set (thread and message columns included)."""
        name_code, names = self._name_code, self._names
        ts, et, ncodes, procs, threads = [], [], [], [], []
        sizes, partners, tags = [], [], []
        n = 0
        for line in lines:
            self._line += 1
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
                if not isinstance(d, dict):
                    raise ValueError("not an event object")
                p = int(d.get("proc", 0))
                t = int(d["ts"])
                thread = int(d.get("thread", 0))
                s = d.get("size")
                size = float(s) if s is not None else np.nan
                pr = d.get("partner")
                partner = int(pr) if pr is not None else -1
                g = d.get("tag")
                tag = int(g) if g is not None else 0
                etc = _ET_CODE.get(d.get("et", ENTER), 2)
                nm = d.get("name", "")
            except (ValueError, KeyError, TypeError) as e:
                locus = f"{self._origin}line {self._line}"
                if self.on_error == "strict":
                    raise TraceReadError(self.path,
                                         f"malformed event line ({e})",
                                         locus=locus) from e
                self.report.skip(self.path, 1, locus, str(e))
                continue
            c = name_code.get(nm)
            if c is None:
                c = len(names)
                name_code[nm] = c
                names.append(nm)
            ts.append(t)
            et.append(etc)
            ncodes.append(c)
            procs.append(p)
            threads.append(thread)
            sizes.append(size)
            partners.append(partner)
            tags.append(tag)
            n += 1
        self.report.add_rows(self.path, n)
        if n == 0:
            return None
        return EventFrame({
            TS: np.asarray(ts, np.int64),
            ET: Categorical.from_codes(np.asarray(et, np.int32), _ET_CATS),
            NAME: Categorical.from_codes(np.asarray(ncodes, np.int32),
                                         np.asarray(names, dtype=object)),
            PROC: np.asarray(procs, np.int64),
            THREAD: np.asarray(threads, np.int64),
            MSG_SIZE: np.asarray(sizes),
            PARTNER: np.asarray(partners, np.int64),
            TAG: np.asarray(tags, np.int64),
        })


def sorted_names(ev: EventFrame) -> EventFrame:
    """Remap first-seen name codes onto a sorted category table — the
    Categorical ``np.unique`` ingest produces."""
    cat = ev.column(NAME)
    if not isinstance(cat, Categorical) or len(cat.categories) == 0:
        return ev
    order = np.argsort(cat.categories.astype(str), kind="stable")
    inv = np.empty(len(order), np.int64)
    inv[order] = np.arange(len(order))
    ev[NAME] = Categorical(inv[cat.codes].astype(np.int32),
                           cat.categories[order])
    return ev


def finish_frame(ev: EventFrame) -> EventFrame:
    """The whole-file column shape: thread / message columns only when the
    trace has them, integer columns downcast."""
    if not np.any(np.asarray(ev[THREAD], np.int64)):
        ev = ev.drop(THREAD)
    if not (np.any(~np.isnan(np.asarray(ev[MSG_SIZE], np.float64)))
            or np.any(np.asarray(ev[PARTNER], np.int64) >= 0)):
        ev = ev.drop(MSG_SIZE, PARTNER, TAG)
    return optimize_dtypes(ev)


@register_reader("jsonl", extensions=(".jsonl",), sniff=_sniff_jsonl,
                 priority=10)
def read_jsonl(path_or_buf, label: Optional[str] = None,
               on_error: str = "strict",
               report: Optional[IngestReport] = None,
               device="cuda") -> Trace:
    """Read a whole JSON-lines trace (a path or a binary file object)
    into a Trace whose ops run on ``device``."""
    check_on_error(on_error, ("strict", "skip"))
    rpt = report if report is not None else IngestReport()
    src = path_or_buf if isinstance(path_or_buf, str) else "<buffer>"
    rpt.begin(src)
    if isinstance(path_or_buf, str):
        require_nonempty(path_or_buf, os.path.getsize(path_or_buf),
                         what="jsonl trace")
        label = label or path_or_buf
        # binary: a non-UTF-8 garbage line fails as a per-line ValueError
        with open(path_or_buf, "rb") as f:
            ev = _JsonlParser(src, on_error, rpt).parse(f)
    else:
        ev = _JsonlParser(src, on_error, rpt).parse(path_or_buf)
    if ev is None:
        t = Trace(EventFrame(), label=label, device=device)
    else:
        t = Trace(finish_frame(sorted_names(ev)), label=label, device=device)
    t._ingest = rpt
    return t


def iter_lines_range(f, lo: int, hi: int) -> Iterator[bytes]:
    """Lines of the binary stream ``f`` whose first byte lies in [lo, hi):
    split offsets may land anywhere, and every line belongs to exactly one
    range."""
    if lo > 0:
        f.seek(lo - 1)
        if f.read(1) != b"\n":
            f.readline()  # skip the tail of the line owned by the range below
    else:
        f.seek(0)
    while True:
        if f.tell() >= hi:
            return
        line = f.readline()
        if not line:
            return
        yield line


@register_chunked("jsonl")
def iter_chunks_jsonl(path: str, chunk_rows: int,
                      byte_range: Optional[Tuple[int, int]] = None,
                      on_error: str = "strict",
                      report: Optional[IngestReport] = None
                      ) -> Iterator[EventFrame]:
    """Stream ``path`` in EventFrames of at most ``chunk_rows`` events
    without ever holding the file.  ``byte_range=(lo, hi)`` reads only the
    lines that start inside that span.  The streaming executor masks
    every chunk with the plan itself: the reader pushes nothing down."""
    check_on_error(on_error, ("strict", "skip"))
    require_nonempty(path, os.path.getsize(path), what="jsonl trace")
    rpt = report if report is not None else IngestReport()
    if byte_range is None:
        rpt.begin(path)
    origin = f"span@{int(byte_range[0])}+" if byte_range is not None else ""
    parser = _JsonlParser(path, on_error, rpt, line_origin=origin)
    with open(path, "rb") as f:  # binary for the same reason as read_jsonl
        lines = (f if byte_range is None else
                 iter_lines_range(f, int(byte_range[0]), int(byte_range[1])))
        while True:
            batch = list(itertools.islice(lines, chunk_rows))
            if not batch:
                return
            ev = parser.parse(batch)
            if ev is not None:
                yield optimize_dtypes(ev)


def write_jsonl(trace_or_events, path: str) -> None:
    ev = getattr(trace_or_events, "events", trace_or_events)
    cols = ev.columns
    ts = np.asarray(ev[TS], np.int64)
    et = ev[ET]
    names = ev[NAME]
    procs = np.asarray(ev[PROC], np.int64)
    threads = np.asarray(ev[THREAD], np.int64) if THREAD in cols else None
    sizes = np.asarray(ev[MSG_SIZE], np.float64) if MSG_SIZE in cols else None
    partners = np.asarray(ev[PARTNER], np.int64) if PARTNER in cols else None
    tags = np.asarray(ev[TAG], np.int64) if TAG in cols else None
    with open(path, "w") as f:
        for i in range(len(ev)):
            d = {"ts": int(ts[i]), "et": str(et[i]), "name": str(names[i]),
                 "proc": int(procs[i])}
            if threads is not None and threads[i]:
                d["thread"] = int(threads[i])
            if sizes is not None and not np.isnan(sizes[i]):
                d["size"] = sizes[i]
            if partners is not None and partners[i] >= 0:
                d["partner"] = int(partners[i])
            if tags is not None and tags[i]:
                d["tag"] = int(tags[i])
            f.write(json.dumps(d) + "\n")
