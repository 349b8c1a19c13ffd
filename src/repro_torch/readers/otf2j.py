"""OTF2-structured reader (schema-faithful JSON rendering).

Mirrors :mod:`repro.readers.otf2j`.  Archives are JSON **with OTF2's exact
logical structure** (see Eschweiler et al. [10]):

* ``definitions``: string table, region table (name refs into strings),
  location groups (= MPI ranks) and locations (= threads),
* per-location **event streams**, each a list of
  ``[timestamp, kind, ...]`` records with kinds ``E`` (Enter, region ref),
  ``L`` (Leave, region ref), ``S`` (MpiSend: receiver, length, tag),
  ``R`` (MpiRecv: sender, length, tag).

Two on-disk layouts are accepted, mirroring OTF2's anchor-plus-streams:

* single file: one JSON object with ``definitions`` and ``events`` keyed by
  location id;
* directory: ``definitions.json`` + ``locations/<id>.json`` one stream per
  file — this is the layout the parallel reader (paper §VI) fans out over.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

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

__all__ = ["read_otf2_json", "iter_chunks_otf2j", "plan_units_otf2j",
           "write_otf2_json"]

_ET_CATS = np.asarray([ENTER, LEAVE, INSTANT])


def _sniff_otf2j(path: str, head: str) -> bool:
    if os.path.isdir(path):
        return os.path.exists(os.path.join(path, "definitions.json"))
    return '"definitions"' in head and '"strings"' in head


def _stream_to_columns(loc: dict, events: List[list], strings: List[str],
                       regions: List[dict]):
    """Decode one location's event stream into column lists."""
    n = len(events)
    ts = np.empty(n, np.int64)
    et = np.empty(n, np.int32)
    name_code = np.empty(n, np.int64)  # index into regions, or -1 for msgs
    sizes = np.full(n, np.nan)
    partners = np.full(n, -1, np.int64)
    tags = np.zeros(n, np.int64)
    is_send = np.zeros(n, bool)
    is_recv = np.zeros(n, bool)
    for i, rec in enumerate(events):
        try:
            ts[i] = rec[0]
            kind = rec[1]
            if kind == "E":
                et[i] = 0
                if not 0 <= int(rec[2]) < len(regions):
                    raise ValueError(f"region ref {rec[2]} out of range")
                name_code[i] = rec[2]
            elif kind == "L":
                et[i] = 1
                if not 0 <= int(rec[2]) < len(regions):
                    raise ValueError(f"region ref {rec[2]} out of range")
                name_code[i] = rec[2]
            elif kind == "S":
                et[i] = 2
                name_code[i] = -1
                is_send[i] = True
                partners[i] = rec[2]
                sizes[i] = rec[3]
                tags[i] = rec[4] if len(rec) > 4 else 0
            elif kind == "R":
                et[i] = 2
                name_code[i] = -1
                is_recv[i] = True
                partners[i] = rec[2]
                sizes[i] = rec[3]
                tags[i] = rec[4] if len(rec) > 4 else 0
            else:  # metric/other -> instant named by region ref
                et[i] = 2
                name_code[i] = (rec[2] if len(rec) > 2
                                and 0 <= int(rec[2]) < len(regions) else -1)
        except (ValueError, TypeError, IndexError, KeyError) as e:
            raise ValueError(f"record {i}: {e}") from e
    region_names = np.asarray(
        [strings[r["name"]] if isinstance(r, dict) else strings[r] for r in regions]
        + [MPI_SEND, MPI_RECV], dtype=object)
    code = np.where(is_send, len(regions), np.where(is_recv, len(regions) + 1,
                                                    np.maximum(name_code, 0)))
    names = region_names[code]
    return ts, et, names, sizes, partners, tags


def _unpack_definitions(doc, path: str = "<doc>"):
    """The (strings, regions, locations) triple from an archive document.
    Definitions are the anchor every stream decodes against — a damaged
    table is never skippable, so structural faults raise regardless of
    the ``on_error`` policy."""
    try:
        defs = doc["definitions"]
        return defs, defs["strings"], defs["regions"], defs["locations"]
    except (KeyError, TypeError) as e:
        raise TraceReadError(
            path, f"corrupt OTF2 definitions (missing or bad {e})") from e


def _decode_archive(doc: dict, label: Optional[str], locations_subset=None,
                    path: str = "<doc>", on_error: str = "strict",
                    report: Optional[IngestReport] = None,
                    device="cuda") -> Trace:
    defs, strings, regions, locs = _unpack_definitions(doc, path)
    all_cols: Dict[str, list] = {k: [] for k in
                                 (TS, ET, NAME, PROC, THREAD, MSG_SIZE, PARTNER, TAG)}
    for loc in locs:
        try:
            lid = str(loc["id"])
            rank = int(loc["group"])
        except (KeyError, TypeError) as e:
            raise TraceReadError(
                path, f"corrupt OTF2 location table entry ({e})") from e
        if locations_subset is not None and lid not in locations_subset:
            continue
        stream = doc["events"].get(lid, [])
        try:
            ts, et, names, sizes, partners, tags = _stream_to_columns(
                loc, stream, strings, regions)
        except (ValueError, TypeError, IndexError, KeyError) as e:
            if on_error == "strict":
                raise TraceReadError(path, f"malformed event stream ({e})",
                                     locus=f"location {lid}") from e
            if report is not None:
                report.skip(path, 1, f"location {lid}",
                            f"location dropped ({e})")
            continue
        n = len(ts)
        if report is not None:
            report.add_rows(path, n)
        all_cols[TS].append(ts)
        all_cols[ET].append(et)
        all_cols[NAME].append(names)
        all_cols[PROC].append(np.full(n, rank, np.int64))
        all_cols[THREAD].append(np.full(n, loc.get("thread", 0), np.int64))
        all_cols[MSG_SIZE].append(sizes)
        all_cols[PARTNER].append(partners)
        all_cols[TAG].append(tags)
    if not all_cols[TS]:
        return Trace(EventFrame(), label=label, device=device)
    ev = EventFrame({
        TS: np.concatenate(all_cols[TS]),
        ET: Categorical.from_codes(np.concatenate(all_cols[ET]).astype(np.int32),
                                   _ET_CATS),
        NAME: np.concatenate(all_cols[NAME]),
        PROC: np.concatenate(all_cols[PROC]),
        THREAD: np.concatenate(all_cols[THREAD]),
        MSG_SIZE: np.concatenate(all_cols[MSG_SIZE]),
        PARTNER: np.concatenate(all_cols[PARTNER]),
        TAG: np.concatenate(all_cols[TAG]),
    })
    # canonical order: (process, thread, time) — stable for matching
    ev = ev.sort_by([PROC, THREAD, TS])
    return Trace(optimize_dtypes(ev), label=label, device=device,
                 definitions=defs)


def _load_definitions(anchor: str) -> dict:
    """Load and parse ``definitions.json`` — always strict (see
    :func:`_unpack_definitions`)."""
    if not os.path.exists(anchor):
        raise TraceReadError(anchor, "missing definitions.json — not an "
                                     "OTF2-structured archive")
    require_nonempty(anchor, os.path.getsize(anchor),
                     what="OTF2 definitions table")
    try:
        with open(anchor) as f:
            return json.load(f)
    except ValueError as e:
        locus = (f"line {e.lineno}"
                 if isinstance(e, json.JSONDecodeError) else None)
        raise TraceReadError(anchor, f"corrupt definitions JSON ({e})",
                             locus=locus) from e


@register_reader("otf2j", extensions=(".otf2.json",), sniff=_sniff_otf2j,
                 priority=20)
def read_otf2_json(path: str, label: Optional[str] = None,
                   locations_subset=None, on_error: str = "strict",
                   report: Optional[IngestReport] = None,
                   device="cuda") -> Trace:
    """Read a whole archive (one file, or a directory with
    ``definitions.json`` and ``locations/``) into a Trace whose ops run on
    ``device``."""
    check_on_error(on_error, ("strict", "skip"))
    rpt = report if report is not None else IngestReport()
    label = label or path
    rpt.begin(path)
    if os.path.isdir(path):
        defs = _load_definitions(os.path.join(path, "definitions.json"))
        events = {}
        locdir = os.path.join(path, "locations")
        names = sorted(os.listdir(locdir)) if os.path.isdir(locdir) else []
        for fn in names:
            lid = os.path.splitext(fn)[0]
            if locations_subset is not None and lid not in locations_subset:
                continue
            fp = os.path.join(locdir, fn)
            try:
                require_nonempty(fp, os.path.getsize(fp),
                                 what="OTF2 location stream")
                with open(fp) as f:
                    events[lid] = json.load(f)
            except (ValueError, OSError) as e:
                if on_error == "strict":
                    if isinstance(e, TraceReadError):
                        raise
                    raise TraceReadError(
                        fp, f"corrupt location stream ({e})") from e
                rpt.skip(fp, 1, "", f"location stream dropped ({e})")
        doc = {"definitions": defs, "events": events}
    else:
        require_nonempty(path, os.path.getsize(path),
                         what="OTF2-structured trace")
        try:
            with open(path) as f:
                doc = json.load(f)
        except ValueError as e:
            if on_error == "strict":
                locus = (f"line {e.lineno}"
                         if isinstance(e, json.JSONDecodeError) else None)
                raise TraceReadError(path, f"corrupt archive JSON ({e})",
                                     locus=locus) from e
            rpt.lose_bytes(path, os.path.getsize(path), "",
                           f"corrupt archive JSON ({e})")
            t = Trace(EventFrame(), label=label, device=device)
            t._ingest = rpt
            return t
    t = _decode_archive(doc, label, locations_subset, path=path,
                        on_error=on_error, report=rpt, device=device)
    t._ingest = rpt
    return t


def _location_frame(loc: dict, stream: List[list], strings, regions
                    ) -> EventFrame:
    ts, et, names, sizes, partners, tags = _stream_to_columns(
        loc, stream, strings, regions)
    n = len(ts)
    return EventFrame({
        TS: ts,
        ET: Categorical.from_codes(et, _ET_CATS),
        NAME: names,
        PROC: np.full(n, loc["group"], np.int64),
        THREAD: np.full(n, loc.get("thread", 0), np.int64),
        MSG_SIZE: sizes,
        PARTNER: partners,
        TAG: tags,
    })


@register_chunked("otf2j")
def iter_chunks_otf2j(path: str, chunk_rows: int,
                      hints: Optional[PlanHints] = None,
                      label: Optional[str] = None,
                      locations_subset=None, on_error: str = "strict",
                      report: Optional[IngestReport] = None):
    """Stream an OTF2-structured archive location by location.

    The directory layout (``definitions.json`` + ``locations/<id>.json``) is
    the truly out-of-core path: one location stream in memory at a time,
    and locations whose rank the plan excludes are *never opened* (process
    pushdown at file granularity).  A single-file archive is decoded whole
    but still yielded in bounded slices.

    ``on_error="skip"`` drops corrupt location streams (counted per
    location in ``report``) — the same per-location decision the eager
    reader makes, so survivors match across execution modes.  A corrupt
    definitions table always raises.
    ``label`` (the handle's, as in the reference) names no column: a
    chunk is a bare frame, and the executor's per-chunk trace carries it.
    """
    check_on_error(on_error, ("strict", "skip"))
    if report is not None:
        report.begin(path)
    is_dir = os.path.isdir(path)
    if is_dir:
        defs = _load_definitions(os.path.join(path, "definitions.json"))
        doc = None
    else:
        require_nonempty(path, os.path.getsize(path),
                         what="OTF2-structured trace")
        try:
            with open(path) as f:
                doc = json.load(f)
        except ValueError as e:
            if on_error == "strict":
                locus = (f"line {e.lineno}"
                         if isinstance(e, json.JSONDecodeError) else None)
                raise TraceReadError(path, f"corrupt archive JSON ({e})",
                                     locus=locus) from e
            if report is not None:
                report.lose_bytes(path, os.path.getsize(path), "",
                                  f"corrupt archive JSON ({e})")
            return
    _, strings, regions, locs = _unpack_definitions(
        {"definitions": defs} if is_dir else doc, path)
    tw = hints.time_window if hints is not None else None
    for loc in locs:
        try:
            lid = str(loc["id"])
            rank = int(loc["group"])
        except (KeyError, TypeError) as e:
            raise TraceReadError(
                path, f"corrupt OTF2 location table entry ({e})") from e
        if locations_subset is not None and lid not in locations_subset:
            continue
        if hints is not None and not hints.admits_proc(rank):
            continue
        if is_dir:
            fn = os.path.join(path, "locations", f"{lid}.json")
            if not os.path.exists(fn):
                continue
            try:
                require_nonempty(fn, os.path.getsize(fn),
                                 what="OTF2 location stream")
                with open(fn) as f:
                    stream = json.load(f)
            except (ValueError, OSError) as e:
                if on_error == "strict":
                    if isinstance(e, TraceReadError):
                        raise
                    raise TraceReadError(
                        fn, f"corrupt location stream ({e})") from e
                if report is not None:
                    report.skip(fn, 1, "",
                                f"location stream dropped ({e})")
                continue
        else:
            stream = doc["events"].get(lid, [])
        if not stream:
            continue
        try:
            ev = optimize_dtypes(
                _location_frame(loc, stream, strings, regions))
        except (ValueError, TypeError, IndexError, KeyError) as e:
            if on_error == "strict":
                raise TraceReadError(path, f"malformed event stream ({e})",
                                     locus=f"location {lid}") from e
            if report is not None:
                report.skip(path, 1, f"location {lid}",
                            f"location dropped ({e})")
            continue
        if report is not None:
            report.add_rows(path, len(ev))
        if tw is not None:
            ts = np.asarray(ev[TS], np.float64)
            ev = ev.mask((ts >= tw[0]) & (ts <= tw[1]))
        for lo in range(0, len(ev), chunk_rows):
            sub = ev.take(np.arange(lo, min(lo + chunk_rows, len(ev))))
            if len(sub):
                yield sub


@register_units("otf2j")
def plan_units_otf2j(path: str, n_units: int):
    """Per-rank work units for the directory layout: the anchor's location
    table (cheap to read) maps ranks to per-location stream files, so
    disjoint rank groups parallelize with file-level pushdown.  Single-file
    archives decode the whole document per reader call and are not split.
    """
    if not os.path.isdir(path):
        return None
    try:
        with open(os.path.join(path, "definitions.json")) as f:
            defs = json.load(f)
        ranks = sorted({int(loc["group"])
                        for loc in defs.get("locations", [])})
    except (OSError, ValueError, TypeError, KeyError, AttributeError):
        # damaged anchor: no parallel plan — the serial path owns the
        # strict-raise / skip decision
        return None
    n = max(min(int(n_units), len(ranks)), 1)
    if n <= 1:
        return None
    return [ProcSpan(path, procs) for procs in even_groups(ranks, n)]


def write_otf2_json(trace_or_events, path: str, split_locations: bool = False) -> None:
    """Serialize a trace into the OTF2-structured archive (inverse reader)."""
    ev = getattr(trace_or_events, "events", trace_or_events)
    procs = np.asarray(ev[PROC], np.int64)
    threads = np.asarray(ev[THREAD], np.int64) if THREAD in ev else np.zeros_like(procs)
    ts = np.asarray(ev[TS], np.int64)
    names = ev[NAME]
    et = ev[ET]
    sizes = np.asarray(ev[MSG_SIZE], np.float64) if MSG_SIZE in ev else np.full(len(ev), np.nan)
    partners = np.asarray(ev[PARTNER], np.int64) if PARTNER in ev else np.full(len(ev), -1)
    tags = np.asarray(ev[TAG], np.int64) if TAG in ev else np.zeros(len(ev), np.int64)

    uniq_names = sorted({str(n) for n, e in zip(names, et) if e in (ENTER, LEAVE)})
    string_of = {n: i for i, n in enumerate(uniq_names)}
    strings = uniq_names
    regions = [{"name": i} for i in range(len(uniq_names))]

    loc_key = procs * (threads.max() + 1 if len(threads) else 1) + threads
    uniq_locs = np.unique(loc_key)
    locations = []
    events: Dict[str, list] = {}
    for li, lk in enumerate(uniq_locs):
        rows = np.nonzero(loc_key == lk)[0]
        rows = rows[np.argsort(ts[rows], kind="stable")]
        locations.append({"id": li, "group": int(procs[rows[0]]),
                          "thread": int(threads[rows[0]])})
        stream = []
        for r in rows:
            e = et[r]
            nm = str(names[r])
            if e == ENTER:
                stream.append([int(ts[r]), "E", string_of[nm]])
            elif e == LEAVE:
                stream.append([int(ts[r]), "L", string_of[nm]])
            elif nm == MPI_SEND:
                stream.append([int(ts[r]), "S", int(partners[r]),
                               float(np.nan_to_num(sizes[r])), int(tags[r])])
            elif nm == MPI_RECV:
                stream.append([int(ts[r]), "R", int(partners[r]),
                               float(np.nan_to_num(sizes[r])), int(tags[r])])
        events[str(li)] = stream
    defs = {"strings": strings, "regions": regions, "locations": locations}
    if split_locations:
        os.makedirs(os.path.join(path, "locations"), exist_ok=True)
        with open(os.path.join(path, "definitions.json"), "w") as f:
            json.dump(defs, f)
        for lid, stream in events.items():
            with open(os.path.join(path, "locations", f"{lid}.json"), "w") as f:
                json.dump(stream, f)
    else:
        with open(path, "w") as f:
            json.dump({"definitions": defs, "events": events}, f)
