"""HLO reader: a compiled XLA program becomes a Pipit trace.

Mirrors :mod:`repro.readers.hlo`.  The *planned* execution of a compiled
SPMD program is modeled as a per-device event timeline that every Pipit
operation (comm_matrix, comm_comp_breakdown, time_profile, critical path)
can analyze.  The rates come from ``hw``: by default the port's H100
table (:data:`repro_torch.analysis.roofline.HW`); pass another table (the
reference's, say) to model other hardware.

Model:

* the entry computation's instructions execute in text order, one logical
  "process" per modeled device (SPMD ⇒ identical programs);
* compute ops (fusion/dot/etc.) take ``max(flops/peak, bytes/hbm_bw)``
  seconds; dot FLOPs come from resolved operand shapes, byte counts from the
  result + operand shapes on the line;
* collectives take ``wire_bytes/link_bw`` and emit ring MpiSend/MpiRecv
  instants to the neighbor device; ``*-start``/``*-done`` pairs model
  *asynchronous* collectives: the transfer runs on thread 1 while compute
  continues on thread 0 — Pipit's ``comm_comp_breakdown`` then measures the
  overlap the compiler actually scheduled;
* ``while`` bodies are expanded ``trip_count`` times (parsed from the loop
  condition).

Timestamps are nanoseconds.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import numpy as np

from ..analysis.hlostats import DTYPE_BYTES, shape_bytes
from ..analysis.roofline import HW
from ..core.constants import (ENTER, ET, LEAVE, MPI_RECV, MPI_SEND, MSG_SIZE,
                              NAME, PARTNER, PROC, TAG, THREAD, TS)
from ..core.errors import (IngestReport, TraceReadError, check_on_error,
                           require_nonempty)
from ..core.frame import Categorical, EventFrame
from ..core.registry import register_reader
from ..core.trace import Trace

__all__ = ["read_hlo", "read_hlo_file"]

_DEF = re.compile(r"^\s*(?:ROOT\s+)?%([\w\.\-]+)\s*=\s*(\w+)\[([\d,]*)\]")
_OPKIND = re.compile(r"=\s*(?:\([^)]*\)|[\w\[\],{}]+)?\s*([a-z][\w\-]*)\(")
_COMP_HDR = re.compile(r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s*\(")
_CONTRACT = re.compile(r"lhs_contracting_dims=\{([\d,]*)\}")
_WHILE = re.compile(r"while\(.*?\)\s*,\s*condition=%?([\w\.\-]+)\s*,\s*body=%?([\w\.\-]+)")
_CALLS = re.compile(r"(?:calls|to_apply|body)=%?([\w\.\-]+)")
_CONST_INT = re.compile(r"constant\((\d+)\)")

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_SKIP = {"parameter", "constant", "tuple", "get-tuple-element", "bitcast",
         "after-all", "iota", "broadcast", "reshape", "transpose", "copy"}


def _line_bytes(line: str) -> int:
    return sum(shape_bytes(f"{m.group(1)}[{m.group(2)}]")
               for m in re.finditer(r"(\w+)\[([\d,]*)\]", line)
               if m.group(1) in DTYPE_BYTES)


def _dot_flops(line: str, shapes: Dict[str, tuple]) -> float:
    m = _DEF.match(line)
    if not m:
        return 0.0
    res = 1
    for x in m.group(3).split(","):
        if x:
            res *= int(x)
    ops = re.findall(r"%([\w\.\-]+)", line)
    k = 1
    c = _CONTRACT.search(line)
    if c and len(ops) >= 2:
        lhs = shapes.get(ops[1], ())
        for ci in (int(x) for x in c.group(1).split(",") if x):
            if ci < len(lhs):
                k *= lhs[ci]
    return 2.0 * res * k


def _sniff_hlo(path: str, head: str) -> bool:
    return head.lstrip().startswith("HloModule")


@register_reader("hlo", extensions=(".hlo", ".hlo.txt"), sniff=_sniff_hlo,
                 priority=30)
def read_hlo_file(path: str, on_error: str = "strict",
                  report: Optional[IngestReport] = None, **kw) -> Trace:
    """Registry entry point: read an HLO text dump from a file path.

    The HLO parser is line-regex based and inherently lenient — unmatched
    lines are simply not events — so the only hard fault is a dump with no
    ``ENTRY`` computation: ``on_error="strict"`` raises, ``"skip"``
    returns an empty trace with the fault recorded."""
    check_on_error(on_error, ("strict", "skip"))
    rpt = report if report is not None else IngestReport()
    require_nonempty(path, os.path.getsize(path), what="HLO dump")
    rpt.begin(path)
    with open(path) as f:
        text = f.read()
    try:
        t = read_hlo(text, **kw)
    except ValueError as e:
        if on_error == "strict":
            raise TraceReadError(path, str(e)) from e
        rpt.skip(path, 1, "", str(e))
        t = Trace(EventFrame(), label=kw.get("label") or path,
                  device=kw.get("device", "cuda"))
    else:
        rpt.add_rows(path, len(t.events))
    t._ingest = rpt
    return t


def read_hlo(hlo_text: str, *, n_procs: int = 8, label: Optional[str] = None,
             hw: Dict[str, float] = HW, group_size: int = 256,
             max_events_per_proc: int = 200_000, device="cuda") -> Trace:
    """Model ``hlo_text``'s entry computation on ``n_procs`` devices at the
    rates of ``hw`` (at most ``max_events_per_proc`` calls a device) as a
    Trace whose ops run on ``device``; ValueError without an ``ENTRY``."""
    shapes: Dict[str, tuple] = {}
    comp_lines: Dict[str, List[str]] = {}
    comp = "?"
    entry = None
    trips: Dict[str, int] = {}
    conds: Dict[str, str] = {}
    for line in hlo_text.splitlines():
        if line and not line.startswith(" "):
            h = _COMP_HDR.match(line.strip())
            if h and "{" in line:
                comp = h.group(1)
                comp_lines.setdefault(comp, [])
                if line.startswith("ENTRY"):
                    entry = comp
        m = _DEF.match(line)
        if m:
            shapes[m.group(1)] = tuple(int(x) for x in m.group(3).split(",") if x)
        w = _WHILE.search(line)
        if w:
            conds[w.group(2)] = w.group(1)
        comp_lines.setdefault(comp, []).append(line)
    for body, cond in conds.items():
        consts: List[int] = []
        for line in comp_lines.get(cond, []):
            consts += [int(x) for x in _CONST_INT.findall(line)]
        trips[body] = max(consts) if consts else 1

    # -- single-device schedule --------------------------------------------
    events: List[tuple] = []   # (t_enter, t_leave, name, thread, partner_sz)
    pending_async: Dict[str, float] = {}
    # a line's op kind, bytes and dot FLOPs depend on the line alone: a
    # loop body's lines are parsed once, not once an iteration
    kinds: Dict[str, Optional[str]] = {}
    nbytes: Dict[str, int] = {}
    flops: Dict[str, float] = {}

    def line_bytes(line: str) -> int:
        b = nbytes.get(line)
        if b is None:
            b = nbytes[line] = _line_bytes(line)
        return b

    def dot_flops(line: str) -> float:
        f = flops.get(line)
        if f is None:
            f = flops[line] = _dot_flops(line, shapes)
        return f

    def emit(comp_name: str, t0: float) -> float:
        t = t0
        for line in comp_lines.get(comp_name, []):
            if len(events) >= max_events_per_proc:
                return t
            if line in kinds:
                kind = kinds[line]
            else:
                k = _OPKIND.search(line)
                kind = kinds[line] = k.group(1) if k else None
            if kind is None:
                continue
            if kind in _SKIP:
                continue
            if kind == "while":
                w = _WHILE.search(line)
                if w:
                    body = w.group(2)
                    for it in range(trips.get(body, 1)):
                        t = emit(body, t)
                        if len(events) >= max_events_per_proc:
                            return t
                continue
            base = next((c for c in _COLLECTIVES if kind.startswith(c)), None)
            if base is not None:
                g = group_size
                fac = (g - 1) / g
                b = line_bytes(line)
                wire = {"all-gather": fac * b, "all-reduce": 2 * fac * b,
                        "reduce-scatter": fac * b, "all-to-all": fac * b,
                        "collective-permute": float(b)}[base]
                dur = max(wire / hw["ici_bw"] * 1e9, 1.0)
                name = _DEF.match(line)
                nm = name.group(1) if name else base
                if kind.endswith("-start"):
                    pending_async[nm.replace("-start", "")] = t
                    events.append((t, t + dur, base, 1, wire))
                    continue
                if kind.endswith("-done"):
                    # wait until the async transfer (started earlier) is done
                    ops = re.findall(r"%([\w\.\-]+)", line)
                    st = pending_async.pop(ops[1].replace("-start", ""), t) \
                        if len(ops) > 1 else t
                    t = max(t, st + dur)
                    continue
                events.append((t, t + dur, base, 0, wire))
                t += dur
                continue
            # compute-ish op
            fl = dot_flops(line) if kind == "dot" else 0.0
            by = line_bytes(line)
            dur = max(fl / hw["peak_flops"] * 1e9, by / hw["hbm_bw"] * 1e9)
            if dur < 50.0 and kind not in ("dot", "fusion", "custom-call",
                                           "convolution"):
                continue   # drop sub-50ns bookkeeping ops
            if kind == "fusion" or kind == "call":
                c = _CALLS.search(line)
                if c and any(" dot(" in l for l in comp_lines.get(c.group(1), [])):
                    for l2 in comp_lines.get(c.group(1), []):
                        if " dot(" in l2:
                            fl += dot_flops(l2)
                    dur = max(dur, fl / hw["peak_flops"] * 1e9)
            events.append((t, t + max(dur, 1.0), kind, 0, None))
            t += max(dur, 1.0)
        return t

    if entry is None:
        raise ValueError("no ENTRY computation in HLO dump")
    emit(entry, 0.0)

    # -- replicate across modeled devices + ring messages --------------------
    ev = _replicate(events, n_procs)
    tr = Trace(ev.sort_by([PROC, TS]), label=label or "hlo", device=device)
    tr.definitions["modeled"] = {"n_procs": n_procs, "group_size": group_size,
                                 "hw": dict(hw)}
    return tr


def _replicate(events: List[tuple], n_procs: int) -> EventFrame:
    """The single-device schedule on each of ``n_procs`` devices: an
    Enter/Leave pair a call and, for a collective, a ring MpiSend to the
    next device and MpiRecv from the previous one at the call's midpoint.
    The rows and their order are the reference's (device by device, call
    by call); they are built with array ops, and the string columns as
    categoricals from the one device's rows."""
    n_ev = len(events)
    if n_ev == 0 or n_procs <= 0:
        empty = np.asarray([])
        return EventFrame({
            TS: np.asarray([], np.float64), ET: empty, NAME: empty,
            PROC: np.asarray([], np.int64),
            THREAD: np.asarray([], np.int64),
            PARTNER: np.asarray([], np.int64),
            MSG_SIZE: np.asarray([], np.float64),
            TAG: np.zeros(0, np.int64)})
    t0 = np.asarray([e[0] for e in events], np.float64)
    t1 = np.asarray([e[1] for e in events], np.float64)
    names = np.asarray([e[2] for e in events], dtype=object)
    threads = np.asarray([e[3] for e in events], np.int64)
    msg = np.asarray([e[4] is not None for e in events])
    wire = np.asarray([e[4] if e[4] is not None else np.nan
                       for e in events], np.float64)
    # one device's rows: 2 a call, 4 a collective
    per = 2 + 2 * msg.astype(np.int64)
    start = np.cumsum(per) - per
    n_rows = int(per.sum())
    ts = np.empty(n_rows, np.float64)
    et = np.empty(n_rows, dtype=object)
    name = np.empty(n_rows, dtype=object)
    thread = np.repeat(threads, per)
    side = np.zeros(n_rows, np.int64)      # +1 a send, -1 a receive
    size = np.full(n_rows, np.nan)
    ts[start], ts[start + 1] = t0, t1
    et[start], et[start + 1] = ENTER, LEAVE
    name[start] = name[start + 1] = names
    m = start[msg]
    mid = 0.5 * (t0[msg] + t1[msg])
    ts[m + 2], ts[m + 3] = mid, mid + 1
    et[m + 2], et[m + 3] = "MpiSend", "MpiRecv"
    name[m + 2], name[m + 3] = MPI_SEND, MPI_RECV
    side[m + 2], side[m + 3] = 1, -1
    size[m + 2] = size[m + 3] = wire[msg]

    def tiled(col) -> Categorical:
        cats, codes = np.unique(col.astype(str), return_inverse=True)
        return Categorical(np.tile(codes.astype(np.int32), n_procs), cats)

    procs = np.arange(n_procs, dtype=np.int64)
    partner = np.where(side[None, :] > 0, ((procs + 1) % n_procs)[:, None],
                       np.where(side[None, :] < 0,
                                ((procs - 1) % n_procs)[:, None], -1))
    n = n_rows * n_procs
    return EventFrame({
        TS: np.tile(ts, n_procs), ET: tiled(et), NAME: tiled(name),
        PROC: np.repeat(procs, n_rows),
        THREAD: np.tile(thread, n_procs),
        PARTNER: partner.reshape(-1).astype(np.int64),
        MSG_SIZE: np.tile(size, n_procs),
        TAG: np.zeros(n, np.int64),
    })
