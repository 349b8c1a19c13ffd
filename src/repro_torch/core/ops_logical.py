"""Logical structure, lateness (Isaacs et al.) and critical-path analysis
(paper §IV-D, Figs. 10/11).

The *logical structure* assigns every communication operation a global step
index using the happens-before relation: within a process operations are
sequential; a receive happens after its matching send.  Physical timestamps
give a valid topological order (message latency is non-negative), so logical
steps are computed in one sweep over time-sorted operations.

``calculate_lateness``: lateness(op) = t_complete(op) − min over processes of
t_complete at the same logical step — how far an operation lags the fastest
peer at the same point of the logical program.

``critical_path_analysis``: backward walk from the last completion.  Within a
process we hop to the previous operation; when the walk reaches a receive
whose matching send *ends later than the previous local operation* (i.e. the
process was genuinely waiting on the message), it jumps to the sender.

Mirrors :mod:`repro.core.ops_logical`.  No kernel backs these ops, in the
reference or here: they run in NumPy on the host whatever the ``device``
(which is still checked, so asking for the card without one raises), and
need the whole trace at once, so they have no streaming form.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .accel import resolve_device
from .constants import (ENTER, ET, INSTANT, LEAVE, MATCH, MPI_RECV, MPI_SEND,
                        NAME, PARENT, PROC, TS)
from .frame import EventFrame
from .registry import register_op

__all__ = ["logical_steps", "calculate_lateness", "lateness_by_process",
           "critical_path_analysis"]


# -- recognizing communication operations ---------------------------------

_RECV_NAMES = ("MPI_Recv", "MPI_Irecv", "MPI_Wait", "MPI_Waitall", MPI_RECV, "recv")
_SEND_NAMES = ("MPI_Send", "MPI_Isend", MPI_SEND, "send")


def _op_rows(trace) -> np.ndarray:
    """Rows that constitute 'operations' for the logical timeline: Enter
    events of communication functions plus message instants."""
    ev = trace.events
    et = ev.cat(ET)
    name = ev.cat(NAME)
    is_comm = name.mask_isin(_RECV_NAMES + _SEND_NAMES)
    sel = is_comm & (et.mask_eq(ENTER) | et.mask_eq(INSTANT))
    return np.nonzero(sel)[0]


@register_op("logical_steps", needs_structure=True, needs_messages=True)
def logical_steps(trace, device="cuda") -> EventFrame:
    """Logical (happens-before) step per communication operation.

    Assigns every send/recv/wait operation a global step index: within a
    process operations are sequential, and a receive's step exceeds its
    matching send's — the logical timeline of Isaacs et al. that lateness
    and critical-path analysis build on.

    Returns:
        EventFrame with one row per operation: ``row`` (index into
        ``trace.events``), ``Process``, ``Name``, ``Timestamp (ns)``,
        ``complete`` (ns when the operation finished — its Leave, or its
        own timestamp for instants), and ``step`` (logical step index).
    """
    resolve_device(device)
    trace._ensure_structure()
    trace._ensure_messages()
    ev = trace.events
    ts = np.asarray(ev[TS], np.float64)
    procs = np.asarray(ev[PROC], np.int64)
    match = np.asarray(ev.column(MATCH), np.int64)
    mmatch = trace._msg_match
    name = ev.cat(NAME)
    is_recv = name.mask_isin(_RECV_NAMES)

    rows = _op_rows(trace)
    if len(rows) == 0:
        return EventFrame({"row": np.asarray([], np.int64)})

    # completion time: Leave of the call (Enter rows) or own ts (instants)
    complete = np.where(match[rows] >= 0, ts[np.maximum(match[rows], 0)], ts[rows])

    # message partner *operation*: for a recv operation, the row of the send
    # operation it depends on.  Message instants are matched directly; for
    # Enter(MPI_Recv) style rows, the instant lives inside the call — map the
    # instant's row to its enclosing comm Enter via parent links.
    parent = np.asarray(ev.column(PARENT), np.int64)
    op_of_row = np.full(len(ev), -1, np.int64)
    op_of_row[rows] = np.arange(len(rows))
    # an instant's operation is itself if selected, else its parent Enter
    inst_rows = np.nonzero(ev.cat(ET).mask_eq(INSTANT))[0]
    carrier = np.where(op_of_row[inst_rows] >= 0, inst_rows,
                       np.maximum(parent[inst_rows], 0))

    pred = np.full(len(rows), -1, np.int64)  # op index of message predecessor
    if mmatch is not None:
        recv_inst = inst_rows[(mmatch[inst_rows] >= 0) & name.mask_eq(MPI_RECV)[inst_rows]]
        for r in recv_inst:
            send_row = mmatch[r]
            # send's carrying operation
            s_op = op_of_row[send_row]
            if s_op < 0 and parent[send_row] >= 0:
                s_op = op_of_row[parent[send_row]]
            r_op = op_of_row[r]
            if r_op < 0 and parent[r] >= 0:
                r_op = op_of_row[parent[r]]
            if r_op >= 0 and s_op >= 0:
                pred[r_op] = s_op

    # sweep in completion-time order; per-process step counters
    order = np.argsort(complete, kind="stable")
    step = np.zeros(len(rows), np.int64)
    nproc = int(procs.max()) + 1
    proc_step = np.full(nproc, -1, np.int64)
    op_proc = procs[rows]
    for i in order:
        s = proc_step[op_proc[i]] + 1
        if pred[i] >= 0:
            s = max(s, step[pred[i]] + 1)
        step[i] = s
        proc_step[op_proc[i]] = s

    return EventFrame({
        "row": rows, PROC: op_proc.astype(np.int32),
        NAME: ev.cat(NAME).take(rows),
        TS: ts[rows], "complete": complete, "step": step,
    })


@register_op("calculate_lateness", needs_structure=True, needs_messages=True)
def calculate_lateness(trace, device="cuda") -> EventFrame:
    """Lateness per communication operation (§IV-D, Isaacs et al. [27]).

    ``lateness(op) = complete(op) − min over processes of complete at the
    same logical step`` — how far (ns) an operation lags the fastest peer
    at the same point of the logical program.  0 marks the front-runner.

    Returns:
        The :func:`logical_steps` frame plus a ``lateness`` column (ns).
    """
    ops = logical_steps(trace, device=device)
    if len(ops) == 0:
        return ops
    step = np.asarray(ops["step"], np.int64)
    complete = np.asarray(ops["complete"], np.float64)
    nsteps = int(step.max()) + 1
    earliest = np.full(nsteps, np.inf)
    np.minimum.at(earliest, step, complete)
    out = ops.copy()
    out["lateness"] = complete - earliest[step]
    return out


@register_op("lateness_by_process", needs_structure=True, needs_messages=True)
def lateness_by_process(trace, device="cuda") -> EventFrame:
    """Maximum lateness per process (paper Fig. 11, right).

    Identifies the processes that fall furthest behind the logical front —
    the usual suspects for a load-imbalance or slow-link root cause.

    Returns:
        EventFrame with ``Process`` and ``max_lateness`` (ns, the worst
        lateness of any of the process's operations), sorted descending.
    """
    ops = calculate_lateness(trace, device=device)
    if len(ops) == 0:
        return ops
    procs = np.asarray(ops[PROC], np.int64)
    late = np.asarray(ops["lateness"], np.float64)
    nproc = int(procs.max()) + 1
    mx = np.zeros(nproc)
    np.maximum.at(mx, procs, late)
    order = np.argsort(-mx, kind="stable")
    return EventFrame({PROC: order.astype(np.int32), "max_lateness": mx[order]})


@register_op("critical_path_analysis", needs_structure=True, needs_messages=True)
def critical_path_analysis(trace, max_hops: int = 1_000_000,
                           device="cuda") -> List[EventFrame]:
    """Critical path of the execution (§IV-D, Fig. 10).

    Walks backward from the last completion: within a process it hops to
    the previous operation; at a receive that was genuinely waiting (its
    matching send ends later than the previous local operation) it jumps to
    the sender.  The result is the dependency chain that bounds the run's
    wall-clock time — shorten something on it or the run doesn't speed up.

    Args:
        max_hops: safety bound on walk length for malformed traces.

    Returns:
        Single-element list (paper API shape) holding an EventFrame of the
        path's events, earliest first, with ``_row`` giving each event's
        row index in ``trace.events``.
    """
    resolve_device(device)
    trace._ensure_structure()
    trace._ensure_messages()
    ev = trace.events
    ts = np.asarray(ev[TS], np.float64)
    procs = np.asarray(ev[PROC], np.int64)
    match = np.asarray(ev.column(MATCH), np.int64)
    parent = np.asarray(ev.column(PARENT), np.int64)
    mmatch = trace._msg_match
    name = ev.cat(NAME)
    et = ev.cat(ET)
    is_enter = et.mask_eq(ENTER)
    is_recv_call = name.mask_isin(_RECV_NAMES) & is_enter
    n = len(ev)
    if n == 0:
        return [EventFrame()]

    # per-process event rows in time order (enters only, the call timeline)
    ent_rows = np.nonzero(is_enter)[0]
    by_proc: dict = {}
    posmap = np.full(n, -1, np.int64)
    for p in np.unique(procs[ent_rows]):
        rows = ent_rows[procs[ent_rows] == p]
        rows = rows[np.argsort(ts[rows], kind="stable")]
        by_proc[int(p)] = rows
        posmap[rows] = np.arange(len(rows))

    # map recv call -> matching send call row (via the message instants)
    recv2send = np.full(n, -1, np.int64)
    if mmatch is not None:
        inst_rows = np.nonzero(name.mask_eq(MPI_RECV) & (mmatch >= 0))[0]
        for r in inst_rows:
            rcall = parent[r] if parent[r] >= 0 else r
            scall = parent[mmatch[r]] if parent[mmatch[r]] >= 0 else mmatch[r]
            if rcall >= 0:
                recv2send[rcall] = scall

    # start: the *last operation* (latest Enter) on the last-finishing process
    leaves = np.nonzero(et.mask_eq(LEAVE) & (match >= 0))[0]
    if len(leaves) == 0:
        return [EventFrame()]
    p_star = int(procs[leaves[np.argmax(ts[leaves])]])
    cur = int(by_proc[p_star][-1])
    path: List[int] = []
    hops = 0
    while cur >= 0 and hops < max_hops:
        hops += 1
        path.append(cur)
        p = int(procs[cur])
        rows = by_proc.get(p)
        i = int(posmap[cur])  # index of cur within its process timeline
        if is_recv_call[cur] and recv2send[cur] >= 0:
            prev_end = ts[match[rows[i - 1]]] if i > 0 and match[rows[i - 1]] >= 0 \
                else -np.inf
            send = int(recv2send[cur])
            send_end = ts[match[send]] if match[send] >= 0 else ts[send]
            if send_end >= prev_end:  # genuinely waiting on the message
                cur = send
                continue
        cur = int(rows[i - 1]) if i > 0 else -1
    path_rows = np.asarray(path[::-1], np.int64)
    out = ev.take(path_rows)
    out["_row"] = path_rows
    return [out]
