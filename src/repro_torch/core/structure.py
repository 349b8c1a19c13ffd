"""Structural derivations over a trace: enter/leave matching, call depth,
caller/callee (parent) relations, inclusive/exclusive metrics, message matching.

All hot paths are vectorized NumPy (the paper's §III-A argument); the only
Python-level loops are over *call depth levels* (tens) and mismatch-repair
fallbacks, never over events.

A copy of :mod:`repro.core.structure` (the port imports nothing of the JAX
package).  Structure is derived on the host, exactly as the reference does.
One addition, for the streaming stitcher: ``open_head=True`` matches a
chunk that starts inside calls opened before it (see :func:`match_events`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .constants import (ENTER, ET, INSTANT, LEAVE, MPI_RECV, MPI_SEND, NAME,
                        PARTNER, PROC, TAG, THREAD, TS)
from .frame import EventFrame


def _group_ids(events: EventFrame) -> np.ndarray:
    """Integer id per (process, thread)."""
    proc = np.asarray(events[PROC], np.int64)
    if THREAD in events:
        thread = np.asarray(events[THREAD], np.int64)
    else:
        thread = np.zeros_like(proc)
    key = proc * (thread.max() + 1 if len(thread) else 1) + thread
    _, gid = np.unique(key, return_inverse=True)
    return gid.astype(np.int64)


def match_events(events: EventFrame, open_head: bool = False
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized enter/leave matching.

    Returns ``(matching, depth, order)`` where ``matching[i]`` is the row index
    of event *i*'s partner (-1 for instants / unmatched), ``depth[i]`` is the
    call depth of the event (0 = top level), and ``order`` is the
    (process, thread, time)-sorted permutation used (stable; callers reuse it).

    Algorithm: within each (process, thread), Enter=+1 / Leave=-1 gives a
    running depth via segmented cumsum.  Within one (group, depth) level,
    enters and leaves strictly alternate in time order, so the k-th enter
    matches the k-th leave — a pure sort-and-align, no stack machine.

    A Leave below depth 0 (a truncated head) is unmatched, and so, by
    default, is every event after it in its (process, thread), as in the
    reference.  ``open_head=True`` is for a chunk that continues a stream
    (the streaming stitcher's): such a Leave closes a call opened before
    the chunk, and the depths after it count from it, so the calls that
    open and close inside the chunk after it still match here, not one
    by one in the stitcher's carry stacks.
    """
    n = len(events)
    matching = np.full(n, -1, np.int64)
    depth = np.zeros(n, np.int32)
    if n == 0:
        return matching, depth, np.arange(0)

    gid = _group_ids(events)
    ts = np.asarray(events[TS], np.int64)
    et = events.cat(ET)
    is_enter = et.mask_eq(ENTER)
    is_leave = et.mask_eq(LEAVE)

    order = np.lexsort((ts, gid))  # stable: preserves file order for equal ts
    g_s = gid[order]
    sign = np.where(is_enter[order], 1, np.where(is_leave[order], -1, 0)).astype(np.int64)

    # segmented cumulative depth (reset at each group boundary)
    total = np.cumsum(sign)
    grp_start = np.zeros(n, dtype=bool)
    grp_start[0] = True
    grp_start[1:] = g_s[1:] != g_s[:-1]
    start_idx = np.nonzero(grp_start)[0]
    base_vals = np.concatenate([[0], total[start_idx[1:] - 1]])
    seg = np.cumsum(grp_start) - 1  # group ordinal per sorted row
    post = total - base_vals[seg]

    e_s = is_enter[order]
    l_s = is_leave[order]
    if open_head:
        # the group's lowest depth before each event (0 at its start): a
        # Leave that goes below it closes a call opened before the chunk
        big = 2 * n + 2
        low = np.minimum.accumulate(post - seg * big) + seg * big
        floor = np.zeros(n, np.int64)
        floor[1:] = np.minimum(low[:-1], 0)
        floor[grp_start] = 0
        post = post - floor
    # depth of the call an event belongs to
    depth_call = np.where(e_s, post - 1, post).astype(np.int64)
    neg = depth_call < 0  # unbalanced leaves (truncated head) — unmatched
    depth_call = np.maximum(depth_call, 0)

    pos = np.arange(n, dtype=np.int64)
    # composite key (group, depth) — dense encoding
    maxd = int(depth_call.max()) + 1 if n else 1
    key = g_s * maxd + depth_call

    ew = np.nonzero(e_s & ~neg)[0]
    lw = np.nonzero(l_s & ~neg)[0]
    # sort each side by (key, position); stable lexsort keeps time order per key
    e_sorted = ew[np.lexsort((pos[ew], key[ew]))]
    l_sorted = lw[np.lexsort((pos[lw], key[lw]))]

    m = min(len(e_sorted), len(l_sorted))
    ok = np.zeros(m, dtype=bool)
    if m:
        ok = key[e_sorted[:m]] == key[l_sorted[:m]]
    if m and not ok.all() or len(e_sorted) != len(l_sorted):
        # unbalanced trace (e.g. truncated): repair by per-key alignment
        e_sorted, l_sorted = _align_by_key(key, pos, e_sorted, l_sorted)
        m = len(e_sorted)
        ok = np.ones(m, dtype=bool)
    e_al, l_al = e_sorted[:m][ok[:m]], l_sorted[:m][ok[:m]]
    # enter must precede its leave
    good = pos[e_al] < pos[l_al]
    e_al, l_al = e_al[good], l_al[good]

    orig_e = order[e_al]
    orig_l = order[l_al]
    matching[orig_e] = orig_l
    matching[orig_l] = orig_e
    depth[order] = depth_call.astype(np.int32)
    return matching, depth, order


def _align_by_key(key, pos, e_sorted, l_sorted):
    """Per-key alignment fallback for unbalanced traces (rare path)."""
    ek, lk = key[e_sorted], key[l_sorted]
    keys = np.unique(np.concatenate([ek, lk]))
    e_keep, l_keep = [], []
    for k in keys:
        es = e_sorted[ek == k]
        ls = l_sorted[lk == k]
        m = min(len(es), len(ls))
        e_keep.append(es[:m])
        l_keep.append(ls[:m])
    return (np.concatenate(e_keep) if e_keep else e_sorted[:0],
            np.concatenate(l_keep) if l_keep else l_sorted[:0])


def compute_parents(events: EventFrame, matching: np.ndarray, depth: np.ndarray,
                    order: np.ndarray) -> np.ndarray:
    """Parent (enclosing call's Enter row) per event; -1 at top level.

    Loop over depth *levels* only: parent of an event at depth d is the most
    recent Enter at depth d-1 within the same (process, thread) — one
    ``searchsorted`` per level.
    """
    n = len(events)
    parent = np.full(n, -1, np.int64)
    if n == 0:
        return parent
    gid = _group_ids(events)
    et = events.cat(ET)
    is_enter = et.mask_eq(ENTER)

    # position of each event in the canonical (group, time) order
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    # encode (group, rank) into one sortable key; rank < n so multiply by n+1
    gkey = gid.astype(np.int64) * (n + 1) + rank

    # events at "slot depth" d need the latest enter at depth d-1 before them.
    # enters have slot depth = depth; leaves/instants slot depth = depth + 1
    # (they live *inside* the call at their depth)... but leaves belong to the
    # call at `depth`, whose parent is at depth-1 — identical to their enter's
    # parent, so we assign leave parents from their matched enter afterwards.
    is_leave = et.mask_eq(LEAVE)
    inst = ~is_enter & ~is_leave

    maxd = int(depth.max()) if n else 0
    enters_by_depth = {}
    for d in range(0, maxd + 1):
        sel = np.nonzero(is_enter & (depth == d))[0]
        enters_by_depth[d] = sel[np.argsort(gkey[sel], kind="stable")]

    for d in range(1, maxd + 1):
        targets = np.nonzero((is_enter & (depth == d)) | (inst & (depth == d)))[0]
        if len(targets) == 0:
            continue
        cand = enters_by_depth.get(d - 1)
        if cand is None or len(cand) == 0:
            continue
        ck = gkey[cand]
        j = np.searchsorted(ck, gkey[targets]) - 1
        valid = j >= 0
        pj = cand[np.maximum(j, 0)]
        valid &= gid[pj] == gid[targets]
        parent[targets[valid]] = pj[valid]

    # instants at depth 0 sit inside the depth-0 call? no: depth 0 instant is
    # outside any call only if no call open; if inside the top-level call its
    # depth is 1 (post of cumsum unchanged by instant). Handled above.
    leaves = np.nonzero(is_leave & (matching >= 0))[0]
    parent[leaves] = parent[matching[leaves]]
    return parent


def compute_inc_exc(events: EventFrame, matching: np.ndarray, parent: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Inclusive / exclusive time per Enter row (NaN elsewhere)."""
    n = len(events)
    ts = np.asarray(events[TS], np.float64)
    et = events.cat(ET)
    is_enter = et.mask_eq(ENTER)
    inc = np.full(n, np.nan)
    exc = np.full(n, np.nan)
    ent = np.nonzero(is_enter & (matching >= 0))[0]
    inc[ent] = ts[matching[ent]] - ts[ent]
    child_sum = np.zeros(n)
    has_par = ent[parent[ent] >= 0]
    np.add.at(child_sum, parent[has_par], inc[has_par])
    exc[ent] = inc[ent] - child_sum[ent]
    return inc, exc


#: process-local call counter for :func:`derive_structure` — the test hook
#: proving that reopening a pack with a structure sidecar (or streaming it
#: chunk by chunk) never derives structure again.  Monotonic: snapshot
#: before, compare after.
DERIVE_CALLS = 0


def derive_structure(events: EventFrame, open_head: bool = False
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray, np.ndarray]:
    """The full structural derivation in one call:
    ``(matching, depth, parent, inc, exc)`` — the match → parents →
    inc/exc pipeline ``Trace._ensure_structure`` runs on whole traces and
    the streaming stitcher on every chunk (with ``open_head=True``, see
    :func:`match_events`).  Every call bumps :data:`DERIVE_CALLS`.
    """
    global DERIVE_CALLS
    DERIVE_CALLS += 1
    matching, depth, order = match_events(events, open_head)
    parent = compute_parents(events, matching, depth, order)
    inc, exc = compute_inc_exc(events, matching, parent)
    return matching, depth, parent, inc, exc


def match_messages(events: EventFrame) -> np.ndarray:
    """FIFO-match MpiSend/MpiRecv instants by (src, dst, tag) channel order.

    Returns ``msg_match`` with the partner row index (-1 if unmatched).
    """
    n = len(events)
    out = np.full(n, -1, np.int64)
    if n == 0 or PARTNER not in events:
        return out
    name = events.cat(NAME)
    sends = np.nonzero(name.mask_eq(MPI_SEND))[0]
    recvs = np.nonzero(name.mask_eq(MPI_RECV))[0]
    if len(sends) == 0 or len(recvs) == 0:
        return out
    proc = np.asarray(events[PROC], np.int64)
    partner = np.asarray(events[PARTNER], np.int64)
    tag = np.asarray(events[TAG], np.int64) if TAG in events else np.zeros(n, np.int64)
    ts = np.asarray(events[TS], np.int64)

    nprocs = int(proc.max()) + 1
    ntags = int(tag.max()) + 2
    # channel key: (src, dst, tag)
    s_key = (proc[sends] * nprocs + partner[sends]) * ntags + tag[sends]
    r_key = (partner[recvs] * nprocs + proc[recvs]) * ntags + tag[recvs]

    s_ord = sends[np.lexsort((ts[sends], s_key))]
    r_ord = recvs[np.lexsort((ts[recvs], r_key))]
    sk = (proc[s_ord] * nprocs + partner[s_ord]) * ntags + tag[s_ord]
    rk = (partner[r_ord] * nprocs + proc[r_ord]) * ntags + tag[r_ord]
    m = min(len(s_ord), len(r_ord))
    if m and (len(s_ord) != len(r_ord) or not np.array_equal(sk[:m], rk[:m])):
        s_ord, r_ord = _align_by_key_simple(sk, rk, s_ord, r_ord)
        m = len(s_ord)
    s_al, r_al = s_ord[:m], r_ord[:m]
    out[s_al] = r_al
    out[r_al] = s_al
    return out


def _align_by_key_simple(sk, rk, s_ord, r_ord):
    keys = np.unique(np.concatenate([sk, rk]))
    s_keep, r_keep = [], []
    for k in keys:
        ss = s_ord[sk == k]
        rr = r_ord[rk == k]
        m = min(len(ss), len(rr))
        s_keep.append(ss[:m])
        r_keep.append(rr[:m])
    return (np.concatenate(s_keep) if s_keep else s_ord[:0],
            np.concatenate(r_keep) if r_keep else r_ord[:0])
