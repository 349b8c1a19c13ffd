"""Out-of-core trace generation: large sharded traces from a seed.

Mirrors :mod:`repro.tracegen.big` with the same RNG draws
(``_rank_batches``, ``_leaf_batch`` are copies), so both packages generate
identical events from one seed.  :func:`big_trace` writes one shard per
rank in bounded batches: ``rank_<p>.jsonl`` text, or with
``format="pack"`` ``rank_<p>.pack`` columnar shards written straight from
the column batches through a :class:`~repro_torch.readers.pack.PackWriter`
(no text round trip; each shard gets a structure sidecar), the same files
byte for byte as the reference writes.  :func:`big_events` builds the same
events in memory, as the frame ``Trace.open`` gives for those shards.

Each rank's stream is, in time order::

    Enter main()
      Enter iteration / [compute_cells() | halo_exchange() | smooth()
      (+ MpiSend every 8th call)] x calls_per_iter / Leave iteration
      ... repeated ...
    Leave main()
"""

from __future__ import annotations

import os
from typing import Iterator, List, Tuple

import numpy as np

from ..core.constants import (ET, MSG_SIZE, NAME, PARTNER, PROC, TAG,
                              THREAD, TS)
from ..core.frame import Categorical, EventFrame, concat

__all__ = ["big_trace", "big_events"]

_US = 1_000  # ns

# name table (codes are batch-local positions here; writers re-intern)
_NAMES = ("main()", "iteration", "compute_cells()", "halo_exchange()",
          "smooth()", "MpiSend")
_MAIN, _ITER, _MPISEND = 0, 1, 5
_LEAF_NAMES = (2, 3, 4)
# event-type codes match the on-disk convention: Enter=0 / Leave=1 / Instant=2
_ENTER, _LEAVE, _INSTANT = 0, 1, 2


def big_trace(out_dir: str, nprocs: int = 8, events_per_proc: int = 125_000,
              calls_per_iter: int = 500, seed: int = 0,
              batch_calls: int = 50_000, format: str = "jsonl") -> List[str]:
    """Write a sharded synthetic trace of about ``nprocs * events_per_proc``
    events without holding it in memory; returns the shard paths in rank
    order (``out_dir/rank_<p>.<format>``, ``format`` ``"jsonl"`` or
    ``"pack"``)."""
    if format not in ("jsonl", "pack"):
        raise ValueError(f'format must be "jsonl" or "pack", got {format!r}')
    write = _write_rank_jsonl if format == "jsonl" else _write_rank_pack
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for p in range(nprocs):
        path = os.path.join(out_dir, f"rank_{p}.{format}")
        write(path, p, nprocs, events_per_proc, calls_per_iter, seed,
              batch_calls)
        paths.append(path)
    return paths


def big_events(nprocs: int = 8, events_per_proc: int = 125_000,
               calls_per_iter: int = 500, seed: int = 0,
               batch_calls: int = 50_000) -> EventFrame:
    """The events :func:`big_trace` writes for the same parameters, built
    in memory: the frame ``Trace.open`` returns for its shards (per-rank
    frames in the jsonl reader's column shape, merged in (process, time)
    order)."""
    from ..readers.jsonl import finish_frame, sorted_names
    et_cats = np.asarray(["Enter", "Leave", "Instant"])
    frames = []
    for p in range(nprocs):
        cols = list(zip(*_rank_batches(p, nprocs, events_per_proc,
                                       calls_per_iter, seed, batch_calls)))
        ts, et, name, size, tag = (np.concatenate(c) for c in cols)
        n = len(ts)
        msg = ~np.isnan(size)
        present, codes = np.unique(name, return_inverse=True)
        frames.append(finish_frame(sorted_names(EventFrame({
            TS: ts,
            ET: Categorical(et.astype(np.int32), et_cats),
            NAME: Categorical(codes.astype(np.int32),
                              np.asarray(_NAMES)[present]),
            PROC: np.full(n, p, np.int64),
            THREAD: np.zeros(n, np.int64),
            MSG_SIZE: size,
            PARTNER: np.where(msg, (p + 1) % nprocs, -1).astype(np.int64),
            TAG: np.where(msg, tag, 0).astype(np.int64),
        }))))
    return concat(frames).sort_by([PROC, TS])


# ---------------------------------------------------------------------------
# shared vectorized event stream (copied from the reference)
# ---------------------------------------------------------------------------

def _rank_batches(p: int, nprocs: int, events_per_proc: int,
                  calls_per_iter: int, seed: int, batch_calls: int
                  ) -> Iterator[Tuple[np.ndarray, ...]]:
    """Column batches ``(ts, et, name, size, tag)`` of one rank's stream in
    time order — wrapper events included.  ``size`` is NaN on non-message
    rows; every message row is an ``MpiSend`` instant to rank ``p+1``."""
    rng = np.random.default_rng(seed * 100_003 + p)
    # rows per leaf call: 2 (enter/leave); every 8th call adds a message
    # instant; each iteration adds 2 wrapper rows.  Solve for leaf count.
    rows_per_call = 2 + 1 / 8
    n_iters = max(1, int((events_per_proc - 2)
                         / (calls_per_iter * rows_per_call + 2)))
    t = 0
    yield _single(t, _ENTER, _MAIN)
    for it in range(n_iters):
        yield _single(t, _ENTER, _ITER)
        done = 0
        while done < calls_per_iter:
            k = min(batch_calls, calls_per_iter - done)
            batch, t = _leaf_batch(rng, t, k, it)
            yield batch
            done += k
        t += 2 * _US
        yield _single(t, _LEAVE, _ITER)
    t += 5 * _US
    yield _single(t, _LEAVE, _MAIN)


def _single(t: int, et: int, name: int) -> Tuple[np.ndarray, ...]:
    return (np.asarray([t], np.int64), np.asarray([et], np.int8),
            np.asarray([name], np.int32), np.asarray([np.nan]),
            np.asarray([0], np.int64))


def _leaf_batch(rng, t: int, k: int, tag: int) -> Tuple[Tuple[np.ndarray, ...], int]:
    """k leaf calls (plus their message instants) as interleaved column
    arrays, in time order."""
    durs = rng.integers(5 * _US, 40 * _US, size=k)
    which = rng.integers(0, len(_LEAF_NAMES), size=k)
    starts = t + np.concatenate([[0], np.cumsum(durs[:-1])])
    ends = starts + durs
    msg_at = np.arange(k) % 8 == 7  # every 8th call sends
    sizes = rng.integers(256, 8192, size=k)
    n_msg = int(msg_at.sum())
    n = 2 * k + n_msg
    ts = np.empty(n, np.int64)
    et = np.empty(n, np.int8)
    name = np.empty(n, np.int32)
    size = np.full(n, np.nan)
    tags = np.zeros(n, np.int64)
    # row position of each call's enter: 2 rows per call + 1 per earlier msg
    msg_before = np.concatenate([[0], np.cumsum(msg_at[:-1])])
    pos = 2 * np.arange(k) + msg_before
    ts[pos] = starts
    et[pos] = _ENTER
    name[pos] = np.asarray(_LEAF_NAMES, np.int32)[which]
    leave_pos = pos + 1 + msg_at  # message instant (if any) sits between
    ts[leave_pos] = ends
    et[leave_pos] = _LEAVE
    name[leave_pos] = np.asarray(_LEAF_NAMES, np.int32)[which]
    mpos = pos[msg_at] + 1
    ts[mpos] = (starts[msg_at] + ends[msg_at]) // 2
    et[mpos] = _INSTANT
    name[mpos] = _MPISEND
    size[mpos] = sizes[msg_at]
    tags[mpos] = tag
    return (ts, et, name, size, tags), int(ends[-1]) if k else t


# ---------------------------------------------------------------------------
# serialization
# ---------------------------------------------------------------------------

_ET_STR = ("Enter", "Leave", "Instant")


def _write_rank_jsonl(path: str, p: int, nprocs: int, events_per_proc: int,
                      calls_per_iter: int, seed: int,
                      batch_calls: int) -> None:
    dst = (p + 1) % nprocs
    with open(path, "w") as f:
        for ts, et, name, size, tag in _rank_batches(
                p, nprocs, events_per_proc, calls_per_iter, seed,
                batch_calls):
            lines = []
            for i in range(len(ts)):
                if et[i] == _INSTANT:
                    lines.append(
                        f'{{"ts":{ts[i]},"et":"Instant",'
                        f'"name":"{_NAMES[name[i]]}","proc":{p},'
                        f'"partner":{dst},"size":{int(size[i])},'
                        f'"tag":{tag[i]}}}\n')
                else:
                    lines.append(
                        f'{{"ts":{ts[i]},"et":"{_ET_STR[et[i]]}",'
                        f'"name":"{_NAMES[name[i]]}","proc":{p}}}\n')
            f.writelines(lines)


def _write_rank_pack(path: str, p: int, nprocs: int, events_per_proc: int,
                     calls_per_iter: int, seed: int,
                     batch_calls: int) -> None:
    from ..readers.pack import PackWriter
    dst = (p + 1) % nprocs
    cats = np.asarray(_NAMES, dtype=object).astype(str)
    et_cats = np.asarray(_ET_STR)
    # in-place (non-atomic) write: a killed generator leaves finished chunk
    # groups at the destination, which salvage recovers
    with PackWriter(path, atomic=False) as w:
        for ts, et, name, size, tag in _rank_batches(
                p, nprocs, events_per_proc, calls_per_iter, seed,
                batch_calls):
            n = len(ts)
            partner = np.where(np.isnan(size), -1, dst).astype(np.int64)
            w.append(EventFrame({
                TS: ts,
                ET: Categorical(et.astype(np.int32), et_cats),
                NAME: Categorical(name, cats),
                PROC: np.full(n, p, np.int64),
                MSG_SIZE: size,
                PARTNER: partner,
                TAG: np.where(partner >= 0, tag, 0),
            }))
        w.finish(sidecar=True)
