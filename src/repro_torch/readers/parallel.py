"""Parallel sharded reading (paper §VI, Fig. 5 center).

Mirrors :mod:`repro.readers.parallel`.  Trace archives are sharded per
location (one ``rank_<p>.*`` file per rank); this module fans a reader over
the shards with a ``multiprocessing`` spawn pool and concatenates the
frames in (process, time) order.  Format dispatch goes through the reader
registry (:mod:`repro_torch.core.registry`), so ``kind="auto"`` sniffs each
shard.  When a plan restricts processes, shards whose registered
``shard_procs`` hint proves they cannot contribute are *skipped before
parsing* (predicate pushdown into the reader).

Workers read on the host only (their frames never reach a device); the
merged Trace runs its ops on the caller's ``device``.  Unlike the
reference, ``processes=None`` reads serially: a spawn worker imports
``torch``, which takes seconds, so the pool is opt-in (``processes=N``).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.accel import resolve_device
from ..core.constants import (DERIVED_COLUMNS, ENTER, ET, INSTANT, LEAVE,
                              NAME, PROC, TS)
from ..core.frame import Categorical, EventFrame, concat
from ..core.registry import resolve_reader
from ..core.trace import Trace
from ..parallel_util import map_maybe_parallel, spawn_pool_ok

__all__ = ["read_parallel", "open_many", "select_shards",
           "split_jsonl_by_process", "spawn_pool_ok"]


def _ensure_registered() -> None:
    # importing the reader modules populates the registry: needed in the
    # parent (when only this module was imported) and in spawned workers
    from . import chrome, csvreader, hlo, jsonl, otf2j, pack  # noqa: F401


def _read_one(args) -> EventFrame:
    kind, path, reader_kwargs = args
    _ensure_registered()
    ev = resolve_reader(path, kind).open(path, "cpu",
                                         **(reader_kwargs or {})).events
    # per-shard derived structure (pack sidecars) indexes the shard's own
    # rows; the merged sort below invalidates it — strip before concat
    return ev.drop(*DERIVED_COLUMNS)


def select_shards(paths: Sequence[str], kind: str = "auto",
                  procs: Optional[Set[int]] = None,
                  proc_bounds: Optional[Tuple[float, float]] = None
                  ) -> List[str]:
    """Shards that can contribute events under the given process
    restriction: a shard is kept when its reader gives no ``shard_procs``
    hint (unknown contents are never skipped) or when a hinted process id
    satisfies both the explicit set and the [lo, hi] bounds."""
    paths = list(paths)
    if procs is None and proc_bounds is None:
        return paths
    _ensure_registered()
    keep: List[str] = []
    for p in paths:
        spec = resolve_reader(p, kind)
        hint = spec.shard_procs(p) if spec.shard_procs else None
        if hint is None:
            keep.append(p)
            continue
        if any((procs is None or q in procs)
               and (proc_bounds is None
                    or proc_bounds[0] <= q <= proc_bounds[1])
               for q in hint):
            keep.append(p)
    return keep


def read_parallel(paths: Sequence[str], kind: str = "auto",
                  processes: Optional[int] = None,
                  label: Optional[str] = None,
                  procs: Optional[Set[int]] = None,
                  proc_bounds: Optional[Tuple[float, float]] = None,
                  device="cuda", **reader_kwargs) -> Trace:
    """Read per-location shards (in a spawn pool of up to ``processes``
    workers when that is more than 1; serially by default) and merge them
    into one Trace whose ops run on ``device``.  Extra keyword arguments
    go to every per-shard reader."""
    _ensure_registered()
    sel = select_shards(paths, kind, procs=procs, proc_bounds=proc_bounds)
    if not sel:
        # canonical empty frame: ops on a fully-pruned read must see the
        # uniform columns, not a column-less frame
        empty = EventFrame({
            TS: np.asarray([], np.int64),
            ET: Categorical.from_codes(np.asarray([], np.int32),
                                       np.asarray([ENTER, LEAVE, INSTANT])),
            NAME: Categorical.from_codes(np.asarray([], np.int32),
                                         np.asarray([], dtype=object)),
            PROC: np.asarray([], np.int64),
        })
        return Trace(empty, label=label or "parallel[0]", device=device)
    args = [(kind, p, reader_kwargs) for p in sel]
    frames, _pooled = map_maybe_parallel(_read_one, args, processes)
    ev = concat(frames).sort_by([PROC, TS])
    return Trace(ev, label=label or f"parallel[{len(sel)}]", device=device)


def _open_one(args) -> Trace:
    kind, item, reader_kwargs = args
    _ensure_registered()
    return Trace.open(item, format=kind, device="cpu",
                      **(reader_kwargs or {}))


def open_many(paths: Sequence, kind: str = "auto",
              processes: Optional[int] = None, device="cuda",
              **reader_kwargs) -> List[Trace]:
    """Open N *whole traces* (batched ingest for cross-run comparisons):
    one Trace per item, each on ``device``.  An item may itself be a list
    of shard paths, read through :func:`read_parallel`.  ``processes`` > 1
    opens the members in a spawn pool (the calling script needs the
    standard ``if __name__ == "__main__"`` guard); the default is serial."""
    _ensure_registered()
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]  # a bare path must not be iterated char by char
    args = [(kind, os.fspath(p) if isinstance(p, (str, os.PathLike)) else
             [os.fspath(q) for q in p], reader_kwargs) for p in paths]
    if not args:
        return []
    dev = resolve_device(device)
    traces, _pooled = map_maybe_parallel(_open_one, args, processes)
    for t in traces:
        t.device = dev
    return traces


def split_jsonl_by_process(path: str, out_dir: str) -> List[str]:
    """Shard a JSONL trace by process id (one ``rank_<p>.jsonl`` file per
    rank)."""
    import json
    os.makedirs(out_dir, exist_ok=True)
    handles = {}
    try:
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                p = json.loads(line).get("proc", 0)
                if p not in handles:
                    handles[p] = open(os.path.join(out_dir,
                                                   f"rank_{p}.jsonl"), "w")
                handles[p].write(line)
    finally:
        for h in handles.values():
            h.close()
    return [os.path.join(out_dir, f"rank_{p}.jsonl")
            for p in sorted(handles)]
