"""pipitpack — the native columnar binary trace store (parse once, mmap ever
after), with per-chunk integrity and salvage.

A copy of :mod:`repro.readers.pack` (the port imports nothing of the
reference package): the same format, the same bytes.  For the same events
``write_pack`` here and in the reference write identical files, sidecar
and content id included (the footer holds no clock, pid or uuid), and each
package reads the other's files.  What the port adds is the ``device=`` of
the Trace a read returns: its ops run their kernels there.

Re-opening a text trace means re-decoding it before the first kernel runs;
a pack stores the uniform data model (paper Fig. 1) as little-endian
per-column arrays plus a small JSON footer holding:

* the **name table** (``Name`` is stored as int32 codes),
* the **chunk index**: fixed-row chunks with each chunk's row range, time
  range, process set, byte span and CRC-32 — chunked/streaming reads skip
  chunks a plan's time-window or process restriction provably cannot need
  *without touching their bytes* (index pushdown),
* an optional **structure sidecar**: matching / depth / parent / inc / exc
  computed once at pack time, so reopening skips ``derive_structure``
  entirely (eager opens attach the columns; streaming chunks carry
  row-localized slices the
  :class:`~repro_torch.core.streaming.CallStitcher` consumes instead of
  deriving per chunk),
* a **content id** (SHA-256 over all column + sidecar bytes), so copies
  and rewrites with identical content can be told apart from changed ones.

Format version 2 file layout (version 1, whole-file column-major, is still
fully readable)::

    #pipitpack 2\\n                      ASCII magic line (sniffable)
    <chunk group 0> <chunk group 1> ...  one group per index chunk
    <sidecar arrays, back to back>       (optional)
    <footer JSON, utf-8>
    <footer length, uint64 LE> <b"PIPITPK\\0">   last 16 bytes

where each **chunk group** is self-describing and individually verifiable::

    <column slices for this chunk's rows, back to back>
    <trailer JSON>                       seq, row range, ts range, procs,
                                         column sizes, names first interned
                                         in this chunk
    <trailer length, uint32 LE> <CRC-32, uint32 LE> <b"PPKCHNK\\n">

The CRC covers the column slices plus the trailer, so a bit flip anywhere
in a group is detected; the trailing group magic makes groups discoverable
by scanning even when the footer itself is lost (a torn write, a crashed
writer, a truncated copy).  That scan is the salvage path: the name table
is rebuilt incrementally from each trailer's ``new_names``, so every chunk
that checksums clean is recovered **byte-identically**.

``on_error`` open policies (``read_pack`` / ``iter_chunks_pack``):

* ``"strict"`` (default) — no checksum pass; structural damage raises
  :class:`~repro_torch.core.errors.TraceReadError` with the file and byte
  offset.
* ``"skip_chunk"`` — footer must be intact; every chunk group is CRC
  verified and failing groups are dropped (quarantined) with a warning.
* ``"salvage"`` — like ``skip_chunk``, but a lost/corrupt footer triggers
  the trailer scan instead of failing.  Recovers every intact chunk from a
  truncated or bit-flipped pack.

Quarantine counters surface in :func:`io_stats`; :func:`verify_pack` and
:func:`repair_pack` check and rewrite a damaged file.

Write paths: ``Trace.save_pack(path)`` / ``write_pack`` (in-memory),
``StreamingTrace.save_pack`` / :class:`PackWriter` (out-of-core append —
one chunk group is buffered at a time, then written with its trailer).
``PackWriter(path, atomic=False)`` writes groups straight to ``path`` so a
killed writer leaves a salvageable prefix — the mode
``tracegen.big_trace(format="pack")`` uses.  The append/commit protocol
(:meth:`PackWriter.open_append`, :func:`committed_prefix`, ``live=``
reads) comes along with the writer; the live handles that poll it
(``Trace.open(live=True)``) are not ported yet.
"""

from __future__ import annotations

import hashlib
import json
import mmap
import os
import struct
import tempfile
import warnings
import zlib
from typing import Any, Dict, Iterator, List, Optional, Set, Tuple

import numpy as np

from ..core import structure
from ..core.constants import (DEPTH, ENTER, ET, EXC, INC, INSTANT, LEAVE,
                              MATCH, MATCH_TS, MSG_SIZE, NAME, PARENT,
                              PARTNER, PROC, TAG, THREAD, TS)
from ..core.errors import (IngestReport, TraceReadError, check_on_error,
                           require_nonempty)
from ..core.frame import Categorical, EventFrame
from ..core.registry import (PlanHints, RowSpan, even_groups,
                             register_chunked, register_reader,
                             register_units)
from ..core.trace import Trace

__all__ = ["write_pack", "read_pack", "PackWriter", "read_footer",
           "content_id", "io_stats", "reset_io_stats", "verify_pack",
           "repair_pack", "scan_chunk_groups", "committed_prefix",
           "DEFAULT_PACK_CHUNK_ROWS"]

MAGIC = b"#pipitpack 1\n"
MAGIC2 = b"#pipitpack 2\n"
MAGIC_PREFIX = b"#pipitpack "
TAIL_MAGIC = b"PIPITPK\x00"
CHUNK_MAGIC = b"PPKCHNK\n"
VERSION = 2
DEFAULT_PACK_CHUNK_ROWS = 250_000

_ET_CODE = {ENTER: 0, LEAVE: 1, INSTANT: 2}
_ET_CATS = np.asarray([ENTER, LEAVE, INSTANT])

#: (footer key, canonical column, on-disk dtype) — event columns in file order
_EVENT_COLS = (
    ("ts", TS, "<i8"),
    ("et", ET, "<i1"),
    ("name", NAME, "<i4"),
    ("proc", PROC, "<i4"),
    ("thread", THREAD, "<i4"),
    ("size", MSG_SIZE, "<f8"),
    ("partner", PARTNER, "<i4"),
    ("tag", TAG, "<i4"),
)
_COL_DTYPE = {k: d for k, _c, d in _EVENT_COLS}
#: fill value for an optional column a chunk group did not store
_COL_FILL = {"thread": 0, "size": np.nan, "partner": -1, "tag": 0}
#: sidecar arrays (footer key, canonical column, dtype)
_SIDECAR_COLS = (
    ("matching", MATCH, "<i8"),
    ("depth", DEPTH, "<i4"),
    ("parent", PARENT, "<i8"),
    ("inc", INC, "<f8"),
    ("exc", EXC, "<f8"),
)

_ON_ERROR_MODES = ("strict", "skip_chunk", "salvage")


# ---------------------------------------------------------------------------
# io accounting (tests / benchmarks assert pushdown actually skips chunks,
# and the fault suite asserts salvage quarantines exactly the damaged ones)
# ---------------------------------------------------------------------------

_IO_STATS = {"chunks_read": 0, "chunks_skipped": 0, "chunks_quarantined": 0,
             "footers_rebuilt": 0, "sidecars_dropped": 0,
             "verify_cache_hits": 0}

#: aspects ("chunks", "sidecar") whose CRC sweep passed, keyed by
#: (abspath, size, mtime_ns, inode, committed-group count) — a
#: verified-clean file needs no re-sweep until it changes on disk, so
#: steady-state verifying reopens (service handle revalidation, repeated
#: queries) cost the same as a strict open.  The group count is part of
#: the key because append workloads can grow a pack within one mtime
#: granule on coarse-mtime filesystems; size alone is not enough once a
#: finalize rewrites the tail in place.  Failures are never cached:
#: damage is re-diagnosed on every open.
_VERIFIED_CLEAN: Dict[tuple, set] = {}
_VERIFIED_CLEAN_MAX = 256


def _verify_key(path: str, st: os.stat_result, n_groups: int = -1) -> tuple:
    return (os.path.abspath(path), st.st_size, st.st_mtime_ns, st.st_ino,
            int(n_groups))


def _mark_verified(key: tuple, aspect: str) -> None:
    if key not in _VERIFIED_CLEAN and \
            len(_VERIFIED_CLEAN) >= _VERIFIED_CLEAN_MAX:
        _VERIFIED_CLEAN.clear()
    _VERIFIED_CLEAN.setdefault(key, set()).add(aspect)


def io_stats() -> Dict[str, int]:
    """Process-local counters since the last :func:`reset_io_stats`
    (advisory; parallel pool workers count in their own process):
    footer-index chunks read vs skipped by pushdown, plus the fault-path
    counters — chunks quarantined by CRC/scan failure, footers rebuilt by
    trailer scan, sidecars dropped as corrupt."""
    return dict(_IO_STATS)


def reset_io_stats() -> None:
    for k in _IO_STATS:
        _IO_STATS[k] = 0


# ---------------------------------------------------------------------------
# footer access
# ---------------------------------------------------------------------------

_FOOTER_CACHE: Dict[str, Tuple[Tuple[int, int], dict]] = {}


def read_footer(path: str) -> dict:
    """Parse and return the footer of ``path`` (cached per (size, mtime)).

    Raises :class:`TraceReadError` (a ValueError) when the file is not a
    readable pack, always naming the path and what was wrong.
    """
    path = os.fspath(path)
    st = os.stat(path)
    if st.st_size == 0:
        raise TraceReadError(path, "empty file (0 bytes) — not a pack")
    key = (st.st_size, st.st_mtime_ns)
    hit = _FOOTER_CACHE.get(path)
    if hit is not None and hit[0] == key:
        return hit[1]
    with open(path, "rb") as f:
        head = f.read(len(MAGIC))
        if not head.startswith(MAGIC_PREFIX):
            raise TraceReadError(path, "not a pipitpack file")
        if head not in (MAGIC, MAGIC2):
            raise TraceReadError(
                path, f"unsupported pack version {head[len(MAGIC_PREFIX):]!r}"
                      f" (this reader supports 1 and {VERSION})")
        if st.st_size < len(MAGIC) + 16:
            raise TraceReadError(path, "truncated pack (no footer)")
        f.seek(-16, os.SEEK_END)
        flen, tail = struct.unpack("<Q", f.read(8))[0], f.read(8)
        if tail != TAIL_MAGIC:
            raise TraceReadError(path, "bad pack trailer (truncated write?)")
        if flen > st.st_size - len(MAGIC) - 16:
            raise TraceReadError(path, "bad pack trailer (footer length "
                                       "exceeds file)")
        f.seek(st.st_size - 16 - flen)
        try:
            footer = json.loads(f.read(flen).decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            raise TraceReadError(path, f"corrupt pack footer ({e})") from e
    if footer.get("version") not in (1, VERSION):
        raise TraceReadError(path, f"unsupported pack version "
                                   f"{footer.get('version')!r} (this reader "
                                   f"supports 1 and {VERSION})")
    if len(_FOOTER_CACHE) > 256:
        _FOOTER_CACHE.clear()
    _FOOTER_CACHE[path] = (key, footer)
    return footer


def is_pack(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(len(MAGIC_PREFIX)) == MAGIC_PREFIX
    except OSError:
        return False


def content_id(path: str) -> Optional[str]:
    """The pack's stored content id (SHA-256 over column + sidecar bytes),
    or None when ``path`` is not a readable pack.  Footer-only read."""
    try:
        if not is_pack(path):
            return None
        return read_footer(path).get("content_id")
    except (OSError, ValueError):
        return None


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _int_column(arr: np.ndarray, dtype: str, what: str) -> np.ndarray:
    out = np.asarray(arr)
    info = np.iinfo(np.dtype(dtype))
    if len(out) and (out.min() < info.min or out.max() > info.max):
        raise ValueError(f"pack {what} column value out of {dtype} range "
                         f"[{info.min}, {info.max}]")
    return out.astype(dtype, copy=False)


def _et_codes(ev: EventFrame) -> np.ndarray:
    """Canonical 0/1/2 Enter/Leave/Instant codes; richer instant subtypes
    (MpiSend/...) render as plain instants, like every on-disk format."""
    col = ev.column(ET)
    if isinstance(col, Categorical):
        remap = np.asarray([_ET_CODE.get(str(c), 2) for c in col.categories],
                           np.int8)
        return remap[col.codes]
    return np.asarray([_ET_CODE.get(str(v), 2) for v in np.asarray(col)],
                      np.int8)


class PackWriter:
    """Out-of-core pack writer: append EventFrames in stream order, then
    :meth:`finish`.  One chunk group (``chunk_rows`` rows) is buffered at a
    time and written with its CRC'd trailer as soon as it fills, so memory
    stays bounded and every already-written group is recoverable even if
    the process dies; the chunk index, name interner and content hash
    accumulate as groups are flushed.

    ``atomic=True`` (default) stages the file next to ``path`` and
    ``os.replace``\\ s it at finish — no partial pack ever lands.
    ``atomic=False`` writes straight to ``path``: a crash mid-write leaves
    a footer-less prefix that ``on_error="salvage"`` / :func:`repair_pack`
    recovers group by group (the crash-consistency mode).

    Usable as a context manager: leaving the ``with`` block without having
    called :meth:`finish` (including via an exception) aborts the write —
    except in append mode, where the committed prefix is durable data and
    abort merely closes the file.

    **Append mode** (:meth:`open_append`): the writer targets ``path``
    in place and exposes :meth:`commit`.  Each commit flushes the
    buffered rows as one self-describing chunk group — the CRC'd trailer
    *is* the commit record — and (with ``fsync=True``) makes it durable,
    so a reader at any instant sees exactly the committed prefix and a
    SIGKILLed writer loses at most the uncommitted tail.
    :func:`committed_prefix` / ``live=True`` reads consume that prefix
    while the writer is still running; :meth:`finalize` seals the footer
    (after which the file is a perfectly ordinary pack).  Reopening an
    existing append shard resumes after its last committed group,
    truncating any uncommitted tail (and, when resuming a *finalized*
    pack, its footer/sidecar — a new finalize rewrites them).

    Timestamps are stored as integer nanoseconds; float timestamps
    quantize by truncation, exactly like every text writer in this repo
    (``write_jsonl``'s ``int(ts)``).  The structure sidecar is always
    consistent with the *stored* values.
    """

    def __init__(self, path: str, chunk_rows: int = DEFAULT_PACK_CHUNK_ROWS,
                 atomic: bool = True, append: bool = False,
                 fsync: bool = False):
        self.path = os.fspath(path)
        self.chunk_rows = int(chunk_rows)
        if self.chunk_rows <= 0:
            raise ValueError("chunk_rows must be positive")
        self.append_mode = bool(append)
        self.atomic = bool(atomic) and not self.append_mode
        self._fsync = bool(fsync)
        self._buf: List[Dict[str, np.ndarray]] = []
        self._buf_rows = 0
        self._flushed = 0  # rows written out in finalized groups
        self._name_code: Dict[str, int] = {}
        self._names: List[str] = []
        self._names_written = 0  # names already recorded by an earlier trailer
        self._chunks: List[dict] = []  # finalized chunk index records
        self._has_thread = False
        self._has_messages = False
        self._hash = hashlib.sha256()
        self._finished = False
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        if self.atomic:
            fd, self._tmp = tempfile.mkstemp(prefix=".pack_tmp_", dir=d)
            self._out = os.fdopen(fd, "wb")
        else:
            self._tmp = self.path
            if self.append_mode and os.path.exists(self.path) \
                    and os.path.getsize(self.path) > 0:
                self._resume()
                return
            self._out = open(self.path, "wb")
        self._out.write(MAGIC2)
        self._off = len(MAGIC2)

    @classmethod
    def open_append(cls, path: str,
                    chunk_rows: int = DEFAULT_PACK_CHUNK_ROWS,
                    fsync: bool = True) -> "PackWriter":
        """Open ``path`` as an append-mode shard (creating it if absent,
        resuming after its last committed group otherwise).  ``fsync=True``
        (default) makes every :meth:`commit` durable before it returns —
        the crash-consistency contract live readers rely on."""
        return cls(path, chunk_rows=chunk_rows, atomic=False, append=True,
                   fsync=fsync)

    def _resume(self) -> None:
        """Rebuild writer state from ``path``'s committed prefix and
        truncate the uncommitted tail (or the footer/sidecar of a
        finalized pack being reopened for append)."""
        snap = committed_prefix(self.path)
        self._chunks = [dict(c) for c in snap["chunks"]]
        self._names = list(snap["names"])
        self._name_code = {s: i for i, s in enumerate(self._names)}
        self._names_written = len(self._names)
        self._flushed = snap["rows"]
        self._has_thread = bool(snap["has_thread"])
        self._has_messages = bool(snap["has_messages"])
        if self._chunks:
            last = self._chunks[-1]
            self._off = (last["offset"] + last["nbytes"] + last["tlen"]
                         + 8 + len(CHUNK_MAGIC))
        else:
            self._off = len(MAGIC2)
        self._out = open(self.path, "r+b")
        # re-feed the content hash with the committed column bytes so a
        # later finalize produces the same content_id a fresh writer would
        for ch in self._chunks:
            self._out.seek(ch["offset"])
            self._hash.update(self._out.read(ch["nbytes"]))
        self._out.seek(self._off)
        self._out.truncate(self._off)
        _FOOTER_CACHE.pop(self.path, None)
        _LIVE_SCAN.pop(os.path.abspath(self.path), None)

    @property
    def watermark(self) -> dict:
        """The committed watermark of this writer: rows/groups durable on
        disk (buffered-but-uncommitted rows are *not* included)."""
        return {"rows": self._flushed, "groups": len(self._chunks),
                "ts_min": (min(c["ts_min"] for c in self._chunks)
                           if self._chunks else None),
                "ts_max": (max(c["ts_max"] for c in self._chunks)
                           if self._chunks else None),
                "bytes": self._off, "finalized": self._finished}

    def commit(self) -> dict:
        """Flush all buffered rows as one committed chunk group and make
        it durable (``fsync=True`` writers).  The group trailer + CRC +
        magic are the commit record: once they hit the disk, the group is
        part of the committed prefix every concurrent/live reader sees.
        Returns the new :attr:`watermark`.  A commit with no buffered
        rows just syncs and returns the current watermark."""
        if self._finished:
            raise RuntimeError("PackWriter already finished")
        if self._buf_rows:
            self._flush_group(self._buf_rows)
        self._out.flush()
        if self._fsync:
            os.fsync(self._out.fileno())
        return self.watermark

    # -- context manager ---------------------------------------------------
    def __enter__(self) -> "PackWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if not self._finished:
            self.abort()

    # -- append ------------------------------------------------------------
    def append(self, frame_or_trace) -> None:
        """Append one EventFrame (or Trace) worth of events, in stream
        order.  Missing optional columns (thread / message triplet) are
        synthesized; name codes are re-interned into the file-global
        table."""
        ev = getattr(frame_or_trace, "events", frame_or_trace)
        n = len(ev)
        if n == 0:
            return
        ts = _int_column(ev[TS], "<i8", "ts")
        et = _et_codes(ev)
        name = self._intern(ev)
        proc = _int_column(ev[PROC], "<i4", "proc")
        if THREAD in ev:
            thread = _int_column(ev[THREAD], "<i4", "thread")
        else:
            thread = np.zeros(n, "<i4")
        if MSG_SIZE in ev:
            size = np.asarray(ev[MSG_SIZE], np.float64).astype("<f8",
                                                               copy=False)
        else:
            size = np.full(n, np.nan, "<f8")
        if PARTNER in ev:
            partner = _int_column(ev[PARTNER], "<i4", "partner")
        else:
            partner = np.full(n, -1, "<i4")
        if TAG in ev:
            tag = _int_column(ev[TAG], "<i4", "tag")
        else:
            tag = np.zeros(n, "<i4")
        self._buf.append({"ts": ts, "et": et, "name": name, "proc": proc,
                          "thread": thread, "size": size, "partner": partner,
                          "tag": tag})
        self._buf_rows += n
        while self._buf_rows >= self.chunk_rows:
            self._flush_group(self.chunk_rows)

    def _intern(self, ev: EventFrame) -> np.ndarray:
        cat = ev.cat(NAME)
        local = np.empty(len(cat.categories), np.int32)
        for i, c in enumerate(cat.categories):
            s = str(c)
            g = self._name_code.get(s)
            if g is None:
                g = len(self._names)
                self._name_code[s] = g
                self._names.append(s)
            local[i] = g
        return local[cat.codes].astype("<i4", copy=False)

    def _take(self, nrows: int) -> Dict[str, np.ndarray]:
        """Pop exactly ``nrows`` buffered rows (front of the stream)."""
        parts: Dict[str, List[np.ndarray]] = {k: [] for k, _c, _d
                                              in _EVENT_COLS}
        need = nrows
        while need:
            blk = self._buf[0]
            bn = len(blk["ts"])
            if bn <= need:
                for k in parts:
                    parts[k].append(blk[k])
                self._buf.pop(0)
                need -= bn
            else:
                for k in parts:
                    parts[k].append(blk[k][:need])
                    blk[k] = blk[k][need:]
                need = 0
        self._buf_rows -= nrows
        return {k: (v[0] if len(v) == 1 else np.concatenate(v))
                for k, v in parts.items()}

    def _flush_group(self, nrows: int) -> None:
        """Write one self-describing chunk group: column slices, trailer,
        (length, CRC-32) and the group magic."""
        cols = self._take(nrows)
        n = len(cols["ts"])
        thread_any = bool(np.any(cols["thread"]))
        msg_any = bool(np.any(~np.isnan(cols["size"]))
                       or np.any(cols["partner"] >= 0))
        keep = {"ts": True, "et": True, "name": True, "proc": True,
                "thread": thread_any, "size": msg_any, "partner": msg_any,
                "tag": msg_any}
        blobs: List[bytes] = []
        colmeta: List[list] = []
        for key, _c, dt in _EVENT_COLS:
            if not keep[key]:
                continue
            b = np.ascontiguousarray(
                cols[key].astype(dt, copy=False)).tobytes()
            blobs.append(b)
            colmeta.append([key, dt, len(b)])
        data = b"".join(blobs)
        trailer = {
            "seq": len(self._chunks), "lo": self._flushed, "rows": n,
            "ts_min": int(cols["ts"].min()), "ts_max": int(cols["ts"].max()),
            "procs": sorted(int(p) for p in np.unique(cols["proc"]).tolist()),
            "cols": colmeta, "name_base": self._names_written,
            "new_names": self._names[self._names_written:],
        }
        tblob = json.dumps(trailer, separators=(",", ":")).encode("utf-8")
        crc = zlib.crc32(tblob, zlib.crc32(data))
        off = self._off
        self._out.write(data)
        self._out.write(tblob)
        self._out.write(struct.pack("<II", len(tblob), crc))
        self._out.write(CHUNK_MAGIC)
        self._hash.update(data)
        self._chunks.append({
            "lo": self._flushed, "hi": self._flushed + n,
            "ts_min": trailer["ts_min"], "ts_max": trailer["ts_max"],
            "procs": trailer["procs"], "offset": off, "nbytes": len(data),
            "tlen": len(tblob), "crc": crc, "cols": colmeta,
        })
        self._off += len(data) + len(tblob) + 8 + len(CHUNK_MAGIC)
        self._flushed += n
        self._names_written = len(self._names)
        self._has_thread = self._has_thread or thread_any
        self._has_messages = self._has_messages or msg_any

    # -- finish ------------------------------------------------------------
    def abort(self) -> None:
        """Discard the partial write (atomic staging file, or the in-place
        partial pack) without finishing.  Append-mode shards are *not*
        unlinked: the committed prefix is durable data — abort just stops
        writing, exactly like a crash after the last commit."""
        self._out.close()
        if not self.append_mode:
            try:
                os.unlink(self._tmp)
            except OSError:
                pass
        self._finished = True

    def finish(self, sidecar: Any = "auto",
               _sidecar_arrays: Optional[dict] = None) -> str:
        """Flush the final partial group, write the sidecar + footer, and
        (in atomic mode) land the file at ``path``.

        ``sidecar=True`` derives the structure sidecar (matching / depth /
        parent / inc / exc) from the just-written groups via a memmap
        pass — this is the only whole-trace step.  ``"auto"`` means True.
        ``_sidecar_arrays`` lets ``write_pack`` hand in structure a Trace
        already materialized.
        """
        if self._finished:
            raise RuntimeError("PackWriter already finished")
        if self._buf_rows:
            self._flush_group(self._buf_rows)
        want_sidecar = bool(sidecar) or _sidecar_arrays is not None
        sidecar_meta = None
        sidecar_crc = None
        if want_sidecar and self._flushed:
            arrays = _sidecar_arrays
            if arrays is None:
                self._out.flush()  # the memmap pass reads the written groups
                arrays = self._derive_sidecar()
            sidecar_meta = []
            crc = 0
            for key, _col, dt in _SIDECAR_COLS:
                arr = np.ascontiguousarray(
                    np.asarray(arrays[key]).astype(dt, copy=False))
                if len(arr) != self._flushed:
                    raise ValueError(
                        f"sidecar {key!r} has {len(arr)} rows, pack has "
                        f"{self._flushed}")
                b = arr.tobytes()
                self._hash.update(b)
                crc = zlib.crc32(b, crc)
                self._out.write(b)
                sidecar_meta.append({"key": key, "dtype": dt,
                                     "offset": self._off})
                self._off += len(b)
            sidecar_crc = crc
        keep = self._store_flags()
        footer = {
            "version": VERSION,
            "rows": self._flushed,
            "chunk_rows": self.chunk_rows,
            "columns": [{"key": k, "dtype": d} for k, _c, d in _EVENT_COLS
                        if keep[k]],
            "names": self._names,
            "has_thread": self._has_thread,
            "has_messages": self._has_messages,
            "chunks": self._chunks,
            "procs": sorted({p for c in self._chunks for p in c["procs"]}),
            "sidecar": sidecar_meta,
            "sidecar_crc": sidecar_crc,
            "content_id": self._hash.hexdigest(),
        }
        blob = json.dumps(footer, separators=(",", ":")).encode("utf-8")
        self._out.write(blob)
        self._out.write(struct.pack("<Q", len(blob)))
        self._out.write(TAIL_MAGIC)
        self._out.flush()
        if self._fsync:
            os.fsync(self._out.fileno())
        self._out.close()
        if self.atomic:
            os.replace(self._tmp, self.path)
        self._finished = True
        _FOOTER_CACHE.pop(self.path, None)
        _LIVE_SCAN.pop(os.path.abspath(self.path), None)
        return self.path

    def finalize(self, sidecar: Any = "auto") -> str:
        """Seal the append shard: flush the remaining buffered rows,
        derive + write the structure sidecar, and write the footer.  The
        file becomes an ordinary finalized pack (strict opens, sidecar
        fast path, content id).  Alias for :meth:`finish` — named for the
        append/finalize protocol."""
        return self.finish(sidecar=sidecar)

    def _store_flags(self) -> Dict[str, bool]:
        """Which optional columns any group stored (footer-level view;
        individual groups record their own column sets)."""
        keep = {k: True for k, _c, _d in _EVENT_COLS}
        keep["thread"] = self._has_thread
        if not self._has_messages:
            keep["size"] = keep["partner"] = keep["tag"] = False
        return keep

    def _derive_sidecar(self) -> dict:
        """One structure pass over the just-written groups (memmapped)."""
        cols = _assemble_columns(self._tmp, self._chunks, self._flushed,
                                 self._has_thread, self._has_messages)
        ev = EventFrame()
        ev[TS] = cols["ts"]
        ev[ET] = Categorical(cols["et"].astype(np.int32), _ET_CATS)
        ev[NAME] = Categorical(cols["name"],
                               np.asarray(self._names,
                                          dtype=object).astype(str))
        ev[PROC] = cols["proc"]
        if self._has_thread:
            ev[THREAD] = cols["thread"]
        if self._has_messages:
            ev[MSG_SIZE] = cols["size"]
            ev[PARTNER] = cols["partner"]
            ev[TAG] = cols["tag"]
        matching, depth, parent, inc, exc = structure.derive_structure(ev)
        return {"matching": matching, "depth": depth, "parent": parent,
                "inc": inc, "exc": exc}


def write_pack(trace_or_events, path: str,
               chunk_rows: int = DEFAULT_PACK_CHUNK_ROWS,
               sidecar: bool = True) -> str:
    """Serialize an in-memory trace (or EventFrame) as one pack file.

    ``sidecar=True`` (default) stores the structure sidecar: the trace's
    already-materialized structure columns are reused when present and
    row-for-row valid; otherwise structure is derived once on the event
    frame (the same pass reopening would pay — paid here exactly once).

    Float timestamps quantize to integer ns by truncation (the convention
    every text writer in this repo follows), and the sidecar is derived
    from the stored values in that case, so reopen-and-derive equivalence
    always holds.
    """
    ev = getattr(trace_or_events, "events", trace_or_events)
    with PackWriter(path, chunk_rows=chunk_rows) as w:
        w.append(ev)
        arrays = None
        # the sidecar must equal what derive_structure would produce on the
        # *stored* (integer-ns) columns — already-materialized structure is
        # only reusable when the source timestamps are integers, so storage
        # quantization is the identity
        int_ts = np.asarray(ev[TS]).dtype.kind in "iu" if len(ev) else True
        if sidecar and len(ev) and int_ts and all(
                c in ev for c in (MATCH, DEPTH, PARENT, INC, EXC)):
            arrays = {"matching": np.asarray(ev.column(MATCH), np.int64),
                      "depth": np.asarray(ev.column(DEPTH), np.int32),
                      "parent": np.asarray(ev.column(PARENT), np.int64),
                      "inc": np.asarray(ev.column(INC), np.float64),
                      "exc": np.asarray(ev.column(EXC), np.float64)}
        return w.finish(sidecar=sidecar, _sidecar_arrays=arrays)


# ---------------------------------------------------------------------------
# integrity: verification, quarantine, trailer-scan salvage
# ---------------------------------------------------------------------------

def _group_span_ok(ch: dict, size: int) -> bool:
    end = ch["offset"] + ch["nbytes"] + ch.get("tlen", 0)
    return 0 <= ch["offset"] and end + 8 + len(CHUNK_MAGIC) <= size


def _verify_chunk(mm, ch: dict, size: int) -> bool:
    """CRC-check one v2 footer chunk record against the file bytes."""
    if not _group_span_ok(ch, size):
        return False
    end = ch["offset"] + ch["nbytes"] + ch["tlen"]
    return zlib.crc32(mm[ch["offset"]:end]) == ch["crc"]


def _reindex(chunks: List[dict]) -> List[dict]:
    """Rebase chunk row ranges to the surviving row space (salvaged packs
    drop rows; the reopened trace is the concatenation of survivors)."""
    out = []
    pos = 0
    for ch in chunks:
        n = ch["hi"] - ch["lo"]
        c = dict(ch)
        c["lo"], c["hi"] = pos, pos + n
        out.append(c)
        pos += n
    return out


def scan_chunk_groups(path: str) -> List[dict]:
    """Discover intact chunk groups by scanning for group trailers —
    the salvage path when the footer is lost or corrupt.  Returns footer
    -style chunk records (original row coordinates) plus each trailer's
    ``name_base`` / ``new_names``, sorted by sequence number; CRC-failing
    or unparseable candidates are dropped."""
    path = os.fspath(path)
    size = os.stat(path).st_size
    found: Dict[int, dict] = {}
    if size == 0:
        return []
    with open(path, "rb") as f, \
            mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        pos = mm.find(CHUNK_MAGIC)
        while pos != -1:
            rec = _parse_group_at(mm, pos)
            if rec is not None and rec["seq"] not in found:
                found[rec["seq"]] = rec
            pos = mm.find(CHUNK_MAGIC, pos + 1)
    return [found[s] for s in sorted(found)]


def _parse_group_at(mm, magic_pos: int) -> Optional[dict]:
    """Validate a candidate group ending at ``magic_pos``; None unless the
    trailer parses and the CRC over (data + trailer) matches."""
    if magic_pos < 8:
        return None
    tlen, crc = struct.unpack("<II", mm[magic_pos - 8:magic_pos])
    tstart = magic_pos - 8 - tlen
    if tstart < 0:
        return None
    try:
        tr = json.loads(mm[tstart:magic_pos - 8].decode("utf-8"))
        cols = [[str(k), str(d), int(nb)] for k, d, nb in tr["cols"]]
        nbytes = sum(nb for _k, _d, nb in cols)
        dstart = tstart - nbytes
        if dstart < 0:
            return None
        if zlib.crc32(mm[dstart:magic_pos - 8]) != crc:
            return None
        return {"seq": int(tr["seq"]), "lo": int(tr["lo"]),
                "hi": int(tr["lo"]) + int(tr["rows"]),
                "ts_min": tr["ts_min"], "ts_max": tr["ts_max"],
                "procs": list(tr["procs"]), "offset": dstart,
                "nbytes": nbytes, "tlen": tlen, "crc": crc, "cols": cols,
                "name_base": int(tr["name_base"]),
                "new_names": list(tr["new_names"])}
    except (ValueError, KeyError, TypeError, UnicodeDecodeError):
        return None


def _salvage_footer(path: str) -> dict:
    """Rebuild a footer-equivalent (chunk index + name table) from the
    trailer scan.  The sidecar and content id are unrecoverable without
    the footer; chunks keep their *original* row coordinates here."""
    groups = scan_chunk_groups(path)
    if not groups:
        raise TraceReadError(
            path, "salvage found no intact chunk groups (not a v2 pack, or "
                  "every group is damaged; v1 packs carry no per-chunk "
                  "recovery records)")
    names: List[str] = []
    lost = 0
    for g in groups:
        if g["name_base"] > len(names):
            pad = g["name_base"] - len(names)
            names.extend(f"<lost-name-{len(names) + i}>" for i in range(pad))
            lost += pad
        names.extend(g["new_names"])
    if lost:
        warnings.warn(f"{path}: {lost} interned name(s) lost with "
                      f"quarantined chunks; placeholders substituted",
                      RuntimeWarning, stacklevel=3)
    missing = groups[-1]["seq"] + 1 - len(groups)
    _IO_STATS["chunks_quarantined"] += missing
    _IO_STATS["footers_rebuilt"] += 1
    if missing:
        warnings.warn(f"{path}: {missing} chunk group(s) unrecoverable "
                      f"(CRC mismatch or lost bytes); salvaging "
                      f"{len(groups)} intact group(s)",
                      RuntimeWarning, stacklevel=3)
    chunks = [{k: g[k] for k in ("lo", "hi", "ts_min", "ts_max", "procs",
                                 "offset", "nbytes", "tlen", "crc", "cols")}
              for g in groups]
    stored = {k for ch in chunks for k, _d, _n in ch["cols"]}
    return {"version": VERSION, "salvaged": True,
            "rows": sum(c["hi"] - c["lo"] for c in chunks),
            "chunk_rows": max(c["hi"] - c["lo"] for c in chunks),
            "columns": [{"key": k, "dtype": d} for k, _c, d in _EVENT_COLS
                        if k in stored],
            "names": names, "has_thread": "thread" in stored,
            "has_messages": "size" in stored, "chunks": chunks,
            "procs": sorted({int(p) for c in chunks for p in c["procs"]}),
            "sidecar": None, "sidecar_crc": None, "content_id": None}


# ---------------------------------------------------------------------------
# committed prefix — the read side of the append/commit protocol
# ---------------------------------------------------------------------------

#: incremental forward-scan cache for still-growing shards, keyed by
#: abspath: {"ino", "pos", "groups", "names", "tail"} where ``pos`` is the
#: byte just past the last accepted group and ``tail`` the 16 bytes ending
#: at ``pos`` (trailer length + CRC + group magic).  A poll over a live
#: shard then re-reads only the newly committed bytes; any rewrite under
#: the cursor (inode change, shrink, tail mismatch — e.g. a resume
#: truncated the file) forces a full rescan.
_LIVE_SCAN: Dict[str, dict] = {}
_LIVE_SCAN_MAX = 64
_TAIL_CHECK = 8 + len(CHUNK_MAGIC)


def _snapshot(chunks: List[dict], names: List[str], has_thread: bool,
              has_messages: bool, nbytes: int, finalized: bool) -> dict:
    rows = chunks[-1]["hi"] if chunks else 0
    return {
        "rows": rows, "chunks": chunks, "names": names,
        "has_thread": bool(has_thread), "has_messages": bool(has_messages),
        "procs": sorted({int(p) for c in chunks for p in c["procs"]}),
        "finalized": bool(finalized),
        "watermark": {
            "rows": rows, "groups": len(chunks),
            "ts_min": (min(c["ts_min"] for c in chunks) if chunks else None),
            "ts_max": (max(c["ts_max"] for c in chunks) if chunks else None),
            "bytes": int(nbytes), "finalized": bool(finalized)},
    }


def committed_prefix(path: str) -> dict:
    """Snapshot the committed prefix of a pack: the maximal contiguous run
    of CRC-clean chunk groups starting at the header, with no footer
    required.  This is the read side of the append/commit protocol — at
    any instant (mid-write, post-SIGKILL) the snapshot equals what a clean
    writer stopped at the same commit would have produced, byte for byte.

    Returns ``{rows, chunks, names, has_thread, has_messages, procs,
    finalized, watermark}``: ``chunks`` are footer-style records (row
    coordinates are contiguous from 0 by construction) and ``watermark``
    is ``{rows, groups, ts_min, ts_max, bytes, finalized}``.  A missing,
    empty, or header-only file yields an empty snapshot — a live shard
    that has not committed yet is data that hasn't arrived, not an error.
    Finalized packs take the footer fast path.  Repeated calls on a
    growing shard scan only the new bytes (incremental cursor cache).
    """
    path = os.fspath(path)
    apath = os.path.abspath(path)
    try:
        st = os.stat(path)
    except OSError:
        return _snapshot([], [], False, False, 0, finalized=False)
    size = st.st_size
    if size <= len(MAGIC2):
        with open(path, "rb") as f:
            head = f.read(len(MAGIC2))
        if head and not MAGIC2.startswith(head):
            raise TraceReadError(path, "not a pipitpack v2 file (append/"
                                       "live reads need the v2 header)")
        return _snapshot([], [], False, False, size, finalized=False)
    try:
        footer = read_footer(path)
    except (OSError, ValueError):
        footer = None
    if footer is not None:
        if footer["version"] != VERSION:
            raise TraceReadError(
                path, "v1 pack has no chunk groups (append/live requires "
                      "format version 2)")
        chunks = [dict(c) for c in footer["chunks"]]
        return _snapshot(chunks, list(footer["names"]),
                         footer["has_thread"], footer["has_messages"],
                         size, finalized=True)
    groups: List[dict] = []
    names: List[str] = []
    pos = len(MAGIC2)
    with open(path, "rb") as f, \
            mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        if bytes(mm[:len(MAGIC2)]) != MAGIC2:
            raise TraceReadError(path, "not a pipitpack v2 file (append/"
                                       "live reads need the v2 header)")
        ent = _LIVE_SCAN.get(apath)
        if (ent is not None and ent["ino"] == st.st_ino
                and size >= ent["pos"]
                and bytes(mm[ent["pos"] - _TAIL_CHECK:ent["pos"]])
                == ent["tail"]):
            groups = list(ent["groups"])
            names = list(ent["names"])
            pos = ent["pos"]
        search = pos
        while True:
            mpos = mm.find(CHUNK_MAGIC, search)
            if mpos == -1:
                break
            rec = _parse_group_at(mm, mpos)
            if rec is None:
                # magic bytes inside column data — keep looking for the
                # real end of the group that starts at ``pos``
                search = mpos + 1
                continue
            if (rec["offset"] == pos and rec["seq"] == len(groups)
                    and rec["lo"] == (groups[-1]["hi"] if groups else 0)
                    and rec["name_base"] == len(names)):
                groups.append(rec)
                names.extend(rec["new_names"])
                pos = mpos + len(CHUNK_MAGIC)
                search = pos
                continue
            if rec["offset"] >= pos:
                # a valid group *not* starting at the cursor: the group at
                # ``pos`` is torn or uncommitted — the committed prefix
                # (strict by definition) ends here
                break
            search = mpos + 1
        if groups:
            if apath not in _LIVE_SCAN and len(_LIVE_SCAN) >= _LIVE_SCAN_MAX:
                _LIVE_SCAN.clear()
            _LIVE_SCAN[apath] = {
                "ino": st.st_ino, "pos": pos, "groups": list(groups),
                "names": list(names),
                "tail": bytes(mm[pos - _TAIL_CHECK:pos])}
    stored = {k for g in groups for k, _d, _n in g["cols"]}
    chunks = [{k: g[k] for k in ("lo", "hi", "ts_min", "ts_max", "procs",
                                 "offset", "nbytes", "tlen", "crc", "cols")}
              for g in groups]
    return _snapshot(chunks, names, "thread" in stored, "size" in stored,
                     pos, finalized=False)


def _resolve_live(path: str, upto_rows: Optional[int]
                  ) -> Tuple[dict, List[dict]]:
    """Footer-equivalent view of a (possibly still-growing) pack's
    committed prefix, truncated to ``upto_rows`` when given.  Live plans
    pin their snapshot watermark at planning time, and commits only ever
    land whole groups, so ``upto_rows`` always falls on a group boundary
    — execution never reads past what the planner saw even if the file
    grows mid-read."""
    snap = committed_prefix(path)
    chunks = snap["chunks"]
    if upto_rows is not None:
        chunks = [c for c in chunks if c["hi"] <= int(upto_rows)]
    stored = {k for ch in chunks for k, _d, _n in ch["cols"]}
    footer = {"version": VERSION, "live": True,
              "rows": chunks[-1]["hi"] if chunks else 0,
              "chunk_rows": max((c["hi"] - c["lo"] for c in chunks),
                                default=DEFAULT_PACK_CHUNK_ROWS),
              "columns": [{"key": k, "dtype": d} for k, _c, d in _EVENT_COLS
                          if k in stored],
              "names": snap["names"],
              "has_thread": snap["has_thread"],
              "has_messages": snap["has_messages"],
              "chunks": chunks, "procs": snap["procs"],
              "sidecar": None, "sidecar_crc": None, "content_id": None}
    return footer, chunks


def _resolve_chunks(path: str, on_error: str) -> Tuple[dict, List[dict], bool]:
    """Open policy front door: returns ``(footer, chunks, intact)`` where
    ``chunks`` are the surviving chunk records rebased to the surviving
    row space and ``intact`` says whether every original chunk survived
    (the sidecar is only meaningful then)."""
    check_on_error(on_error, _ON_ERROR_MODES)
    # an empty file is total data loss under every policy — salvage must
    # not dress it up as a successfully-recovered empty trace
    require_nonempty(path, os.stat(path).st_size, what="pack")
    try:
        footer = read_footer(path)
    except (OSError, ValueError) as e:
        if on_error == "strict":
            raise
        if on_error == "skip_chunk":
            raise TraceReadError(
                path, f"footer unreadable ({e}); on_error='skip_chunk' "
                      f"needs an intact footer — use on_error='salvage'")
        footer = _salvage_footer(path)
        return footer, _reindex(footer["chunks"]), False
    if footer["version"] == 1 or on_error == "strict":
        return footer, list(footer["chunks"]), True
    # v2 + verifying mode: CRC every chunk, quarantine failures.  A file
    # that already passed a full sweep is not re-swept until it changes.
    st = os.stat(path)
    key = _verify_key(path, st, len(footer["chunks"]))
    if "chunks" in _VERIFIED_CLEAN.get(key, ()):
        _IO_STATS["verify_cache_hits"] += 1
        return footer, list(footer["chunks"]), True
    size = st.st_size
    good: List[dict] = []
    bad = 0
    with open(path, "rb") as f, \
            mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        for ch in footer["chunks"]:
            if _verify_chunk(mm, ch, size):
                good.append(ch)
            else:
                bad += 1
    if bad:
        _IO_STATS["chunks_quarantined"] += bad
        warnings.warn(f"{path}: quarantined {bad} chunk group(s) failing "
                      f"CRC; {len(good)} intact group(s) kept",
                      RuntimeWarning, stacklevel=3)
        return footer, _reindex(good), False
    _mark_verified(key, "chunks")
    return footer, good, True


def verify_pack(path: str) -> dict:
    """Full integrity report for a pack: per-chunk CRC verdicts plus the
    sidecar checksum (v2), or a structural-only check (v1).  Never raises
    on damage — damage lands in the report; raises only when ``path`` has
    no readable footer at all (then ``--repair`` / salvage is the tool)."""
    path = os.fspath(path)
    footer = read_footer(path)
    size = os.stat(path).st_size
    rep = {"path": path, "version": footer["version"],
           "rows": footer["rows"], "chunks_total": len(footer["chunks"]),
           "chunks_bad": [], "sidecar_ok": None, "ok": True}
    if footer["version"] == 1:
        # v1 stores no checksums: verify byte coverage only
        last = max((c["offset"] for c in footer.get("columns", [])),
                   default=0)
        rep["note"] = "v1 pack: no per-chunk CRCs (structural check only)"
        rep["ok"] = last < size
        return rep
    with open(path, "rb") as f, \
            mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        for i, ch in enumerate(footer["chunks"]):
            if not _verify_chunk(mm, ch, size):
                rep["chunks_bad"].append(
                    {"index": i, "rows": [ch["lo"], ch["hi"]],
                     "offset": ch["offset"]})
        meta = footer.get("sidecar")
        if meta and footer.get("sidecar_crc") is not None:
            lo = meta[0]["offset"]
            hi = (meta[-1]["offset"]
                  + footer["rows"] * np.dtype(meta[-1]["dtype"]).itemsize)
            rep["sidecar_ok"] = (hi <= size and
                                 zlib.crc32(mm[lo:hi])
                                 == footer["sidecar_crc"])
    rep["ok"] = not rep["chunks_bad"] and rep["sidecar_ok"] is not False
    return rep


def repair_pack(src: str, dst: str,
                chunk_rows: Optional[int] = None) -> dict:
    """Rewrite a damaged pack from its salvageable chunks: salvage-open
    ``src`` (footer loss and CRC-failing groups tolerated), then write a
    fresh, fully-checksummed pack with a re-derived sidecar at ``dst``.
    Returns a report with rows recovered and groups quarantined."""
    before = dict(_IO_STATS)
    # the recovered rows only pass through the host on their way back to
    # disk: no op runs on them
    t = read_pack(src, on_error="salvage", sidecar=False, device="cpu")
    write_pack(t, dst, chunk_rows=chunk_rows or DEFAULT_PACK_CHUNK_ROWS)
    return {"src": os.fspath(src), "dst": os.fspath(dst),
            "rows_recovered": len(t),
            "chunks_quarantined": (_IO_STATS["chunks_quarantined"]
                                   - before["chunks_quarantined"]),
            "footer_rebuilt": bool(_IO_STATS["footers_rebuilt"]
                                   - before["footers_rebuilt"])}


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

def _sniff_pack(path: str, head: str) -> bool:
    return head.startswith("#pipitpack ")


def _shard_procs_pack(path: str) -> Optional[Set[int]]:
    """Footer-exact shard hint: the process set a pack shard contains (used
    by shard skipping before any byte of the column data is touched)."""
    try:
        return set(read_footer(path).get("procs", ())) or None
    except (OSError, ValueError):
        return None


def _open_columns_v1(path: str, footer: dict) -> Dict[str, np.ndarray]:
    rows = footer["rows"]
    out = {}
    for c in footer["columns"]:
        out[c["key"]] = np.memmap(path, dtype=np.dtype(c["dtype"]), mode="r",
                                  offset=c["offset"], shape=(rows,))
    return out


def _assemble_columns(path: str, chunks: List[dict], rows: int,
                      has_thread: bool, has_messages: bool
                      ) -> Dict[str, np.ndarray]:
    """Materialize whole columns from v2 chunk groups: one allocation per
    column, one memcpy per (group, column) slice — still zero-parse.
    ``chunks`` must be rebased (contiguous lo/hi over ``rows``)."""
    out: Dict[str, np.ndarray] = {
        "ts": np.empty(rows, "<i8"), "et": np.empty(rows, "<i1"),
        "name": np.empty(rows, "<i4"), "proc": np.empty(rows, "<i4")}
    if has_thread:
        out["thread"] = np.zeros(rows, "<i4")
    if has_messages:
        out["size"] = np.full(rows, np.nan, "<f8")
        out["partner"] = np.full(rows, -1, "<i4")
        out["tag"] = np.zeros(rows, "<i4")
    if not chunks:
        return out
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    size = raw.shape[0]
    for ch in chunks:
        n = ch["hi"] - ch["lo"]
        off = ch["offset"]
        for key, dt, nb in ch["cols"]:
            if off + nb > size:
                raise TraceReadError(
                    path, f"chunk group column {key!r} extends past end of "
                          f"file (truncated pack?) — reopen with "
                          f"on_error='salvage'", locus=f"byte {off}")
            if key in out:
                seg = raw[off:off + nb].view(dt)
                if len(seg) != n:
                    raise TraceReadError(
                        path, f"chunk group column {key!r} has {len(seg)} "
                              f"rows, index says {n}", locus=f"byte {off}")
                out[key][ch["lo"]:ch["hi"]] = seg
            off += nb
    return out


class _GroupColumn:
    """Lazy ``[lo:hi]`` reads of one column across v2 chunk groups: a
    zero-copy memmap view when the slice lives in one group, a bounded
    copy when it crosses groups.  Slots straight into ``_frame_slice``."""

    def __init__(self, src: "_GroupColumnSource", key: str):
        self._src = src
        self._key = key

    def __getitem__(self, sl: slice) -> np.ndarray:
        return self._src.read(self._key, sl.start, sl.stop)


class _GroupColumnSource:
    def __init__(self, path: str, chunks: List[dict], has_thread: bool,
                 has_messages: bool):
        self._path = path
        self._raw = np.memmap(path, dtype=np.uint8, mode="r")
        self._spans: List[Tuple[int, int, Dict[str, Tuple[int, str, int]]]] \
            = []
        for ch in chunks:
            off = ch["offset"]
            colmap: Dict[str, Tuple[int, str, int]] = {}
            for key, dt, nb in ch["cols"]:
                colmap[key] = (off, dt, nb)
                off += nb
            self._spans.append((ch["lo"], ch["hi"], colmap))
        keys = ["ts", "et", "name", "proc"]
        if has_thread:
            keys.append("thread")
        if has_messages:
            keys += ["size", "partner", "tag"]
        self._cols = {k: _GroupColumn(self, k) for k in keys}

    def __contains__(self, key: str) -> bool:
        return key in self._cols

    def __getitem__(self, key: str) -> _GroupColumn:
        return self._cols[key]

    def read(self, key: str, lo: int, hi: int) -> np.ndarray:
        dt = np.dtype(_COL_DTYPE[key])
        parts: List[np.ndarray] = []
        size = self._raw.shape[0]
        for clo, chi, colmap in self._spans:
            if chi <= lo or clo >= hi:
                continue
            s, e = max(lo, clo), min(hi, chi)
            ent = colmap.get(key)
            if ent is None:
                arr = np.full(e - s, _COL_FILL[key], dt)
            else:
                off, cdt, nb = ent
                if off + nb > size:
                    raise TraceReadError(
                        self._path, f"chunk group column {key!r} extends "
                                    f"past end of file (truncated pack?) — "
                                    f"reopen with on_error='salvage'",
                        locus=f"byte {off}")
                arr = self._raw[off:off + nb].view(cdt)[s - clo:e - clo]
            if s == lo and e == hi:
                return arr
            parts.append(arr)
        if not parts:
            return np.empty(0, dt)
        return np.concatenate(parts).astype(dt, copy=False)


def _open_sidecar(path: str, footer: dict, on_error: str = "strict"
                  ) -> Optional[Dict[str, np.ndarray]]:
    """Memmap the structure sidecar; a corrupt/truncated sidecar degrades
    gracefully (warning + derive-on-demand) instead of failing the open."""
    meta = footer.get("sidecar")
    if not meta:
        return None
    rows = footer["rows"]
    try:
        side = {c["key"]: np.memmap(path, dtype=np.dtype(c["dtype"]),
                                    mode="r", offset=c["offset"],
                                    shape=(rows,))
                for c in meta}
    except (OSError, ValueError) as e:
        _IO_STATS["sidecars_dropped"] += 1
        warnings.warn(f"{path}: structure sidecar unreadable ({e}); falling "
                      f"back to derive_structure", RuntimeWarning,
                      stacklevel=3)
        return None
    if on_error != "strict" and footer.get("sidecar_crc") is not None:
        key = _verify_key(path, os.stat(path),
                          len(footer.get("chunks", ())))
        if "sidecar" not in _VERIFIED_CLEAN.get(key, ()):
            lo = meta[0]["offset"]
            hi = (meta[-1]["offset"]
                  + rows * np.dtype(meta[-1]["dtype"]).itemsize)
            with open(path, "rb") as f, \
                    mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
                ok = hi <= len(mm) and zlib.crc32(mm[lo:hi]) == \
                    footer["sidecar_crc"]
            if not ok:
                _IO_STATS["sidecars_dropped"] += 1
                warnings.warn(f"{path}: structure sidecar fails CRC; "
                              f"falling back to derive_structure",
                              RuntimeWarning, stacklevel=3)
                return None
            _mark_verified(key, "sidecar")
    # even without a CRC pass (strict mode stays zero-scan over the data
    # columns), the row-index columns feed fancy-indexing — an out-of-range
    # value from a damaged sidecar must degrade, not crash
    for key in ("matching", "parent"):
        if key in side and rows:
            idx = np.asarray(side[key], np.int64)
            if int(idx.max(initial=-1)) >= rows or \
                    int(idx.min(initial=0)) < -1:
                _IO_STATS["sidecars_dropped"] += 1
                warnings.warn(
                    f"{path}: structure sidecar has out-of-range row "
                    f"indices (corrupt?); falling back to "
                    f"derive_structure", RuntimeWarning, stacklevel=3)
                return None
    return side


def _name_table(footer: dict) -> np.ndarray:
    return np.asarray(footer["names"], dtype=object).astype(str)


def _frame_slice(cols, names: np.ndarray, lo: int, hi: int,
                 uniform: bool) -> EventFrame:
    """EventFrame over rows [lo, hi) — memmap-backed slices (v1 columns or
    v2 group views), no copies except the small int8→int32 Event Type
    widening.  ``uniform=True`` (chunked reads) synthesizes absent optional
    columns so chunks concatenate with every other chunked reader's
    output."""
    n = hi - lo
    ev = EventFrame({
        TS: cols["ts"][lo:hi],
        ET: Categorical(cols["et"][lo:hi].astype(np.int32), _ET_CATS),
        NAME: Categorical(np.asarray(cols["name"][lo:hi]), names),
        PROC: cols["proc"][lo:hi],
    })
    if "thread" in cols:
        ev[THREAD] = cols["thread"][lo:hi]
    elif uniform:
        ev[THREAD] = np.zeros(n, np.int32)
    if "size" in cols:
        ev[MSG_SIZE] = cols["size"][lo:hi]
        ev[PARTNER] = cols["partner"][lo:hi]
        ev[TAG] = cols["tag"][lo:hi]
    elif uniform:
        ev[MSG_SIZE] = np.full(n, np.nan)
        ev[PARTNER] = np.full(n, -1, np.int32)
        ev[TAG] = np.zeros(n, np.int32)
    return ev


def _localize(side: Dict[str, np.ndarray], ev: EventFrame, lo: int,
              hi: int) -> None:
    """Attach the sidecar slice [lo, hi) with row indices re-based to the
    slice (partners/parents outside it become -1 — exactly the within-chunk
    structure the streaming stitcher derives, minus the lexsort)."""
    m = np.asarray(side["matching"][lo:hi], np.int64)
    p = np.asarray(side["parent"][lo:hi], np.int64)
    inside_m = (m >= lo) & (m < hi)
    inside_p = (p >= lo) & (p < hi)
    ev[MATCH] = np.where(inside_m, m - lo, -1)
    ev[PARENT] = np.where(inside_p, p - lo, -1)
    ev[INC] = side["inc"][lo:hi]
    ev[EXC] = side["exc"][lo:hi]


@register_reader("pack", extensions=(".pack",), sniff=_sniff_pack,
                 shard_procs=_shard_procs_pack, priority=30)
def read_pack(path: str, label: Optional[str] = None,
              sidecar: bool = True, on_error: str = "strict",
              report=None, live: bool = False,
              upto_rows: Optional[int] = None, device="cuda") -> Trace:
    """Open a pack whole-file into a Trace whose ops run on ``device``:
    column data is memmap-backed (v1, read-only) or assembled with one
    memcpy per group slice (v2) — zero parse either way.

    With ``sidecar=True`` (default) and a stored sidecar, the derived
    structure columns (matching / depth / parent / inc / exc plus the
    matching-timestamp column) attach directly and the returned Trace is
    already structured — ``derive_structure`` never runs.  A corrupt
    sidecar never fails the open: it is dropped with a warning and
    structure derives lazily.

    ``on_error``: ``"strict"`` (default) raises on structural damage with
    file/offset context; ``"skip_chunk"`` CRC-verifies and quarantines
    damaged chunk groups; ``"salvage"`` additionally rebuilds a lost
    footer by trailer scan.  See the module docstring.

    ``live=True`` reads the **committed prefix** of a (possibly still
    -growing) append-mode shard: no footer needed, no warnings for the
    expected-missing tail, empty trace when nothing has committed yet.
    ``upto_rows`` pins the read to an earlier watermark (always a group
    boundary) so concurrent growth cannot leak into the result.
    """
    path = os.fspath(path)
    report = report if report is not None else IngestReport()
    quar0 = _IO_STATS["chunks_quarantined"]
    if live or upto_rows is not None:
        footer, chunks = _resolve_live(path, upto_rows)
        intact = False  # live prefixes carry no sidecar; derive lazily
    else:
        footer, chunks, intact = _resolve_chunks(path, on_error)
    names = _name_table(footer)
    rows = sum(c["hi"] - c["lo"] for c in chunks)
    report.begin(path)
    q = _IO_STATS["chunks_quarantined"] - quar0
    if q:
        report.skip(path, q, "",
                    "chunk groups quarantined (CRC/structure fault)")
    report.add_rows(path, rows)
    if footer["version"] == 1:
        cols = _open_columns_v1(path, footer)
    else:
        cols = _assemble_columns(path, chunks, rows, footer["has_thread"],
                                 footer["has_messages"])
    ev = _frame_slice(cols, names, 0, rows, uniform=False)
    t = Trace(ev, label=label or path, device=device)
    t._ingest = report
    side = (_open_sidecar(path, footer, on_error)
            if sidecar and intact else None)
    if side is not None:
        matching = np.asarray(side["matching"], np.int64)
        ev[MATCH] = matching
        ev[DEPTH] = side["depth"]
        ev[PARENT] = side["parent"]
        ev[INC] = side["inc"]
        ev[EXC] = side["exc"]
        ts = np.asarray(ev[TS], np.float64)
        ev[MATCH_TS] = np.where(matching >= 0, ts[np.maximum(matching, 0)],
                                np.nan)
        t._structured = True
    return t


def _admits_chunk(ch: dict, hints: Optional[PlanHints]) -> bool:
    """False when the footer index proves the chunk cannot contribute."""
    if hints is None:
        return True
    if hints.time_window is not None:
        t0, t1 = hints.time_window
        if ch["ts_max"] < t0 or ch["ts_min"] > t1:
            return False
    if hints.procs is not None or hints.proc_bounds is not None:
        if not any(hints.admits_proc(p) for p in ch["procs"]):
            return False
    return True


def _row_mask(ev: EventFrame, hints: Optional[PlanHints]) -> Optional[np.ndarray]:
    """Row-level pushdown mask for a surviving chunk, or None when every
    row is admitted (the common all-or-nothing case keeps the zero-copy
    slice and its sidecar fast path)."""
    if hints is None:
        return None
    mask = None
    if hints.procs is not None or hints.proc_bounds is not None:
        proc = np.asarray(ev[PROC], np.int64)
        m = np.ones(len(proc), bool)
        if hints.procs is not None:
            m &= np.isin(proc, np.fromiter(hints.procs, np.int64,
                                           len(hints.procs)))
        if hints.proc_bounds is not None:
            m &= (proc >= hints.proc_bounds[0]) & (proc <= hints.proc_bounds[1])
        mask = m
    if hints.time_window is not None:
        ts = np.asarray(ev[TS], np.float64)
        m = (ts >= hints.time_window[0]) & (ts <= hints.time_window[1])
        mask = m if mask is None else (mask & m)
    if mask is None or mask.all():
        return None
    return mask


@register_chunked("pack")
def iter_chunks_pack(path: str, chunk_rows: int,
                     hints: Optional[PlanHints] = None,
                     label: Optional[str] = None,
                     row_range: Optional[tuple] = None,
                     sidecar: bool = True,
                     on_error: str = "strict",
                     report=None, live: bool = False,
                     upto_rows: Optional[int] = None
                     ) -> Iterator[EventFrame]:
    """Stream a pack in EventFrame chunks of at most ``chunk_rows`` rows.

    Index pushdown runs first: footer chunks whose time range / process set
    cannot satisfy ``hints`` are skipped without touching their bytes
    (counted in :func:`io_stats`).  Surviving contiguous row runs are
    coalesced and re-sliced to ``chunk_rows``, so the yielded chunk size is
    independent of the pack's own chunking.  ``row_range=(lo, hi)``
    restricts the read to those rows (:class:`~repro_torch.core.registry.RowSpan`
    parallel work units).  With a stored sidecar, unfiltered chunks carry
    row-localized structure columns the streaming stitcher consumes instead
    of re-deriving per chunk.  ``on_error`` follows :func:`read_pack`:
    verifying modes quarantine CRC-failing chunk groups before pushdown,
    and ``"salvage"`` streams a footer-less pack from its trailer scan.
    ``live`` / ``upto_rows`` follow :func:`read_pack`: stream the
    committed prefix of a still-growing shard, pinned to a watermark.
    """
    path = os.fspath(path)
    quar0 = _IO_STATS["chunks_quarantined"]
    if live or upto_rows is not None:
        footer, fchunks = _resolve_live(path, upto_rows)
        intact = False
    else:
        footer, fchunks, intact = _resolve_chunks(path, on_error)
    names = _name_table(footer)
    total = sum(c["hi"] - c["lo"] for c in fchunks)
    if report is not None and row_range is None:
        report.begin(path)
        q = _IO_STATS["chunks_quarantined"] - quar0
        if q:
            report.skip(path, q, "",
                        "chunk groups quarantined (CRC/structure fault)")
        report.add_rows(path, total)
    if footer["version"] == 1:
        cols = _open_columns_v1(path, footer)
    elif fchunks:
        cols = _GroupColumnSource(path, fchunks, footer["has_thread"],
                                  footer["has_messages"])
    else:
        cols = {}  # nothing committed yet — no bytes to map
    side = (_open_sidecar(path, footer, on_error)
            if sidecar and intact else None)
    r_lo, r_hi = (0, total) if row_range is None else (
        int(row_range[0]), int(row_range[1]))
    # pushdown at footer-chunk granularity, then coalesce surviving runs
    runs: List[List[int]] = []
    for ch in fchunks:
        lo, hi = max(ch["lo"], r_lo), min(ch["hi"], r_hi)
        if hi <= lo:
            continue
        if not _admits_chunk(ch, hints):
            _IO_STATS["chunks_skipped"] += 1
            continue
        _IO_STATS["chunks_read"] += 1
        if runs and runs[-1][1] == lo:
            runs[-1][1] = hi
        else:
            runs.append([lo, hi])
    for lo, hi in runs:
        for s in range(lo, hi, chunk_rows):
            e = min(s + chunk_rows, hi)
            ev = _frame_slice(cols, names, s, e, uniform=True)
            mask = _row_mask(ev, hints)
            if mask is None:
                if side is not None:
                    _localize(side, ev, s, e)
                yield ev
            else:
                if not np.any(mask):
                    continue
                # row filtering invalidates localized structure indices —
                # the stitcher re-derives on the filtered chunk, exactly
                # like parse-time pushdown in the text readers
                yield ev.mask(mask)


@register_units("pack")
def plan_units_pack(path: str, n_units: int) -> Optional[List[RowSpan]]:
    """Split one pack into up to ``n_units`` RowSpans aligned to footer
    chunk boundaries — the ideal ByteSpan analogue: rows are random-access,
    so no line-boundary alignment pass is ever needed and the spans
    partition the rows exactly by construction."""
    footer = read_footer(path)
    chunks = footer["chunks"]
    if n_units <= 1 or len(chunks) <= 1:
        return None
    groups = even_groups(chunks, n_units)
    return [RowSpan(path, g[0]["lo"], g[-1]["hi"]) for g in groups]
