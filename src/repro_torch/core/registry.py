"""Op and reader registries of the port.

Mirrors the op table and reader sniffing of :mod:`repro.core.registry`
that ``Trace`` uses: every analysis op registers itself with its declared
prerequisites (``needs_structure``: enter/leave matching, parents,
inc/exc; ``needs_messages``: send/recv matching), and every trace format
registers a reader plus an optional content sniffer, so
``Trace.open(path, format="auto")`` resolves the format here.

The port has no backend table: each built-in op has one implementation,
which runs its kernels on the ``device=`` it is given.  A user's op,
detector, streaming factory or reader keeps the reference's contract,
``fn(trace, *args, **kwargs)``: the registry records whether the callable
takes ``device`` (a parameter of that name, or ``**kwargs``), and
:func:`call_with_device` hands it ``device=`` only then.  An op may also
declare a
streaming form (:func:`register_streaming`), and a reader a chunked one
(``iter_chunks``), which the out-of-core executor
(:mod:`repro_torch.core.streaming`) drives, a per-shard process hint
(``shard_procs``: shards a process-restricted plan cannot need are skipped
before parsing) and a work-unit planner (``plan_units``: :class:`ByteSpan`,
:class:`RowSpan` or :class:`ProcSpan` units for the parallel executor,
:mod:`repro_torch.core.executor`).  A plan hands chunked readers its
process and time-window restriction as :class:`PlanHints`.  This module
imports nothing of the trace or query layers, so every module can import
it without cycles.
"""

from __future__ import annotations

import inspect
import os
import re
from dataclasses import dataclass, replace
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Set, Tuple)

from .errors import TraceReadError

__all__ = ["OpSpec", "register_op", "register_streaming", "get_op",
           "list_ops", "terminal_op", "ReaderSpec",
           "register_reader", "register_chunked", "register_units",
           "get_reader", "list_readers", "sniff_format", "resolve_reader",
           "rank_shard_procs", "PlanHints", "ByteSpan", "ProcSpan",
           "RowSpan", "even_edges", "even_groups", "takes_device",
           "call_with_device"]


def takes_device(fn: Callable) -> bool:
    """True when ``fn`` accepts a ``device`` keyword: a parameter of that
    name, or ``**kwargs``.  A callable whose signature cannot be read is
    taken not to."""
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return False
    return any(p.kind is p.VAR_KEYWORD
               or (p.name == "device"
                   and p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY))
               for p in params)


def call_with_device(fn: Callable, takes: Optional[bool], /, *args: Any,
                     **kwargs: Any) -> Any:
    """``fn(*args, **kwargs)``, where a ``device`` among ``kwargs`` is
    handed on only when ``fn`` takes it (``takes``: the registration's
    record, or None to read the signature now).  The one way the port
    calls a registered op, detector, streaming factory or reader."""
    if not (takes_device(fn) if takes is None else takes):
        kwargs.pop("device", None)
    return fn(*args, **kwargs)


@dataclass(frozen=True)
class PlanHints:
    """Pushdown hints a query plan hands to a chunked reader.

    Every field is advisory: a reader may drop rows or chunks that provably
    cannot satisfy the hints, or ignore them — the streaming executor
    re-applies the plan's fused mask to every chunk.

    * ``procs`` — explicit set of process ids the plan restricts to;
    * ``proc_bounds`` — inclusive ``[lo, hi]`` bound on process ids;
    * ``time_window`` — inclusive ``[t0, t1]`` ns window holding every
      surviving row's own timestamp (only ``trim="within"`` windows).
    """

    procs: Optional[frozenset] = None
    proc_bounds: Optional[Tuple[float, float]] = None
    time_window: Optional[Tuple[float, float]] = None

    def admits_proc(self, p: int) -> bool:
        if self.procs is not None and p not in self.procs:
            return False
        if self.proc_bounds is not None and not (
                self.proc_bounds[0] <= p <= self.proc_bounds[1]):
            return False
        return True


# ---------------------------------------------------------------------------
# parallel work units
# ---------------------------------------------------------------------------

def even_edges(lo: int, hi: int, n: int) -> List[int]:
    """n+1 monotone edges splitting [lo, hi) into ~equal integer spans."""
    return [lo + (hi - lo) * i // n for i in range(n + 1)]


def even_groups(seq: Sequence, n: int) -> List[Tuple]:
    """Split ``seq`` into up to ``n`` contiguous non-empty tuples of ~equal
    length, in order."""
    seq = list(seq)
    out = []
    for k in range(n):
        part = tuple(seq[len(seq) * k // n: len(seq) * (k + 1) // n])
        if part:
            out.append(part)
    return out


@dataclass(frozen=True)
class ByteSpan:
    """One byte range of a line-oriented trace file: a work unit whose
    reader keeps the records whose first byte lies in ``[lo, hi)``, so
    spans planned over one file partition its records exactly."""

    path: str
    lo: int
    hi: int


@dataclass(frozen=True)
class RowSpan:
    """One row range ``[lo, hi)`` of a random-access columnar file (a
    pipitpack): the reader slices rows directly, so spans partition the
    rows by construction."""

    path: str
    lo: int
    hi: int


@dataclass(frozen=True)
class ProcSpan:
    """One process-subset work unit of a trace file: the rows of ``procs``
    only.  The executor enforces the subset with an explicit per-chunk
    mask (reader hints stay advisory), so spans over disjoint process sets
    partition the rows exactly.  ``extra`` carries reader-specific keyword
    items (a pre-passed pid table) as a tuple of pairs."""

    path: str
    procs: Tuple[int, ...]
    extra: Tuple = ()


@dataclass(frozen=True)
class OpSpec:
    """A registered analysis operation.

    ``scope`` declares the op's input shape: a ``"trace"`` op is
    ``fn(trace, *args, **kwargs)`` and terminates a single-trace
    :class:`~repro_torch.core.query.TraceQuery`; a ``"set"`` op is
    ``fn(traces, *args, **kwargs)`` over a sequence of traces and
    terminates a :class:`~repro_torch.core.diff.TraceSet` query.  Either
    way ``fn`` runs with the declared prerequisites already materialized
    (on every member trace for set-scoped ops).  ``takes_device`` and
    ``streaming_takes_device`` record whether ``fn`` and the streaming
    factory take ``device`` (:func:`takes_device`)."""

    name: str
    fn: Callable[..., Any]
    needs_structure: bool = False
    needs_messages: bool = False
    scope: str = "trace"
    #: factory building a streaming aggregator
    #: (:class:`repro_torch.core.streaming.StreamAgg`) for out-of-core
    #: execution, or None when the op needs a materialized trace
    streaming: Optional[Callable[..., Any]] = None
    #: True when the streaming aggregator also declares a cross-worker
    #: merge (``supports_parallel`` and ``merge_from``): the parallel
    #: executor fans such ops over work units
    parallel_safe: bool = False
    takes_device: bool = True
    streaming_takes_device: bool = True


_OP_REGISTRY: Dict[str, OpSpec] = {}


def register_op(name: Optional[str] = None, *, needs_structure: bool = False,
                needs_messages: bool = False,
                scope: str = "trace") -> Callable:
    """Decorator registering an analysis op usable from ``TraceQuery``
    (``scope="trace"``, the default) or ``TraceSet`` (``scope="set"``);
    the last registration of a name wins."""
    if scope not in ("trace", "set"):
        raise ValueError(f'scope must be "trace" or "set", got {scope!r}')

    def deco(fn: Callable) -> Callable:
        op_name = name or fn.__name__
        _OP_REGISTRY[op_name] = OpSpec(op_name, fn, needs_structure,
                                       needs_messages, scope,
                                       takes_device=takes_device(fn))
        return fn

    return deco


def register_streaming(op_name: str) -> Callable:
    """Decorator declaring ``op_name``'s streaming (combinable) form: the
    decorated factory, called with the op's own ``(*args, **kwargs)``
    (and ``device=`` when it takes it), returns a streaming aggregator
    whose result reproduces the in-memory op.  A factory carrying ``supports_parallel =
    True`` and a ``merge_from`` method marks the op parallel-safe."""

    def deco(factory: Callable) -> Callable:
        spec = _OP_REGISTRY.get(op_name)
        if spec is None:
            raise ValueError(
                f"cannot declare streaming form of unregistered op "
                f"{op_name!r}; register the op first")
        par = bool(getattr(factory, "supports_parallel", False)
                   and getattr(factory, "merge_from", None) is not None)
        _OP_REGISTRY[op_name] = replace(
            spec, streaming=factory, parallel_safe=par,
            streaming_takes_device=takes_device(factory))
        return factory

    return deco


def get_op(name: str) -> Optional[OpSpec]:
    return _OP_REGISTRY.get(name)


def list_ops() -> List[str]:
    return sorted(_OP_REGISTRY)


def terminal_op(name: str, run: Callable[..., Any], owner: str) -> Callable:
    """Resolve ``name`` as a registered-op terminal bound to ``run`` — the
    shared ``__getattr__`` dispatch of TraceQuery and StreamingTrace.
    Raises AttributeError for private names and unknown ops, so
    ``getattr`` / ``hasattr`` keep their meaning on the owner."""
    if name.startswith("_"):
        raise AttributeError(name)
    spec = get_op(name)
    if spec is None:
        raise AttributeError(
            f"{name!r} is neither a {owner} method nor a registered "
            f"analysis op (see repro_torch.core.registry.list_ops())")

    def terminal(*args: Any, **kwargs: Any) -> Any:
        return run(name, *args, **kwargs)

    terminal.__name__ = name
    terminal.__qualname__ = f"{owner}.{name}"
    terminal.__doc__ = spec.fn.__doc__
    return terminal


@dataclass(frozen=True)
class ReaderSpec:
    """A registered trace-format reader: ``read(path, **kw)`` returns a
    Trace (``read_takes_device``: whether it takes ``device=``; a trace
    from one that does not is put on the caller's device, see
    :meth:`open`); ``sniff(path, head)`` gets the path and the first few KB of
    file text and returns True when the content is this format.
    ``shard_procs(path)`` optionally returns the process ids a shard holds
    (None when unknown): shards a process-restricted plan cannot need are
    skipped before parsing.  ``iter_chunks(path, chunk_rows, hints,
    **kw)`` optionally yields successive EventFrames of at most
    ``chunk_rows`` events without holding the whole file (``hints``: the
    plan's :class:`PlanHints`, advisory); formats without one stream a
    whole-file read sliced into chunks.  ``plan_units(path, n_units)``
    optionally splits one file into up to ``n_units`` work units for the
    parallel executor (None: the file is one unit)."""

    name: str
    read: Callable[..., Any]
    extensions: Tuple[str, ...] = ()
    sniff: Optional[Callable[[str, str], bool]] = None
    shard_procs: Optional[Callable[[str], Optional[Set[int]]]] = None
    priority: int = 0  # higher sniffs first
    iter_chunks: Optional[Callable[..., Iterator[Any]]] = None
    plan_units: Optional[Callable[[str, int], Optional[List[Any]]]] = None
    read_takes_device: bool = True

    def open(self, path: str, device, **kw: Any) -> Any:
        """``read(path, **kw)``, with ``device=`` when the reader takes it;
        a trace from a reader that does not is moved to ``device``."""
        t = call_with_device(self.read, self.read_takes_device, path,
                             device=device, **kw)
        if not self.read_takes_device:
            from .accel import resolve_device
            t.device = resolve_device(device)
        return t


_READER_REGISTRY: Dict[str, ReaderSpec] = {}


def register_reader(name: str, *, extensions: Sequence[str] = (),
                    sniff: Optional[Callable[[str, str], bool]] = None,
                    shard_procs: Optional[
                        Callable[[str], Optional[Set[int]]]] = None,
                    priority: int = 0,
                    iter_chunks: Optional[Callable[..., Iterator[Any]]] = None
                    ) -> Callable:
    """Decorator registering a reader callable under ``name``, with its
    chunked form ``iter_chunks`` if given (or later by
    :func:`register_chunked`)."""

    def deco(fn: Callable) -> Callable:
        _READER_REGISTRY[name] = ReaderSpec(
            name, fn, tuple(e.lower() for e in extensions), sniff,
            shard_procs, priority, iter_chunks,
            read_takes_device=takes_device(fn))
        return fn

    return deco


def register_chunked(name: str) -> Callable:
    """Decorator attaching a chunked reader to the already-registered
    format ``name``."""

    def deco(fn: Callable) -> Callable:
        spec = _READER_REGISTRY.get(name)
        if spec is None:
            raise ValueError(
                f"cannot attach chunked reader to unregistered format "
                f"{name!r}; register the reader first")
        _READER_REGISTRY[name] = replace(spec, iter_chunks=fn)
        return fn

    return deco


def register_units(name: str) -> Callable:
    """Decorator attaching a work-unit planner (``plan_units(path,
    n_units)``) to the already-registered format ``name``."""

    def deco(fn: Callable) -> Callable:
        spec = _READER_REGISTRY.get(name)
        if spec is None:
            raise ValueError(
                f"cannot attach unit planner to unregistered format "
                f"{name!r}; register the reader first")
        _READER_REGISTRY[name] = replace(spec, plan_units=fn)
        return fn

    return deco


def get_reader(name: str) -> ReaderSpec:
    try:
        return _READER_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown trace format {name!r}; registered: {list_readers()}"
        ) from None


def list_readers() -> List[str]:
    return sorted(_READER_REGISTRY)


def _read_head(path: str, nbytes: int = 8192) -> str:
    try:
        with open(path, "r", errors="replace") as f:
            return f.read(nbytes)
    except (OSError, IsADirectoryError):
        return ""


def sniff_format(path) -> Optional[str]:
    """Guess the registered format of ``path`` from its name and content:
    a content sniffer wins over the extension, and the extension is only
    trusted for formats without a sniffer."""
    path = os.fspath(path)
    specs = sorted(_READER_REGISTRY.values(), key=lambda s: -s.priority)
    if os.path.isdir(path):
        # a directory archive (otf2j) is sniffed by its sniffer alone
        for spec in specs:
            if spec.sniff and spec.sniff(path, ""):
                return spec.name
        return None
    low = path.lower()
    head = _read_head(path)
    for spec in specs:
        if spec.sniff and spec.sniff(path, head):
            return spec.name
    for spec in specs:
        if spec.sniff is None and any(low.endswith(e)
                                      for e in spec.extensions):
            return spec.name
    return None


def _describe_readers() -> str:
    parts = []
    for name in list_readers():
        spec = _READER_REGISTRY[name]
        ext = "/".join(spec.extensions) if spec.extensions else "any"
        sniffer = spec.sniff.__name__ if spec.sniff else "extension only"
        parts.append(f"{name} (extensions: {ext}; sniffer: {sniffer})")
    return ", ".join(parts)


_RANK_RE = re.compile(r"^rank[_\-.](\d+)\.")


def rank_shard_procs(path: str) -> Optional[Set[int]]:
    """Default shard hint: a file named ``rank_<p>.*`` (the layout
    ``split_jsonl_by_process`` and ``big_trace`` write) holds exactly one
    process.  Anchored to the whole stem, so ``lowrank_2.csv`` gets no
    hint and is never skipped."""
    m = _RANK_RE.match(os.path.basename(path))
    return {int(m.group(1))} if m else None


def resolve_reader(path, format: str = "auto") -> ReaderSpec:
    """Resolve ``format`` (or sniff when "auto") to a ReaderSpec."""
    if format and format != "auto":
        return get_reader(format)
    name = sniff_format(path)
    if name is None:
        try:
            size = (None if os.path.isdir(path)
                    else os.path.getsize(os.fspath(path)))
        except OSError:
            size = None
        if size == 0:
            raise TraceReadError(
                os.fspath(path),
                f"empty file (0 bytes) — cannot determine trace format. "
                f"Sniffers tried: {_describe_readers()}")
        raise ValueError(
            f"cannot determine trace format of {path!r}: no registered "
            f"sniffer recognized the content.  Registered formats: "
            f"{_describe_readers()}.  Pass format=<name> to force one.")
    return get_reader(name)
