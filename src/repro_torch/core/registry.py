"""Op and reader registries of the port.

Mirrors the op table and reader sniffing of :mod:`repro.core.registry`
that ``Trace`` uses: every analysis op registers itself with its declared
prerequisites (``needs_structure``: enter/leave matching, parents,
inc/exc; ``needs_messages``: send/recv matching), and every trace format
registers a reader plus an optional content sniffer, so
``Trace.open(path, format="auto")`` resolves the format here.

The port has no backend table: each op has one implementation, which runs
its kernels on the ``device=`` it is given.  This module imports nothing
of the trace or query layers, so every module can import it without
cycles.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .errors import TraceReadError

__all__ = ["OpSpec", "register_op", "get_op", "list_ops", "ReaderSpec",
           "register_reader", "get_reader", "list_readers", "sniff_format",
           "resolve_reader"]


@dataclass(frozen=True)
class OpSpec:
    """A registered analysis operation: ``fn(trace, *args, **kwargs)``
    runs with the declared prerequisites already materialized."""

    name: str
    fn: Callable[..., Any]
    needs_structure: bool = False
    needs_messages: bool = False


_OP_REGISTRY: Dict[str, OpSpec] = {}


def register_op(name: Optional[str] = None, *, needs_structure: bool = False,
                needs_messages: bool = False) -> Callable:
    """Decorator registering an analysis op (last registration wins)."""

    def deco(fn: Callable) -> Callable:
        op_name = name or fn.__name__
        _OP_REGISTRY[op_name] = OpSpec(op_name, fn, needs_structure,
                                       needs_messages)
        return fn

    return deco


def get_op(name: str) -> Optional[OpSpec]:
    return _OP_REGISTRY.get(name)


def list_ops() -> List[str]:
    return sorted(_OP_REGISTRY)


@dataclass(frozen=True)
class ReaderSpec:
    """A registered trace-format reader: ``read(path, **kw)`` returns a
    Trace; ``sniff(path, head)`` gets the path and the first few KB of
    file text and returns True when the content is this format."""

    name: str
    read: Callable[..., Any]
    extensions: Tuple[str, ...] = ()
    sniff: Optional[Callable[[str, str], bool]] = None
    priority: int = 0  # higher sniffs first


_READER_REGISTRY: Dict[str, ReaderSpec] = {}


def register_reader(name: str, *, extensions: Sequence[str] = (),
                    sniff: Optional[Callable[[str, str], bool]] = None,
                    priority: int = 0) -> Callable:
    """Decorator registering a reader callable under ``name``."""

    def deco(fn: Callable) -> Callable:
        _READER_REGISTRY[name] = ReaderSpec(
            name, fn, tuple(e.lower() for e in extensions), sniff, priority)
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
