"""Wire protocol for the trace-query service: JSON codecs and digests.

Mirrors :mod:`repro.serving.protocol`.  Everything the service speaks is
JSON, but analysis results are columnar numeric data, so arrays travel as
raw little-endian column bytes, base64-encoded, beside their dtype and
shape.  The envelope stays one self-describing JSON document (clients need
only the standard library), decoding is one ``np.frombuffer`` per column,
and the round trip is **bit-exact**: a result decoded from the wire
digests the same as the library call it came from.

* **plans**: :func:`encode_filter` / :func:`encode_steps` serialize a
  client's ``Filter`` trees and plan steps; :func:`apply_steps` replays
  them onto a server-side ``TraceQuery`` through its builder methods, so
  the service runs the plan a local script would (mask fusion, pushdown
  and plan-cache keys included).
* **values**: :func:`encode_value` / :func:`decode_value` cover every type
  a registered op returns (``EventFrame``, ``Categorical``, numeric and
  string arrays, tuples, lists, dicts, scalars) and every op argument a
  JSON request can carry.
* **digests**: :func:`result_digest` is a canonical SHA-256 over a result
  value, independent of its wire form; :func:`canonical_json` keys the
  service's single-flight table.

User ``Filter`` subclasses and callable arguments do not travel: the
codec raises :class:`ProtocolError` rather than guess their meaning.
"""

from __future__ import annotations

import base64
import hashlib
import json
from typing import Any, List, Sequence

import numpy as np

from ..core.filters import Filter, _And, _Not, _Or
from ..core.frame import Categorical, EventFrame

__all__ = ["ProtocolError", "encode_filter", "decode_filter",
           "encode_steps", "decode_steps", "apply_steps", "encode_value",
           "decode_value", "result_digest", "canonical_json"]


class ProtocolError(ValueError):
    """A request or value cannot be represented on (or decoded from) the
    wire.  The service maps this to HTTP 400."""


# ---------------------------------------------------------------------------
# filters and plan steps
# ---------------------------------------------------------------------------

def encode_filter(f: Filter) -> dict:
    if isinstance(f, _And):
        return {"k": "and", "a": encode_filter(f.a), "b": encode_filter(f.b)}
    if isinstance(f, _Or):
        return {"k": "or", "a": encode_filter(f.a), "b": encode_filter(f.b)}
    if isinstance(f, _Not):
        return {"k": "not", "a": encode_filter(f.a)}
    if type(f) is not Filter:
        raise ProtocolError(
            f"custom Filter subclass {type(f).__name__!r} cannot travel "
            f"over the wire; express the predicate with Filter leaves")
    return {"k": "leaf", "field": f.field, "op": f.operator,
            "value": encode_value(f.value),
            "trim": getattr(f, "_trim", None)}


def decode_filter(d: dict) -> Filter:
    try:
        kind = d["k"]
        if kind == "and":
            return _And(decode_filter(d["a"]), decode_filter(d["b"]))
        if kind == "or":
            return _Or(decode_filter(d["a"]), decode_filter(d["b"]))
        if kind == "not":
            return _Not(decode_filter(d["a"]))
        if kind == "leaf":
            f = Filter(d["field"], d["op"], decode_value(d["value"]))
            if d.get("trim") is not None:
                f._trim = d["trim"]
            return f
    except ProtocolError:
        raise
    except (KeyError, TypeError, ValueError) as e:
        raise ProtocolError(f"malformed filter {d!r}: {e}") from None
    raise ProtocolError(f"unknown filter kind {kind!r}")


def encode_steps(steps: Sequence) -> List[dict]:
    """Serialize plan steps (the real ``query.Step`` objects a local
    TraceQuery carries)."""
    from ..core.query import FilterStep, ProcessStep, SliceTimeStep
    out = []
    for step in steps:
        if type(step) is FilterStep:
            out.append({"k": "filter", "filter": encode_filter(step.filter)})
        elif type(step) is SliceTimeStep:
            out.append({"k": "slice_time", "start": float(step.start),
                        "end": float(step.end), "trim": step.trim})
        elif type(step) is ProcessStep:
            out.append({"k": "restrict_processes",
                        "procs": [int(p) for p in step.procs]})
        else:
            raise ProtocolError(
                f"plan step {type(step).__name__!r} cannot travel over "
                f"the wire")
    return out


def decode_steps(steps: Sequence[dict]) -> List[dict]:
    """Validate a wire step list (shape only); returns it unchanged.
    :func:`apply_steps` does the real decoding onto a query object."""
    for s in steps:
        if not isinstance(s, dict) or s.get("k") not in (
                "filter", "slice_time", "restrict_processes"):
            raise ProtocolError(f"malformed plan step {s!r}")
    return list(steps)


def apply_steps(query, steps: Sequence[dict]):
    """Replay wire steps onto a ``TraceQuery`` via its builder methods —
    the server-side plan is then byte-for-byte the plan a local chain
    would build (same fusion, same plan-cache key)."""
    for s in decode_steps(steps):
        try:
            if s["k"] == "filter":
                query = query.filter(decode_filter(s["filter"]))
            elif s["k"] == "slice_time":
                query = query.slice_time(float(s["start"]), float(s["end"]),
                                         trim=s.get("trim", "overlap"))
            else:
                query = query.restrict_processes(
                    [int(p) for p in s["procs"]])
        except ProtocolError:
            raise
        except (KeyError, TypeError, ValueError) as e:
            raise ProtocolError(f"malformed plan step {s!r}: {e}") from None
    return query


# ---------------------------------------------------------------------------
# values (op arguments and results)
# ---------------------------------------------------------------------------

_MARK = "__pipit__"


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(
        np.ascontiguousarray(arr).tobytes()).decode("ascii")


def encode_value(obj: Any) -> Any:
    """JSON-able encoding of one op argument or result value."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, (np.bool_, np.integer, np.floating)):
        return {_MARK: "scalar", "dtype": np.asarray(obj).dtype.str,
                "b64": _b64(np.asarray(obj))}
    if isinstance(obj, EventFrame):
        return {_MARK: "frame",
                "columns": [[name, encode_value(obj.column(name))]
                            for name in obj.columns]}
    if isinstance(obj, Categorical):
        return {_MARK: "categorical", "codes": encode_value(obj.codes),
                "categories": [str(c) for c in obj.categories]}
    if isinstance(obj, np.ndarray):
        if obj.dtype.kind in "UOS":
            return {_MARK: "strarray", "shape": list(obj.shape),
                    "items": [str(x) for x in obj.ravel()]}
        return {_MARK: "ndarray", "dtype": obj.dtype.str,
                "shape": list(obj.shape), "b64": _b64(obj)}
    if isinstance(obj, tuple):
        return {_MARK: "tuple", "items": [encode_value(x) for x in obj]}
    if isinstance(obj, (list,)):
        return [encode_value(x) for x in obj]
    if isinstance(obj, (set, frozenset)):
        return {_MARK: "tuple",
                "items": sorted((encode_value(x) for x in obj), key=repr)}
    if isinstance(obj, range):
        return {_MARK: "tuple", "items": [int(x) for x in obj]}
    if isinstance(obj, dict):
        items = []
        for k, v in obj.items():
            if not isinstance(k, (str, int, float, bool)) and k is not None:
                raise ProtocolError(f"dict key {k!r} cannot travel as JSON")
            items.append([k, encode_value(v)])
        return {_MARK: "dict", "items": items}
    raise ProtocolError(
        f"value of type {type(obj).__name__!r} cannot travel over the wire")


def decode_value(obj: Any) -> Any:
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, list):
        return [decode_value(x) for x in obj]
    if not isinstance(obj, dict):
        raise ProtocolError(f"undecodable wire value {obj!r}")
    kind = obj.get(_MARK)
    try:
        if kind is None:
            raise ProtocolError(f"plain JSON objects must use the "
                                f"{{{_MARK!r}: 'dict'}} envelope: {obj!r}")
        if kind == "scalar":
            raw = base64.b64decode(obj["b64"])
            return np.frombuffer(raw, dtype=np.dtype(obj["dtype"]))[0]
        if kind == "ndarray":
            raw = base64.b64decode(obj["b64"])
            arr = np.frombuffer(raw, dtype=np.dtype(obj["dtype"]))
            return arr.reshape(obj["shape"]).copy()
        if kind == "strarray":
            arr = np.asarray([str(x) for x in obj["items"]], dtype=object)
            return arr.reshape(obj["shape"])
        if kind == "categorical":
            return Categorical.from_codes(
                np.asarray(decode_value(obj["codes"]), np.int32),
                np.asarray([str(c) for c in obj["categories"]],
                           dtype=object))
        if kind == "frame":
            out = EventFrame()
            for name, enc in obj["columns"]:
                out[str(name)] = decode_value(enc)
            return out
        if kind == "tuple":
            return tuple(decode_value(x) for x in obj["items"])
        if kind == "dict":
            return {k: decode_value(v) for k, v in obj["items"]}
    except ProtocolError:
        raise
    except (KeyError, TypeError, ValueError) as e:
        raise ProtocolError(f"undecodable wire value "
                            f"({kind!r}): {e}") from None
    raise ProtocolError(f"unknown wire value kind {kind!r}")


# ---------------------------------------------------------------------------
# digests
# ---------------------------------------------------------------------------

def _digest_into(h, obj: Any) -> None:
    if obj is None:
        h.update(b"\x00N")
    elif isinstance(obj, (bool, np.bool_)):
        h.update(b"\x00b" + (b"1" if obj else b"0"))
    elif isinstance(obj, (int, np.integer)):
        h.update(b"\x00i" + repr(int(obj)).encode())
    elif isinstance(obj, (float, np.floating)):
        h.update(b"\x00f" + repr(float(obj)).encode())
    elif isinstance(obj, str):
        h.update(b"\x00s" + obj.encode())
    elif isinstance(obj, EventFrame):
        h.update(b"\x00F")
        for name in obj.columns:
            _digest_into(h, name)
            _digest_into(h, obj.column(name))
    elif isinstance(obj, Categorical):
        # digest by decoded content, not representation: a Categorical and
        # the equivalent string array digest identically
        _digest_into(h, obj.to_strings())
    elif isinstance(obj, np.ndarray):
        if obj.dtype.kind in "UOS":
            h.update(b"\x00S" + repr(list(obj.shape)).encode())
            for x in obj.ravel():
                _digest_into(h, str(x))
        else:
            h.update(b"\x00A" + obj.dtype.str.encode()
                     + repr(list(obj.shape)).encode())
            h.update(np.ascontiguousarray(obj).tobytes())
    elif isinstance(obj, (list, tuple)):
        # lists and tuples digest identically: wire transport must not
        # change a result's digest
        h.update(b"\x00L" + repr(len(obj)).encode())
        for x in obj:
            _digest_into(h, x)
    elif isinstance(obj, dict):
        h.update(b"\x00D" + repr(len(obj)).encode())
        for k in sorted(obj, key=repr):
            _digest_into(h, k)
            _digest_into(h, obj[k])
    else:
        raise ProtocolError(
            f"cannot digest value of type {type(obj).__name__!r}")


def result_digest(value: Any) -> str:
    """Canonical SHA-256 of a result value.  Representation-independent
    where the wire is: tuples/lists collapse, ``Categorical`` digests as
    its decoded strings — so ``digest(decode(encode(x))) == digest(x)``
    always, and the service-vs-library equality checks are one string
    compare."""
    h = hashlib.sha256()
    _digest_into(h, value)
    return h.hexdigest()


def canonical_json(obj: Any) -> str:
    """Deterministic JSON (sorted keys, tight separators) — the service's
    fallback single-flight key for requests outside the plan cache's
    digestible domain."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=str)
