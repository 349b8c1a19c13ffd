"""HLO dot inventory: enumerate every ``dot`` in an HLO module with resolved
operand shapes and FLOPs.

A copy of :mod:`repro.analysis.dots` (it parses HLO text and uses no
jax), so that the port reads the same inventory from an HLO module as the
reference does.

Two passes:
1. collect every instruction definition ``%name = type[dims]{...} ...`` and
   every computation's body, plus while-loop trip counts (parsed from the
   loop condition's comparison constant);
2. for each ``dot``, resolve operand shapes by name, read the contracting
   dims, and compute FLOPs = 2 × prod(result) × prod(contracting).

``summarize_dots`` aggregates by (computation × shape signature) and applies
trip-count multipliers so scanned-body dots are weighted honestly.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Tuple

__all__ = ["dot_inventory", "summarize_dots", "while_trip_counts"]

_DEF = re.compile(r"^\s*(?:ROOT\s+)?%([\w\.\-]+)\s*=\s*(\w+)\[([\d,]*)\]")
_COMP_HDR = re.compile(r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s*\(")
_DOT_LINE = re.compile(
    r"^\s*(?:ROOT\s+)?%[\w\.\-]+\s*=\s*\w+\[([\d,]*)\][^=]*?\bdot\("
    r"\s*%([\w\.\-]+)\s*,\s*%([\w\.\-]+)\s*\)")
_CONTRACT = re.compile(r"lhs_contracting_dims=\{([\d,]*)\}")
_WHILE = re.compile(r"while\(.*?\)\s*,\s*condition=%?([\w\.\-]+)\s*,\s*body=%?([\w\.\-]+)")
_CONST_INT = re.compile(r"constant\((\d+)\)")


def _parse_module(hlo: str):
    """Returns (shapes by (comp, name), comp of each line, comp bodies,
    while edges [(caller_comp, cond, body)])."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    comp = "?"
    comp_lines: Dict[str, List[str]] = defaultdict(list)
    whiles: List[Tuple[str, str, str]] = []
    for line in hlo.splitlines():
        hdr = _COMP_HDR.match(line.strip()) if line and not line.startswith(" ") else None
        if hdr and "{" in line:
            comp = hdr.group(1)
        m = _DEF.match(line)
        if m:
            name, _, dims = m.groups()
            shapes[name] = tuple(int(x) for x in dims.split(",") if x)
        w = _WHILE.search(line)
        if w:
            whiles.append((comp, w.group(1), w.group(2)))
        comp_lines[comp].append(line)
    return shapes, comp_lines, whiles


def while_trip_counts(hlo: str) -> Dict[str, int]:
    """body-computation name → trip count (best effort: the largest integer
    constant in the condition computation)."""
    shapes, comp_lines, whiles = _parse_module(hlo)
    out = {}
    for _, cond, body in whiles:
        consts = []
        for line in comp_lines.get(cond, []):
            consts += [int(x) for x in _CONST_INT.findall(line)]
        out[body] = max(consts) if consts else 1
    return out


def dot_inventory(hlo: str) -> List[Dict]:
    shapes, comp_lines, whiles = _parse_module(hlo)
    trips = while_trip_counts(hlo)
    # computations transitively inside a while body inherit its trip count
    body_mult: Dict[str, int] = defaultdict(lambda: 1)
    for body, t in trips.items():
        body_mult[body] = max(body_mult[body], t)
    out = []
    for comp, lines in comp_lines.items():
        mult = body_mult[comp]
        for line in lines:
            m = _DOT_LINE.match(line)
            if not m:
                continue
            res_dims = tuple(int(x) for x in m.group(1).split(",") if x)
            lhs = shapes.get(m.group(2), ())
            c = _CONTRACT.search(line)
            cdims = [int(x) for x in c.group(1).split(",") if x] if c else []
            k = 1
            for ci in cdims:
                if ci < len(lhs):
                    k *= lhs[ci]
            res = 1
            for d in res_dims:
                res *= d
            out.append({
                "computation": comp, "trip_mult": mult,
                "result": "x".join(map(str, res_dims)) or "scalar",
                "lhs": "x".join(map(str, lhs)),
                "flops": 2.0 * res * k,
                "flops_weighted": 2.0 * res * k * mult,
            })
    return out


def summarize_dots(hlo: str, top: int = 20) -> List[Tuple[str, float, int]]:
    agg: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for d in dot_inventory(hlo):
        key = (f"[{d['lhs']}]·→[{d['result']}] ×{d['trip_mult']} "
               f"@{d['computation'][:28]}")
        agg[key][0] += d["flops_weighted"]
        agg[key][1] += 1
    rows = sorted(((k, v[0], v[1]) for k, v in agg.items()),
                  key=lambda r: -r[1])
    return rows[:top]
