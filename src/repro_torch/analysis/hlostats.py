"""HLO text analysis: byte accounting of HLO shapes and collective traffic.

Mirrors :mod:`repro.analysis.hlostats`: the bytes per element of each HLO
dtype, the size of a shape such as ``bf16[16,512]``, and the per-device
wire bytes of every ``all-gather`` / ``all-reduce`` / ``reduce-scatter`` /
``all-to-all`` / ``collective-permute`` in a module, with the standard
ring-algorithm factors (:func:`wire_bytes`):

    all-gather        (g-1)/g × result_bytes
    all-reduce      2·(g-1)/g × operand_bytes
    reduce-scatter    (g-1)/g × operand_bytes
    all-to-all        (g-1)/g × operand_bytes
    collective-permute          operand_bytes

where g is the replica-group size parsed from the op's ``replica_groups``.
The dry run (:mod:`repro_torch.launch.dryrun`) prices the collectives of
a torch step with the same factors.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Tuple

__all__ = ["DTYPE_BYTES", "shape_bytes", "iter_collectives",
           "collective_stats", "wire_bytes", "summarize", "COLL_KINDS"]

DTYPE_BYTES = {
    "f64": 8, "s64": 8, "u64": 8, "c64": 8,
    "f32": 4, "s32": 4, "u32": 4,
    "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
    "f8e4m3fn": 1, "f8e5m2": 1, "s8": 1, "u8": 1, "pred": 1,
}

_SHAPE_RE = re.compile(r"(\w+?)\[([\d,]*)\]")
COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")
# e.g.:  %ag = bf16[16,512]{1,0} all-gather(bf16[16,32]{1,0} %x), ...
_OP_RE = re.compile(
    r"=\s*(?:\([^)]*\)|[\w\[\],{}]+)?\s*"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(")
_GROUPS_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def shape_bytes(shape_str: str) -> int:
    """'bf16[16,512]' → bytes (an unknown dtype counts 4 bytes)."""
    m = _SHAPE_RE.match(shape_str)
    if not m:
        return 0
    dt, dims = m.groups()
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * DTYPE_BYTES.get(dt, 4)


def _line_shapes(line: str) -> List[str]:
    return [f"{m.group(1)}[{m.group(2)}]" for m in _SHAPE_RE.finditer(line)
            if m.group(1) in DTYPE_BYTES]


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_RE.search(line)
    if m:
        ids = [x for x in m.group(1).split(",") if x.strip() != ""]
        return max(len(ids), 1)
    return default


def iter_collectives(hlo_text: str, default_group: int = 1):
    """Yields (kind, result_bytes, operand_bytes, group_size, line)."""
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        kind = m.group(1)
        if "-done(" in line:    # async pair: count the -start only
            continue
        shapes = _line_shapes(line)
        if not shapes:
            continue
        result_b = shape_bytes(shapes[0])
        # operands: the shapes after the result
        operand_b = sum(shape_bytes(s) for s in shapes[1:]) or result_b
        g = _group_size(line, default_group)
        yield kind, result_b, operand_b, g, line


def wire_bytes(kind: str, result_b: float, operand_b: float, g: int
               ) -> float:
    """Per-device bytes one collective moves on the wire (ring model)."""
    fac = (g - 1) / g if g > 1 else 0.0
    if kind == "all-gather":
        return fac * result_b
    if kind == "all-reduce":
        return 2.0 * fac * operand_b
    if kind in ("reduce-scatter", "all-to-all"):
        return fac * operand_b
    return float(operand_b)                       # collective-permute


def summarize(items: Iterable[Tuple[str, float, float, int]]
              ) -> Dict[str, Dict[str, float]]:
    """(kind, result_bytes, operand_bytes, group_size) items → per-kind
    totals plus a 'total' row of per-device wire bytes."""
    out: Dict[str, Dict[str, float]] = {
        k: {"count": 0, "operand_bytes": 0.0, "wire_bytes": 0.0}
        for k in COLL_KINDS}
    for kind, res_b, op_b, g in items:
        d = out[kind]
        d["count"] += 1
        d["operand_bytes"] += op_b
        d["wire_bytes"] += wire_bytes(kind, res_b, op_b, g)
    out["total"] = {
        "count": sum(out[k]["count"] for k in COLL_KINDS),
        "operand_bytes": sum(out[k]["operand_bytes"] for k in COLL_KINDS),
        "wire_bytes": sum(out[k]["wire_bytes"] for k in COLL_KINDS),
    }
    return out


def collective_stats(hlo_text: str, default_group: int = 1
                     ) -> Dict[str, Dict[str, float]]:
    """Per-kind totals + 'total' row with per-device wire bytes."""
    return summarize(c[:4] for c in iter_collectives(hlo_text, default_group))
