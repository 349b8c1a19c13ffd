"""Calling context tree (paper §III-C, §IV-A).

A single CCT is kept per Trace, aggregated over both time and processes —
the union of every per-process, per-instant CCT.  Nodes are identified by
(parent node, function name); construction is vectorized per *depth level*
(np.unique over (parent_cct_node, name_code) pairs), never per event.

A copy of :mod:`repro.core.cct` (the port imports nothing of the JAX
package); the tree is built on the host.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .constants import ENTER, ET, INC, NAME, PROC
from .frame import EventFrame


class CCTNode:
    __slots__ = ("nid", "name", "parent", "children", "depth")

    def __init__(self, nid: int, name: str, parent: Optional["CCTNode"], depth: int):
        self.nid = nid
        self.name = name
        self.parent = parent
        self.children: List["CCTNode"] = []
        self.depth = depth

    def path(self) -> List[str]:
        node, out = self, []
        while node is not None and node.nid != 0:
            out.append(node.name)
            node = node.parent
        return out[::-1]

    def __repr__(self) -> str:  # pragma: no cover
        return f"CCTNode({self.nid}, {'->'.join(self.path()) or '<root>'})"


class CCT:
    """Unified calling context tree + per-node aggregate metrics."""

    def __init__(self):
        self.root = CCTNode(0, "<root>", None, -1)
        self.nodes: List[CCTNode] = [self.root]
        # event row -> node id (filled by build); -1 for non-enter rows
        self.event_node: np.ndarray = np.asarray([], np.int64)

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, events: EventFrame, parent: np.ndarray, depth: np.ndarray) -> "CCT":
        """Build the union CCT from per-event parent links.

        ``parent[i]`` is the row index of the enclosing call's Enter (-1 at
        top level); only Enter rows spawn nodes.  Work is O(levels) passes of
        vectorized unique/gather.
        """
        cct = cls()
        n = len(events)
        cct.event_node = np.full(n, -1, np.int64)
        if n == 0:
            return cct
        is_enter = events.cat(ET).mask_eq(ENTER)
        name_codes = events.codes(NAME)
        cats = events.cat(NAME).categories

        maxd = int(depth.max()) if n else 0
        # node id per event, built level by level
        for d in range(maxd + 1):
            rows = np.nonzero(is_enter & (depth == d))[0]
            if len(rows) == 0:
                continue
            if d == 0:
                par_nid = np.zeros(len(rows), np.int64)  # root
            else:
                par_rows = parent[rows]
                ok = par_rows >= 0
                par_nid = np.where(ok, cct.event_node[np.maximum(par_rows, 0)], 0)
            key = par_nid * (len(cats) + 1) + name_codes[rows]
            uniq, inv = np.unique(key, return_inverse=True)
            base = len(cct.nodes)
            for k in uniq:
                pn = int(k) // (len(cats) + 1)
                nc = int(k) % (len(cats) + 1)
                node = CCTNode(len(cct.nodes), str(cats[nc]), cct.nodes[pn], d)
                cct.nodes[pn].children.append(node)
                cct.nodes.append(node)
            cct.event_node[rows] = base + inv
        return cct

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.nodes)

    def aggregate(self, events: EventFrame, metric: str = INC) -> EventFrame:
        """Per-node totals of ``metric`` (summed over time and processes)."""
        vals = np.nan_to_num(np.asarray(events.column(metric), np.float64))
        tot = np.zeros(len(self.nodes))
        sel = self.event_node >= 0
        np.add.at(tot, self.event_node[sel], vals[sel])
        names = np.asarray([" -> ".join(nd.path()) for nd in self.nodes], dtype=object)
        order = np.argsort(-tot, kind="stable")
        order = order[tot[order] > 0]
        return EventFrame({"path": names[order], metric: tot[order],
                           "node": order.astype(np.int64)})

    def per_process(self, events: EventFrame, node_id: int, metric: str = INC
                    ) -> EventFrame:
        """Metric for one call path, broken out by process — the paper's
        'same call path across different processes' discrepancy analysis."""
        sel = np.nonzero(self.event_node == node_id)[0]
        sub = events.take(sel)
        vals = np.nan_to_num(np.asarray(sub.column(metric), np.float64))
        procs = np.asarray(sub[PROC], np.int64)
        npr = int(procs.max()) + 1 if len(procs) else 0
        tot = np.zeros(npr)
        np.add.at(tot, procs, vals)
        return EventFrame({PROC: np.arange(npr, dtype=np.int32), metric: tot})

    def render(self, events: Optional[EventFrame] = None, metric: str = INC,
               max_nodes: int = 40) -> str:
        """ASCII rendering of the tree (depth-first), optionally with metrics."""
        tot = None
        if events is not None and metric in events:
            vals = np.nan_to_num(np.asarray(events.column(metric), np.float64))
            tot = np.zeros(len(self.nodes))
            sel = self.event_node >= 0
            np.add.at(tot, self.event_node[sel], vals[sel])
        lines: List[str] = []

        def rec(node: CCTNode, prefix: str):
            if len(lines) >= max_nodes:
                return
            label = node.name
            if tot is not None and node.nid != 0:
                label += f"  [{tot[node.nid]:.4g}]"
            lines.append(prefix + label)
            for ch in node.children:
                rec(ch, prefix + "  ")

        rec(self.root, "")
        if len(self.nodes) > max_nodes:
            lines.append(f"... ({len(self.nodes)} nodes)")
        return "\n".join(lines)
