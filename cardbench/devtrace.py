"""The device trace of a traced run: ``torch.profiler`` (CPU and CUDA
activity) over a stretch of the window, read into plain tables that the
metric readers and the breakdown take.

A :class:`Table` holds the device's activities (kernels, copies, sets) as
(name, start, end) in seconds on the profiler's clock, the host's
top-level operators the same way with their thread.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

Span = Tuple[str, float, float]
HostSpan = Tuple[str, float, float, int]


@dataclasses.dataclass
class Table:
    device: List[Span]          # every device activity, by start
    host: List[HostSpan]        # top-level host operators and their thread
    wall_s: float               # the stretch's length on the host clock

    def kernels(self) -> List[Span]:
        """The kernels (no copies or sets)."""
        return [k for k in self.device if is_kernel(k[0])]

    def busy_s(self) -> float:
        """Seconds in which some device activity ran (their union)."""
        return sum(e - s for s, e in merged(self.device))


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def merged(spans: List[Span]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for _, s, e in sorted(spans, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Capture:
    """``start()`` begins profiling and ``stop()`` ends it; ``finish()``,
    called once the measured window has closed, reads the stretch into
    its :class:`Table` (reading a long profile takes seconds)."""

    def __init__(self):
        self.table: Optional[Table] = None
        self.stopped = False
        self._prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self._wall = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        self.stopped = True

    def finish(self) -> Optional[Table]:
        if self.stopped and self.table is None:
            self.table = read(self._prof, self._wall)
            self._prof = None
        return self.table


def read(prof, wall_s: float) -> Table:
    """A finished profile's raw events as a :class:`Table`: a host event
    is top-level when no earlier event of its thread still runs at its
    start."""
    from torch.autograd import DeviceType
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    device, cpu = [], []
    for e in res.events():
        s = (e.start_ns() - t0) * 1e-9
        t = s + e.duration_ns() * 1e-9
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            device.append((name, s, t))
        else:
            cpu.append((s, -t, name, e.start_thread_id()))
    cpu.sort()
    host, end = [], {}
    for s, neg_t, name, th in cpu:
        if s >= end.get(th, -np.inf):
            host.append((name, s, -neg_t, th))
            end[th] = -neg_t
    device.sort(key=lambda x: x[1])
    return Table(device, host, wall_s)


def top_device_ops(table: Table, n: int = 10) -> List[List]:
    """The device operations that took the most time: [[name, seconds]]."""
    by: Dict[str, float] = {}
    for name, s, e in table.device:
        by[name] = by.get(name, 0.0) + (e - s)
    return [[k[:160], v] for k, v in
            sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(table: Table, n: int = 10) -> List[List]:
    """The device's idle gaps between activities, summed by the host
    operator that was running at each gap's middle (the latest begun, of
    any thread; "python" where none was): [[name, seconds]], the longest
    first.  A thread's top-level operators do not overlap, so the one
    that began last before the middle is the only candidate."""
    busy = merged(table.device)
    threads = {}
    for h in table.host:
        threads.setdefault(h[3], []).append(h)
    index = [(np.array([h[1] for h in hs]), hs) for hs in threads.values()]
    by: Dict[str, float] = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        gap = s1 - e0
        if gap <= 0:
            continue
        mid = 0.5 * (e0 + s1)
        name, since = "python", -np.inf
        for starts, hs in index:
            i = int(np.searchsorted(starts, mid, side="right")) - 1
            if i >= 0 and hs[i][2] >= mid and hs[i][1] > since:
                name, since = hs[i][0], hs[i][1]
        by[name] = by.get(name, 0.0) + gap
    return [[k[:160], v] for k, v in
            sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def breakdown(table: Table) -> dict:
    return {"device_ops": top_device_ops(table),
            "idle_gaps": idle_gaps(table)}
