"""Application-shaped trace generators (see package docstring).

Every generator takes a ``perturb`` knob: a mapping from function name to a
duration multiplier applied at generation time (``{"computeRhs": 1.5}``
makes every computeRhs call 50% slower, shifting downstream events on the
same timeline consistently).  Generating the same app twice — once without
and once with a perturbation — yields a "before/after" pair whose only
injected difference is known, which is exactly what the TraceDiff subsystem
(:mod:`repro.core.diff`) needs for regression-hunting tests and benchmarks;
:func:`regression_pair` packages that recipe.

Mirrors :mod:`repro.tracegen.apps`: the same events, column for column,
from the same seed; each generator also takes ``device=``, the device of
the port Trace it returns (the card by default).
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np

from ..core.trace import Trace
from .builder import TraceBuilder

__all__ = ["gol", "stencil3d", "amg_vcycle", "kripke_sweep", "tortuga",
           "loimos", "axonn_training", "regression_pair"]

_US = 1_000.0          # 1 microsecond in ns
_MS = 1_000_000.0      # 1 millisecond in ns

Perturb = Optional[Mapping[str, float]]


def _pfac(perturb: Perturb, name: str) -> float:
    """Duration multiplier the perturbation knob assigns to ``name``."""
    return float(perturb.get(name, 1.0)) if perturb else 1.0


def gol(nprocs: int = 4, iters: int = 10, rows_per_proc: int = 512,
        imbalance: float = 0.3, seed: int = 0, perturb: Perturb = None,
        device="cuda") -> Trace:
    """1-D row-decomposed Game of Life: compute + halo exchange with ring
    neighbors. Process 0 gets `imbalance` extra work so it drags the critical
    path through its sends (paper Fig. 10/11 structure)."""
    rng = np.random.default_rng(seed)
    b = TraceBuilder()
    halo_bytes = rows_per_proc * 8.0
    # per-process clocks; blocking semantics enforced by recv-after-send times
    clocks = np.zeros(nprocs)
    for p in range(nprocs):
        b.enter(0.0, "main()", p)
    send_done = np.zeros((iters, nprocs))  # time each proc's send completes
    for it in range(iters):
        b_tag = it
        for p in range(nprocs):
            t = clocks[p]
            work = 200 * _US * (1.0 + (imbalance if p == 0 else 0.0)
                                + 0.05 * rng.standard_normal())
            work *= _pfac(perturb, "compute_cells()")
            t = b.call(t, max(work, _US), "compute_cells()", p)
            nbr = (p + 1) % nprocs
            t = b.send(t, 5 * _US, p, nbr, halo_bytes, tag=b_tag)
            send_done[it, p] = t
            clocks[p] = t
        for p in range(nprocs):
            src = (p - 1) % nprocs
            t0 = clocks[p]
            arrive = send_done[it, src] + 2 * _US  # network latency
            t1 = max(t0, arrive) + 3 * _US
            b.recv(t0, t1 - t0, p, src, halo_bytes, tag=b_tag)
            clocks[p] = t1
    end = clocks.max() + 10 * _US
    for p in range(nprocs):
        b.leave(end if p == 0 else clocks[p] + 5 * _US, "main()", p)
    return b.trace(label=f"gol_{nprocs}", device=device)


def stencil3d(nprocs: int = 32, iters: int = 5, side_bytes: float = 6750.0,
              seed: int = 0, perturb: Perturb = None, device="cuda") -> Trace:
    """3-D near-neighbor exchange on a virtual processor grid — produces the
    banded, symmetric comm matrix of Fig. 3 (Laghos) with three message-size
    clusters (corner/edge/face)."""
    rng = np.random.default_rng(seed)
    # factor nprocs into a 3-d grid
    dims = _balanced_dims(nprocs, 3)
    coords = np.array(np.unravel_index(np.arange(nprocs), dims)).T
    b = TraceBuilder()
    clocks = np.zeros(nprocs)
    for p in range(nprocs):
        b.enter(0.0, "main()", p)
    for it in range(iters):
        for p in range(nprocs):
            t = clocks[p]
            t = b.call(t, (300 + 30 * rng.standard_normal()) * _US
                       * _pfac(perturb, "kernel_update()"),
                       "kernel_update()", p)
            c = coords[p]
            for axis in range(3):
                for d in (-1, 1):
                    nc = c.copy()
                    nc[axis] += d
                    if (nc < 0).any() or (nc >= np.array(dims)).any():
                        continue
                    q = int(np.ravel_multi_index(nc, dims))
                    nbytes = side_bytes * 2 if axis == 0 else (
                        side_bytes if axis == 1 else side_bytes / 5.0)
                    t = b.send(t, 4 * _US, p, q, nbytes, tag=it)
                    t = b.recv(t, 6 * _US, p, q, nbytes, tag=it)
            clocks[p] = t
    for p in range(nprocs):
        b.leave(clocks[p] + 5 * _US, "main()", p)
    return b.trace(label=f"stencil3d_{nprocs}", device=device)


def amg_vcycle(nprocs: int = 16, iters: int = 4, levels: int = 4,
               fine_bytes: float = 13500.0, seed: int = 0,
               perturb: Perturb = None, device="cuda") -> Trace:
    """Algebraic-multigrid V-cycle: per level, smooth + neighbor exchange with
    message sizes shrinking 4× per level, plus an all-reduce (norm check) at
    the coarsest level (AMG trace structure of Fig. 5)."""
    rng = np.random.default_rng(seed)
    b = TraceBuilder()
    clocks = np.zeros(nprocs)
    for p in range(nprocs):
        b.enter(0.0, "main()", p)
    for it in range(iters):
        for direction, levs in (("down", range(levels)),
                                ("up", range(levels - 2, -1, -1))):
            for lev in levs:
                sz = fine_bytes / (4.0 ** lev)
                for p in range(nprocs):
                    t = clocks[p]
                    t = b.call(t, (120 / (2.0 ** lev)
                                   + 8 * rng.standard_normal()) * _US
                               * _pfac(perturb, f"smooth_l{lev}()"),
                               f"smooth_l{lev}()", p)
                    for q in (p - 1, p + 1):
                        if 0 <= q < nprocs:
                            t = b.send(t, 3 * _US, p, q, sz, tag=lev)
                            t = b.recv(t, 4 * _US, p, q, sz, tag=lev)
                    clocks[p] = t
        # coarse-level all-reduce: model as send to 0 + broadcast back
        tmax = clocks.max()
        for p in range(nprocs):
            t = max(clocks[p], tmax)
            t = b.call(t, 15 * _US * _pfac(perturb, "MPI_Allreduce"),
                       "MPI_Allreduce", p)
            clocks[p] = t
    for p in range(nprocs):
        b.leave(clocks[p] + 5 * _US, "main()", p)
    return b.trace(label=f"amg_{nprocs}", device=device)


def kripke_sweep(nprocs: int = 16, iters: int = 3, cell_bytes: float = 4096.0,
                 seed: int = 0, perturb: Perturb = None,
                 device="cuda") -> Trace:
    """Wavefront sweep: proc p's work in each sweep depends on p-1's send —
    a long dependency chain that dominates the critical path (Kripke)."""
    rng = np.random.default_rng(seed)
    b = TraceBuilder()
    clocks = np.zeros(nprocs)
    for p in range(nprocs):
        b.enter(0.0, "main()", p)
    for it in range(iters):
        # downward sweep 0→n-1 then upward n-1→0
        for order in (range(nprocs), range(nprocs - 1, -1, -1)):
            order = list(order)
            upstream_done = 0.0
            for i, p in enumerate(order):
                t = clocks[p]
                if i > 0:
                    src = order[i - 1]
                    t0 = t
                    t = max(t, upstream_done + 2 * _US) + 4 * _US
                    b.recv(t0, t - t0, p, src, cell_bytes, tag=it)
                t = b.call(t, (150 + 10 * rng.standard_normal()) * _US
                           * _pfac(perturb, "sweep_cells()"),
                           "sweep_cells()", p)
                if i < len(order) - 1:
                    t = b.send(t, 3 * _US, p, order[i + 1], cell_bytes, tag=it)
                    upstream_done = t
                clocks[p] = t
    for p in range(nprocs):
        b.leave(clocks[p] + 5 * _US, "main()", p)
    return b.trace(label=f"kripke_{nprocs}", device=device)


def tortuga(nprocs: int = 16, iters: int = 6, scaling_knee: int = 32,
            seed: int = 0, perturb: Perturb = None, device="cuda") -> Trace:
    """CFD iteration with the Fig. 12 function mix.  Past ``scaling_knee``
    processes, per-process work stops shrinking (surface-to-volume effect), so
    total time across the multirun study rises — reproducing the paper's
    'computeRhs/gradC2C scale poorly' finding.  Every iteration is wrapped in
    a ``time-loop`` marker for pattern detection (Fig. 8)."""
    rng = np.random.default_rng(seed)
    b = TraceBuilder()
    # per-process work: ideal scaling up to the knee, then saturates
    eff = min(nprocs, scaling_knee)
    base = 4000.0 / eff * _US          # computeRhs per-proc cost
    ghost_bytes = 6750.0 * (1.0 + nprocs / 64.0)
    clocks = np.zeros(nprocs)
    for p in range(nprocs):
        b.enter(0.0, "main()", p)
    for it in range(iters):
        tl_start = clocks.copy()
        for p in range(nprocs):
            b.enter(clocks[p], "time-loop", p)
        send_done = np.zeros(nprocs)
        for p in range(nprocs):
            t = clocks[p]
            t = b.call(t, base * (1 + 0.04 * rng.standard_normal())
                       * _pfac(perturb, "computeRhs"), "computeRhs", p)
            t = b.call(t, base * 0.22 * (1 + 0.05 * rng.standard_normal())
                       * _pfac(perturb, "gradC2C"), "gradC2C", p)
            t = b.call(t, base * 0.06
                       * _pfac(perturb, "setGhostCvsInterfaces"),
                       "setGhostCvsInterfaces", p)
            for q in (p - 1, p + 1):
                if 0 <= q < nprocs:
                    t = b.send(t, 3 * _US, p, q, ghost_bytes, tag=it,
                               name="MPI_Isend")
            send_done[p] = t
            clocks[p] = t
        for p in range(nprocs):
            t = clocks[p]
            nbrs = [q for q in (p - 1, p + 1) if 0 <= q < nprocs]
            arrive = max(send_done[q] for q in nbrs) + 2 * _US
            t_wait_end = max(t, arrive) + 2 * _US
            b.enter(t, "MPI_Wait", p)
            for q in nbrs:
                b.event(t + _US, "MpiRecv", "MpiRecv", p, partner=q,
                        size=ghost_bytes, tag=it)
            b.leave(t_wait_end, "MPI_Wait", p)
            t = b.call(t_wait_end, base * 0.065
                       * _pfac(perturb, "endGhostCvsInterfaces"),
                       "endGhostCvsInterfaces", p)
            b.leave(t, "time-loop", p)
            clocks[p] = t
    for p in range(nprocs):
        b.leave(clocks[p] + 5 * _US, "main()", p)
    return b.trace(label=f"tortuga_{nprocs}", device=device)


def loimos(nprocs: int = 128, iters: int = 4, seed: int = 0,
           hot_procs=(21, 22, 23, 24, 29), perturb: Perturb = None,
           device="cuda") -> Trace:
    """Actor-style epidemic simulation: ComputeInteractions / SendVisitMessages
    / ReceiveVisitMessages with a hot subset of processes carrying 2-3× load
    (Fig. 7 structure), plus explicit Idle spans."""
    rng = np.random.default_rng(seed)
    hot = set(q for q in hot_procs if q < nprocs)
    b = TraceBuilder()
    clocks = np.zeros(nprocs)
    for p in range(nprocs):
        b.enter(0.0, "main()", p)
    for it in range(iters):
        for p in range(nprocs):
            t = clocks[p]
            boost = 2.2 if p in hot else 1.0
            t = b.call(t, 90 * boost * (1 + .1 * rng.standard_normal()) * _US
                       * _pfac(perturb, "ComputeInteractions()"),
                       "ComputeInteractions()", p)
            dst = int(rng.integers(0, nprocs))
            b.enter(t, "SendVisitMessages()", p)
            b.event(t + 2 * _US, "MpiSend", "MpiSend", p, partner=dst,
                    size=float(rng.integers(256, 4096)), tag=it)
            t += 60 * boost * 0.8 * _US * _pfac(perturb, "SendVisitMessages()")
            b.leave(t, "SendVisitMessages()", p)
            t = b.call(t, 70 * boost * (1 + .1 * rng.standard_normal()) * _US
                       * _pfac(perturb, "ReceiveVisitMessages(const VisitMessage &impl_noname_1)"),
                       "ReceiveVisitMessages(const VisitMessage &impl_noname_1)", p)
            # under-loaded procs idle while hot procs finish
            idle = (180.0 * (2.2 - boost) + 20 * abs(rng.standard_normal())) * _US
            t = b.call(t, idle * _pfac(perturb, "Idle"), "Idle", p)
            clocks[p] = t
    for p in range(nprocs):
        b.leave(clocks[p] + 5 * _US, "main()", p)
    return b.trace(label=f"loimos_{nprocs}", device=device)


def axonn_training(nprocs: int = 8, iters: int = 8, version: int = 0,
                   seed: int = 0, perturb: Perturb = None,
                   device="cuda") -> Trace:
    """Data/tensor-parallel training iterations at three optimization levels
    (Fig. 13):

    * v0 — big blocking all-reduce after backward (no overlap, extra transpose
      comm),
    * v1 — transposed layouts remove half the communication volume,
    * v2 — remaining all-reduce bucketed and overlapped with backward compute
      on a second stream (thread 1).
    """
    rng = np.random.default_rng(seed)
    b = TraceBuilder(with_threads=True)
    comm_scale = {0: 1.0, 1: 0.45, 2: 0.45}[version]
    overlap = version == 2
    clocks = np.zeros(nprocs)
    for p in range(nprocs):
        b.enter(0.0, "train()", p, 0)
    grad_bytes = 25e6 * comm_scale
    for it in range(iters):
        for p in range(nprocs):
            t = clocks[p]
            t = b.call(t, (900 + 25 * rng.standard_normal()) * _US
                       * _pfac(perturb, "forward"), "forward", p, 0)
            bwd = (1800 + 40 * rng.standard_normal()) * _US \
                * _pfac(perturb, "backward")
            if overlap:
                # backward on stream 0; bucketed all-reduce on stream 1
                b.enter(t, "backward", p, 0)
                tb = t
                n_buckets = 4
                for k in range(n_buckets):
                    tc = t + bwd * (k + 0.5) / n_buckets
                    dst = (p + 1) % nprocs
                    b.enter(tc, "ncclAllReduce", p, 1)
                    b.event(tc + 2 * _US, "MpiSend", "MpiSend", p, 1,
                            partner=dst, size=grad_bytes / n_buckets, tag=k)
                    b.event(tc + 3 * _US, "MpiRecv", "MpiRecv", p, 1,
                            partner=(p - 1) % nprocs, size=grad_bytes / n_buckets,
                            tag=k)
                    b.leave(tc + bwd / n_buckets * 0.7, "ncclAllReduce", p, 1)
                t = tb + bwd
                b.leave(t, "backward", p, 0)
                t = b.call(t, (250 + comm_scale * 120) * _US, "ncclAllReduce", p, 0)
            else:
                t = b.call(t, bwd, "backward", p, 0)
                dur = (900 * comm_scale + 420) * _US
                dst = (p + 1) % nprocs
                b.enter(t, "ncclAllReduce", p, 0)
                b.event(t + 3 * _US, "MpiSend", "MpiSend", p, 0, partner=dst,
                        size=grad_bytes, tag=it)
                b.event(t + 5 * _US, "MpiRecv", "MpiRecv", p, 0,
                        partner=(p - 1) % nprocs, size=grad_bytes, tag=it)
                b.leave(t + dur, "ncclAllReduce", p, 0)
                t += dur
            t = b.call(t, 120 * _US * _pfac(perturb, "optimizer_step"),
                       "optimizer_step", p, 0)
            clocks[p] = t
    for p in range(nprocs):
        b.leave(clocks[p] + 5 * _US, "train()", p, 0)
    return b.trace(label=f"axonn_v{version}_{nprocs}", device=device)


_APPS = {
    "gol": gol, "stencil3d": stencil3d, "amg_vcycle": amg_vcycle,
    "kripke_sweep": kripke_sweep, "tortuga": tortuga, "loimos": loimos,
    "axonn_training": axonn_training,
}


def regression_pair(app: str = "tortuga", func: str = "computeRhs",
                    factor: float = 1.5, seed: int = 0,
                    **kw) -> Tuple[Trace, Trace]:
    """A "before/after" trace pair with one *known* injected regression.

    Generates ``app`` twice with the same seed — identical except that in
    the "after" run every call of ``func`` is slowed by ``factor`` (the
    ``perturb`` knob), so downstream timestamps shift consistently while
    every other function's own durations stay bit-identical.  The pair is
    the ground truth the TraceDiff subsystem's ``regression_report`` is
    tested and benchmarked against: its top-ranked function must be
    ``func``.

    Args:
        app: generator name (one of gol, stencil3d, amg_vcycle,
            kripke_sweep, tortuga, loimos, axonn_training).
        func: exact event name to slow down (as emitted by the generator,
            e.g. ``"compute_cells()"`` for gol).
        factor: duration multiplier for the "after" run (> 1 = regression,
            < 1 = improvement).
        **kw: forwarded to the generator (nprocs, iters, ...).

    Returns:
        ``(before, after)`` traces labeled ``<app>-before`` / ``<app>-after``.
    """
    try:
        gen = _APPS[app]
    except KeyError:
        raise ValueError(f"unknown app {app!r}; one of {sorted(_APPS)}") \
            from None
    before = gen(seed=seed, **kw)
    after = gen(seed=seed, perturb={func: factor}, **kw)
    before.label = f"{app}-before"
    after.label = f"{app}-after"
    return before, after


def _balanced_dims(n: int, k: int):
    """Factor n into k near-equal dims (largest first)."""
    dims = [1] * k
    rem = n
    for i in range(k):
        d = int(round(rem ** (1.0 / (k - i))))
        while d > 1 and rem % d:
            d -= 1
        dims[i] = max(d, 1)
        rem //= dims[i]
    dims[0] *= rem
    return tuple(sorted(dims, reverse=True))
