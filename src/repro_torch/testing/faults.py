"""Fault injection for trace I/O robustness testing.

Mirrors :mod:`repro.testing.faults`: the same injectors, which damage the
same bytes on the same seed.  Two layers of deterministic, closed-loop
injectors:

**File-level** — damage a *copy* of a trace file in a precisely known
way, so tests can assert the reader's contract (strict = loud failure
naming the file and locus; salvage/skip = survivors intact, losses
counted) against ground truth:

* :func:`truncate_at` — cut the file at a byte offset or fraction
  (simulates a crash mid-write or a short download);
* :func:`bit_flip` — flip bits at seeded-random or explicit offsets
  (simulates silent media corruption; trips pack CRCs);
* :func:`garbage_append` — append seeded-random bytes (simulates a torn
  append or concatenated partial write);
* :func:`torn_footer` — pack-specific: sever the footer mid-blob, the
  exact shape a SIGKILL during footer write leaves behind.

**Service-level** — inject transport and open failures around the
trace-query service:

* :class:`FaultProxy` — a byte-pumping TCP proxy between client and
  server with programmable connection resets (including *mid-response*)
  and fixed delays, with counters for closed-loop assertions;
* :func:`flaky_opens` — make the service's handle opens fail a chosen
  number of times (drives the circuit breaker without corrupt files).

Everything here is stdlib-only and deterministic (seeded RNG, counted
faults) — injectors never touch the original file and never depend on
timing to decide *whether* a fault fires.
"""

from __future__ import annotations

import contextlib
import os
import random
import shutil
import socket
import struct
import threading
import time
from typing import Iterator, Optional

__all__ = ["truncate_at", "bit_flip", "garbage_append", "torn_footer",
           "FaultProxy", "flaky_opens"]


# ---------------------------------------------------------------------------
# file-level injectors
# ---------------------------------------------------------------------------

def _copy(src: str, dst: str) -> int:
    src, dst = os.fspath(src), os.fspath(dst)
    if os.path.abspath(src) != os.path.abspath(dst):
        shutil.copyfile(src, dst)  # src == dst damages in place
    return os.path.getsize(dst)


def truncate_at(src: str, dst: str, *, offset: Optional[int] = None,
                frac: Optional[float] = None) -> dict:
    """Copy ``src`` to ``dst`` truncated at ``offset`` bytes (or at
    ``frac`` of the original size).  ``frac=0.0`` produces an empty file,
    ``frac=0.99`` a file missing its tail — both are distinct reader
    pathologies.  Returns ``{"size", "cut_at", "lost"}``."""
    size = _copy(src, dst)
    if offset is None:
        if frac is None:
            raise ValueError("truncate_at needs offset= or frac=")
        offset = int(size * float(frac))
    offset = max(0, min(int(offset), size))
    with open(dst, "r+b") as f:
        f.truncate(offset)
    return {"size": size, "cut_at": offset, "lost": size - offset}


def bit_flip(src: str, dst: str, *, offsets: Optional[list] = None,
             frac: float = 0.5, count: int = 1, seed: int = 0) -> dict:
    """Copy ``src`` to ``dst`` with ``count`` single-bit flips.  Explicit
    ``offsets`` pin the damage; otherwise offsets are drawn from a seeded
    RNG centred on ``frac`` of the file (body damage by default — pass
    ``frac`` near 1.0 to hit index/footer regions).  Returns the exact
    flipped offsets so tests can assert which chunk/record was hit."""
    size = _copy(src, dst)
    if size == 0:
        raise ValueError(f"{src}: cannot bit-flip an empty file")
    rng = random.Random(seed)
    if offsets is None:
        lo = int(size * max(0.0, float(frac) - 0.25))
        hi = max(lo + 1, int(size * min(1.0, float(frac) + 0.25)))
        offsets = [rng.randrange(lo, min(hi, size)) for _ in range(count)]
    offsets = [int(o) % size for o in offsets]
    with open(dst, "r+b") as f:
        for off in offsets:
            f.seek(off)
            b = f.read(1)[0]
            f.seek(off)
            f.write(bytes([b ^ (1 << rng.randrange(8))]))
    return {"size": size, "offsets": sorted(offsets)}


def garbage_append(src: str, dst: str, *, nbytes: int = 256,
                   seed: int = 0) -> dict:
    """Copy ``src`` to ``dst`` and append ``nbytes`` of seeded-random
    garbage — a torn concurrent append / partially-flushed next record."""
    size = _copy(src, dst)
    rng = random.Random(seed)
    with open(dst, "ab") as f:
        f.write(bytes(rng.randrange(256) for _ in range(int(nbytes))))
    return {"size": size, "appended": int(nbytes)}


def torn_footer(src: str, dst: str, *, keep_frac: float = 0.5) -> dict:
    """Copy a **pack** to ``dst`` with its footer torn: the trailing
    ``(blob, <Q length>, tail magic)`` triplet is cut mid-blob (keeping
    ``keep_frac`` of it), exactly what a SIGKILL between the last chunk
    group and a completed footer write leaves on disk.  Falls back to
    chopping the final 25% of a non-pack file.  The chunk groups remain
    intact, so salvage must recover every row."""
    size = _copy(src, dst)
    cut = None
    if size >= 16:
        with open(dst, "rb") as f:
            f.seek(size - 16)
            flen = struct.unpack("<Q", f.read(8))[0]
            tail = f.read(8)
        if tail == b"PIPITPK\x00" and flen <= size - 16:
            foot_start = size - 16 - flen
            cut = foot_start + int(flen * float(keep_frac))
    if cut is None:
        cut = int(size * 0.75)
    with open(dst, "r+b") as f:
        f.truncate(cut)
    return {"size": size, "cut_at": cut, "lost": size - cut}


# ---------------------------------------------------------------------------
# service-level injectors
# ---------------------------------------------------------------------------

class FaultProxy:
    """A TCP proxy that injects transport faults between a client and the
    trace-query server.

    Faults are decided per *HTTP request* (request starts are recognized
    in the client byte stream, so keep-alive connections carrying many
    requests are faulted correctly), counted from 1 across the proxy's
    lifetime:

    * ``reset_every=k`` — every k-th request is answered with a hard
      connection reset (``SO_LINGER`` 0 → RST) instead of a response;
    * ``reset_after_bytes=n`` — a doomed request additionally forwards
      the first ``n`` bytes of the server's real response before the
      reset: the *mid-response* reset a retrying client must survive
      (the server **did** execute the request).  ``n=0`` (default)
      resets before the request even reaches the server — a pure
      transport fault;
    * ``delay=s`` — sleep ``s`` seconds before pumping each response
      batch (drives client/service deadline paths without slow ops).

    ``stats`` counts ``connections``, ``requests`` and ``resets`` so
    tests close the loop on exactly how many faults fired.
    Deterministic: whether a request is faulted depends only on its
    sequence number.
    """

    _METHODS = (b"GET ", b"POST", b"PUT ", b"HEAD", b"DELE", b"PATC",
                b"OPTI")

    def __init__(self, upstream_host: str, upstream_port: int, *,
                 reset_every: int = 0, reset_after_bytes: int = 0,
                 delay: float = 0.0):
        self.upstream = (upstream_host, int(upstream_port))
        self.reset_every = int(reset_every)
        self.reset_after_bytes = int(reset_after_bytes)
        self.delay = float(delay)
        self.stats = {"connections": 0, "requests": 0, "resets": 0}
        self._count_lock = threading.Lock()
        self._srv: Optional[socket.socket] = None
        self._threads: list = []
        self._stop = threading.Event()
        self.port: Optional[int] = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> int:
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(32)
        self._srv.settimeout(0.2)
        self.port = self._srv.getsockname()[1]
        t = threading.Thread(target=self._accept_loop,
                             name="faultproxy-accept", daemon=True)
        t.start()
        self._threads.append(t)
        return self.port

    def stop(self) -> None:
        self._stop.set()
        if self._srv is not None:
            with contextlib.suppress(OSError):
                self._srv.close()
        for t in self._threads:
            t.join(timeout=2.0)

    def __enter__(self) -> "FaultProxy":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- internals --------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                cli, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            self.stats["connections"] += 1
            idx = self.stats["connections"]
            t = threading.Thread(target=self._serve, args=(cli,),
                                 name=f"faultproxy-conn-{idx}", daemon=True)
            t.start()
            self._threads.append(t)

    @staticmethod
    def _abort(sock: socket.socket) -> None:
        """Hard-abort: RST instead of FIN, so the peer sees a genuine
        connection reset rather than a clean close."""
        with contextlib.suppress(OSError):
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                            struct.pack("ii", 1, 0))
        # a sibling pump thread may be blocked in recv() on this socket;
        # close() alone would defer teardown (the syscall pins the fd) and
        # the RST would never be sent — SHUT_RD wakes it first
        with contextlib.suppress(OSError):
            sock.shutdown(socket.SHUT_RD)
        with contextlib.suppress(OSError):
            sock.close()

    def _next_request_doomed(self) -> bool:
        with self._count_lock:
            self.stats["requests"] += 1
            n = self.stats["requests"]
        return bool(self.reset_every) and n % self.reset_every == 0

    def _serve(self, cli: socket.socket) -> None:
        try:
            up = socket.create_connection(self.upstream, timeout=10.0)
        except OSError:
            self._abort(cli)
            return
        # response-byte budget for the currently-doomed request; None when
        # the in-flight request is healthy.  Keep-alive requests are
        # sequential, so one slot per connection is enough.
        budget = [None]

        def reset():
            self.stats["resets"] += 1
            self._abort(cli)
            self._abort(up)

        def pump_requests():
            try:
                while not self._stop.is_set():
                    data = cli.recv(65536)
                    if not data:
                        break
                    if data[:4] in self._METHODS:
                        if self._next_request_doomed():
                            if self.reset_after_bytes <= 0:
                                # pure transport fault: the server never
                                # sees the request
                                reset()
                                return
                            budget[0] = self.reset_after_bytes
                        else:
                            budget[0] = None
                    up.sendall(data)
            except OSError:
                pass
            finally:
                with contextlib.suppress(OSError):
                    up.shutdown(socket.SHUT_WR)

        def pump_responses():
            try:
                while not self._stop.is_set():
                    data = up.recv(65536)
                    if not data:
                        break
                    if self.delay:
                        time.sleep(self.delay)
                    if budget[0] is not None:
                        cli.sendall(data[:max(budget[0], 0)])
                        budget[0] -= len(data)
                        if budget[0] <= 0:
                            # mid-response reset: part of the real
                            # response escaped, the rest never will
                            reset()
                            return
                    else:
                        cli.sendall(data)
            except OSError:
                pass
            finally:
                with contextlib.suppress(OSError):
                    cli.shutdown(socket.SHUT_WR)

        tr = threading.Thread(target=pump_requests, daemon=True)
        tr.start()
        pump_responses()
        tr.join(timeout=5.0)
        for s in (cli, up):
            with contextlib.suppress(OSError):
                s.close()


@contextlib.contextmanager
def flaky_opens(times: int, exc: Optional[Exception] = None
                ) -> Iterator[dict]:
    """Make :class:`~repro_torch.serving.tracequery.HandlePool` opens fail
    the first ``times`` calls with ``exc`` (default ``OSError``), then
    behave normally — a deterministic way to drive circuit-breaker tests
    that does not require an actually-corrupt file.  Yields a counter dict
    (``{"calls", "failed"}``); restores the original open on exit."""
    from ..serving.tracequery import HandlePool
    counter = {"calls": 0, "failed": 0}
    orig = HandlePool._open

    def _failing(self, spec):
        counter["calls"] += 1
        if counter["failed"] < times:
            counter["failed"] += 1
            raise (exc if exc is not None
                   else OSError("injected open failure"))
        return orig(self, spec)

    HandlePool._open = _failing
    try:
        yield counter
    finally:
        HandlePool._open = orig
