"""Convert traces of any registered format to pipitpack (convert once,
analyze fast), and check or repair packs.

Mirrors the reference's pack tool (``tools/pack.py``) on the port's
readers.  Each input (file, OTF2-style archive directory, or ``rank_*``
shard) is converted on its own to ``<stem>.pack``: per-shard packs keep
the per-location layout the parallel reader uses.  Conversion streams
chunk by chunk (bounded memory); the structure sidecar (default on) lets
a reopen skip ``derive_structure``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.pack TRACE [TRACE ...]
        [-o OUT]            # output file (one input) or directory
        [--format auto]     # source format (default: sniff)
        [--chunk-rows N]    # footer index granularity (default 250k)
        [--no-sidecar]      # skip the structure sidecar
        [--verify]          # reopen and compare a flat-profile digest
        [--device cuda]     # where the digest's flat_profile runs

Maintenance modes (inputs that are already packs)::

    PYTHONPATH=src python -m repro_torch.launch.pack --verify run.pack
        # integrity report: per-chunk CRC verdicts + sidecar checksum
    PYTHONPATH=src python -m repro_torch.launch.pack --repair bad.pack \\
        [-o fixed.pack]
        # salvage-open (footer loss and CRC-failing chunk groups are
        # tolerated) and rewrite a fresh, fully-checksummed pack
    PYTHONPATH=src python -m repro_torch.launch.pack --watermark rank_0.pack
        # committed-prefix watermark of a live (append-mode) shard, with
        # the heartbeat record if the writing rank left one

``--verify`` on packs exits non-zero if any pack fails its CRCs;
``--repair`` exits non-zero only when a pack yields no rows at all.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from typing import Optional


def _out_path(inp: str, out: Optional[str], many: bool) -> str:
    stem = os.path.basename(inp.rstrip(os.sep))
    for ext in (".jsonl", ".json", ".csv", ".otf2"):
        if stem.lower().endswith(ext):
            stem = stem[: -len(ext)]
            break
    if out is None:
        return os.path.join(os.path.dirname(inp) or ".", stem + ".pack")
    if many or os.path.isdir(out):
        os.makedirs(out, exist_ok=True)
        return os.path.join(out, stem + ".pack")
    return out


def _digest(handle, device) -> str:
    import numpy as np
    prof = handle.flat_profile(device=device)
    h = hashlib.sha256()
    h.update("\x00".join(map(str, prof["Name"])).encode())
    h.update(np.ascontiguousarray(
        np.asarray(prof["time.exc"], np.float64)).tobytes())
    return h.hexdigest()


def _digest_source(inp: str, fmt: str, device) -> str:
    """Digest of the source with the pack's storage quantization applied:
    packs store integer-ns timestamps (truncation, as the text writers
    do), so a float-ns source (an HLO model's timeline) is compared after
    that truncation."""
    import numpy as np

    from ..core.constants import TS
    from ..core.trace import Trace
    t = Trace.open(inp, format=fmt, streaming=True, cache=False,
                   device=device).materialize()
    ev = t.events
    ev[TS] = np.asarray(ev[TS], np.int64)
    return _digest(Trace(ev, device=device), device)


def _is_pack(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(11) == b"#pipitpack "
    except OSError:
        return False


def _verify_mode(inputs: list) -> int:
    """Integrity report: every input is already a pack."""
    from ..readers.pack import verify_pack
    failures = 0
    for inp in inputs:
        try:
            rep = verify_pack(inp)
        except (OSError, ValueError) as e:
            print(f"{inp}: UNREADABLE ({e}) — try --repair")
            failures += 1
            continue
        bad = rep["chunks_bad"]
        side = {None: "n/a", True: "ok", False: "CORRUPT"}[rep["sidecar_ok"]]
        verdict = "OK" if rep["ok"] else "DAMAGED"
        print(f"{inp}: {verdict}  v{rep['version']}, {rep['rows']} rows, "
              f"{rep['chunks_total']} chunk group(s), {len(bad)} bad, "
              f"sidecar {side}")
        for b in bad:
            print(f"  bad group #{b['index']}: rows "
                  f"[{b['rows'][0]}, {b['rows'][1]}) at byte {b['offset']}")
        if rep.get("note"):
            print(f"  note: {rep['note']}")
        failures += 0 if rep["ok"] else 1
    return 1 if failures else 0


def _repair_mode(inputs: list, out: Optional[str]) -> int:
    from ..readers.pack import repair_pack
    many = len(inputs) > 1
    failures = 0
    for inp in inputs:
        if out is None:
            dst = (inp[:-5] if inp.endswith(".pack") else inp) \
                + ".repaired.pack"
        elif many or os.path.isdir(out):
            os.makedirs(out, exist_ok=True)
            dst = os.path.join(out, os.path.basename(inp))
        else:
            dst = out
        rep = repair_pack(inp, dst)
        print(f"{inp} -> {dst}  ({rep['rows_recovered']} rows recovered, "
              f"{rep['chunks_quarantined']} chunk group(s) quarantined"
              f"{', footer rebuilt' if rep['footer_rebuilt'] else ''})")
        if rep["rows_recovered"] == 0:
            print("  NOTHING SALVAGEABLE")
            failures += 1
    return 1 if failures else 0


def _watermark_mode(inputs: list) -> int:
    """Committed-prefix report of live append-mode shards (of a finalized
    pack, the watermark is the whole file)."""
    from ..readers.pack import committed_prefix
    from ..runtime.tracer import read_heartbeat
    failures = 0
    for inp in inputs:
        try:
            snap = committed_prefix(inp)
        except (OSError, ValueError) as e:
            print(f"{inp}: UNREADABLE ({e})")
            failures += 1
            continue
        out = dict(snap["watermark"], path=inp)
        hb = read_heartbeat(inp)
        if hb is not None:
            age = time.time() - hb["wall"] if hb.get("wall") else None
            out["heartbeat"] = dict(
                hb, age_s=round(age, 3) if age is not None else None)
        print(json.dumps(out))
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("inputs", nargs="+", help="trace files / archives")
    ap.add_argument("-o", "--out", help="output .pack file (one input) "
                    "or directory (several)")
    ap.add_argument("--format", default="auto",
                    help="source format (default: sniff per input)")
    ap.add_argument("--chunk-rows", type=int, default=None,
                    help="rows per footer-index chunk (default 250000)")
    ap.add_argument("--no-sidecar", action="store_true",
                    help="do not store the structure sidecar")
    ap.add_argument("--verify", action="store_true",
                    help="converting: reopen each pack and check the "
                    "flat-profile digest against the source; on inputs "
                    "that are already packs: full CRC integrity report")
    ap.add_argument("--repair", action="store_true",
                    help="salvage a damaged pack and rewrite it as a "
                    "fresh, fully-checksummed pack (default output: "
                    "<stem>.repaired.pack)")
    ap.add_argument("--watermark", action="store_true",
                    help="print each shard's committed-prefix watermark "
                    "(+ heartbeat, if any) as one JSON line")
    ap.add_argument("--device", default="cuda",
                    help='where the digest check\'s flat_profile runs: '
                    '"cuda" (default) or "cpu"')
    args = ap.parse_args(argv)

    if args.watermark:
        return _watermark_mode(args.inputs)
    if args.repair:
        return _repair_mode(args.inputs, args.out)
    if args.verify and all(_is_pack(i) for i in args.inputs):
        return _verify_mode(args.inputs)

    from ..core.trace import Trace

    many = len(args.inputs) > 1
    failures = 0
    for inp in args.inputs:
        dst = _out_path(inp, args.out, many)
        t0 = time.time()
        src = Trace.open(inp, format=args.format, streaming=True,
                         cache=False, device=args.device)
        src.save_pack(dst, chunk_rows=args.chunk_rows,
                      sidecar=not args.no_sidecar)
        dt = time.time() - t0
        src_b = sum(
            os.path.getsize(os.path.join(r, f))
            for r, _d, fs in os.walk(inp) for f in fs
        ) if os.path.isdir(inp) else os.path.getsize(inp)
        print(f"{inp} -> {dst}  ({src_b / 1e6:.1f} MB -> "
              f"{os.path.getsize(dst) / 1e6:.1f} MB, {dt:.1f}s)")
        if args.verify:
            a = _digest_source(inp, args.format, args.device)
            b = _digest(Trace.open(dst, streaming=True, cache=False,
                                   device=args.device), args.device)
            ok = a == b
            print(f"  verify: {'OK' if ok else 'DIGEST MISMATCH'}")
            failures += 0 if ok else 1
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
