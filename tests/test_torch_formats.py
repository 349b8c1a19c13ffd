"""The port's readers against the reference's: ``tests/test_conformance.py``
on ``repro_torch``.

One golden trace (``gol(nprocs=3, iters=4, seed=7)``, messages included)
is written in every format — jsonl, csv, chrome, otf2j (one file and a
directory archive) and pack — once by the reference's writers and once by
the port's, and every file is read by both packages.  Every route back
into memory gives the golden canonical table, exactly: the registered
reader, the auto sniff, the chunked reader at 13 and 101 rows a chunk,
the streaming handle and the parallel work units (``ByteSpan`` for csv,
``ProcSpan`` for chrome and the otf2j directory, pruned under a process
restriction).  Each format's seven op calls on the CPU hold the
reference's ``numpy`` backend within the ``bench_backends.py`` gate
(rtol 1e-4 plus 1e-6 x the largest magnitude; counts and edges exact).
The corruption matrix (``truncate_at`` 25 / 75 / 99 %, ``bit_flip``,
``garbage_append``, under ``strict`` and the lenient policy) gives the
reference's outcome on the same damaged file: raise against not raise,
and the same survivors.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro import tracegen as tg
from repro.core.errors import TraceReadError as RefTraceReadError
from repro.core.trace import Trace as RefTrace
from repro.readers.chrome import write_chrome as ref_write_chrome
from repro.readers.csvreader import write_csv as ref_write_csv
from repro.readers.jsonl import write_jsonl as ref_write_jsonl
from repro.readers.otf2j import write_otf2_json as ref_write_otf2_json
from repro.readers.pack import write_pack as ref_write_pack
from repro.testing import faults as ref_faults
from repro_torch import Trace
from repro_torch.core import Filter, executor, registry
from repro_torch.core.constants import DERIVED_COLUMNS, PROC
from repro_torch.core.errors import TraceReadError
from repro_torch.core.frame import concat
from repro_torch.core.streaming import StreamingTrace
from repro_torch.launch.cardcheck import digest
from repro_torch.readers import (write_chrome, write_csv, write_jsonl,
                                 write_otf2_json, write_pack)
from repro_torch.serving.protocol import result_digest
from repro_torch.testing import faults

from test_conformance import assert_canonical_equal, canonical
from test_torch_ops import fresh_plan_cache  # noqa: F401
from test_torch_ops import OPS, assert_within_gate, to_port
from test_torch_stragglers import assert_findings

TERMINALS = OPS + [("stragglers", {"threshold": -1.0})]
OP_IDS = [f"{op}-{i}" for i, (op, _) in enumerate(TERMINALS)]
ALL_FMTS = ["jsonl", "csv", "chrome", "otf2j", "otf2j-dir", "pack"]
FILES = {"jsonl": "golden.jsonl", "csv": "golden.csv",
         "chrome": "golden.json", "otf2j": "golden.otf2.json",
         "otf2j-dir": "golden_archive", "pack": "golden.pack"}
WRITERS = {
    "ref": {"jsonl": ref_write_jsonl, "csv": ref_write_csv,
            "chrome": ref_write_chrome, "otf2j": ref_write_otf2_json,
            "otf2j-dir": lambda t, p: ref_write_otf2_json(
                t, p, split_locations=True),
            "pack": ref_write_pack},
    "port": {"jsonl": write_jsonl, "csv": write_csv,
             "chrome": write_chrome, "otf2j": write_otf2_json,
             "otf2j-dir": lambda t, p: write_otf2_json(
                 t, p, split_locations=True),
             "pack": write_pack},
}
CASES = [(w, f) for w in WRITERS for f in ALL_FMTS]
CASE_IDS = [f"{w}-{f}" for w, f in CASES]
#: the planner's unit type for each format that splits
UNIT_TYPES = {"jsonl": registry.ByteSpan, "csv": registry.ByteSpan,
              "chrome": registry.ProcSpan, "otf2j-dir": registry.ProcSpan}
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def _name(fmt: str) -> str:
    return "otf2j" if fmt.startswith("otf2j") else fmt


@pytest.fixture(scope="module")
def golden():
    return tg.gol(nprocs=3, iters=4, seed=7)


@pytest.fixture(scope="module")
def golden_canonical(golden):
    return canonical(golden)


@pytest.fixture(scope="module")
def written(golden, tmp_path_factory):
    """(writer, format) -> path: every format written by each package."""
    port_golden = to_port(golden)
    out = {}
    for who, writers in WRITERS.items():
        d = tmp_path_factory.mktemp(f"formats_{who}")
        for fmt, write in writers.items():
            p = str(d / FILES[fmt])
            write(golden if who == "ref" else port_golden, p)
            out[who, fmt] = p
    return out


def _tree_bytes(path):
    if not os.path.isdir(path):
        with open(path, "rb") as f:
            return f.read()
    out = {}
    for root, _dirs, files in os.walk(path):
        for fn in files:
            p = os.path.join(root, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, path)] = f.read()
    return out


@pytest.mark.parametrize("fmt", ALL_FMTS)
def test_port_writers_write_the_reference_bytes(fmt, written):
    assert _tree_bytes(written["port", fmt]) == \
        _tree_bytes(written["ref", fmt])


@pytest.mark.parametrize("who,fmt", CASES, ids=CASE_IDS)
def test_registered_reader_of_both_packages(who, fmt, written,
                                            golden_canonical):
    path = written[who, fmt]
    spec = registry.get_reader(_name(fmt))
    got = spec.read(path, device="cpu")
    assert got.device.type == "cpu"
    assert_canonical_equal(golden_canonical, canonical(got),
                           f"{who}/{fmt} port reader")
    ref = RefTrace.open(path, format=_name(fmt))
    assert_canonical_equal(canonical(ref), canonical(got),
                           f"{who}/{fmt} port vs reference reader")
    assert got.definitions.keys() == ref.definitions.keys()


@pytest.mark.parametrize("who,fmt", CASES, ids=CASE_IDS)
def test_auto_sniff(who, fmt, written, golden_canonical):
    path = written[who, fmt]
    assert registry.sniff_format(path) == _name(fmt)
    got = Trace.open(path, device="cpu")
    assert_canonical_equal(golden_canonical, canonical(got),
                           f"{who}/{fmt} auto")


@pytest.mark.parametrize("chunk_rows", [13, 101])
@pytest.mark.parametrize("who,fmt", CASES, ids=CASE_IDS)
def test_chunked_reader(who, fmt, chunk_rows, written, golden_canonical):
    spec = registry.get_reader(_name(fmt))
    assert spec.iter_chunks is not None, f"{fmt} has no chunked reader"
    chunks = list(spec.iter_chunks(written[who, fmt], chunk_rows, None))
    assert all(len(c) > 0 for c in chunks)
    # an X or B/E pair expands per event object: chunks stay near the size
    assert max(len(c) for c in chunks) <= 2 * chunk_rows
    got = canonical(concat([c.drop(*DERIVED_COLUMNS) for c in chunks]))
    assert_canonical_equal(golden_canonical, got,
                           f"{who}/{fmt} chunked({chunk_rows})")


@pytest.mark.parametrize("who,fmt", CASES, ids=CASE_IDS)
def test_streaming_handle(who, fmt, written, golden_canonical):
    path = written[who, fmt]
    eager = Trace.open(path, device="cpu")
    st = Trace.open(path, streaming=True, chunk_rows=61, device="cpu")
    for op, kw in TERMINALS[:3]:
        assert digest(st.run(op, **kw)) == digest(eager.run(op, **kw)), op
    assert_canonical_equal(golden_canonical, canonical(st.materialize()),
                           f"{who}/{fmt} streamed")


@pytest.mark.parametrize("who,fmt", CASES, ids=CASE_IDS)
def test_parallel_units(who, fmt, written, golden_canonical):
    """The frames of every planned unit, in unit order, partition the
    golden events exactly, in the unit type the reference plans."""
    from repro.core.executor import _unit_frames as ref_unit_frames
    from repro.core.frame import concat as ref_concat
    from repro.core.registry import get_reader as ref_get_reader
    path = written[who, fmt]
    spec = registry.get_reader(_name(fmt))
    if spec.plan_units is None or fmt == "otf2j":
        assert (ref_get_reader(_name(fmt)).plan_units is None
                or ref_get_reader(_name(fmt)).plan_units(path, 3) is None)
        if spec.plan_units is not None:
            assert spec.plan_units(path, 3) is None
        return
    units = spec.plan_units(path, 3)
    ref_units = ref_get_reader(_name(fmt)).plan_units(path, 3)
    if fmt == "pack":
        # the golden pack is one chunk group: neither package splits it
        assert units is None and ref_units is None
        return
    assert len(units) == 3
    assert all(isinstance(u, UNIT_TYPES[fmt]) for u in units)
    assert [type(u).__name__ for u in units] == \
        [type(u).__name__ for u in ref_units]
    frames = [f.drop(*DERIVED_COLUMNS) for u in units
              for f in executor._unit_frames(u, _name(fmt), 37, None, {})]
    assert_canonical_equal(golden_canonical, canonical(concat(frames)),
                           f"{who}/{fmt} units")
    ref_frames = [f.drop(*DERIVED_COLUMNS) for u in ref_units
                  for f in ref_unit_frames(u, _name(fmt), 37, None, {})]
    assert_canonical_equal(canonical(ref_concat(ref_frames)),
                           canonical(concat(frames)),
                           f"{who}/{fmt} port vs reference units")


def _run_units(path, op, kw, steps=()):
    """The parallel route over 3 units run in-process (as
    ``test_torch_parallel.py`` runs them)."""
    st = StreamingTrace([path], chunk_rows=29, device="cpu", processes=2)
    spec = registry.get_op(op)
    kw = dict(kw, device="cpu")
    res = executor.execute_parallel(st, tuple(steps), spec, (), kw,
                                    spec.streaming(**kw), n_units=3,
                                    use_pool=False)
    return res, st


@pytest.mark.parametrize("op,kw", TERMINALS, ids=OP_IDS)
@pytest.mark.parametrize("fmt", ["csv", "chrome", "otf2j-dir"])
def test_units_run_in_process_give_the_eager_bits(fmt, op, kw, written):
    path = written["port", fmt]
    got, _st = _run_units(path, op, kw)
    assert digest(got) == digest(Trace.open(path, device="cpu").run(op, **kw))


@pytest.mark.parametrize("fmt", ["csv", "chrome", "otf2j-dir"])
def test_restricted_plan_prunes_process_units(fmt, written):
    """Under a process restriction the ProcSpan units that cannot hold a
    row are pruned (byte spans never are), as the reference prunes them,
    and the plan gives the eager selection's bits."""
    from repro.core import executor as ref_executor
    from repro.core.filters import Filter as RefFilter
    from repro.core.streaming import StreamingTrace as RefStreamingTrace
    path = written["port", fmt]
    q = StreamingTrace([path], device="cpu").query().filter(
        Filter(PROC, "in", [0, 1]))
    planned = executor.plan_units(q._source.handle, q._steps, 3)
    pruned = executor._prune_units(planned,
                                   executor._steps_hints(q._steps))
    ref_q = RefStreamingTrace([path]).query().filter(
        RefFilter(PROC, "in", [0, 1]))
    ref_planned = ref_executor.plan_units(ref_q._source.handle,
                                          ref_q._steps, 3)
    ref_pruned = ref_executor._prune_units(
        ref_planned, ref_executor._steps_hints(ref_q._steps))
    assert len(planned) == len(ref_planned) == 3
    assert len(pruned) == len(ref_pruned)
    if fmt == "csv":
        assert pruned == planned
    else:
        assert [u.procs for u in pruned] == [(0,), (1,)]
    got, st = _run_units(path, "flat_profile", {}, q._steps)
    assert st.units_pruned == len(planned) - len(pruned)
    want = Trace.open(path, device="cpu").query().filter(
        Filter(PROC, "in", [0, 1])).collect()
    assert digest(got) == digest(want.flat_profile())


@pytest.mark.parametrize("op,kw", TERMINALS, ids=OP_IDS)
@pytest.mark.parametrize("fmt", ALL_FMTS)
def test_ops_within_gate_of_numpy(fmt, op, kw, written):
    path = written["port", fmt]
    got = Trace.open(path, device="cpu").run(op, **kw)
    ref = RefTrace.open(path, format=_name(fmt))
    want = ref.query().run(op, cache=False, backend="numpy", **kw)
    if op == "stragglers":
        assert_findings(got, want, f"{fmt}/{op}")
    else:
        assert_within_gate(op, got, want, ref, kw, context=f"{fmt}/{op}")


_SCRIPT = """
import sys, warnings
sys.path.insert(0, {src!r})
from repro_torch import Trace
from repro_torch.core import Filter
from repro_torch.launch.cardcheck import digest

OPS = [("flat_profile", {{}}), ("comm_matrix", {{}})]


def main():
    warnings.simplefilter("error", RuntimeWarning)  # no degradation
    for path in {paths!r}:
        eager = Trace.open(path, device="cpu")
        st = Trace.open(path, streaming=True, chunk_rows=31, processes=3,
                        device="cpu")
        for op, kw in OPS:
            assert digest(st.run(op, **kw)) == digest(eager.run(op, **kw)), \\
                (path, op)
            assert len(st.units_cuda) >= 2 and not any(st.units_cuda)
        q = st.query().filter(Filter("Process", "in", [1, 2]))
        want = eager.query().filter(Filter("Process", "in", [1, 2]))
        assert digest(q.flat_profile()) == digest(want.flat_profile()), path
        print("UNITS", path, len(st.units_cuda), st.units_pruned)
    st._pool.close()
    print("POOLED")


if __name__ == "__main__":
    main()
"""


def test_spawn_pool_from_a_script_on_disk(written, tmp_path):
    """A real three-worker spawn pool over csv byte spans and the chrome and
    otf2j-dir process units, from a script file: every op the eager
    bits, a process-restricted plan prunes the unit of rank 0, no
    degradation warning, no worker on the card."""
    paths = [written["port", f] for f in ("csv", "chrome", "otf2j-dir")]
    script = tmp_path / "run_pool.py"
    script.write_text(textwrap.dedent(_SCRIPT.format(src=SRC, paths=paths)))
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[-1] == "POOLED", out.stdout
    pruned = {ln.split()[1]: int(ln.split()[3]) for ln in lines[:-1]}
    assert pruned == {paths[0]: 0, paths[1]: 1, paths[2]: 1}, pruned


def test_read_parallel_over_csv_and_chrome_shards(golden, tmp_path):
    """``Trace.open(shards, format=...)`` reads csv and chrome shards
    through the registry, as the reference's sharded reader does."""
    ev = golden.events
    procs = np.asarray(ev[PROC])
    for fmt, write, ext in (("csv", write_csv, "csv"),
                            ("chrome", write_chrome, "json")):
        paths = []
        for p in range(3):
            sub = to_port(golden).events.mask(procs == p)
            path = str(tmp_path / f"rank_{p}.{ext}")
            write(sub, path)
            paths.append(path)
        got = Trace.open(paths, format=fmt, device="cpu")
        ref = RefTrace.open(paths, format=fmt)
        if fmt == "csv":
            assert_canonical_equal(canonical(golden), canonical(got), fmt)
        # chrome shards each hold one pid: both packages densify it to 0
        assert_canonical_equal(canonical(ref), canonical(got), fmt)


# ---------------------------------------------------------------------------
# the corruption matrix: each reader x injected damage x error policy
# ---------------------------------------------------------------------------

MATRIX_FMTS = ["jsonl", "csv", "chrome", "otf2j", "pack"]
LENIENT = {"pack": "salvage"}  # every other reader spells it "skip"
CORRUPTIONS = {
    "trunc25": lambda m, s, d: m.truncate_at(s, d, frac=0.25),
    "trunc75": lambda m, s, d: m.truncate_at(s, d, frac=0.75),
    "trunc99": lambda m, s, d: m.truncate_at(s, d, frac=0.99),
    "bitflip": lambda m, s, d: m.bit_flip(s, d, frac=0.5, count=4, seed=13),
    "garbage": lambda m, s, d: m.garbage_append(s, d, nbytes=97, seed=13),
}


@pytest.fixture(scope="module")
def matrix_sources(golden, written, tmp_path_factory):
    """The port-written goldens, but the pack in small chunk groups so that
    partial damage has partial survivors."""
    d = tmp_path_factory.mktemp("matrix_src")
    paths = {f: written["port", f] for f in MATRIX_FMTS}
    paths["pack"] = str(d / "golden.pack")
    write_pack(to_port(golden), paths["pack"], chunk_rows=20)
    return paths


def _outcome(open_fn, errors):
    try:
        return open_fn(), None
    except errors as e:
        return None, e


@pytest.mark.parametrize("hurt", sorted(CORRUPTIONS))
@pytest.mark.parametrize("fmt", MATRIX_FMTS)
def test_corruption_matrix(fmt, hurt, matrix_sources, tmp_path):
    src = matrix_sources[fmt]
    dst = str(tmp_path / os.path.basename(src))
    ref_dst = str(tmp_path / ("ref-" + os.path.basename(src)))
    assert CORRUPTIONS[hurt](faults, src, dst) == \
        CORRUPTIONS[hurt](ref_faults, src, ref_dst)
    assert _tree_bytes(dst) == _tree_bytes(ref_dst)
    lenient = LENIENT.get(fmt, "skip")
    for policy in ("strict", lenient):
        got, err = _outcome(lambda: Trace.open(
            dst, format=fmt, on_error=policy, device="cpu"),
            (TraceReadError, ValueError))
        want, ref_err = _outcome(lambda: RefTrace.open(
            dst, format=fmt, on_error=policy),
            (RefTraceReadError, ValueError))
        ctx = f"{fmt}/{hurt}/{policy}"
        assert (err is None) == (ref_err is None), (ctx, err, ref_err)
        if err is not None:
            assert os.path.basename(dst) in str(err), (ctx, err)
            assert type(err).__name__ == type(ref_err).__name__, ctx
            continue
        assert len(got.events) == len(want.events), ctx
        assert got.ingest_report().total_skipped() == \
            want.ingest_report().total_skipped(), ctx
        assert got.ingest_report().clean == want.ingest_report().clean, ctx
        st = None
        if policy == lenient:
            st = Trace.open(dst, format=fmt, streaming=True, chunk_rows=61,
                            on_error=lenient, device="cpu").materialize()
        if len(got.events) == 0:
            # total loss, accounted for in the report (a single-file JSON
            # body destroyed): the streamed read is empty too
            assert not got.ingest_report().clean, ctx
            assert st is None or len(st.events) == 0, ctx
            continue
        assert_canonical_equal(canonical(want), canonical(got), ctx)
        if st is not None:
            assert_canonical_equal(canonical(got), canonical(st),
                                   f"{ctx} eager-vs-streaming")


@pytest.mark.parametrize("fmt", MATRIX_FMTS + ["hlo"])
def test_empty_file_is_loud_under_every_policy(fmt, tmp_path):
    ext = {"jsonl": ".jsonl", "csv": ".csv", "chrome": ".json",
           "otf2j": ".otf2.json", "pack": ".pack", "hlo": ".hlo"}[fmt]
    p = str(tmp_path / ("empty" + ext))
    open(p, "w").close()
    for policy in ("strict", LENIENT.get(fmt, "skip")):
        with pytest.raises(TraceReadError) as exc:
            Trace.open(p, format=fmt, on_error=policy, device="cpu")
        msg = str(exc.value)
        assert "empty file" in msg and os.path.basename(p) in msg, \
            (fmt, policy, msg)


def test_empty_file_auto_sniff_names_every_sniffer(tmp_path):
    p = str(tmp_path / "mystery.dat")
    open(p, "w").close()
    with pytest.raises(TraceReadError) as exc:
        Trace.open(p, device="cpu")
    msg = str(exc.value)
    assert "empty file" in msg and "Sniffers tried" in msg
    for fmt in MATRIX_FMTS + ["hlo"]:
        assert fmt in msg


def test_archive_stream_damage_drops_only_that_location(written, tmp_path,
                                                        golden_canonical):
    """A damaged location stream of a directory archive is dropped alone,
    as in the reference; a damaged definitions table is fatal."""
    import shutil
    arch = str(tmp_path / "arch")
    shutil.copytree(written["port", "otf2j-dir"], arch)
    loc_dir = os.path.join(arch, "locations")
    victim = os.path.join(loc_dir, sorted(os.listdir(loc_dir))[0])
    faults.bit_flip(victim, victim, offsets=[10], seed=0)

    with pytest.raises(TraceReadError, match=os.path.basename(victim)):
        Trace.open(arch, format="otf2j", on_error="strict", device="cpu")
    t = Trace.open(arch, format="otf2j", on_error="skip", device="cpu")
    ref = RefTrace.open(arch, format="otf2j", on_error="skip")
    assert 0 < len(t.events) < len(golden_canonical)
    assert t.ingest_report().total_skipped() == \
        ref.ingest_report().total_skipped() >= 1
    assert_canonical_equal(canonical(ref), canonical(t), "archive skip")
    st = Trace.open(arch, format="otf2j", streaming=True, chunk_rows=61,
                    on_error="skip", device="cpu").materialize()
    assert_canonical_equal(canonical(t), canonical(st),
                           "archive eager-vs-streaming")

    defs = os.path.join(arch, "definitions.json")
    faults.truncate_at(defs, defs, frac=0.5)
    for policy in ("strict", "skip"):
        with pytest.raises(TraceReadError, match="definitions"):
            Trace.open(arch, format="otf2j", on_error=policy, device="cpu")


# ---------------------------------------------------------------------------
# a detector gives the same result from every format
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pathology_written(tmp_path_factory):
    tr, gt = tg.pathology_trace("straggler", nprocs=3, iters=12,
                                magnitude=2.0, seed=7)
    port = to_port(tr)
    d = tmp_path_factory.mktemp("patho_formats")
    paths = {}
    for fmt, write in WRITERS["port"].items():
        p = str(d / FILES[fmt])
        write(port, p)
        paths[fmt] = p
    return port, gt, paths


@pytest.mark.parametrize("fmt", ALL_FMTS)
def test_detector_identical_across_formats(fmt, pathology_written):
    port, gt, paths = pathology_written
    want = result_digest(port.query().run("diagnose", cache=False))
    eager = Trace.open(paths[fmt], device="cpu")
    assert result_digest(eager.query().run("diagnose", cache=False)) == want
    st = Trace.open(paths[fmt], streaming=True, chunk_rows=47, device="cpu")
    assert result_digest(st.query().run("diagnose", cache=False)) == want
    top = eager.stragglers()
    assert int(np.asarray(top["process"])[0]) == gt.process


def test_definitions_survive_selections_and_set_clones(written):
    """A reader's definitions (chrome's raw pids, an OTF2 archive's
    tables) travel with the trace through a plan's selection and a set's
    relabelled members, as in the reference."""
    from repro_torch import TraceSet
    for fmt in ("chrome", "otf2j-dir"):
        t = Trace.open(written["port", fmt], device="cpu")
        assert t.definitions
        sel = t.query().filter(Filter(PROC, "in", [0, 1])).collect()
        assert sel.definitions == t.definitions
        t._ensure_structure()
        remapped = t.query().restrict_processes([0]).collect()
        assert remapped._structured and \
            remapped.definitions == t.definitions
        members = TraceSet([t, t], labels=["a", "b"])._traces
        assert all(m.definitions == t.definitions for m in members)


def test_a_rewritten_archive_file_is_planned_again(written, tmp_path):
    """Unit plans are cached per input; a location stream rewritten in an
    otf2j directory changes the directory's size, time and file count key,
    so the next op plans again."""
    import shutil
    arch = str(tmp_path / "arch")
    shutil.copytree(written["port", "otf2j-dir"], arch)
    st = StreamingTrace([arch], device="cpu", processes=2)
    first = executor.plan_units(st, (), 3)
    assert executor.plan_units(st, (), 3) is first
    loc = os.path.join(arch, "locations",
                       sorted(os.listdir(os.path.join(arch, "locations")))[0])
    with open(loc, "a") as f:
        f.write(" ")
    os.utime(loc, ns=(1, 10**19))
    assert executor.plan_units(st, (), 3) is not first
