"""The port's HLO reader against the reference's.

``read_hlo`` models a compiled SPMD program's entry computation as a
per-device timeline.  Given the reference's hardware table (``hw=``), the
port gives the reference's events exactly, column for column, on
``tests/test_readers.py``'s ``HLO_MIN`` and on a module JAX compiles on the
CPU.  With the port's default table (the H100's rates) only the
timestamps move: the same calls, names, devices, threads, partners and
wire sizes.  The four ops ``chip_smoke.py`` runs on an HLO trace hold the
reference's ``numpy`` backend within the ``bench_backends.py`` gate, and
the file reader keeps the reference's error policies.
"""

import numpy as np
import pytest

from repro.analysis.roofline import HW as REF_HW
from repro.core.trace import Trace as RefTrace
from repro.readers.hlo import read_hlo as ref_read_hlo
from repro_torch import Trace
from repro_torch.analysis import roofline
from repro_torch.core.constants import (ET, MSG_SIZE, NAME, PARTNER, PROC,
                                        TAG, THREAD, TS)
from repro_torch.core.errors import TraceReadError
from repro_torch.readers.hlo import read_hlo

from test_readers import HLO_MIN
from test_torch_ops import assert_within_gate

COLUMNS = (TS, ET, NAME, PROC, THREAD, PARTNER, MSG_SIZE, TAG)
#: a collective of each kind inside the loop body, and an async pair
HLO_RING = HLO_MIN.replace(
    "  %one = s32[] constant(1)\n",
    "  %ag = f32[512,128] all-gather(%ar), replica_groups={{0,1,2,3}}, "
    "dimensions={0}\n"
    "  %rs = f32[32,128] reduce-scatter(%ar), replica_groups={{0,1,2,3}}, "
    "dimensions={0}, to_apply=%sum\n"
    "  %cps = f32[128,128] collective-permute-start(%d), "
    "source_target_pairs={{0,1},{1,2},{2,3},{3,0}}\n"
    "  %e = f32[1024,128] exponential(%x)\n"
    "  %cpd = f32[128,128] collective-permute-done(%cps)\n"
    "  %one = s32[] constant(1)\n")
CASES = {"min": (HLO_MIN, 4, 4), "ring": (HLO_RING, 8, 256)}


def _jax_module() -> str:
    """The optimized HLO of a small jitted function on the CPU: a matmul
    loop (a ``while`` with a ``dot`` in its body)."""
    import jax
    import jax.numpy as jnp

    def f(x):
        return jax.lax.fori_loop(0, 5, lambda i, a: jnp.tanh(a @ x), x)

    x = jnp.ones((64, 64), jnp.float32)
    return jax.jit(f).lower(x).compile().as_text()


@pytest.fixture(scope="module")
def texts():
    return dict(CASES, jax=(_jax_module(), 4, 4))


def assert_same_events(got, want, columns=COLUMNS, context=""):
    assert len(got.events) == len(want.events), context
    for c in columns:
        a, b = np.asarray(got.events[c]), np.asarray(want.events[c])
        if a.dtype.kind in "UO" or b.dtype.kind in "UO":
            assert a.astype(str).tolist() == b.astype(str).tolist(), \
                f"{context}: {c}"
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{context}: {c}")


@pytest.mark.parametrize("case", ["min", "ring", "jax"])
def test_reference_table_gives_the_reference_events(texts, case):
    text, n_procs, group = texts[case]
    got = read_hlo(text, n_procs=n_procs, group_size=group, hw=REF_HW,
                   device="cpu")
    want = ref_read_hlo(text, n_procs=n_procs, group_size=group)
    assert len(got.events) > 0
    assert_same_events(got, want, context=case)
    for c in (ET, NAME):     # the same categoricals, codes and tables
        a, b = got.events.column(c), want.events.column(c)
        np.testing.assert_array_equal(a.codes, b.codes)
        assert a.categories.tolist() == b.categories.tolist()
        assert a.categories.dtype == b.categories.dtype
    assert got.definitions == want.definitions
    assert got.label == want.label == "hlo"


@pytest.mark.parametrize("case", ["min", "ring", "jax"])
def test_default_table_moves_only_the_timestamps(texts, case):
    text, n_procs, group = texts[case]
    got = read_hlo(text, n_procs=n_procs, group_size=group, device="cpu")
    want = ref_read_hlo(text, n_procs=n_procs, group_size=group)
    assert got.definitions["modeled"]["hw"] == roofline.HW_H100
    assert roofline.HW is roofline.HW_H100
    # (a bookkeeping op under 50 ns is dropped: an input whose op crosses
    # 50 ns between the two tables would change the calls too)
    assert len(got.events) == len(want.events), case
    # the sort by (process, time) can reorder calls whose times moved, so
    # the rows are compared as sets of calls per device
    def calls(t):
        ev = t.events
        return sorted(zip(np.asarray(ev[PROC]).tolist(),
                          np.asarray(ev[THREAD]).tolist(),
                          np.asarray(ev[NAME]).astype(str).tolist(),
                          np.asarray(ev[ET]).astype(str).tolist(),
                          np.asarray(ev[PARTNER]).tolist(),
                          np.nan_to_num(np.asarray(ev[MSG_SIZE]),
                                        nan=-1.0).tolist()))
    assert calls(got) == calls(want)
    assert not np.array_equal(np.asarray(got.events[TS]),
                              np.asarray(want.events[TS]))


def test_h100_table_is_faster_than_the_reference_table():
    t_h100 = read_hlo(HLO_RING, n_procs=4, device="cpu")
    t_ref = read_hlo(HLO_RING, n_procs=4, hw=REF_HW, device="cpu")
    assert np.asarray(t_h100.events[TS]).max() < \
        np.asarray(t_ref.events[TS]).max()


OPS4 = [("flat_profile", {}), ("comm_matrix", {}),
        ("time_profile", {"num_bins": 16}),
        ("message_histogram", {"bins": 10})]


@pytest.mark.parametrize("op,kw", OPS4, ids=[o for o, _ in OPS4])
@pytest.mark.parametrize("case", ["min", "ring"])
def test_ops_on_an_hlo_trace_within_gate_of_numpy(case, op, kw):
    text, n_procs, group = CASES[case]
    got = Trace.from_hlo(text, n_procs=n_procs, group_size=group, hw=REF_HW,
                         device="cpu").run(op, **kw)
    ref = RefTrace.from_hlo(text, n_procs=n_procs, group_size=group)
    want = ref.query().run(op, cache=False, backend="numpy", **kw)
    assert_within_gate(op, got, want, ref, kw, context=f"{case}/{op}")


@pytest.mark.parametrize("n_procs", [1, 2, 5])
def test_max_events_per_proc_binds_as_in_the_reference(n_procs):
    text = HLO_RING.replace("constant(3)", "constant(5000)")
    got = read_hlo(text, n_procs=n_procs, max_events_per_proc=1_000,
                   hw=REF_HW, device="cpu")
    want = ref_read_hlo(text, n_procs=n_procs, max_events_per_proc=1_000)
    assert_same_events(got, want, context="bound")


def test_an_entry_with_no_timed_op_gives_the_reference_empty_frame():
    text = ("HloModule m\n\nENTRY %main (a: f32[2]) -> f32[2] {\n"
            "  ROOT %a = f32[2] parameter(0)\n}\n")
    got = read_hlo(text, device="cpu")
    want = ref_read_hlo(text)
    assert len(got.events) == len(want.events) == 0
    assert got.events.columns == want.events.columns


def test_file_reader_sniffs_and_keeps_the_policies(tmp_path):
    p = str(tmp_path / "module.hlo")
    with open(p, "w") as f:
        f.write(HLO_MIN)
    t = Trace.open(p, device="cpu", n_procs=4, group_size=4, hw=REF_HW)
    assert_same_events(t, ref_read_hlo(HLO_MIN, n_procs=4, group_size=4))
    assert t.ingest_report().as_dict()["paths"][p]["rows"] == len(t.events)

    broken = str(tmp_path / "broken.hlo")
    with open(broken, "w") as f:
        f.write("HloModule busted\n\n%f (x: f32[2]) -> f32[2] {\n  ROOT")
    with pytest.raises((TraceReadError, ValueError), match="broken.hlo"):
        Trace.open(broken, format="hlo", on_error="strict", device="cpu")
    t = Trace.open(broken, format="hlo", on_error="skip", device="cpu")
    assert len(t.events) == 0
    assert t.ingest_report().total_skipped() >= 1
    ref = RefTrace.open(broken, format="hlo", on_error="skip")
    assert t.ingest_report().total_skipped() == \
        ref.ingest_report().total_skipped()


def test_streaming_an_hlo_file_reads_it_whole(tmp_path):
    """HLO has no chunked reader: a streamed open slices the whole-file
    read, and gives the eager bits."""
    from repro_torch.launch.cardcheck import digest
    p = str(tmp_path / "module.hlo")
    with open(p, "w") as f:
        f.write(HLO_RING)
    eager = Trace.open(p, device="cpu")
    st = Trace.open(p, device="cpu", streaming=True, chunk_rows=17)
    assert digest(st.flat_profile()) == digest(eager.flat_profile())
