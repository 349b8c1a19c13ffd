"""Paper Table I on the port: ``tests/test_api_surface.py``'s capability
matrix asserted on :class:`repro_torch.core.trace.Trace`.

Every row of the matrix holds.  Of the reference's readers the port has
``from_jsonl`` and ``from_events``; the four others wait for the readers
slice (ROADMAP §A item 6) and are listed here as still missing — the list
is checked both ways, so a reader that lands must be moved out of it.
"""

import inspect

import pytest

from repro.core.trace import Trace as RefTrace
from repro_torch.core.trace import Trace

from test_api_surface import CAPABILITIES, READERS

#: readers that come with ROADMAP §A item 6
WAITING_FOR_READERS = ["from_csv", "from_chrome", "from_otf2_json",
                       "from_hlo"]

ROWS = [(cap, n) for cap, names in CAPABILITIES.items() for n in names]


def test_matrix_has_every_row():
    assert len(CAPABILITIES) == 12
    assert all(hasattr(RefTrace, n) for _cap, n in ROWS)


@pytest.mark.parametrize("cap,name", ROWS, ids=[n for _c, n in ROWS])
def test_capability(cap, name):
    assert hasattr(Trace, name), (cap, name)


@pytest.mark.parametrize("name", ["from_jsonl", "from_events",
                                  "calc_inc_metrics", "calc_exc_metrics"])
def test_readers_and_metric_entry_points(name):
    assert callable(getattr(Trace, name))


def test_readers_still_missing_are_exactly_item_6():
    missing = [n for n in READERS if not hasattr(Trace, n)]
    assert missing == WAITING_FOR_READERS


def test_ops_take_documented_args_and_a_device():
    for meth, args in (("load_imbalance", ("metric", "num_processes")),
                       ("time_profile", ("num_bins",)),
                       ("comm_matrix", ("output",)),
                       ("idle_time", ("idle_functions", "k")),
                       ("comm_by_process", ("output",)),
                       ("comm_over_time", ("num_bins", "output")),
                       ("comm_comp_breakdown", ("comm_matcher",)),
                       ("detect_pattern", ("start_event",)),
                       ("calculate_lateness", ()),
                       ("critical_path_analysis", ()),
                       ("multirun_analysis", ("traces", "metric", "top_n"))):
        params = inspect.signature(getattr(Trace, meth)).parameters
        for a in args + ("device",):
            assert a in params, (meth, a)
        assert params["device"].default is None, meth
    assert isinstance(inspect.getattr_static(Trace, "multirun_analysis"),
                      staticmethod)
