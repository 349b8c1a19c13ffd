"""Paper Table I on the port: ``tests/test_api_surface.py``'s capability
matrix asserted on :class:`repro_torch.core.trace.Trace`.

Every row of the matrix holds, and the port has each of the reference's
readers.  ``WAITING_FOR_READERS`` (the readers still missing) is empty; it
is checked both ways, so a reader that went missing would show.
"""

import inspect

import pytest

from repro.core.trace import Trace as RefTrace
from repro_torch.core.trace import Trace

from test_api_surface import CAPABILITIES, READERS

#: readers of the reference that the port still lacks
WAITING_FOR_READERS = []

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


@pytest.mark.parametrize("name", READERS)
def test_every_reader_defaults_to_the_card(name):
    params = inspect.signature(getattr(Trace, name)).parameters
    assert params["device"].default == "cuda", name


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
