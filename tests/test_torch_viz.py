"""The port's plots (``repro_torch.core.viz``) against the reference's
``repro.core.viz`` on the same trace, on matplotlib's Agg backend: the
same bars (positions, sizes, colours), arrows, lines, legend and image.
Where a plot draws a kernel-backed op's result (``time_profile``'s
``time_bin``, ``comm_matrix``'s ``pair_sum``, ``multirun_analysis``'s
``seg_sum``: f32 sums) its heights are held to the
``benchmarks/bench_backends.py`` gate; everything else is exact.

With matplotlib blocked from import, ``import repro_torch`` and the
``Trace`` ops still work, and a plot raises an ImportError naming
matplotlib."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from repro import tracegen as rtg  # noqa: E402
from repro.core import viz as ref_viz  # noqa: E402
from repro.core.trace import Trace as RefTrace  # noqa: E402
from repro_torch import Trace  # noqa: E402
from repro_torch.core import viz  # noqa: E402
from repro_torch.launch.cardcheck import gate  # noqa: E402

from test_torch_ops import to_port  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


@pytest.fixture(autouse=True)
def close_figures():
    yield
    plt.close("all")


def _pair(make):
    ref = make()
    port = to_port(make())
    port.label = ref.label
    return ref, port


def _bars(ax):
    return np.asarray([(p.get_x(), p.get_y(), p.get_width(), p.get_height())
                       for p in ax.patches if hasattr(p, "get_width")]
                      ).reshape(-1, 4)


def _colors(ax):
    return [tuple(p.get_facecolor()) for p in ax.patches]


def _legend(ax):
    leg = ax.get_legend()
    return [t.get_text() for t in leg.get_texts()] if leg else []


def _same_axes(got, want, heights="exact"):
    """Bars (x and width exact; bottom and height exact or in the gate),
    colours,
    legend, annotations, lines, images, limits and tick labels."""
    gb, wb = _bars(got), _bars(want)
    assert gb.shape == wb.shape
    if heights == "exact":
        np.testing.assert_array_equal(gb, wb)
    elif len(wb):
        # stacked bars: each bottom is the sum of the heights below it
        np.testing.assert_array_equal(gb[:, [0, 2]], wb[:, [0, 2]])
        gate(gb[:, [1, 3]], wb[:, [1, 3]])
    assert _colors(got) == _colors(want)
    assert _legend(got) == _legend(want)
    ga = [(a.xy, a.xyann) for a in got.texts]
    wa = [(a.xy, a.xyann) for a in want.texts]
    assert ga == wa
    assert len(got.lines) == len(want.lines)
    for g, w in zip(got.lines, want.lines):
        np.testing.assert_array_equal(g.get_xydata(), w.get_xydata())
    assert len(got.images) == len(want.images)
    for g, w in zip(got.images, want.images):
        gate(np.asarray(g.get_array()), np.asarray(w.get_array()))
    assert got.get_xlim() == want.get_xlim()
    assert got.get_xlabel() == want.get_xlabel()
    assert got.get_ylabel() == want.get_ylabel()
    assert [t.get_text() for t in got.get_xticklabels()] == \
        [t.get_text() for t in want.get_xticklabels()]


@pytest.mark.parametrize("kw", [{}, {"show_critical_path": True},
                                {"show_messages": False, "max_functions": 2}])
@pytest.mark.parametrize("app", ["gol", "tortuga", "axonn"])
def test_plot_timeline_equals_the_reference(app, kw):
    make = {"gol": lambda: rtg.gol(nprocs=3, iters=2),
            "tortuga": lambda: rtg.tortuga(nprocs=4, iters=2),
            "axonn": lambda: rtg.axonn_training(nprocs=2, iters=1,
                                                version=2)}[app]
    ref, port = _pair(make)
    _same_axes(port.plot_timeline(**kw), ref_viz.plot_timeline(ref, **kw))


@pytest.mark.parametrize("app", ["gol", "tortuga"])
def test_plot_time_profile_within_the_gate(app):
    make = {"gol": lambda: rtg.gol(nprocs=3, iters=2),
            "tortuga": lambda: rtg.tortuga(nprocs=4, iters=2)}[app]
    ref, port = _pair(make)
    _same_axes(port.plot_time_profile(num_bins=12),
               ref_viz.plot_time_profile(ref, num_bins=12), heights="gate")


@pytest.mark.parametrize("kw", [{}, {"log_scale": True},
                                {"output": "count"}])
def test_plot_comm_matrix_within_the_gate(kw):
    ref, port = _pair(lambda: rtg.stencil3d(nprocs=8, iters=2))
    _same_axes(port.plot_comm_matrix(**kw),
               ref_viz.plot_comm_matrix(ref, **kw))


@pytest.mark.parametrize("output", ["size", "count"])
def test_plot_comm_by_process_equals_the_reference(output):
    ref, port = _pair(lambda: rtg.gol(nprocs=4, iters=3))
    _same_axes(port.plot_comm_by_process(output=output),
               ref_viz.plot_comm_by_process(ref, output=output))


def test_plot_message_histogram_equals_the_reference():
    ref, port = _pair(lambda: rtg.amg_vcycle(nprocs=4, iters=2))
    _same_axes(port.plot_message_histogram(bins=6),
               ref_viz.plot_message_histogram(ref, bins=6))


def test_plot_multirun_within_the_gate():
    refs = [rtg.tortuga(nprocs=n, iters=2) for n in (4, 8, 16)]
    ports = []
    for r in refs:
        p = to_port(r)
        p.label = r.label
        ports.append(p)
    _same_axes(viz.plot_multirun(Trace.multirun_analysis(ports)),
               ref_viz.plot_multirun(RefTrace.multirun_analysis(refs)),
               heights="gate")


def test_plot_saves_a_file(tmp_path):
    _ref, port = _pair(lambda: rtg.gol(nprocs=2, iters=1))
    out = tmp_path / "t.png"
    port.plot_timeline(save=str(out))
    assert out.stat().st_size > 0


_BLOCKED = """
import sys
sys.path.insert(0, {src!r})


class Block:
    def find_spec(self, name, path=None, target=None):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError("matplotlib is blocked in this check")
        return None


sys.meta_path.insert(0, Block())
import repro_torch
from repro_torch import Trace
from repro_torch.core import viz  # noqa: F401
from repro_torch.tracegen import gol

t = gol(nprocs=2, iters=2, device="cpu")
assert len(t.idle_time()) == 2 and len(t.comm_by_process()) == 2
assert "matplotlib" not in sys.modules
try:
    t.plot_timeline()
except ImportError as e:
    assert "matplotlib" in str(e), e
    print("REFUSED", e)
else:
    raise SystemExit("plot_timeline drew without matplotlib")
"""


def test_without_matplotlib_the_package_works_and_plots_refuse(tmp_path):
    script = tmp_path / "blocked.py"
    script.write_text(textwrap.dedent(_BLOCKED.format(src=SRC)))
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("REFUSED"), out.stdout
