"""``EventFrame.rename``, ``groupby_agg``, ``to_dict`` and ``to_csv`` of the
port against :mod:`repro.core.frame` on the same frames.

Each case builds its frame from the same seeded NumPy columns in both
packages, calls the method, and compares the results column by column:
names and order, dtypes, categorical codes and category tables, and
values (NaN where the reference has NaN).  ``to_csv`` is compared as
text, written to a string and to a path.
"""

import numpy as np
import pytest

from repro.core import frame as ref_frame
from repro_torch.core import frame as port_frame

NAME, PROC = "Name", "Process"


def _columns(n: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n) * 1e3
    x[rng.random(n) < 0.2] = np.nan
    return {
        NAME: rng.choice(["MPI_Recv", "compute", "main()", "MPI_Send"], n),
        PROC: rng.integers(0, 4, n).astype(np.int32),
        "kind": rng.choice(["a", "b"], n),
        "x": x,
        "y": rng.integers(-50, 50, n).astype(np.int64),
        "t": np.sort(rng.integers(0, 10 ** 6, n)).astype(np.float64),
    }


def _frame(mod, n: int = 57, seed: int = 0):
    return mod.EventFrame({k: v.copy() for k, v in _columns(n, seed).items()})


def _spread(v):
    return float(np.max(v) - np.min(v)) if len(v) else 0.0


AGGS = {"x": "sum", "y": "mean", "t": "min"}
CASES = {
    # groupby_agg: keys, aggregations, count_name
    "one_categorical_key": lambda f: f.groupby_agg(NAME, AGGS),
    "one_numeric_key": lambda f: f.groupby_agg(PROC, {"x": "max",
                                                      "y": "sum"}),
    "key_list_of_one": lambda f: f.groupby_agg([PROC], {"t": "max"}),
    "two_keys": lambda f: f.groupby_agg([NAME, PROC], AGGS,
                                        count_name="count"),
    "three_keys_mixed": lambda f: f.groupby_agg([PROC, "kind", NAME],
                                                {"y": "max"},
                                                count_name="n"),
    "count_only": lambda f: f.groupby_agg(NAME, {}, count_name="count"),
    "sum": lambda f: f.groupby_agg(NAME, {"x": "sum", "y": "sum"}),
    "mean": lambda f: f.groupby_agg(NAME, {"x": "mean", "y": "mean"}),
    "min": lambda f: f.groupby_agg(NAME, {"x": "min", "y": "min"}),
    "max": lambda f: f.groupby_agg(NAME, {"x": "max", "y": "max"}),
    "std_median": lambda f: f.groupby_agg(PROC, {"x": "std",
                                                 "y": "median"}),
    "first_last": lambda f: f.groupby_agg(NAME, {"x": "first",
                                                 "t": "last"}),
    "callable": lambda f: f.groupby_agg(NAME, {"y": _spread,
                                               "x": np.nansum}),
    "categorical_value": lambda f: f.groupby_agg(PROC, {"kind": "max"}),
    "after_mask": lambda f: f.mask(np.asarray(f[PROC]) == 2).groupby_agg(
        NAME, AGGS, count_name="count"),
    "empty_frame": lambda f: f.mask(np.zeros(len(f), bool)).groupby_agg(
        [NAME, PROC], AGGS, count_name="count"),
    "no_columns": lambda f: type(f)().groupby_agg(NAME, {"x": "sum"}),
    # rename, to_dict
    "rename": lambda f: f.rename({NAME: "function", "x": "value"}),
    "rename_unknown_key": lambda f: f.rename({"absent": "z"}),
    "rename_then_groupby": lambda f: f.rename({PROC: "rank"}).groupby_agg(
        "rank", {"y": "sum"}),
    "to_dict": lambda f: f.to_dict(),
    "to_dict_empty": lambda f: f.head(0).to_dict(),
    # to_csv to a string
    "to_csv": lambda f: f.to_csv(),
    "to_csv_grouped": lambda f: f.groupby_agg(NAME, AGGS).to_csv(),
    "to_csv_empty": lambda f: f.head(0).to_csv(),
}


def _same(got, want, where: str) -> None:
    if isinstance(want, str) or want is None:
        assert got == want, where
        return
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _same_values(got[k], want[k], f"{where}[{k}]")
        return
    assert got.columns == want.columns, where
    assert len(got) == len(want), where
    for c in want.columns:
        a, b = got.column(c), want.column(c)
        if isinstance(b, ref_frame.Categorical):
            assert isinstance(a, port_frame.Categorical), (where, c)
            np.testing.assert_array_equal(a.codes, b.codes)
            np.testing.assert_array_equal(a.categories, b.categories)
        else:
            _same_values(a, b, f"{where}.{c}")


def _same_values(a, b, where: str) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (where, a.dtype, b.dtype)
    assert a.shape == b.shape, where
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a.tolist() == b.tolist(), where


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_frame_method_matches_the_reference(case, seed):
    fn = CASES[case]
    _same(fn(_frame(port_frame, seed=seed)), fn(_frame(ref_frame,
                                                        seed=seed)), case)


@pytest.mark.parametrize("case", ["whole", "grouped", "empty"])
def test_to_csv_to_a_path_matches_the_reference(tmp_path, case):
    def make(mod):
        f = _frame(mod)
        if case == "grouped":
            return f.groupby_agg([NAME, PROC], AGGS, count_name="count")
        return f.head(0) if case == "empty" else f

    mine, theirs = str(tmp_path / "port.csv"), str(tmp_path / "ref.csv")
    assert make(port_frame).to_csv(mine) is None
    assert make(ref_frame).to_csv(theirs) is None
    with open(mine) as a, open(theirs) as b:
        text = a.read()
        assert text == b.read()
    assert text == make(port_frame).to_csv()


def test_groupby_keeps_the_references_order_on_ties():
    """Equal keys keep their input order inside a group (a stable sort),
    so ``first`` / ``last`` name the same rows as the reference's."""
    cols = {NAME: np.asarray(["b", "a", "b", "a", "b"]),
            "v": np.asarray([5.0, 4.0, 3.0, 2.0, 1.0])}
    got = port_frame.EventFrame(dict(cols)).groupby_agg(
        NAME, {"v": "first"})
    want = ref_frame.EventFrame(dict(cols)).groupby_agg(
        NAME, {"v": "first"})
    _same(got, want, "ties")
    assert np.asarray(got["v"]).tolist() == [4.0, 5.0]


def test_unknown_aggregation_raises_as_the_reference():
    for mod in (port_frame, ref_frame):
        with pytest.raises(ValueError, match="unknown agg 'count'"):
            _frame(mod).groupby_agg(NAME, {"x": "count"})
