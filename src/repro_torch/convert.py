"""Carry a trace across from the reference package.

A reference ``EventFrame`` (:class:`repro.core.frame.EventFrame`) goes in
as plain NumPy: its columns and its category tables.  The port never
imports the reference; the caller takes the arrays out::

    columns = {c: np.asarray(ev.column(c).codes
                             if c in cats else ev.column(c))
               for c in ev.columns}
    categories = {c: list(ev.column(c).categories) for c in cats}

Data takes the place of weights in this system: this is how the tests
feed one trace to both packages.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .core.frame import Categorical, EventFrame

__all__ = ["events_from_columns"]


def events_from_columns(columns: Dict[str, np.ndarray],
                        categories: Dict[str, List[str]]) -> EventFrame:
    """The port's frame for a reference frame's columns: a column named in
    ``categories`` holds int codes into that table (a dictionary-encoded
    string column); every other column is copied as it is."""
    ev = EventFrame()
    for name, values in columns.items():
        if name in categories:
            ev[name] = Categorical.from_codes(np.asarray(values, np.int32),
                                              list(categories[name]))
        else:
            ev[name] = np.array(values, copy=True)
    return ev
