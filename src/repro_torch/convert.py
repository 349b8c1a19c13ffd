"""Carry a trace across from the reference package.

A reference ``EventFrame`` (:class:`repro.core.frame.EventFrame`) goes in
as plain NumPy: its columns and its category tables.  The port never
imports the reference; the caller takes the arrays out::

    columns = {c: np.asarray(ev.column(c).codes
                             if c in cats else ev.column(c))
               for c in ev.columns}
    categories = {c: list(ev.column(c).categories) for c in cats}

Data takes the place of weights in this system: this is how the tests
feed one trace to both packages.  Model weights go across the same way
(:func:`params_from_jax`): the reference's ``LM.init`` tree as NumPy
arrays in, the port's ``LM`` state dict out.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .core.frame import Categorical, EventFrame
from .models.config import ModelConfig

__all__ = ["events_from_columns", "params_from_jax"]


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


def _tensor(x) -> torch.Tensor:
    """A NumPy array as a tensor; NumPy's bfloat16 (ml_dtypes) goes across
    bit for bit."""
    a = np.ascontiguousarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(tree: Dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The port's ``LM`` state dict for a reference ``LM.init`` parameter
    tree given as NumPy arrays (``jax.tree_util.tree_map(np.asarray,
    params)``).  Top-level leaves keep their names; each ``blocks`` leaf
    ``[n_layers, ...]`` is unstacked into ``layers.<i>.<name>``.  Every
    matrix keeps the reference's ``[in, out]`` layout, as the port's
    layers use it.  Trees with a gemma3-style period or a ``tail`` / meta
    stack raise: those layers are not ported yet."""
    extra = set(tree) - {"embed", "final_ln", "unembed", "blocks"}
    if extra:
        raise NotImplementedError(
            f"parameters {sorted(extra)} belong to layers not yet ported to "
            f"repro_torch (ROADMAP.md §A)")
    out = {k: _tensor(tree[k]) for k in ("embed", "final_ln", "unembed")
           if k in tree}
    for name, arr in tree["blocks"].items():
        arr = np.asarray(arr)
        if arr.ndim < 2 or arr.shape[0] != cfg.n_layers:
            raise ValueError(f"blocks/{name}: leading axis {arr.shape} is "
                             f"not n_layers = {cfg.n_layers}")
        for i in range(cfg.n_layers):
            out[f"layers.{i}.{name}"] = _tensor(arr[i])
    return out
