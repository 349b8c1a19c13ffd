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
arrays in, the port's ``LM`` state dict out; and an optimizer state
(:func:`adamw_state_from_jax`), so both packages resume from one state.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .core.frame import Categorical, EventFrame
from .models.config import ModelConfig
from .optim import AdamWState

__all__ = ["events_from_columns", "params_from_jax",
           "adamw_state_from_jax"]


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


def _layer_plan(cfg: ModelConfig):
    """(period, n_periods, tail length) of the reference's stacking: a
    gemma3-style config stacks ``[n_periods, period, ...]`` blocks and a
    tail, every other config ``[n_layers, ...]``."""
    if cfg.global_every:
        n_periods = cfg.n_layers // cfg.global_every
        return (cfg.global_every, n_periods,
                cfg.n_layers - n_periods * cfg.global_every)
    return 1, cfg.n_layers, 0


def params_from_jax(tree: Dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The port's ``LM`` state dict for a reference ``LM.init`` parameter
    tree given as NumPy arrays (``jax.tree_util.tree_map(np.asarray,
    params)``).  Top-level leaves (``embed``, ``final_ln``, ``unembed``,
    ``meta``; the encoder-decoder's ``frontend`` and ``enc_ln``) keep
    their names; each ``blocks`` leaf is unstacked into
    ``layers.<i>.<name>``: ``[n_layers, ...]``, or with a gemma3-style
    period ``[n_periods, period, ...]`` to layer ``n * period + i``; each
    ``tail`` leaf ``[n_tail, ...]`` goes to the last layers, and each
    ``enc_blocks`` leaf ``[enc_layers, ...]`` to ``enc_layers.<i>.<name>``.
    Every matrix keeps the reference's ``[in, out]`` layout, as the port's
    layers use it."""
    top = ("embed", "final_ln", "unembed", "meta", "frontend", "enc_ln")
    extra = set(tree) - set(top) - {"blocks", "tail", "enc_blocks"}
    if extra:
        raise ValueError(f"parameters {sorted(extra)} belong to no layer "
                         f"of the port's models")
    period, n_periods, n_tail = _layer_plan(cfg)
    out = {k: _tensor(tree[k]) for k in top if k in tree}
    for name, arr in tree.get("enc_blocks", {}).items():
        arr = np.asarray(arr)
        if arr.shape[0] != cfg.enc_layers:
            raise ValueError(f"enc_blocks/{name}: leading axis {arr.shape} "
                             f"is not {cfg.enc_layers}")
        for i in range(cfg.enc_layers):
            out[f"enc_layers.{i}.{name}"] = _tensor(arr[i])
    lead = (n_periods,) if period == 1 else (n_periods, period)
    for name, arr in tree["blocks"].items():
        arr = np.asarray(arr)
        if arr.shape[:len(lead)] != lead or arr.ndim <= len(lead):
            raise ValueError(f"blocks/{name}: leading axes {arr.shape} are "
                             f"not {lead}")
        flat = arr.reshape((n_periods * period,) + arr.shape[len(lead):])
        for i in range(n_periods * period):
            out[f"layers.{i}.{name}"] = _tensor(flat[i])
    tail = tree.get("tail", {})
    if bool(tail) != bool(n_tail):
        raise ValueError(f"tail of {len(tail)} leaves, {n_tail} tail "
                         f"layers expected")
    for name, arr in tail.items():
        arr = np.asarray(arr)
        if arr.shape[0] != n_tail:
            raise ValueError(f"tail/{name}: leading axis {arr.shape} is "
                             f"not {n_tail}")
        for t in range(n_tail):
            out[f"layers.{n_periods * period + t}.{name}"] = _tensor(arr[t])
    return out


def adamw_state_from_jax(state, cfg: ModelConfig) -> AdamWState:
    """The port's :class:`repro_torch.optim.AdamWState` (CPU tensors) for
    a reference ``AdamWState`` given as NumPy arrays
    (``jax.tree_util.tree_map(np.asarray, state)``, or any object with
    ``step``, ``m`` and ``v``): each moment tree goes across as
    :func:`params_from_jax` carries the parameters, the step as an int."""
    return AdamWState(step=int(np.asarray(state.step)),
                      m=params_from_jax(state.m, cfg),
                      v=params_from_jax(state.v, cfg))
