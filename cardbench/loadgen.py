"""The benchmark's traffic.  A mix is a data file, ``traffic/<mix>.json``,
whose ``form`` names its generator, the module ``traffic/<form>.py``, and
whose other keys are that generator's parameters.  A new arrival law,
length law or kind of batch comes as a new form module beside the
others, and a new mix of an existing form as a data file alone.

A form module draws everything from the run's seed, and gives every seed
the same amount of work (the same sizes, in another order), so that the
seed changes which rows are sent, not how much work they are.  It
exposes the functions that the kinds it feeds call: a training kind
calls ``batch(mix, seed, step, vocab)``, step ``step``'s ``tokens`` and
``labels`` as int64 arrays [rows, length].
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict

import numpy as np

HERE = Path(__file__).resolve().parent
TRAFFIC = HERE / "traffic"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
_FORMS: Dict[str, ModuleType] = {}


def load(name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad traffic mix name {name!r}")
    return json.loads((TRAFFIC / f"{name}.json").read_text())


def form(mix: dict) -> ModuleType:
    """The generator module that the mix's ``form`` names, loaded once."""
    name = mix["form"]
    if name in _FORMS:
        return _FORMS[name]
    if not NAME.match(name) or "." in name:
        raise ValueError(f"bad traffic form name {name!r}")
    path = TRAFFIC / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no traffic form {name!r} ({path.name})")
    spec = importlib.util.spec_from_file_location(
        f"cardbench.traffic.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _FORMS[name] = mod
    return mod


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one stream of draws of a run: the seed (any whole
    number; folded into 63 bits) and the stream's own numbers."""
    return np.random.default_rng([seed % (1 << 63), *stream])


def batch(mix: dict, seed: int, step: int, vocab: int
          ) -> Dict[str, np.ndarray]:
    """Step ``step``'s training batch of the mix's form."""
    return form(mix).batch(mix, seed, step, vocab)
