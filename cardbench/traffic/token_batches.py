"""Form ``token_batches``: training batches of ``batch`` rows of ``seq``
tokens, ids uniform over the vocabulary.  Step i's rows come from
(seed, i), and the labels are the tokens shifted by one."""

from typing import Dict

import numpy as np

from cardbench.loadgen import rng


def batch(mix: dict, seed: int, step: int, vocab: int
          ) -> Dict[str, np.ndarray]:
    rows = rng(seed, 1, step).integers(
        0, vocab, size=(mix["batch"], mix["seq"] + 1), dtype=np.int64)
    return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
