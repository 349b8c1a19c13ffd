"""The port's synthetic LM stream against the reference's on the CPU.

``repro_torch.data.SyntheticLMStream.batch_at`` must give the bits of
``repro.data.SyntheticLMStream.batch_at`` for every step, seed, shape and
``structured`` setting (a restart re-seeks by step, so a batch is a pure
function of them); iteration yields consecutive steps; ``seek(step)``
makes the next batch ``batch_at(step)``.  The reference's ``seek`` skips
forward from step 0 and gives the same batch from step 2 on; at
``seek(1)`` it yields batch 0 again (ROADMAP §C), so that case is held
to ``batch_at(1)`` alone.
"""

import numpy as np
import pytest

from repro.data import SyntheticLMStream as JaxStream
from repro_torch.data import SyntheticLMStream


@pytest.mark.parametrize("structured", [True, False])
@pytest.mark.parametrize("seed,vocab,batch,seq", [
    (0, 512, 4, 16), (7, 32000, 3, 33), (123, 97, 2, 5)])
def test_batch_at_gives_the_reference_bits(seed, vocab, batch, seq,
                                           structured):
    ours = SyntheticLMStream(vocab, batch, seq, seed=seed,
                             structured=structured)
    ref = JaxStream(vocab, batch, seq, seed=seed, structured=structured)
    try:
        for step in (0, 1, 2, 12, 999):
            a, b = ours.batch_at(step), ref.batch_at(step)
            assert set(a) == {"tokens", "labels"}
            for key in a:
                assert a[key].dtype == np.int32 == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])
            np.testing.assert_array_equal(a["tokens"][:, 1:],
                                          a["labels"][:, :-1])
            assert a["tokens"].min() >= 0 and a["tokens"].max() < vocab
    finally:
        ours.close()
        ref.close()


def test_iteration_yields_consecutive_steps():
    s = SyntheticLMStream(512, 4, 16, seed=3)
    try:
        for step in range(4):
            b = next(s)
            np.testing.assert_array_equal(b["tokens"],
                                          s.batch_at(step)["tokens"])
    finally:
        s.close()


@pytest.mark.parametrize("step", [0, 1, 2, 5])
def test_seek_makes_the_next_batch_that_step(step):
    s = SyntheticLMStream(512, 4, 16, seed=7)
    ref = JaxStream(512, 4, 16, seed=7)
    try:
        next(s)
        next(s)
        s.seek(step)
        got = next(s)
        np.testing.assert_array_equal(got["tokens"],
                                      s.batch_at(step)["tokens"])
        np.testing.assert_array_equal(got["labels"],
                                      s.batch_at(step)["labels"])
        ref.seek(step)
        want = step if step != 1 else 0     # the reference's seek(1)
        np.testing.assert_array_equal(next(ref)["tokens"],
                                      s.batch_at(want)["tokens"])
        np.testing.assert_array_equal(next(s)["tokens"],
                                      s.batch_at(step + 1)["tokens"])
    finally:
        s.close()
        ref.close()


def test_close_stops_the_producer():
    s = SyntheticLMStream(512, 2, 8, prefetch=1)
    next(s)
    s.close()
    assert not s._thread.is_alive()
