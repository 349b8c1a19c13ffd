"""The traffic: a mix names its form, a generator module found by name;
the same seed gives the same mix, every seed the same sizes."""

import json
from pathlib import Path

import numpy as np
import pytest

from cardbench import loadgen

SEEDS = (0, 7, 2**31 + 5, 9_007_199_254_740_993)
MIXES = sorted(p.stem for p in (Path(loadgen.__file__).parent / "traffic")
               .glob("*.json"))


@pytest.mark.parametrize("seed", SEEDS)
def test_token_batches_repeat_and_differ(seed):
    mix = loadgen.load("train-4x2048")
    a = loadgen.batch(mix, seed, 3, 1000)
    b = loadgen.batch(mix, seed, 3, 1000)
    c = loadgen.batch(mix, seed, 4, 1000)
    assert a["tokens"].shape == (4, 2048) == a["labels"].shape
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert 0 <= a["tokens"].min() and a["tokens"].max() < 1000
    assert len({r.tobytes() for r in a["tokens"]}) == 4


@pytest.mark.parametrize("name", MIXES)
def test_every_mix_names_a_form_that_draws_it(name):
    mix = loadgen.load(name)
    assert set(mix) >= {"form", "why"}
    mod = loadgen.form(mix)
    assert mod is loadgen.form(mix)            # loaded once a process
    a = loadgen.batch(mix, 2**31 + 9, 0, 92416)
    b = loadgen.batch(mix, 2**31 + 10, 0, 92416)
    assert a["tokens"].shape == b["tokens"].shape
    assert not np.array_equal(a["tokens"], b["tokens"])


def test_a_new_form_comes_as_new_files(tmp_path, monkeypatch):
    (tmp_path / "ramp.py").write_text(
        "import numpy as np\n"
        "def batch(mix, seed, step, vocab):\n"
        "    t = np.arange(mix['seq'], dtype=np.int64) % vocab\n"
        "    t = np.stack([t] * mix['batch'])\n"
        "    return {'tokens': t, 'labels': t}\n")
    (tmp_path / "ramp-2x8.json").write_text(json.dumps(
        {"form": "ramp", "batch": 2, "seq": 8, "why": "a test"}))
    monkeypatch.setattr(loadgen, "TRAFFIC", tmp_path)
    monkeypatch.setattr(loadgen, "_FORMS", {})
    got = loadgen.batch(loadgen.load("ramp-2x8"), 1, 0, 5)
    np.testing.assert_array_equal(got["tokens"][1], [0, 1, 2, 3, 4, 0, 1, 2])


@pytest.mark.parametrize("name", ["nowhere", "../harness", "a.b"])
def test_an_unknown_or_bad_form_is_refused(name):
    with pytest.raises(ValueError):
        loadgen.form({"form": name})
