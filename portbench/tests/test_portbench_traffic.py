"""The one generator: deterministic by seed, a sample path of its own for
every seed, drawn from the distributions its file states."""
from __future__ import annotations

import json
import math
from statistics import NormalDist

import numpy as np
import pytest

from conftest import BENCH, TINY_CHAT
from pb import traffic as tr

FILES = sorted((BENCH / "traffic").glob("*.json"))
SEEDS = [1, 2 ** 40 + 2, 2 ** 31 + 7]


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.stem)
def test_same_seed_same_requests(path):
    t = json.loads(path.read_text())
    a = tr.make_requests(t, 30, 2 ** 33 + 17, 1000)
    b = tr.make_requests(t, 30, 2 ** 33 + 17, 1000)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.max_new == y.max_new and x.offset_s == y.offset_s
        assert np.array_equal(x.prompt, y.prompt)


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.stem)
def test_each_seed_draws_its_own_path(path):
    """Another seed: other sizes, in another order, at other times."""
    t = json.loads(path.read_text())
    a = tr.make_requests(t, 51, 1, 1000)
    b = tr.make_requests(t, 51, 2 ** 40 + 2, 1000)
    assert len(a) == len(b)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    assert [r.max_new for r in a] != [r.max_new for r in b]
    assert [r.offset_s for r in a] != [r.offset_s for r in b]
    assert len({len(r.prompt) for r in a}) > 5      # the sizes are spread


def _cdf(p, x):
    return NormalDist().cdf((math.log(x) - math.log(p["median"])) / p["sigma"])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("path", FILES, ids=lambda p: p.stem)
def test_one_draw_in_each_stratum(path, seed):
    """Sorted, the i-th of n sizes lies in the i-th of n equal-probability
    strata of its clipped lognormal (to rounding to whole tokens)."""
    t = json.loads(path.read_text())
    reqs = tr.make_requests(t, 51, seed, 1000)
    n = len(reqs)
    for key, sizes in (("prompt", [len(r.prompt) for r in reqs]),
                       ("output", [r.max_new for r in reqs])):
        p = t[key]
        for i, x in enumerate(sorted(sizes)):
            if p["min"] < x < p["max"]:
                assert _cdf(p, x + 0.5) >= i / n - 1e-9 and _cdf(p, x - 0.5) <= (i + 1) / n


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.stem)
def test_matches_its_file(path):
    t = json.loads(path.read_text())
    reqs = tr.make_requests(t, 40, 9, 256000)
    p, o = t["prompt"], t["output"]
    lens = np.array([len(r.prompt) for r in reqs])
    outs = np.array([r.max_new for r in reqs])
    assert lens.min() >= p["min"] and lens.max() <= p["max"]
    assert outs.min() >= o["min"] and outs.max() <= o["max"]
    assert abs(np.median(lens) - p["median"]) <= 0.1 * p["median"]
    assert abs(np.median(outs) - o["median"]) <= 0.15 * o["median"]
    assert all(r.prompt.min() >= 0 and r.prompt.max() < 256000 for r in reqs)
    assert p["max"] + o["max"] <= t["engine"]["max_len"]
    assert len(reqs) == round(t["rate_rps"] * 40)
    due = [r.offset_s for r in reqs]
    assert due == sorted(due) and 0 < due[0] and due[-1] < 40
    assert abs(np.mean(np.diff([0.0] + due)) - 1 / t["rate_rps"]) < 0.1 / t["rate_rps"]


def test_gaps_are_exponential():
    """Pooled over seeds, the gaps over their mean spread as an
    exponential's: coefficient of variation 1, a median of ln 2."""
    g = []
    for seed in range(40):
        due = [r.offset_s for r in tr.make_requests(TINY_CHAT, 2.0, seed, 50)]
        gaps = np.diff([0.0] + due)
        g += list(gaps / gaps.mean())
    g = np.array(g)
    assert abs(g.std() - 1.0) < 0.1 and abs(np.median(g) - math.log(2)) < 0.1


def test_buckets_cover_every_prefill_shape():
    t = {"prompt": {"min": 64, "max": 2048}}
    assert tr.prefill_buckets(t) == [64, 128, 256, 512, 1024, 2048]
    t = {"prompt": {"min": 1024, "max": 3584}}
    assert tr.prefill_buckets(t) == [1024, 2048, 3584]
    t = {"prompt": {"min": 3, "max": 24}}
    assert tr.prefill_buckets(t) == [3, 4, 8, 16, 24]


def test_rate_override_and_large_seed():
    t = json.loads(FILES[0].read_text())
    assert len(tr.make_requests(t, 10, 2 ** 62 + 1, 50, rate=3.0)) == 30


def test_only_open_loop_arrivals():
    with pytest.raises(ValueError):
        tr.make_requests(dict(TINY_CHAT, arrival="backlog"), 1.0, 1, 50)
