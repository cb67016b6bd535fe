"""TTFT, TPOT, the gaps between tokens, their quantiles and tok_s worked out from the step ends of a
scripted fake engine, against the times the fake knows it delivered."""
from __future__ import annotations

from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest

from pb import loop, timeline
from pb.traffic import Req


class Clock:
    def __init__(self):
        self.t = 1000.0

    def perf_counter(self):
        return self.t

    def sleep(self, s):
        self.t += max(0.0, s)


class FakeEngine:
    """ServeEngine's step order: admit into free slots (a prefill costing
    ``prefill_s``, which hands out token 1), hand every live request its
    pending token and retire the finished, then one decode (``decode_s``).
    Records the true delivery time of every token."""

    def __init__(self, clock, slots, prefill_s=0.05, decode_s=0.01):
        self.clock, self.slots = clock, slots
        self.prefill_s, self.decode_s = prefill_s, decode_s
        self.pending, self.live = deque(), []
        self.delivered = {}
        self.decodes = 0

    @property
    def graph_stats(self):
        return {"decodes": self.decodes}

    @property
    def has_work(self):
        return bool(self.pending or self.live)

    def submit(self, *reqs):
        self.pending.extend(reqs)

    def step(self):
        admits = []
        while self.pending and len(self.live) + len(admits) < self.slots:
            admits.append(self.pending.popleft())
        if admits:
            self.clock.t += self.prefill_s
            for r in admits:
                self.live.append(SimpleNamespace(r=r, tokens=[], prefill_s=self.prefill_s / len(admits),
                                                 decode_s=0.0))
        done, deliver = [], []
        for s in list(self.live):
            s.tokens.append(len(s.tokens) + 7)
            deliver.append(s)
            if len(s.tokens) >= s.r.max_new_tokens:
                self.live.remove(s)
                done.append(SimpleNamespace(rid=s.r.rid, tokens=s.tokens,
                                            prefill_s=s.prefill_s, decode_s=s.decode_s))
        if self.live:
            self.clock.t += self.decode_s
            self.decodes += 1
            for s in self.live:
                s.decode_s += self.decode_s / len(self.live)
        for s in deliver:       # a token reaches its user when the step ends
            self.delivered.setdefault(s.r.rid, []).append(self.clock.t)
        return done


@pytest.fixture
def fake(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(loop, "time", clock)
    import repro_torch.serve as serve
    monkeypatch.setattr(serve, "Request", lambda rid, prompt, max_new_tokens: SimpleNamespace(
        rid=rid, prompt=prompt, max_new_tokens=max_new_tokens))
    return clock


def _reqs(n, rate, rng):
    due = np.cumsum(rng.exponential(1 / rate, n))
    return [Req(i, np.zeros(int(rng.integers(3, 9)), np.int32), int(rng.integers(2, 12)),
                float(due[i])) for i in range(n)]


@pytest.mark.parametrize("rate,slots", [(5.0, 4), (40.0, 2), (80.0, 8)])
def test_reconstructed_times_equal_the_true_ones(fake, rate, slots):
    rng = np.random.default_rng(int(rate) + slots)
    reqs = _reqs(60, rate, rng)
    eng = FakeEngine(fake, slots)
    traffic = {"arrival": "poisson", "engine": {"slots": slots}}
    w = loop.Window(eng, reqs, traffic, reqs[-1].offset_s + 0.01)
    tl = w.run()
    assert len(tl.finished()) == 60 and w.decodes == eng.decodes
    ends = tl.step_ends
    for s in tl.finished():
        true = eng.delivered[s.index]
        got = [ends[k] for k in range(s.admit_step, s.done_step + 1)]
        assert got == pytest.approx(true)
    ttft = sorted(eng.delivered[s.index][0] - s.due for s in tl.finished())
    assert sorted(tl.ttft_s()) == pytest.approx(ttft)
    tpot = sorted((d[-1] - d[0]) / (len(d) - 1) for d in eng.delivered.values())
    assert sorted(tl.tpot_s()) == pytest.approx(tpot)
    lo, hi = tl.window
    inside = sum(lo <= t <= hi for d in eng.delivered.values() for t in d)
    assert tl.tokens_in_window() == inside
    summary = tl.summary()
    assert summary["tok_s"] == pytest.approx(inside / (hi - lo))
    assert summary["ttft_p90_ms"] == pytest.approx(np.percentile(ttft, 90) * 1e3)
    assert summary["tpot_p90_ms"] == pytest.approx(np.percentile(tpot, 90) * 1e3)
    itl = [b - a for d in eng.delivered.values() for a, b in zip(d, d[1:])]
    assert sorted(tl.itl_s()) == pytest.approx(sorted(itl))
    assert summary["itl_p50_ms"] == pytest.approx(np.percentile(itl, 50) * 1e3)
    assert summary["ttft_p50_ms"] == pytest.approx(np.percentile(ttft, 50) * 1e3)
    live = tl.live_per_step()
    assert int((live > 0).sum()) == eng.decodes


def test_quantile_is_numpys_linear_rule():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100):
        x = rng.normal(size=n).tolist()
        for q in (0.5, 0.9, 0.95):
            assert timeline.quantile(x, q) == pytest.approx(np.percentile(x, 100 * q))


def test_queue_depth():
    served = [timeline.Served(i, due, 4, 2, done_step=i + 1, tokens=[1, 2])
              for i, due in enumerate([0.0, 0.1, 0.2])]
    tl = timeline.Timeline([0.5, 1.0, 1.5, 2.0], served, (0.0, 2.0))
    # admitted at steps 0, 1, 2 (ends 0.5, 1.0, 1.5)
    assert tl.queue_at(0.3) == 3 and tl.queue_at(1.0) == 1 and tl.queue_at(2.0) == 0
