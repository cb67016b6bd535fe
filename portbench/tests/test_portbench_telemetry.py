"""The readers of the engine's own records (``repro_torch.serve.telemetry``):
``prefill_pad_pct`` and ``masked_decode_pct`` against what is worked out by
hand from the served prompts and their buckets on a tiny CPU cell driven by
:class:`pb.loop.Window` with a real engine, the other readers finite there,
and all four None with
the scripted fake engine (which keeps no records) and without the module
(a program that predates it)."""
from __future__ import annotations

import math
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from conftest import TINY_CHAT, TINY_DENSE
from test_portbench_timeline import FakeEngine, fake  # noqa: F401  (a fixture)

from pb import loop, spec
from pb.traffic import Req

torch.set_num_threads(1)

READERS = ("prefill_pad_pct", "prefill_wall_p50_ms", "masked_decode_pct", "decode_host_ms")
LENS = (5, 9, 3, 12, 7, 16)
GAP_S = 0.1


def _bucket(L: int) -> int:
    return max(4, 1 << (L - 1).bit_length())


@pytest.fixture(scope="module")
def served():
    """A window over requests spaced apart, on a warmed engine: (timeline,
    slots)."""
    from repro_torch.models import Model
    from repro_torch.serve.telemetry import TELEMETRY
    TELEMETRY.clear()
    torch.manual_seed(0)
    model = Model(spec.model_config(TINY_DENSE).replace(use_kernels=False))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    eng = loop.make_engine(model, params, TINY_CHAT, torch.device("cpu"))
    loop.warm_up(eng, TINY_CHAT, model.cfg.vocab, 0)
    rng = np.random.default_rng(5)
    reqs = [Req(i, rng.integers(0, 128, L).astype(np.int32), 4, GAP_S * (i + 1))
            for i, L in enumerate(LENS)]
    tl = loop.Window(eng, reqs, TINY_CHAT, GAP_S * len(LENS) + 0.5).run()
    return tl, int(TINY_CHAT["engine"]["slots"])


def _read(name, tl):
    return spec.metric_reader(name)(SimpleNamespace(tl=tl))


def _admissions(tl):
    """By hand, from the served prompts: each admitting step's requests
    share one prefill group (a tiny cell's buckets always fit the cache)
    at the bucket of the longest, and each member's pad width."""
    by_step = {}
    for s in tl.finished():
        by_step.setdefault(s.admit_step, []).append(s)
    pads = {s.index: _bucket(max(m.prompt_len for m in members)) - s.prompt_len
            for members in by_step.values() for s in members}
    return by_step, pads


def _ended_inside(tl, step):
    lo, hi = tl.window
    return lo <= tl.step_ends[step] <= hi


def test_pad_share_is_the_served_prompts_against_their_buckets(served):
    tl, slots = served
    by_step, _ = _admissions(tl)
    inside = [m for k, m in by_step.items() if _ended_inside(tl, k)]
    assert inside
    real = sum(s.prompt_len for m in inside for s in m)
    padded = sum(slots * _bucket(max(s.prompt_len for s in m)) for m in inside)
    assert _read("prefill_pad_pct", tl) == pytest.approx(100.0 * (1.0 - real / padded))


@pytest.mark.parametrize("name", READERS[1:])
def test_the_other_readers_are_finite(served, name):
    value = _read(name, served[0])
    assert value is not None and math.isfinite(value) and value >= 0.0


def test_masked_share_is_the_steps_with_a_padded_slot(served):
    """A decode step is masked when any live slot carries pads."""
    tl, _ = served
    _, pads = _admissions(tl)
    live = {}
    for s in tl.finished():
        for k in range(s.admit_step, s.done_step):
            live.setdefault(k, []).append(pads[s.index])
    inside = [k for k in live if _ended_inside(tl, k)]
    masked = sum(1 for k in inside if any(live[k]))
    assert inside
    assert _read("masked_decode_pct", tl) == pytest.approx(100.0 * masked / len(inside))


def test_host_time_leaves_out_admissions_and_traced_steps(monkeypatch):
    """``decode_host_ms`` by hand on records made up for the window
    (0, 10): a step's length less its decode wait, over the decode-only
    steps that ended inside the window before a profiler first recorded
    one."""
    from repro_torch.serve import telemetry
    log = telemetry.ServeTelemetry()
    monkeypatch.setattr(telemetry, "TELEMETRY", log)

    def step(t0, length, wait, rows=3, prefill=0, profiled=False):
        s = telemetry.StepRecord(t0, profiled)
        s.t1, s.t_launch, s.t_synced = t0 + length, t0 + 0.001, t0 + 0.001 + wait
        s.decode_rows, s.prefill_tokens, s.prompt_tokens = rows, prefill, prefill // 16
        log.step_log.append(s)

    step(1.0, 0.050, 0.045)                    # 5 ms of host
    step(2.0, 0.047, 0.045)                    # 2 ms
    step(3.0, 2.000, 0.045, prefill=16 * 1024)     # an admission
    step(6.0, 0.060, 0.045, profiled=True)     # traced: the profiler's cost
    step(7.0, 0.040, 0.040, rows=0)            # nothing decoded
    step(8.0, 0.048, 0.045)                    # after the trace: still the profiler's
    step(9.99, 0.050, 0.010)                   # ends after the window closes
    tl = SimpleNamespace(window=(0.0, 10.0))
    assert _read("decode_host_ms", tl) == pytest.approx(3.5)
    assert _read("masked_decode_pct", tl) == pytest.approx(0.0)
    log.step_log[3].profiled = False                # an untraced run: every step counts
    assert _read("decode_host_ms", tl) == pytest.approx((5 + 2 + 15 + 3) / 4)
    assert _read("prefill_pad_pct", tl) == pytest.approx(100.0 * (1 - 1 / 16))


def test_ttft_leaves_out_requests_served_once_a_profiler_recorded(monkeypatch):
    """``ttft_p50_ms.chat`` by hand: due time to the end of the admitting
    step, over the requests whose first token came before the first step
    a profiler recorded; in an untraced run, over every request."""
    from pb.timeline import Served, Timeline
    from repro_torch.serve import telemetry
    log = telemetry.ServeTelemetry()
    monkeypatch.setattr(telemetry, "TELEMETRY", log)
    traced = telemetry.StepRecord(6.0, True)
    traced.t1 = 6.05
    log.step_log.append(traced)
    ends = [1.0, 1.1, 2.0, 2.1, 6.05, 8.0, 8.2]
    served = [Served(0, 0.95, 4, 2, 1, [1, 2]), Served(1, 1.9, 4, 2, 3, [1, 2]),
              Served(2, 7.6, 4, 2, 6, [1, 2])]
    ctx = SimpleNamespace(tl=Timeline(ends, served, (0.0, 10.0)), trace=object())
    read = spec.metric_reader("ttft_p50_ms.chat")
    assert read(ctx) == pytest.approx(75.0)
    traced.profiled = False
    assert read(ctx) == pytest.approx(100.0)


@pytest.mark.parametrize("name", READERS)
def test_none_with_the_fake_engine(fake, name):  # noqa: F811
    from repro_torch.serve.telemetry import TELEMETRY
    TELEMETRY.clear()
    rng = np.random.default_rng(3)
    reqs = [Req(i, np.zeros(int(rng.integers(3, 9)), np.int32), 3, 0.05 * (i + 1))
            for i in range(12)]
    tl = loop.Window(FakeEngine(fake, 4), reqs, {"engine": {"slots": 4}}, 0.7).run()
    assert len(tl.finished()) == 12
    assert _read(name, tl) is None


@pytest.mark.parametrize("name", READERS)
def test_none_without_the_telemetry_module(served, monkeypatch, name):
    monkeypatch.setitem(sys.modules, "repro_torch.serve.telemetry", None)
    assert _read(name, served[0]) is None
