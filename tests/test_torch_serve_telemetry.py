"""The continuous serving loop's own records and spans
(``repro_torch/serve/telemetry.py``), on the CPU at a tiny fp32 dense
size: padded and real prefill tokens, masked and unmasked decodes, the
order of each step's and request's times, the spans' nesting under
``torch.profiler``, no span without a profiler, and the logs' bound."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import Model
from repro_torch.serve import Request, ServeConfig, ServeEngine, telemetry
from repro_torch.serve.telemetry import TELEMETRY, ServeTelemetry

torch.set_num_threads(1)      # six test workers share the CPU

SLOTS, MAX_LEN = 4, 64


@pytest.fixture(scope="module")
def model_params():
    model = Model(get_smoke_config("minitron-4b").replace(
        param_dtype="float32", compute_dtype="float32"))
    return model, model.init(torch.Generator().manual_seed(0), device="cpu")


@pytest.fixture
def engine(model_params):
    TELEMETRY.clear()
    model, params = model_params
    return ServeEngine(model, params, ServeConfig(batch=SLOTS, max_len=MAX_LEN),
                       device="cpu")


def _prompt(rid: int, L: int):
    return np.random.default_rng(rid).integers(1, 128, L).tolist()


def _bucket(L: int) -> int:
    return max(4, 1 << (L - 1).bit_length())


def test_prefill_tokens_are_rows_times_bucket(engine):
    """One request at a time, each its own group at its own bucket; then
    two at once, one group at the longer one's bucket."""
    lens = (5, 9, 3, 12, 7)
    for rid, L in enumerate(lens):
        engine.submit(Request(rid, _prompt(rid, L), max_new_tokens=3))
        engine.drain()
    engine.submit(Request(10, _prompt(10, 5), max_new_tokens=3),
                  Request(11, _prompt(11, 12), max_new_tokens=3))
    engine.drain()
    steps = list(TELEMETRY.step_log)
    assert sum(s.prefill_tokens for s in steps) == SLOTS * (
        sum(_bucket(L) for L in lens) + _bucket(12))
    assert sum(s.prompt_tokens for s in steps) == sum(lens) + 5 + 12
    admitting = [s for s in steps if s.prefill_tokens]
    assert [(s.prefill_tokens, s.prompt_tokens) for s in admitting] == [
        (SLOTS * _bucket(L), L) for L in lens] + [(SLOTS * 16, 17)]
    assert {r.rid: (r.prompt_len, r.padded_len) for r in TELEMETRY.request_log} == {
        **{rid: (L, _bucket(L)) for rid, L in enumerate(lens)}, 10: (5, 16), 11: (12, 16)}


@pytest.mark.parametrize("L,masked", [(8, False), (5, True)])
def test_a_padded_slot_takes_the_masked_decode(engine, L, masked):
    decodes0 = engine.graph_stats["decodes"]
    engine.submit(Request(0, _prompt(0, L), max_new_tokens=6))
    engine.drain()
    decoded = [s for s in TELEMETRY.step_log if s.decode_rows]
    assert decoded and all(s.masked is masked for s in decoded)
    assert all(s.decode_rows == 1 for s in decoded)
    n_masked = sum(s.masked for s in decoded)
    assert n_masked + (len(decoded) - n_masked) == \
        engine.graph_stats["decodes"] - decodes0 == 5


def test_masked_and_unmasked_steps_add_up_to_the_decodes(engine):
    """A power-of-two prompt alone decodes unmasked; once a ragged one
    joins, every step is masked until it leaves."""
    decodes0 = engine.graph_stats["decodes"]
    engine.submit(Request(0, _prompt(0, 8), max_new_tokens=12))
    engine.step()
    engine.step()
    engine.submit(Request(1, _prompt(1, 5), max_new_tokens=4))
    engine.drain()
    decoded = [s for s in TELEMETRY.step_log if s.decode_rows]
    flags = [s.masked for s in decoded]
    assert flags == [False, False, True, True, True] + [False] * 6
    assert [s.decode_rows for s in decoded] == [1, 1, 2, 2, 2] + [1] * 6
    assert len(decoded) == engine.graph_stats["decodes"] - decodes0


def test_times_are_ordered_within_each_step(engine):
    lens = (5, 9, 3, 12, 7, 6)
    for rid, L in enumerate(lens):
        engine.submit(Request(rid, _prompt(rid, L), max_new_tokens=2 + rid))
        engine.step()
    engine.drain()
    steps = list(TELEMETRY.step_log)
    reqs = list(TELEMETRY.request_log)
    assert sorted(r.rid for r in reqs) == list(range(len(lens)))
    for s in steps:
        assert s.t0 <= s.t1
        if s.decode_rows:
            assert s.t0 <= s.t_launch <= s.t_synced <= s.t1
        else:
            assert np.isnan(s.t_launch) and np.isnan(s.t_synced)
    for r in reqs:
        # admitted and handed its first token in one step
        (s,) = [s for s in steps if s.t0 <= r.t_admit <= s.t1]
        assert s.prefill_tokens and s.t0 <= r.t_admit <= r.t_first <= s.t1
    for a, b in zip(steps, steps[1:]):
        assert a.t1 <= b.t0


SPANS = {"serve.step", "serve.prefill", "serve.insert", "serve.wait", "serve.retire",
         "serve.decode", "serve.decode.eager", "serve.sample"}


class _Recorder:
    """Stands in for ``record_function``: counts and records each span's
    name and args, and opens the real one."""

    def __init__(self):
        self.calls = []
        self.real = telemetry.record_function

    def __call__(self, name, args=None):
        self.calls.append((name, args))
        return self.real(name, args)


def test_spans_nest_inside_the_step_and_carry_the_rids(engine, monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(telemetry, "record_function", rec)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.submit(Request(3, _prompt(3, 5), max_new_tokens=3),
                      Request(4, _prompt(4, 9), max_new_tokens=3))
        engine.drain()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("serve.")]
    assert {n for n, _, _ in events} == SPANS
    assert len(TELEMETRY.step_log) == 3 and all(s.profiled for s in TELEMETRY.step_log)
    steps = [(s, e) for n, s, e in events if n == "serve.step"]
    assert len(steps) == 3
    for n, s, e in events:
        if n != "serve.step":
            assert any(s0 <= s and e <= e0 for s0, e0 in steps), n
    decodes = [(s, e) for n, s, e in events if n == "serve.decode"]
    for n, s, e in events:
        if n == "serve.decode.eager":
            assert any(s0 <= s and e <= e0 for s0, e0 in decodes)
    (prefill,) = [a for n, a in rec.calls if n == "serve.prefill"]
    assert prefill == f"rids=[4, 3] rows={SLOTS} padded_len=16"
    assert [a for n, a in rec.calls if n == "serve.step"] == ["step=0", "step=1", "step=2"]
    # the decode lists its live rows in slot order
    assert [a for n, a in rec.calls if n == "serve.decode"] == ["rids=[3, 4] masked=True"] * 2


def test_no_span_without_a_profiler_and_the_same_tokens(engine, model_params, monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(telemetry, "record_function", rec)
    reqs = [Request(rid, _prompt(rid, L), max_new_tokens=5)
            for rid, L in enumerate((5, 9, 3, 12, 7))]
    off = engine.serve(reqs)
    assert rec.calls == [] and len(TELEMETRY.step_log) > 0
    assert not any(s.profiled for s in TELEMETRY.step_log)
    from torch.profiler import ProfilerActivity, profile
    model, params = model_params
    again = ServeEngine(model, params, ServeConfig(batch=SLOTS, max_len=MAX_LEN),
                        device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        on = again.serve(reqs)
    assert rec.calls
    assert {rid: r.tokens for rid, r in on.items()} == {rid: r.tokens for rid, r in off.items()}


def test_the_gate_is_read_once_a_step(engine, monkeypatch):
    """Forced on without a profiler, the gate opens the spans and marks
    each step's record as profiled; it is read once a step."""
    rec = _Recorder()
    monkeypatch.setattr(telemetry, "record_function", rec)
    reads = []
    monkeypatch.setattr(telemetry, "recording", lambda: reads.append(1) or True)
    engine.serve([Request(rid, _prompt(rid, L), max_new_tokens=4)
                  for rid, L in enumerate((5, 9, 3))])
    steps = list(TELEMETRY.step_log)
    assert len(reads) == len(steps) == sum(1 for n, _ in rec.calls if n == "serve.step")
    assert all(s.profiled for s in steps)
    assert {n for n, _ in rec.calls} == SPANS


def _kernel_route_engine(arch: str) -> ServeEngine:
    model = Model(get_smoke_config(arch).replace(
        param_dtype="float32", compute_dtype="float32", use_kernels=True))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    return ServeEngine(model, params, ServeConfig(batch=SLOTS, max_len=MAX_LEN),
                       device="cpu")


@pytest.mark.parametrize("arch", ["minitron-4b", "zamba2-2.7b"])
def test_kernel_route_prefills_each_length_unpadded(arch, monkeypatch):
    """With ``use_kernels`` (their plain versions on the CPU), ragged
    prompts admitted in one step prefill as one group per length, of their
    own rows only: no token of padding, no pad-masked decode and no masked
    decode signature; a retired slot decodes at fill 0."""
    TELEMETRY.clear()
    eng = _kernel_route_engine(arch)
    rec = _Recorder()
    monkeypatch.setattr(telemetry, "record_function", rec)
    monkeypatch.setattr(telemetry, "recording", lambda: True)
    keys = []
    decode = eng._decode
    monkeypatch.setattr(eng, "_decode", lambda key, fn, on=False: keys.append(key) or
                        decode(key, fn, on))
    lens = (5, 9, 5, 12)
    eng.serve([Request(rid, _prompt(rid, L), max_new_tokens=3 + rid)
               for rid, L in enumerate(lens)])
    assert [a for n, a in rec.calls if n == "serve.prefill"] == [
        "rids=[0, 2] rows=2 padded_len=5", "rids=[1] rows=1 padded_len=9",
        "rids=[3] rows=1 padded_len=12"]
    steps = list(TELEMETRY.step_log)
    admitting = [s for s in steps if s.prefill_tokens]
    assert len(admitting) == 1
    assert admitting[0].prefill_tokens == admitting[0].prompt_tokens == sum(lens)
    assert {r.rid: (r.prompt_len, r.padded_len) for r in TELEMETRY.request_log} == {
        rid: (L, L) for rid, L in enumerate(lens)}
    decoded = [s for s in steps if s.decode_rows]
    assert len(decoded) == len(keys) == eng.graph_stats["decodes"] == 5
    assert not any(s.masked for s in decoded)
    assert keys == [("continuous", SLOTS, False)] * 5
    assert all(a.endswith("masked=False") for n, a in rec.calls if n == "serve.decode")
    assert not eng._c_active.any() and not eng._c_pos.any() and not eng._c_pw.any()


def test_wave_mode_records_nothing(model_params):
    TELEMETRY.clear()
    model, params = model_params
    eng = ServeEngine(model, params, ServeConfig(batch=SLOTS, max_len=MAX_LEN, mode="wave"),
                      device="cpu")
    eng.serve([Request(rid, _prompt(rid, L), max_new_tokens=3)
               for rid, L in enumerate((5, 9))])
    assert not TELEMETRY.step_log and not TELEMETRY.request_log


def test_logs_drop_their_oldest_records_at_maxlen():
    assert TELEMETRY.step_log.maxlen == TELEMETRY.request_log.maxlen == telemetry.MAXLEN == 65536
    log = ServeTelemetry(maxlen=3)
    for i in range(5):
        s = telemetry.StepRecord(float(i))
        s.t1 = i + 0.5
        log.step_log.append(s)
        r = telemetry.RequestRecord(i, 4, 4, float(i))
        r.t_first = i + 0.25
        log.request_log.append(r)
    assert [s.t0 for s in log.step_log] == [2.0, 3.0, 4.0]
    assert [r.rid for r in log.request_log] == [2, 3, 4]
    # filtered by where each record ends
    assert [s.t0 for s in log.steps(2.5, 3.5)] == [2.0, 3.0]
    assert [r.rid for r in log.requests(3.0, 4.25)] == [3, 4]
    log.request_log.append(telemetry.RequestRecord(9, 4, 4, 5.0))     # no first token yet
    assert [r.rid for r in log.requests(0.0, 99.0)] == [3, 4]


# ---------------------------------------------------------------------------
# MoE counters and model spans: a tiny DeepSeek-V3 decoder (latent attention,
# one dense layer, two dropless MoE layers of 8 experts, top-2)
# ---------------------------------------------------------------------------
def _deepseek(use_kernels=True):
    from repro_torch.models import DeepSeekMoEConfig, MLAConfig, ModelConfig
    cfg = ModelConfig(
        name="tiny-deepseek", family="moe", n_layers=3, d_model=64, n_heads=4, n_kv=4,
        d_ff=96, vocab=128, act="swiglu", tie_embeddings=False, rope_theta=50000.0,
        param_dtype="float32", compute_dtype="float32", use_kernels=use_kernels,
        moe=DeepSeekMoEConfig(n_experts=8, top_k=2, d_ff_expert=24, n_shared_experts=2,
                              scoring="sigmoid", selection_bias=True, routed_scale=2.446,
                              dropless=True, first_dense_layers=1,
                              mla=MLAConfig(32, 16, 8, 16)))
    model = Model(cfg)
    return model, model.init(torch.Generator().manual_seed(0), device="cpu")


@pytest.fixture(scope="module")
def deepseek():
    return _deepseek()


def test_moe_counters_per_step(deepseek):
    """Prefill and decode apart: layer launches, experts that held a token
    (as the engine's device buffer has them), real rows (tokens x top-2 x 2
    MoE layers; in the decode the live rows' only, a free slot's row is
    routed to no expert) and rows computed (the plain route on the CPU
    computes every row of the C = T buffer)."""
    TELEMETRY.clear()
    model, params = deepseek
    eng = ServeEngine(model, params, ServeConfig(batch=SLOTS, max_len=MAX_LEN), device="cpu")
    eng.submit(*(Request(rid, _prompt(rid, L), max_new_tokens=4)
                 for rid, L in enumerate((5, 9, 5))))
    seen = []
    while eng.has_work:
        eng.step()
        moe = eng._c_moe
        seen.append((TELEMETRY.step_log[-1], int((moe.prefill[:2] > 0).sum()),
                     int((moe.decode > 0).sum())))
    (first, pre_experts, dec_experts), *rest = seen
    # one prefill group a length: 2 rows of 5 and 1 of 9 tokens
    assert first.moe_prefill == (2 * 2, pre_experts, (10 + 9) * 2 * 2, 2 * 8 * (10 + 9))
    assert first.decode_rows == 3 < SLOTS
    assert first.moe_decode == (2, dec_experts, 3 * 2 * 2, 2 * 8 * SLOTS)
    for rec, _, dec in rest:
        assert rec.moe_prefill is None
        if rec.decode_rows:
            assert rec.moe_decode == (2, dec, rec.decode_rows * 2 * 2, 2 * 8 * SLOTS)
    assert 0 < dec_experts <= 2 * 8 and pre_experts <= 2 * 2 * 8


def test_moe_counters_make_no_extra_sync(deepseek, model_params, monkeypatch):
    """The MoE engine synchronizes, and reads tensors back, as often as a
    dense one: once for an admission, once for a decode, one token
    read-back a step."""
    from repro_torch.serve import engine as engine_mod
    counts = []
    for model, params in (deepseek, model_params):
        syncs, reads = [], []
        real_sync, real_cpu = engine_mod._sync, torch.Tensor.cpu
        monkeypatch.setattr(engine_mod, "_sync", lambda d: syncs.append(d) or real_sync(d))
        monkeypatch.setattr(torch.Tensor, "cpu",
                            lambda self, *a, **k: reads.append(1) or real_cpu(self, *a, **k))
        eng = ServeEngine(model, params, ServeConfig(batch=SLOTS, max_len=MAX_LEN),
                          device="cpu")
        eng.submit(Request(0, _prompt(0, 8), max_new_tokens=5))
        steps = 0
        while eng.has_work:
            eng.step()
            steps += 1
        monkeypatch.undo()
        counts.append((len(syncs), len(reads), steps))
    assert counts[0] == counts[1] == (1 + 4, 5, 5)


def test_model_spans_open_in_eager_passes_under_a_profiler(deepseek, monkeypatch):
    """``model.mla`` once a layer, ``model.moe.route`` and
    ``model.moe.experts`` once an MoE layer, in each eager pass while a
    profiler records, inside the engine's spans; none without one."""
    from repro_torch.models import layers
    model, params = deepseek
    rec = _Recorder()
    monkeypatch.setattr(telemetry, "record_function", rec)
    monkeypatch.setattr(layers, "record_function", rec)
    eng = ServeEngine(model, params, ServeConfig(batch=SLOTS, max_len=MAX_LEN), device="cpu")
    eng.submit(Request(0, _prompt(0, 8), max_new_tokens=2))
    eng.drain()
    assert rec.calls == []
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.submit(Request(1, _prompt(1, 8), max_new_tokens=2))
        eng.drain()
    names = [n for n, _ in rec.calls]
    # one prefill and one (eager, CPU) decode
    assert names.count("model.mla") == 2 * 3
    assert names.count("model.moe.route") == names.count("model.moe.experts") == 2 * 2
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    outer = [(s, e) for n, s, e in events if n in ("serve.prefill", "serve.decode")]
    for n, s, e in events:
        if n.startswith("model."):
            assert any(s0 <= s and e <= e0 for s0, e0 in outer), n
