"""The moonlight-16b-a3b cell's counts and readers: ``pb.costs_moe``'s
decode-step need against a count by hand at one shape, and
``decode_mfu.moe``, ``moe_gmm_roofline_pct`` and ``moe_prefill_pad_pct``
on synthetic step records (``repro_torch.serve.telemetry``), each None
where the program keeps no MoE counters."""
from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from conftest import BENCH, TINY_DENSE
from pb import costs, costs_moe, spec
from pb.cell import Ctx
from pb.timeline import Served, Timeline

CFG = spec.model_config(json.loads(
    (BENCH / "configs" / "moe" / "moonlight-16b-a3b.json").read_text()))


def test_decode_step_need_by_hand():
    """Two live rows at fills 100 and 2,000, 50 experts holding a token
    over the 26 MoE layers, by hand from the published widths."""
    mla = 2048 * 16 * 192 + 2048 * 576 + 512 + 512 * 16 * 256 + 16 * 128 * 2048
    assert mla == 13_763_072
    resident = (27 * (mla + 2 * 2048)               # latent attention, two norms a layer
                + 3 * 2048 * 11264                   # the dense layer's SwiGLU
                + 26 * (2048 * 64 + 64 + 2 * 3 * 2048 * 1408)   # router, bias, shared
                + 2048 + 163840 * 2048)              # final norm, output head
    assert costs_moe.resident_params(CFG) == resident == 1_229_714_560
    expert = 3 * 2048 * 1408 * 2                     # 17.3 MB
    row_act = 2048 * 2 + 27 * (12 * 2048 * 2 + 576 * 2) + 163840 * 4
    nbytes = resident * 2 + 50 * expert + 2 * row_act + 27 * (100 + 2000) * 576 * 2
    row_mm = 2 * (resident + 26 * 6 * 3 * 2048 * 1408)
    flops = 2 * row_mm + 27 * 16 * 2 * (100 + 2000) * (576 + 512)
    got = costs_moe.decode_step_need(CFG, [100, 2000], 50)
    assert got == (pytest.approx(nbytes, rel=1e-12), pytest.approx(flops, rel=1e-12))


def test_gmm_need_by_hand():
    nbytes, flops = costs_moe.gmm_need(CFG, 61, 192)
    assert nbytes == 61 * 17_301_504 + 192 * 3 * (2048 + 1408) * 2
    assert flops == 2 * 192 * 3 * 2048 * 1408


def _records(steps):
    from repro_torch.models.moe import MoECounts
    from repro_torch.serve.telemetry import TELEMETRY, StepRecord
    TELEMETRY.clear()
    for k, (pre, dec, profiled) in enumerate(steps):
        r = StepRecord(k + 0.6, profiled)
        r.t1 = k + 0.9
        r.moe_prefill = None if pre is None else MoECounts(*pre)
        r.moe_decode = None if dec is None else MoECounts(*dec)
        TELEMETRY.step_log.append(r)


def _ctx(trace=None, cfg=CFG):
    """Three steps ending at 1, 2 and 3 s: request 0 (prompt 100) decodes
    in steps 0 and 1, request 1 (prompt 50) in step 1."""
    a = Served(0, 0.5, 100, 3, done_step=2, tokens=[1, 2, 3], decode_s=0.02)
    b = Served(1, 0.7, 50, 2, done_step=2, tokens=[4, 5], decode_s=0.01)
    tl = Timeline([1.0, 2.0, 3.0], [a, b], (0.5, 10.0))
    return Ctx(cell=None, cfg=cfg, conf={}, traffic={}, slots=4, tl=tl, summary={},
               setup_s=0.0, decodes=2, trace=trace)


def _read(name, ctx):
    return spec.metric_reader(name)(ctx)


PRE = (26, 1500, 6000, 7680)
STEPS = [(PRE, (26, 100, 156, 6400), True), (None, (26, 150, 312, 9600), True),
         ((26, 700, 3000, 3840), None, False)]


def test_decode_mfu_moe():
    _records(STEPS)
    ctx = _ctx()
    assert ctx.decode_rows() == [[101], [102, 51], []]
    need = (costs.roof_s(*costs_moe.decode_step_need(CFG, [101], 100))
            + costs.roof_s(*costs_moe.decode_step_need(CFG, [102, 51], 150)))
    assert _read("decode_mfu.moe", ctx) == pytest.approx(100 * need / 0.03)


def test_moe_gmm_roofline_pct():
    _records(STEPS)
    trace = SimpleNamespace(kernels={
        "void (anonymous namespace)::wg::gmm_wgmma_kernel(CUtensorMap_st, ...)": (0.004, 52),
        "void (anonymous namespace)::small_c::gmm_small_c_kernel<4>(...)": (0.001, 26),
        "nvjet_tst_128x16": (1.0, 9)})
    need = sum(costs.roof_s(*costs_moe.gmm_need(CFG, e, r))
               for e, r in ((1500, 6000), (100, 156), (150, 312)))   # the profiled steps
    assert _read("moe_gmm_roofline_pct", _ctx(trace)) == pytest.approx(100 * need / 0.005)
    assert _read("moe_gmm_roofline_pct", _ctx()) is None             # untraced
    trace.kernels = {"nvjet_tst_128x16": (1.0, 9)}
    assert _read("moe_gmm_roofline_pct", _ctx(trace)) is None        # no K6 kernel


def test_moe_prefill_pad_pct():
    _records(STEPS)
    assert _read("moe_prefill_pad_pct", _ctx()) == pytest.approx(
        100 * (1 - (6000 + 3000) / (7680 + 3840)))


def test_readers_are_none_without_moe_counters():
    """A dense model's records (no MoE counters) and a program that keeps
    none: every reader returns None."""
    dense = spec.model_config(TINY_DENSE)
    _records([(None, None, True)] * 3)
    trace = SimpleNamespace(kernels={"gmm_wgmma_kernel": (0.1, 1)})
    for name in ("decode_mfu.moe", "moe_gmm_roofline_pct", "moe_prefill_pad_pct"):
        assert _read(name, _ctx(trace, dense)) is None, name
        assert _read(name, _ctx(trace)) is None, name
