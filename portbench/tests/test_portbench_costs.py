"""The frozen counts equal the program's analytic model as of the day
they were frozen (``repro_torch.launch.analytic_cost``), at a few shapes."""
from __future__ import annotations

import json

import pytest

from conftest import BENCH
from pb import costs, spec

CONFIGS = {p.stem: spec.model_config(json.loads(p.read_text()))
           for p in sorted((BENCH / "configs").glob("*.json"))}
SHAPES = [(1, 64), (4, 512), (16, 2048), (3, 777)]


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("B,S", SHAPES)
def test_forward_flops_frozen(name, B, S):
    from repro_torch.launch import analytic_cost as ac
    cfg = CONFIGS[name]
    assert costs.forward_flops(cfg, B, S) == ac.forward_flops(cfg, B, S)
    assert costs.forward_flops(cfg, B, 1, decode=True, cache_len=S) == \
        ac.forward_flops(cfg, B, 1, decode=True, cache_len=S)
    assert costs.prefill_flops(cfg, [S] * B) == pytest.approx(ac.forward_flops(cfg, B, S))


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("B,S", SHAPES)
def test_decode_step_cost_frozen(name, B, S):
    from repro_torch.launch import analytic_cost as ac
    cfg = CONFIGS[name]
    nbytes, flops = costs.decode_step_cost(cfg, [S] * B)
    ref = ac.port_step_cost(cfg, "decode", S, B)
    assert nbytes == pytest.approx(ref.hbm_bytes, rel=1e-12)
    assert flops == pytest.approx(ref.flops, rel=1e-12)
    assert costs.param_count(cfg) == ac.param_count(cfg)[0]


def test_decode_cost_adds_rows():
    cfg = CONFIGS["minitron-4b"]
    w = costs.param_count(cfg) * costs.P_BYTES
    b1, f1 = costs.decode_step_cost(cfg, [100])
    b2, f2 = costs.decode_step_cost(cfg, [3000])
    b12, f12 = costs.decode_step_cost(cfg, [100, 3000])
    assert b12 == pytest.approx(b1 + b2 - w) and f12 == pytest.approx(f1 + f2)


def test_roofs_and_shares():
    assert costs.roof_s(3.35e12, 0) == pytest.approx(1.0)
    assert costs.roof_s(0, 989e12) == pytest.approx(1.0)
    assert costs.share_pct(1.0, 0.0) is None
    assert costs.share_pct(1.0, 4.0) == pytest.approx(25.0)


def test_other_families_have_no_frozen_count():
    from repro_torch.configs import get_config
    cfg = get_config("zamba2-2.7b")
    with pytest.raises(ValueError):
        costs.forward_flops(cfg, 1, 8)
    with pytest.raises(ValueError):
        costs.decode_step_cost(cfg, [8])
