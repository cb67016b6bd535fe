"""On the card: each cell's control (the float32 reference with float8
e4m3 matrix products, put in the program's place) fails the cell's limit
and the program passes it, on three seeds at the cell's own sizes and
load (a short window, drained).  Runs only with a CUDA card:

    python -m pytest -m cuda portbench/tests/test_portbench_control.py
"""
from __future__ import annotations

import json

import pytest

from conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their published sizes")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(card, name):
    from pb import cell as runner, control_run, spec
    spec.set_cache_env(ROOT)
    c = spec.resolve_cell(spec.load_benchmark(ROOT), name, ROOT)
    su = runner.Setup(c, SEEDS[0], card)
    limit = su.limits["logit_gap"]["limit"]
    for row in control_run.readings(su, SEEDS, 15.0):
        assert row["unfinished"] == 0
        assert row["gap"] <= limit < row["control_gap"], row
