"""BENCHMARK.json and the files it names: every cell finds its
configuration, traffic, limits and metric readers by name, and a cell
built from new files alone in a temporary directory runs end to end."""
from __future__ import annotations

import json
import re

import pytest
import torch

from conftest import BENCH, ROOT, TINY_CHAT, TINY_DENSE, write_bench
from pb import cell as runner, spec

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys_and_names():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    assert BENCHMARK["command"] == ["python3", "portbench/run.py"]
    assert BENCHMARK["paths"] == ["portbench"]
    names = ([c["name"] for c in BENCHMARK["configs"]] + CELLS
             + [m["name"] for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len(set(CELLS)) == len(CELLS)
    assert all(w["chips"] == 1 for w in BENCHMARK["workloads"])
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCHMARK["end_to_end"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_files(name):
    c = spec.resolve_cell(BENCHMARK, name)
    for path in (c.config_file, c.traffic_file, c.limits_file):
        assert path.is_file(), path
        assert BENCH in path.parents
    conf = spec.read_json(c.config_file)
    cfg = spec.model_config(conf)
    assert cfg.name == c.config
    limits = spec.read_json(c.limits_file)
    assert limits["logit_gap"]["limit"] > 0 and limits["sample_tokens"] > 0
    e2e = {m.name for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.metric_reader(m.name))
    for m in c.per_layer:
        assert m.moves in e2e, (m.name, m.moves)


def test_every_config_and_traffic_is_used():
    used = {w["config"] for w in BENCHMARK["workloads"]}
    assert used == {c["name"] for c in BENCHMARK["configs"]}
    for c in BENCHMARK["configs"]:
        assert c["file"].startswith("portbench/configs/")


def test_a_throwaway_cell_from_files_alone(tmp_path):
    """A new cell is new files and new entries: nothing under portbench/
    is edited to run it."""
    before = {p: p.read_bytes() for p in BENCH.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    bench_dir = write_bench(tmp_path, [("throwaway.chat", TINY_DENSE, TINY_CHAT)])
    c = spec.resolve_cell(spec.load_benchmark(tmp_path), "throwaway.chat", tmp_path,
                          bench_dir)
    out = runner.run(c, 2 ** 40 + 3, 0.5, False, torch.device("cpu"), 0.0,
                     bench_dir=bench_dir)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"ttft_p50_ms", "itl_p50_ms", "setup_s"}
    assert list(out)[-1] == "check"
    after = {p: p.read_bytes() for p in BENCH.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert before == after
