"""BENCHMARK.json and the files it names: every cell finds its
configuration, traffic, limits, reference and metric readers by name, and a
cell built from new files alone in a temporary directory runs end to end,
for the dense family and for one whose configuration nests a sub-config and
brings its own plain reference."""
from __future__ import annotations

import dataclasses
import json
import re

import pytest
import torch

from conftest import (BENCH, MOE_REFERENCE, ROOT, TINY_CHAT, TINY_DENSE, TINY_MOE,
                      write_bench, write_reference)
from pb import cell as runner, reference, spec
from repro_torch.configs.registry import ARCHS

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


def _files():
    return {p: p.read_bytes() for p in BENCH.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def _throwaway(tmp_path, conf, ref_source=None):
    """Run a throwaway cell of ``conf`` (with ``ref_source`` as its
    ``references/<config>.py``) on the CPU; every file under portbench/
    is left as it was."""
    before = _files()
    bench_dir = write_bench(tmp_path, [("throwaway.chat", conf, TINY_CHAT)])
    if ref_source is not None:
        write_reference(bench_dir, conf["name"], ref_source)
    c = spec.resolve_cell(spec.load_benchmark(tmp_path), "throwaway.chat", tmp_path,
                          bench_dir)
    out = runner.run(c, 2 ** 40 + 3, 0.5, False, torch.device("cpu"), 0.0,
                     bench_dir=bench_dir)
    assert _files() == before
    return c, out


@pytest.mark.parametrize("conf,ref_source", [(TINY_DENSE, None), (TINY_MOE, MOE_REFERENCE)],
                         ids=["dense", "moe"])
def test_a_throwaway_cell_from_files_alone(tmp_path, conf, ref_source):
    """A new cell is new files and new entries: nothing under portbench/
    is edited to run it, whatever the configuration's family."""
    c, out = _throwaway(tmp_path, conf, ref_source)
    assert c.reference_file.is_file() == (ref_source is not None)
    assert (spec.reference_logits(c) is reference.logits) == (ref_source is None)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {m["name"] for m in BENCHMARK["end_to_end"]}
    assert list(out)[-1] == "check"


def test_the_check_reads_the_configurations_reference(tmp_path):
    """The MoE cell against a reference that leaves out the shared expert
    is not correct: the check runs the file, not the dense reference."""
    wrong = MOE_REFERENCE.replace("SHARED_EXPERT = True", "SHARED_EXPERT = False")
    assert wrong != MOE_REFERENCE
    _, out = _throwaway(tmp_path, TINY_MOE, wrong)
    gap, limit = out["check"]["logit_gap"]
    assert not out["correct"] and gap > limit


def test_a_sub_config_comes_from_the_nested_object():
    from repro_torch.models.config import MoEConfig
    cfg = spec.model_config(TINY_MOE)
    assert cfg.moe == MoEConfig(n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=2.0,
                                n_shared_experts=1)
    assert hash(cfg) == hash(spec.model_config(json.loads(json.dumps(TINY_MOE))))


def test_a_nested_object_refuses_a_key_of_no_field():
    """A misspelt sub-config key would build the default silently; it is
    refused.  Top-level keys other than fields stay documentation."""
    typo = {**TINY_MOE, "moe": {**TINY_MOE["moe"], "n_shared_expert": 1}}
    typo["moe"].pop("n_shared_experts")
    with pytest.raises(ValueError, match="n_shared_expert"):
        spec.model_config(typo)
    assert spec.model_config({**TINY_MOE, "published": {"any": 1}}) == spec.model_config(TINY_MOE)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_port_config_round_trips(arch):
    """Every configuration the port builds comes back whole, and hashable,
    from its values as a configuration file holds them."""
    for cfg in (ARCHS[arch].smoke(), ARCHS[arch].config()):
        back = spec.model_config(json.loads(json.dumps(dataclasses.asdict(cfg))))
        assert back == cfg and hash(back) == hash(cfg)
