"""The open-loop serving module (``repro_torch.serve_load``) against the
reference's ``benchmarks/serve_load.py`` on the CPU: the same traces and
arrivals, the same capacity in bytes, both sections' request and token
counts (the reference's ``BENCH_serve.json`` leaves) with identical tokens,
and section 1's tokens equal to the reference engine's on its weights.  No
check that hangs on the open-loop timing (the tokens/s and p99 orders,
whether the cap spilled) is asserted here: on a loaded CPU either can come
out."""
import functools
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import benchmarks.serve_load as jsl  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import serve_load as tsl  # noqa: E402

torch.set_num_threads(1)      # six test workers share the CPU

BENCH = os.path.join(ROOT, "artifacts", "bench", "BENCH_serve.json")
# (n, seed, trace keywords) of each section's trace and of the warm-up burst
TRACES = {"continuous_vs_wave": (16, 0, {}),
          "slo_vs_roundrobin": (30, 3, {"long_every": 2, "long_budget": 40}),
          "warm": (4, 99, {})}


@functools.lru_cache(maxsize=None)
def _reference(dtype):
    """The reference's smoke model and weights (``dtype`` or the config's)."""
    model, params = jsl._model()
    if dtype is not None:
        model = type(model)(model.cfg.replace(param_dtype=dtype, compute_dtype=dtype))
        params = model.init(jax.random.PRNGKey(0))
    return model, params


@functools.lru_cache(maxsize=None)
def _port(dtype):
    """The port's model with the reference's weights carried across."""
    _, jp = _reference(dtype)
    return tsl._model(dtype=dtype, params=jax.tree.map(np.asarray, jp), device="cpu")


def _fields(reqs):
    return [(r.rid, list(r.prompt), r.max_new_tokens) for r in reqs]


@pytest.mark.parametrize("section", sorted(TRACES))
def test_traces_and_arrivals_equal_the_reference(section):
    n, seed, kw = TRACES[section]
    jm, _ = _reference(None)
    tm, _ = _port(None)
    assert _fields(tsl._trace(tm, n, seed=seed, **kw)) == \
        _fields(jsl._trace(jm, n, seed=seed, **kw))
    for rate in (3.7, 101.0):
        np.testing.assert_array_equal(tsl._arrivals(n, rate, seed=seed + 1),
                                      jsl._arrivals(n, rate, seed=seed + 1))


@pytest.mark.parametrize("dtype", [None, "float32"])
def test_capacity_bytes_equal_the_reference(dtype):
    jm, jp = _reference(dtype)
    tm, tp = _port(dtype)
    for caches in (3.5, 10 / 2 + 0.5):
        assert tsl._capacity_bytes(tm, tp, caches=caches, device="cpu") == \
            jsl._capacity_bytes(jm, jp, caches=caches)


@functools.lru_cache(maxsize=None)
def _section(name):
    tm, tp = _port("float32")
    if name == "continuous_vs_wave":
        return tsl.run_continuous_vs_wave(n=16, model=tm, params=tp, device="cpu")
    return tsl.run_slo_vs_roundrobin(n=30, reps=1, model=tm, params=tp, device="cpu")


@pytest.mark.parametrize("name,engines", [
    ("continuous_vs_wave", ("wave", "continuous")),
    ("slo_vs_roundrobin", ("round-robin", "slo"))])
def test_sections_count_the_reference_requests_and_tokens(name, engines):
    with open(BENCH) as f:
        committed = json.load(f)["sections"][name]
    sec = _section(name)
    for e in engines:
        assert (sec[e]["requests"], sec[e]["tokens"]) == \
            (committed[e]["requests"], committed[e]["tokens"])
    assert sec["tokens_identical"] is True
    assert sec["checks"]["tokens_identical"] is True
    assert set(sec) - {"checks", "tokens"} == set(committed)
    for e in engines:
        assert set(committed[e]) <= set(sec[e])
    if name == "slo_vs_roundrobin":
        assert set(sec["checks"]) == {"tokens_identical", "spills_positive",
                                      "slo_beats_roundrobin_p99"}
    else:
        assert set(sec["checks"]) == {"tokens_identical", "continuous_beats_wave_tps",
                                      "continuous_beats_wave_p99"}


def test_section_one_tokens_equal_the_reference_engine():
    jm, jp = _reference("float32")
    reqs = jsl._trace(jm, 16, seed=0)
    eng = JServeEngine(jm, jp, JServeConfig(batch=4, max_len=jsl.MAX_LEN))
    ref = {rid: list(r.tokens) for rid, r in eng.serve(reqs).items()}
    got = _section("continuous_vs_wave")["tokens"]
    assert got["continuous"] == ref
    assert got["wave"] == ref


def test_failed_checks_name_the_section_and_check():
    sections = {"a": {"checks": {"x": True, "y": False}},
                "b": {"checks": {"z": False}}}
    assert tsl.failed_checks(sections) == ["a.y", "b.z"]


@pytest.mark.parametrize("name", ["continuous_vs_wave", "slo_vs_roundrobin"])
def test_sections_pass_the_trajectory_gates_compare(name):
    """Each section, as the CLI writes it, held against ``BENCH_serve.json``
    by the perf gate's ``compare`` (token and request counts within the
    band, ``tokens_identical`` true), the port's and the reference's
    ``compare`` giving the same answer."""
    import benchmarks.perf_gate as jpg
    from repro_torch import perf_gate as tpg
    with open(BENCH) as f:
        committed = json.load(f)
    base = {"benchmark": committed["benchmark"],
            "sections": {name: committed["sections"][name]}}
    sec = {k: v for k, v in _section(name).items() if k != "tokens"}
    fresh = {"benchmark": "serve_load", "sections": {name: sec}}
    assert tpg.compare("serve", base, fresh, 15.0) == []
    assert jpg.compare("serve", base, fresh, 15.0) == []
    assert tpg.n_gated("serve", base) == 4
