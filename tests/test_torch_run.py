"""The paper-claims module (``repro_torch.run``) against the reference's
``benchmarks/run.py`` on the CPU: the claim function on the committed
curves and on synthetic curves around each threshold, the byte columns of
live curves, and ``results.json`` in the reference's layout."""
import dataclasses
import functools
import json
import os
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import benchmarks.bots_alignment as jba  # noqa: E402
import benchmarks.bots_mandelbrot as jbm  # noqa: E402
import benchmarks.bots_sparselu as jbl  # noqa: E402
import benchmarks.common as jcommon  # noqa: E402
import benchmarks.run as jrun  # noqa: E402
from repro_torch import run as trun  # noqa: E402
from repro_torch.bots.common import Curve, CurvePoint  # noqa: E402

torch.set_num_threads(1)      # six test workers share the CPU

RESULTS = os.path.join(ROOT, "artifacts", "bench", "results.json")
# the committed curves fail two of the reference's own claims (ROADMAP §3)
COMMITTED_FAILURES = ["mandelbrot speedup does not grow with image size",
                      "fib small-input should not benefit (paper: 0.91)"]
# the CPU subset: (workload, size, device counts)
PLAN = (("alignment", "small", (1, 2, 4, 8)), ("mandelbrot", "small", (1, 2)),
        ("sparselu", "small", (1, 2, 4, 8)), ("sparselu", "large", (1, 2, 4, 8)))
REFERENCE_RUN = {"alignment": jba.run, "mandelbrot": jbm.run, "sparselu": jbl.run}


def _curves(rows):
    return [Curve(name=c["name"], size=c["size"], serial_s=c["serial_s"],
                  points=[CurvePoint(**p) for p in c["points"]]) for c in rows]


def test_committed_curves_fail_the_references_two_claims():
    with open(RESULTS) as f:
        curves = _curves(json.load(f))
    assert jrun.check_paper_claims(curves) == COMMITTED_FAILURES
    assert trun.check_paper_claims(curves) == COMMITTED_FAILURES
    rows = trun.paper_claims(curves)
    assert len(rows) == 6
    assert [r["failure"] for r in rows if not r["held"]] == COMMITTED_FAILURES


# speedups at D = 2, 4, 8 by (workload, size); every claim holds on BASE
BASE = {("alignment", "small"): (1.5, 2.5, 4.5), ("alignment", "large"): (1.5, 2.5, 5.0),
        ("mandelbrot", "small"): (1.9, 3.5, 4.0), ("mandelbrot", "large"): (1.9, 3.5, 4.0),
        ("fib", "small"): (1.0, 1.0, 1.0), ("fib", "large"): (1.5, 2.5, 3.0),
        ("sparselu", "small"): (0.5, 0.5, 0.5), ("sparselu", "large"): (0.5, 0.5, 0.5)}
# (workload, size, D, speedup) overrides on either side of each threshold
CROSSINGS = {
    "base": (),
    "alignment_flat": (("alignment", "large", 8, 1.4),),
    "alignment_d2_at_1.2": (("alignment", "large", 2, 1.2),),
    "alignment_d2_above_1.2": (("alignment", "large", 2, 1.2000001),),
    "alignment_below_4": (("alignment", "large", 8, 3.99),),
    "alignment_at_4": (("alignment", "large", 8, 4.0),),
    "mandelbrot_at_0.9": (("mandelbrot", "large", 8, 3.6),),
    "mandelbrot_below_0.9": (("mandelbrot", "large", 8, 3.59),),
    "fib_small_at_1.5": (("fib", "small", 8, 1.5),),
    "fib_small_above_1.5": (("fib", "small", 8, 1.51),),
    "fib_large_at_1.2": (("fib", "large", 8, 1.2),),
    "fib_large_at_7.5": (("fib", "large", 8, 7.5),),
    "fib_large_below_7.5": (("fib", "large", 8, 7.49),),
    "sparselu_at_1": (("sparselu", "small", 4, 1.0),),
    "sparselu_small_above_1": (("sparselu", "small", 2, 1.01),),
    "sparselu_large_above_1": (("sparselu", "large", 8, 1.5),),
    "sparselu_d1_ignored": (("sparselu", "large", 1, 5.0),),
    "all_fail": (("alignment", "large", 8, 1.0), ("mandelbrot", "large", 8, 0.1),
                 ("fib", "small", 8, 9.0), ("fib", "large", 8, 9.0),
                 ("sparselu", "small", 8, 2.0)),
}


def _synthetic(overrides):
    sp = {(n, s, d): v for (n, s), vals in BASE.items()
          for d, v in zip((2, 4, 8), vals)}
    sp.update({(n, s, 1): 1.0 for n, s in BASE})
    sp.update({(n, s, d): v for n, s, d, v in overrides})
    return [Curve(name=n, size=s, serial_s=1.0,
                  points=[CurvePoint(devices=d, compute_s=0.0, comm_s=0.0,
                                     makespan_s=1.0 / sp[(n, s, d)],
                                     makespan_overlap_s=0.0, bytes_to=0.0,
                                     bytes_from=0.0, speedup=sp[(n, s, d)],
                                     speedup_overlap=0.0)
                          for d in (1, 2, 4, 8)])
            for n, s in BASE]


@pytest.mark.parametrize("case", sorted(CROSSINGS))
def test_claims_match_the_reference_around_each_threshold(case):
    curves = _synthetic(CROSSINGS[case])
    expected = jrun.check_paper_claims(curves)
    assert trun.check_paper_claims(curves) == expected
    if case == "base":
        assert expected == []
    if case == "all_fail":
        assert len(expected) == 6


@functools.lru_cache(maxsize=None)
def _port_curves():
    curves, err = trun.run_all("cpu", repeats=1, plan=PLAN)
    return curves, err


@functools.lru_cache(maxsize=None)
def _reference_curve(name, size, counts):
    return REFERENCE_RUN[name](size, device_counts=counts)


def _byte_columns(curve):
    return [(p.devices, p.bytes_to, p.bytes_from) for p in curve.points]


@pytest.mark.parametrize("plan", PLAN, ids=lambda p: f"{p[0]}-{p[1]}")
def test_run_all_bytes_equal_the_reference_live_curves(plan):
    curves, err = _port_curves()
    assert err == 0.0
    got = next(c for c in curves if (c.name, c.size) == plan[:2])
    assert _byte_columns(got) == _byte_columns(_reference_curve(*plan))


def test_main_writes_results_in_the_reference_layout(tmp_path, capsys):
    argv = ["--device", "cpu", "--out", str(tmp_path), "--repeats", "1",
            "--skip-comm", "--skip-roofline"]
    for name, size, counts in PLAN:
        argv += ["--curve", f"{name}:{size}:{','.join(map(str, counts))}"]
    assert trun.main(argv) == 0
    assert "sparselu distributed == serial: max abs err 0.00e+00" in capsys.readouterr().out
    with open(tmp_path / "results.json") as f:
        rows = json.load(f)
    assert [(r["name"], r["size"]) for r in rows] == [p[:2] for p in PLAN]
    point_fields = [f.name for f in dataclasses.fields(jcommon.CurvePoint)]
    for row, (name, size, counts) in zip(rows, PLAN):
        # every key of the reference's Curve.to_dict, with its type
        ref = _reference_curve(name, size, counts).to_dict()
        assert set(ref) <= set(row)
        curve = jcommon.Curve(name=row["name"], size=row["size"],
                              serial_s=row["serial_s"],
                              points=[jcommon.CurvePoint(**{k: p[k] for k in point_fields})
                                      for p in row["points"]])
        assert isinstance(curve.serial_s, float)
        assert [p.devices for p in curve.points] == list(counts)
        for p, q in zip(row["points"], ref["points"]):
            assert list(p) == list(q)
            assert all(type(p[k]) is type(q[k]) for k in q), (p, q)
        assert _byte_columns(curve) == _byte_columns(_reference_curve(name, size, counts))
