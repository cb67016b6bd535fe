"""The calibration acceptance gate (``repro_torch.perf_gate``) against the
reference's ``benchmarks/perf_gate.py::calibration_gate`` on the CPU: both
arms bit for bit, the frozen arm's true makespan equal to the reference's,
and the win at least the gate's 20%."""
import functools
import json
import os
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import benchmarks.perf_gate as jpg  # noqa: E402
from repro_torch import perf_gate as tpg  # noqa: E402

torch.set_num_threads(1)      # six test workers share the CPU


@functools.lru_cache(maxsize=None)
def _port():
    return tpg.calibration_gate(device="cpu")


@functools.lru_cache(maxsize=None)
def _reference():
    # save_report=False: the reference would rewrite artifacts/roofline_placement.md
    return jpg.calibration_gate(20.0, save_report=False)


def test_arms_are_bit_for_bit():
    fails, detail = _port()
    assert fails == []
    assert detail["bit_identical"] is True
    assert detail["status"] == "ok"
    frozen, _, _ = tpg.run_arm(False, device="cpu")
    calibrated, _, report = tpg.run_arm(True, device="cpu")
    assert sorted(frozen) == sorted(calibrated)
    assert all(torch.equal(frozen[k], calibrated[k]) for k in frozen)
    assert report is not None


def test_frozen_true_makespan_equals_the_reference():
    _, detail = _port()
    _, ref = _reference()
    assert detail["uncalibrated_true_makespan_s"] == ref["uncalibrated_true_makespan_s"]


def test_win_clears_the_gate_beside_the_reference():
    _, detail = _port()
    _, ref = _reference()
    print(f"calibration win: port {detail['win_pct']:.2f}%, reference "
          f"{ref['win_pct']:.2f}% (committed 86.4%)")
    assert detail["win_pct"] >= 20.0
    assert set(ref) <= set(detail)


def test_true_makespan_reprices_the_recorded_traffic():
    """``_true_makespan`` on a hand-made record: funnel serialized, the
    busiest directed peer link, the busiest device (unknown kernels 30 µs)."""
    from repro_torch.core.costmodel import CostModel
    cost = CostModel(tpg.TRUE_FUNNEL)
    cost.record_transfer("to", 0, 1000)
    cost.record_peer(0, 1, 5000)
    cost.record_peer(0, 1, 5000)
    cost.record_peer(1, 0, 9000)
    cost.record_compute(0, 1.0, kernel="bmod")
    cost.record_compute(1, 1.0, kernel="lu0")
    cost.record_compute(1, 1.0, kernel="other")
    got = tpg._true_makespan(cost, tpg.TRUE_FUNNEL, tpg.TRUE_PEER, tpg.TRUE_KERNELS)
    funnel = tpg.TRUE_FUNNEL.time(1000)
    peer = 2 * tpg.TRUE_PEER.time(5000)
    compute = tpg.TRUE_KERNELS["lu0"] + 30e-6
    assert got == pytest.approx(funnel + peer + compute, rel=1e-12)


def test_main_writes_the_report(tmp_path, capsys):
    out = tmp_path / "perf_gate_report.json"
    assert tpg.main(["--device", "cpu", "--out", str(out)]) == 0
    with open(out) as f:
        report = json.load(f)
    assert report["failures"] == []
    assert report["calibration"]["status"] == "ok"
    assert json.loads(capsys.readouterr().out.rsplit("wrote", 1)[0])["failures"] == []
