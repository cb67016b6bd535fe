"""The port's bench CLIs and the trajectory half of its perf gate against the
reference's on the CPU: the ``resident`` and ``wavefront`` sections' byte
columns (``BENCH_comm.json``'s and the reference's live sections), each
CLI's JSON layout against the committed ``BENCH_*.json``, the trajectory
gate passing on the committed baselines and failing on a doctored one with
the reference's message, and the roofline renderers equal to
``benchmarks/roofline.py``'s at the H100's roofs."""
import copy
import functools
import json
import os
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import benchmarks.comm_modes as jcm  # noqa: E402
import benchmarks.perf_gate as jpg  # noqa: E402
import benchmarks.roofline as jroof  # noqa: E402
from repro_torch import comm_modes as cm  # noqa: E402
from repro_torch import perf_gate as pg  # noqa: E402
from repro_torch import roofline as troof  # noqa: E402
from repro_torch import sched_policies, topo_collectives  # noqa: E402

torch.set_num_threads(1)      # six test workers share the CPU

BENCH_DIR = os.path.join(ROOT, "artifacts", "bench")
CLIS = {"comm": (cm.main, ["--smoke"], "BENCH_comm.json"),
        "sched": (sched_policies.main, [], "BENCH_sched.json"),
        "topo": (topo_collectives.main, ["--smoke"], "BENCH_topo.json")}


def _bench(fn):
    with open(os.path.join(BENCH_DIR, fn)) as f:
        return json.load(f)


@functools.lru_cache(maxsize=None)
def _cli_json(name, tmp):
    main, argv, _ = CLIS[name]
    path = os.path.join(tmp, f"{name}.json")
    assert main(argv + ["--device", "cpu", "--json", path]) == 0
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def tmp_json(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_cli"))


BYTES = {"resident": ("params", "devices", "steps", "bytes_to"),
         "wavefront": ("mapping", "devices", "tasks", "bytes_to", "bytes_peer")}


@pytest.mark.parametrize("section", sorted(BYTES))
def test_resident_and_wavefront_bytes_equal_the_committed_and_live_reference(section):
    if section == "resident":
        got = cm.resident(**cm.SMOKE["resident"], device="cpu")
        live = jcm.run_resident(**cm.SMOKE["resident"])
    else:
        got = cm.wavefront(**cm.SMOKE["wavefront"], device="cpu")
        live = jcm.run_wavefront(**cm.SMOKE["wavefront"])
    committed = _bench("BENCH_comm.json")["sections"][section]
    keys = BYTES[section]
    assert [tuple(r[k] for k in keys) for r in got] == \
        [tuple(r[k] for k in keys) for r in live] == \
        [tuple(r[k] for k in keys) for r in committed]
    assert [set(r) for r in got] == [set(r) for r in committed]


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_json_has_the_committed_keys_and_rows(name, tmp_json):
    got, committed = _cli_json(name, tmp_json), _bench(CLIS[name][2])
    # the committed BENCH_comm.json predates the reference CLI's topology
    # keys, which the port's CLI writes as the reference's does today
    assert set(committed) <= set(got)
    assert {k: v for k, v in committed.items() if k != "sections"} == \
        {k: got[k] for k in committed if k != "sections"}
    assert set(got["sections"]) == set(committed["sections"])
    for sec, rows in committed["sections"].items():
        assert [set(r) for r in got["sections"][sec]] == [set(r) for r in rows], sec
    assert set(jpg.flatten(committed)) <= set(pg.flatten(got))


@pytest.mark.parametrize("name", sorted(CLIS))
def test_compare_equals_the_reference_on_a_doctored_baseline(name, tmp_json):
    fresh, base = _cli_json(name, tmp_json), _bench(CLIS[name][2])
    doctored = copy.deepcopy(base)
    sec = next(s for s, rows in doctored["sections"].items()
               if isinstance(rows, list) and any(r.get("bytes_to") for r in rows)) \
        if name != "topo" else "collectives"
    key = "bytes_to" if name != "topo" else "bytes_peer"
    row = next(r for r in doctored["sections"][sec] if r.get(key))
    row[key] *= 1.2
    for band in (0.0, 15.0):
        for b, f in ((doctored, fresh), (base, fresh), (doctored, base)):
            assert pg.compare(name, b, f, band) == jpg.compare(name, b, f, band)
    assert len(pg.compare(name, doctored, base, 15.0)) == 1
    assert _outside_timing_rows(pg.compare(name, base, fresh, 15.0)) == []
    assert pg.GATED_LEAVES == jpg.GATED_LEAVES and pg.GATED_BOOLS == jpg.GATED_BOOLS
    assert pg._ROW_KEYS == jpg._ROW_KEYS


# BENCH_sched.json's capacity-capped HEFT row: its evictions and refetches,
# and every byte column built on them, depend on when each nowait region's
# release lands (timing-dependent in the reference too: 20 runs of each
# side by side, 8 at a time on 8 cores, read 64-69 evictions in both,
# tests/capped_row_spread.py).  On a loaded CPU the port's reduction_pct
# can leave the band around the committed -35.37 (ROADMAP.md §3), so these
# tests leave that row's band failures out; the gate still holds the row to
# its spill accounting (sched_policies.spill_faults), and the bench to
# results equal to the uncapped runs'.
CAPPED_ROW = "sched:/sections/sparselu[policy=heft (comm-bound, cap=98304B),"


def _outside_timing_rows(fails):
    return [f for f in fails if not f.startswith(CAPPED_ROW)]


@pytest.mark.parametrize("source", ["committed", "cli", "doctored"])
def test_capped_row_keeps_its_spill_accounting(source, tmp_json):
    """The reference's committed row and the port CLI's fresh one keep the
    spill accounting; a row whose refetches were not sent breaks it."""
    rows = copy.deepcopy((_bench("BENCH_sched.json") if source == "committed"
                          else _cli_json("sched", tmp_json))["sections"]["sparselu"])
    capped = rows[-1]
    assert capped["policy"] == CAPPED_ROW.split("policy=")[1].rstrip(",")
    if source != "doctored":
        assert sched_policies.spill_faults(rows) == []
        assert capped["evictions"] > 0 and capped["refetches"] > 0
        return
    capped["refetches"] += 1
    capped["bytes_from"] += 4096
    faults = sched_policies.spill_faults(rows)
    assert len(faults) == 2 and faults[0].startswith(
        "sched: capped row: bytes_to == uncapped bytes_to + refetches x block broken")


@pytest.fixture
def one_thread_children(monkeypatch):
    """Bench children run single-threaded, like this file's tests: the test
    workers share the CPU with timing-sensitive tests."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.mark.parametrize("name", sorted(CLIS))
def test_trajectory_gate_passes_on_the_committed_baselines(name, one_thread_children):
    fails, detail = pg.trajectory_gate(15.0, device="cpu", names=(name,))
    assert _outside_timing_rows(fails) == []
    assert list(detail) == [name]
    assert detail[name]["gated_metrics"] == pg.n_gated(name, _bench(CLIS[name][2]))
    if name != "sched":
        assert detail[name]["status"] == "ok"
    assert set(detail[name]["launches"]) == {"comm": {"q8_wire"}, "sched": {"block_lu"},
                                             "topo": {"block_lu", "q8_wire"}}[name]


def test_trajectory_gate_fails_on_a_raised_baseline_with_the_reference_message(
        monkeypatch, tmp_path, tmp_json, one_thread_children):
    base = _bench("BENCH_sched.json")
    doctored = copy.deepcopy(base)
    doctored["sections"]["strips"][0]["bytes_to"] *= 1.2
    with open(tmp_path / "BENCH_sched.json", "w") as f:
        json.dump(doctored, f)
    monkeypatch.setattr(pg, "BENCH_DIR", str(tmp_path))
    fails, detail = pg.trajectory_gate(15.0, device="cpu", names=("sched",))
    fails = _outside_timing_rows(fails)
    want = _outside_timing_rows(jpg.compare("sched", doctored,
                                            _cli_json("sched", tmp_json), 15.0))
    assert fails == want and len(fails) == 1
    assert fails[0].startswith("sched:/sections/strips[policy=round-robin,devices=4,"
                               "strips=4]/bytes_to: 19660.8 -> 16384")
    assert detail["sched"]["status"] == "fail"


def test_a_failing_bench_fails_the_gate(monkeypatch, one_thread_children):
    monkeypatch.setattr(pg, "BENCHES", [("sched", ["-m", "repro_torch.sched_policies",
                                                   "--no-such-flag"], "BENCH_sched.json")])
    fails, detail = pg.trajectory_gate(15.0, device="cpu")
    assert len(fails) == 1 and fails[0].startswith("sched: bench failed")
    assert detail["sched"]["status"] == "bench-failed"


def test_trajectory_gate_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        pg.trajectory_gate(15.0)


@pytest.fixture
def h100_reference_roofs(monkeypatch):
    monkeypatch.setattr(jroof, "PEAK_FLOPS_BF16", troof.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jroof, "HBM_BW_Bps", troof.HBM_BW_Bps)


def test_calibration_renders_equal_the_reference(h100_reference_roofs):
    profiles = troof.load_profiles(os.path.join(ROOT, "artifacts", "calibration"))
    assert profiles and profiles == jroof.load_profiles(
        os.path.join(ROOT, "artifacts", "calibration"))
    for prof in profiles:
        assert troof.render_calibration_table(prof) == jroof.render_calibration_table(prof)
        assert troof.render_links_table(prof) == jroof.render_links_table(prof)


def test_placement_roofline_render_equals_the_reference(h100_reference_roofs, tmp_path):
    _, _, report = pg.run_arm(True, device="cpu")
    assert report["roofline"]
    assert troof.render_placement_roofline(report) == \
        jroof.render_placement_roofline(report)
    path = pg.write_placement_roofline(report, str(tmp_path / "placement.md"))
    with open(path) as f:
        assert troof.render_placement_roofline(report) in f.read()


def test_roofline_main_renders_the_dryrun_and_the_profiles(tmp_path, capsys):
    from repro_torch.launch import dryrun
    dry = tmp_path / "dryrun"
    assert dryrun.main(["--arch", "mamba2-130m", "--device", "cpu",
                        "--out", str(dry)]) == 0
    out = tmp_path / "roofline_table.md"
    assert troof.main(["--device", "cpu", "--dryrun", str(dry), "--calibration",
                       os.path.join(ROOT, "artifacts", "calibration"),
                       "--out", str(out)]) == 0
    text = out.read_text()
    assert "| mamba2-130m | long_500k |" in text
    assert text.count("| mamba2-130m |") == 4
    assert "### calibration:" in text
    assert "roofs: H100 SXM, 989 TFLOP/s bf16, 3.35 TB/s" in capsys.readouterr().out


def test_kernels_bench_profile_loads_as_a_calibration_profile(tmp_path):
    from repro_torch import kernels_bench
    from repro_torch.core.calibrate import CalibrationProfile
    rows = kernels_bench.run(device="cpu", reps=2)
    path = tmp_path / "kb.json"
    with open(path, "w") as f:
        json.dump(kernels_bench.to_profile_dict(rows), f)
    prof = CalibrationProfile.load(str(path))
    assert sorted(prof.kernels) == ["flash_attention(K4)", "ssd_scan(K5)"]
    assert sorted(prof.skipped_kernels) == sorted(kernels_bench.TILE_KERNELS)
    for r in rows[-2:]:
        assert r["max_abs_err_vs_plain"] == 0.0 and r["ms"] > 0 and r["plain_ms"] > 0
    assert "flash_attention(K4)" in troof.render_calibration_table(prof.to_dict())


def test_run_writes_the_comm_modes_section_of_the_reference(tmp_path):
    """``repro_torch.run``'s comm section: ``comm_modes.modes`` at the
    reference's full sizes, the rows of ``benchmarks/comm_modes.py::run``
    (its keys, and its byte columns from a live reference run)."""
    from repro_torch import run as trun
    assert trun.main(["--device", "cpu", "--out", str(tmp_path), "--repeats", "1",
                      "--curve", "sparselu:small:1,2", "--skip-roofline"]) == 0
    with open(tmp_path / "comm_modes.json") as f:
        got = json.load(f)
    live = jcm.run()
    keys = ("mode", "devices", "bytes_to", "bytes_from", "bytes_peer", "funnel_MB",
            "peer_MB")
    assert [set(r) for r in got] == [set(r) for r in live]
    assert [tuple(r[k] for k in keys) for r in got] == \
        [tuple(r[k] for k in keys) for r in live]
    assert (tmp_path / "results.json").exists()


def test_refresh_host_profile_writes_a_loadable_profile(tmp_path):
    from repro_torch.core import ClusterRuntime, RuntimeConfig
    from repro_torch.core.costmodel import PAPER_ETHERNET
    path = pg.refresh_host_profile("cpu", directory=str(tmp_path))
    assert os.path.dirname(path) == str(tmp_path)
    rt = ClusterRuntime(RuntimeConfig(n_virtual=pg.N_DEV, link=PAPER_ETHERNET),
                        table=pg.bl._make_table(pg.N_DEV), device="cpu")
    try:
        prof = rt.load_calibration(path)
    finally:
        rt.shutdown()
    assert sorted(prof.kernels) == ["bdiv", "bmod", "fwd", "lu0"]
    assert {"funnel", "peer"} <= {k.split(":")[0] for k in prof.links}
