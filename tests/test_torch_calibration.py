"""Measured cost calibration on both packages: the counterparts of
``tests/test_calibration.py`` on the port (profiles, seeding, staleness,
bit-identity with calibration on and off), and profiles crossing between
the packages: one written by either package's ``calibrate`` loads in the
other and seeds ``kernel_time`` and ``cost.link`` identically."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import benchmarks.bots_sparselu as jbl  # noqa: E402
import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core.calibrate import host_info as j_host_info  # noqa: E402
from repro_torch.bots import sparselu as tbl  # noqa: E402
from repro_torch.core.calibrate import (CALIB_TAG, SCHEMA_VERSION,  # noqa: E402
                                        _dry_run_counts, host_info)
from repro_torch.core.costmodel import (DEFAULT_KERNEL_TIME_S,  # noqa: E402
                                        H100_SXM_HBM_BW_Bps,
                                        H100_SXM_PEAK_FLOPS_BF16)
from repro_torch.ft.stragglers import StragglerDetector  # noqa: E402

torch.set_num_threads(1)      # six test workers share the CPU

FAST = dict(reps=2, warmup=1, sizes=(1 << 12, 1 << 16))


def _toy_table(pkg):
    """The reference test's toy table, in ``pkg``'s arrays (same names in
    the same order: the same fingerprint)."""
    t = pkg.KernelTable()
    if pkg is J:
        ones = lambda: jnp.ones((64, 64), jnp.float32)  # noqa: E731
    else:
        ones = lambda: torch.ones(64, 64)  # noqa: E731
    t.register("axpy", lambda x, y: {"out": 2.0 * x + y},
               example=lambda: (ones(), ones()))
    t.register("scale", lambda x: {"out": 3.0 * x}, example=ones)
    return t


def _runtime(pkg, n=2, table=None, **kw):
    cfg = pkg.RuntimeConfig(n_virtual=n, link=pkg.PAPER_ETHERNET, **kw)
    table = table or _toy_table(pkg)
    if pkg is J:
        return J.ClusterRuntime(cfg, table=table)
    return T.ClusterRuntime(cfg, table=table, device="cpu")


def _synthetic_profile(n_devices, fingerprint, *, kernel_s=42e-6,
                       funnel=(2e9, 5e-6), peer=(1e7, 2e-4),
                       version=SCHEMA_VERSION, topology=None):
    return T.CalibrationProfile(
        version=version, created_unix=1.0, host=host_info(),
        n_devices=n_devices, table_fingerprint=fingerprint,
        topology=topology,
        kernels={"axpy": T.KernelProfile(name="axpy", seconds=kernel_s),
                 "scale": T.KernelProfile(name="scale", seconds=2 * kernel_s)},
        links={"funnel": T.LinkProfile("funnel", *funnel),
               "peer": T.LinkProfile("peer", *peer)})


# ---------------------------------------------------------------------------
# alpha-beta fit
# ---------------------------------------------------------------------------
def test_fit_alpha_beta_recovers_link():
    bw, lat = 5e8, 2e-4
    samples = [(n, lat + n / bw) for n in (1 << 14, 1 << 18, 1 << 22)] * 2
    got_lat, got_bw = T.fit_alpha_beta(samples)
    assert got_lat == pytest.approx(lat, rel=1e-6)
    assert got_bw == pytest.approx(bw, rel=1e-6)


def test_fit_alpha_beta_degenerate_clamps():
    lat, bw = T.fit_alpha_beta([(1024, 1e-4), (1024, 1.2e-4)])
    assert lat >= 0.0 and bw == 1e12
    # noisy tiny messages where time *decreases* with size: bandwidth clamps
    lat, bw = T.fit_alpha_beta([(1024, 2e-4), (4096, 1e-4)])
    assert bw == 1e12 and lat >= 0.0


def test_fit_alpha_beta_equals_reference():
    """The same floats as the reference's fit on the same samples: a fit,
    one size, a falling time, one sample, none."""
    for samples in ([(1 << 14, 3.1e-4), (1 << 20, 2.2e-3), (1 << 23, 1.7e-2),
                     (1 << 14, 2.9e-4)],
                    [(1024, 1e-4), (1024, 1.2e-4)], [(1024, 2e-4), (4096, 1e-4)],
                    [(4096, 5e-5)], []):
        assert T.fit_alpha_beta(samples) == J.fit_alpha_beta(samples), samples


# ---------------------------------------------------------------------------
# round trip + seeding
# ---------------------------------------------------------------------------
def test_profile_round_trip_seeds_identically(tmp_path):
    rt = _runtime(T)
    try:
        prof = rt.calibrate(save_dir=str(tmp_path), **FAST)
        path = os.path.join(str(tmp_path), f"{prof.host['hostname']}.json")
        assert os.path.exists(path)
        loaded = T.CalibrationProfile.load(path)
        assert loaded.to_dict() == prof.to_dict()
        assert sorted(prof.kernels) == ["axpy", "scale"]
        assert set(prof.links) == {"funnel", "funnel:to", "funnel:from",
                                   "peer", "peer:fwd", "peer:rev"}
        # a fresh runtime seeded from disk prices exactly like the live one
        rt2 = _runtime(T)
        try:
            rt2.load_calibration(path)
            for k in ("axpy", "scale"):
                assert rt2.cost.kernel_time(k) == prof.kernel_seed(k)
            assert rt2.cost.link == prof.link_model("funnel")
            assert rt2.cost.peer_link == prof.link_model("peer")
            nb = 1 << 16
            assert rt2.cost.link.time(nb) == prof.link_model("funnel").time(nb)
        finally:
            rt2.shutdown()
    finally:
        rt.shutdown()


def test_calibration_discards_its_own_traffic():
    rt = _runtime(T)
    try:
        rt.calibrate(save_dir=None, **FAST)
        for records in ("transfers", "peers", "compute", "events",
                        "placements", "adjustments"):
            assert getattr(rt.cost, records) == [], records
        # the wire operations did run, under the calibration tag
        assert {c.tag for c in rt.pool.trace if c.op in ("XFER_TO", "SEND")} \
            == {CALIB_TAG}
        assert rt.cost.discard_tag(CALIB_TAG) == 0
    finally:
        rt.shutdown()


def _profile_dict(prof):
    d = prof.to_dict()
    d.pop("created_unix")
    d.pop("host")
    for k in d["kernels"].values():
        for key in ("seconds", "min_s", "max_s", "achieved_flops_per_s",
                    "flops", "intensity"):
            k.pop(key)
    return d


def test_profile_layout_and_counts_match_reference():
    """Both packages' calibrate on the toy table give the same profile but
    for the measured seconds, the host and the FLOPs: keys, fingerprint,
    reps, bytes, links (the sample sizes) and skipped kernels.  The port
    counts matmul-class FLOPs only (``FlopCounterMode``), so the toy
    table's elementwise kernels count 0 where XLA counts each add and
    multiply."""
    profs = {}
    for pkg in (J, T):
        rt = _runtime(pkg)
        try:
            profs[pkg] = rt.calibrate(save_dir=None, **FAST)
        finally:
            rt.shutdown()
    want, got = _profile_dict(profs[J]), _profile_dict(profs[T])
    for d in (want, got):
        for link in d["links"].values():
            link["samples"] = [n for n, _ in link["samples"]]
            link.pop("bandwidth_Bps")
            link.pop("latency_s")
    assert got == want
    assert set(profs[T].host) == set(j_host_info())
    assert [k.flops for k in profs[T].kernels.values()] == [0.0, 0.0]


# ---------------------------------------------------------------------------
# profiles cross between the packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_profile_written_by_one_package_loads_in_the_other(writer, tmp_path):
    """A profile saved by ``writer``'s ``calibrate`` (toy table: the same
    fingerprint in both) loads in the other package and seeds
    ``kernel_time``, ``cost.link`` and ``cost.peer_link`` identically."""
    src, dst = (J, T) if writer == "reference" else (T, J)
    rt = _runtime(src)
    try:
        prof = rt.calibrate(save_dir=str(tmp_path), **FAST)
        path = os.path.join(str(tmp_path), f"{prof.host['hostname']}.json")
    finally:
        rt.shutdown()
    rt = _runtime(dst)
    try:
        loaded = rt.load_calibration(path)
        assert loaded.to_dict() == prof.to_dict()
        for k in ("axpy", "scale"):
            assert rt.cost.kernel_time(k) == prof.kernel_seed(k)
        for mine, theirs in ((rt.cost.link, prof.link_model("funnel")),
                             (rt.cost.peer_link, prof.link_model("peer"))):
            assert (mine.name, mine.bandwidth_Bps, mine.latency_s) == \
                (theirs.name, theirs.bandwidth_Bps, theirs.latency_s)
        assert rt.cost.summary()["cold_predictions"] == 0.0
    finally:
        rt.shutdown()


@pytest.mark.parametrize("B", [16, 128])
def test_dry_run_counts_bmod(B):
    """bmod (a −= l @ u) counts 2·B³ FLOPs and 4·B²·4 bytes (three fp32
    operands and the output, each once)."""
    fn = tbl._make_table(1).lookup(tbl._make_table(1).index_of("bmod")).fn
    ops = tuple(torch.randn(B, B) for _ in range(3))
    flops, nbytes, call = _dry_run_counts(fn, ops, {})
    assert (flops, nbytes) == (2.0 * B ** 3, 4.0 * B * B * 4)
    assert call is fn


def test_dry_run_counts_what_the_cpu_cannot_run_as_zero():
    """An entry that cannot run on the CPU counts (0, 0), as the reference
    falls back when XLA cannot lower it; the timed call still runs."""
    def card_only(x):
        raise RuntimeError("this entry runs on the card only")
    assert _dry_run_counts(card_only, (torch.ones(2),), {}) == (0.0, 0.0, card_only)


# ---------------------------------------------------------------------------
# staleness
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["devices", "fingerprint", "schema", "topology"])
def test_stale_profile_rejected(case):
    rt = _runtime(T)
    try:
        fp = rt.pool.table.fingerprint()
        rt.load_calibration(_synthetic_profile(2, fp))    # matching: loads
        stale = {"devices": lambda: _synthetic_profile(4, fp),
                 "fingerprint": lambda: _synthetic_profile(2, "0" * 16),
                 "schema": lambda: _synthetic_profile(2, fp, version=-1),
                 "topology": lambda: _synthetic_profile(
                     2, fp, topology=T.Topology.two_tier(1, 2).describe())}[case]()
        with pytest.raises(T.StaleProfileError, match=case):
            rt.load_calibration(stale)
        # the reference refuses the same profile with the same message
        jrt = _runtime(J)
        try:
            with pytest.raises(J.StaleProfileError) as want:
                jrt.cost.load_profile(J.CalibrationProfile.from_dict(stale.to_dict()),
                                      n_devices=2, table_fingerprint=fp)
        finally:
            jrt.shutdown()
        with pytest.raises(T.StaleProfileError) as got:
            rt.load_calibration(stale)
        assert str(got.value) == str(want.value)
    finally:
        rt.shutdown()


def test_stale_topology_racks_mismatch():
    topo = T.Topology.two_tier(2, 2)
    rt = _runtime(T, n=4, comm_mode="direct", topology=topo)
    try:
        fp = rt.pool.table.fingerprint()
        rt.load_calibration(_synthetic_profile(4, fp, topology=topo.describe()))
        other = T.Topology.two_tier(4, 1).describe()
        with pytest.raises(T.StaleProfileError, match="racks"):
            rt.load_calibration(_synthetic_profile(4, fp, topology=other))
    finally:
        rt.shutdown()


def test_calibrate_under_racks_fits_each_tier():
    """Under a multi-rack topology the peer fabric is fitted per tier and
    the tiers' links take the fits."""
    topo = T.Topology.two_tier(2, 2)
    rt = _runtime(T, n=4, comm_mode="direct", topology=topo)
    try:
        before = topo.describe()
        prof = rt.calibrate(save_dir=None, **FAST)
        assert {"peer:intra", "peer:inter", "peer:intra:fwd",
                "peer:inter:rev"} <= set(prof.links)
        assert "peer" not in prof.links
        assert prof.topology == before      # the snapshot before the load
        assert rt.cost.topology.intra == prof.link_model("peer:intra")
        assert rt.cost.topology.inter == prof.link_model("peer:inter")
        assert rt.cost.peer_link == prof.link_model("peer:intra")
    finally:
        rt.shutdown()


# ---------------------------------------------------------------------------
# kernel_time fallback ladder
# ---------------------------------------------------------------------------
def _ladder(pkg, profile):
    cost = pkg.CostModel()
    out = [cost.kernel_time("nope"), cost.kernel_time("nope", default=7e-4),
           cost.summary()["cold_predictions"]]
    cost.profile = profile
    out += [cost.kernel_time("axpy"), cost.summary()["cold_predictions"]]
    cost.record_compute(0, 1e-2, kernel="axpy")
    cost.record_compute(0, 2e-2, kernel="axpy")
    out += [cost.kernel_time("axpy"), cost.summary()["cold_predictions"]]
    return out


def test_kernel_time_never_none_and_counts_cold():
    prof = _synthetic_profile(1, None)
    got = _ladder(T, prof)
    assert got[:3] == [DEFAULT_KERNEL_TIME_S, 7e-4, 2.0]
    assert got[3:5] == [42e-6, 2.0]                 # profile seed, not cold
    assert got[5] == pytest.approx(1.5e-2) and got[6] == 2.0   # live wins
    assert got == _ladder(J, J.CalibrationProfile.from_dict(prof.to_dict()))


def test_reset_keeps_profile_clears_cold_counter():
    cost = T.CostModel()
    cost.profile = _synthetic_profile(1, None)
    cost.kernel_time("unseeded")
    assert cost.cold_predictions == 1
    cost.reset()
    assert cost.cold_predictions == 0
    assert cost.kernel_time("axpy") == 42e-6


def test_straggler_threshold_ignores_cold_default():
    cost = T.CostModel()
    cost.profile = _synthetic_profile(1, None)
    det = StragglerDetector(cost, min_observations=2, grace_s=0.0)
    # no observations, no baseline: never hedge, neither off the cold
    # default nor off a calibration seed
    assert det.threshold("axpy") is None
    assert det.threshold("nope") is None
    det2 = StragglerDetector(cost, min_observations=2, grace_s=0.0,
                             baseline={"axpy": 1e-2})
    assert det2.threshold("axpy") == pytest.approx(3.0 * 1e-2)


# ---------------------------------------------------------------------------
# bit identity + determinism across policies
# ---------------------------------------------------------------------------
K, B = 3, 16


def _calibrated(pkg, rt):
    prof = pkg.CalibrationProfile(
        version=SCHEMA_VERSION, created_unix=1.0, host={}, n_devices=3,
        table_fingerprint=rt.pool.table.fingerprint(),
        kernels={k: pkg.KernelProfile(name=k, seconds=30e-6)
                 for k in ("lu0", "fwd", "bdiv", "bmod")},
        links={"funnel": pkg.LinkProfile("funnel", 2e9, 5e-6),
               "peer": pkg.LinkProfile("peer", 1e7, 2e-4)})
    rt.load_calibration(prof)


def _sparselu_run(policy, profile, pkg=T):
    bl = tbl if pkg is T else jbl
    mat = bl._matrix(K, B)
    rt = _runtime(pkg, n=3, table=bl._make_table(K))
    try:
        if profile:
            _calibrated(pkg, rt)
        res = rt.wavefront_offload(bl._build_dag(mat, K, B), nowait=True,
                                   peer=True, policy=policy)
        values = {k: np.asarray(v) for k, v in res.items()}
        placements = [(p.task, p.device) for p in rt.cost.placements]
    finally:
        rt.shutdown()
    return values, placements


@pytest.mark.parametrize("policy", ["round-robin", "locality", "heft-frozen"])
def test_results_bit_identical_calibration_on_off(policy):
    base_policy = (T.HeftPlacement(default_task_s=5e-6, use_observed=False)
                   if policy == "heft-frozen" else policy)
    cal_policy = (T.HeftPlacement(estimates="calibrated")
                  if policy == "heft-frozen" else policy)
    base, _ = _sparselu_run(base_policy, profile=False)
    cal, _ = _sparselu_run(cal_policy, profile=True)
    assert sorted(base) == sorted(cal)
    for k in base:
        assert base[k].tobytes() == cal[k].tobytes(), k


def test_calibrated_estimates_are_deterministic():
    """Calibrated HEFT places the same way twice, and as the reference
    places under the same profile; the values repeat bit for bit."""
    runs = [_sparselu_run(T.HeftPlacement(estimates="calibrated"), profile=True)
            for _ in range(2)]
    assert runs[0][1] == runs[1][1]
    for k in runs[0][0]:
        assert runs[0][0][k].tobytes() == runs[1][0][k].tobytes()
    jvalues, jplaced = _sparselu_run(J.HeftPlacement(estimates="calibrated"),
                                     profile=True, pkg=J)
    assert runs[0][1] == jplaced
    for k in jvalues:
        np.testing.assert_allclose(runs[0][0][k], jvalues[k], rtol=2e-5, atol=2e-5)


def test_heft_estimates_modes_validated():
    with pytest.raises(ValueError, match="estimates"):
        T.HeftPlacement(estimates="vibes")
    assert T.HeftPlacement(use_observed=False).estimates == "frozen"
    assert T.HeftPlacement().estimates == "observed"


# ---------------------------------------------------------------------------
# roofline report plumbing
# ---------------------------------------------------------------------------
def test_placement_report_roofline_payload():
    cost = T.CostModel()
    cost.profile = _synthetic_profile(1, None)
    cost.profile.kernels["axpy"].flops = 8192.0
    cost.profile.kernels["axpy"].bytes_accessed = 49152.0
    cost.record_compute(0, 50e-6, kernel="axpy")
    rep = cost.placement_report(roofline=True)
    assert set(rep) == {"placements", "roofline"}
    rows = {r["kernel"]: r for r in rep["roofline"]}
    axpy = rows["axpy"]
    assert axpy["observed_s"] == pytest.approx(50e-6)
    assert axpy["calibrated_s"] == pytest.approx(42e-6)
    assert axpy["model_ratio"] == pytest.approx(50e-6 / 42e-6)
    assert axpy["intensity"] == pytest.approx(8192.0 / 49152.0)
    assert axpy["bound"] == "memory"
    # the roof is the H100 SXM's at this intensity
    assert axpy["roof_flops_per_s"] == pytest.approx(
        8192.0 / 49152.0 * H100_SXM_HBM_BW_Bps)
    assert axpy["roofline_fraction"] == pytest.approx(
        8192.0 / 50e-6 / axpy["roof_flops_per_s"])
    # seeded-but-never-run kernel still shows up, with no observed side
    assert rows["scale"]["observed_s"] is None
    assert rows["scale"]["calibrated_s"] == pytest.approx(84e-6)
    # right of the ridge point (295 FLOP/B) a kernel is compute-bound at peak
    cost.profile.kernels["scale"].flops = 1e9
    cost.profile.kernels["scale"].bytes_accessed = 1e6
    scale = {r["kernel"]: r for r in cost.roofline_summary()}["scale"]
    assert scale["bound"] == "compute"
    assert scale["roof_flops_per_s"] == H100_SXM_PEAK_FLOPS_BF16
