"""Placement on both packages: the locality, HEFT and SLO policies and the
placement side of the cost model.  The port alone reproduces the byte table
of ``artifacts/bench/BENCH_sched.json``; on the sparselu DAG (K=4, B=64,
D=4, peer-routed and host-mediated) every deterministic policy places every
task on the reference's device, with the reference's byte counters,
per-device command sequences and ``placement_report`` rows.  Placement moves
bytes, never values: results are bit-identical within each package and
within 2e-5 between them (``tests/test_kernels.py``'s fp32 tolerance)."""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # container image lacks hypothesis
    from _hypothesis_shim import given, settings, st

ROOT = os.path.join(os.path.dirname(__file__), "..")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import benchmarks.bots_sparselu as jbl  # noqa: E402
import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch import sched_policies as tsp  # noqa: E402
from repro_torch.bots import sparselu as tbl  # noqa: E402

torch.set_num_threads(1)      # six test workers share the CPU

FP32_TOL = dict(rtol=2e-5, atol=2e-5)
COUNTERS = ("bytes_to", "bytes_from", "bytes_peer")
BENCH = os.path.join(ROOT, "artifacts", "bench", "BENCH_sched.json")


def _committed():
    with open(BENCH) as f:
        return json.load(f)["sections"]


# ---------------------------------------------------------------------------
# BENCH_sched.json from the port alone
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def sparselu_rows():
    return tsp.run_sparselu(device="cpu")


def test_sched_sparselu_uncapped_rows_equal_committed(sparselu_rows):
    committed = _committed()["sparselu"]
    assert [r["policy"] for r in sparselu_rows[:4]] == \
        [r["policy"] for r in committed[:4]]
    for got, want in zip(sparselu_rows[:4], committed[:4]):
        for key in ("bytes_to", "bytes_from", "bytes_peer", "devs_used",
                    "tasks", "devices"):
            assert got[key] == want[key], (got["policy"], key)


def test_sched_sparselu_capped_row_spills_and_refetches(sparselu_rows):
    # the reference's capped counts depend on thread timing (66-68
    # evictions over three CPU runs), so the gate is the reference's own:
    # run_sparselu asserted the result bit-identical; at least one eviction
    # and one refetch happened
    capped = sparselu_rows[4]
    assert capped["policy"] == _committed()["sparselu"][4]["policy"]
    assert capped["evictions"] >= 1 and capped["refetches"] >= 1, capped
    assert capped["bytes_peer"] == 0.0


def test_sched_strips_rows_equal_committed():
    rows = tsp.run_strips(device="cpu")
    committed = _committed()["strips"]
    assert len(rows) == len(committed)
    for got, want in zip(rows, committed):
        for key in ("policy", "devices", "strips", "bytes_to", "bytes_from",
                    "bytes_peer"):
            assert got[key] == want[key], (got["policy"], key)


# ---------------------------------------------------------------------------
# placement parity on the sparselu DAG
# ---------------------------------------------------------------------------
K, B, D = 4, 64, 4


def _policy(pkg, name):
    if name in ("round-robin", "locality"):
        return name
    cls, est = {"heft-5us": (pkg.HeftPlacement, 5e-6),
                "heft-100us": (pkg.HeftPlacement, 100e-6),
                "slo": (pkg.SloPlacement, 5e-6)}[name]
    return cls(default_task_s=est, use_observed=False)


def _sparselu_run(pkg, policy, peer):
    """Serial dispatch (``nowait=False``), so every per-device command
    sequence is exact; returns results, counters, task→device, per-device
    command kinds and the placement-report triples."""
    if pkg is T:
        mat = tbl._matrix(K, B)
        rt = T.ClusterRuntime(T.RuntimeConfig(n_virtual=D),
                              table=tbl._make_table(K), device="cpu")
        dag = tbl._build_dag(mat, K, B)
    else:
        mat = jbl._matrix(K, B)
        rt = J.ClusterRuntime(J.RuntimeConfig(n_virtual=D),
                              table=jbl._make_table(K))
        dag = jbl._build_dag(mat, K, B)
    try:
        res = rt.wavefront_offload(dag, nowait=False, resident=True,
                                   peer=peer, policy=_policy(pkg, policy))
        s = rt.cost.summary()
        homes = {c.tag.rsplit(":", 1)[-1]: c.device for c in rt.cost.compute}
        kinds = {d: [c.op for c in rt.pool.trace if c.device == d]
                 for d in range(D)}
        report = [(r["task"], r["policy"], r["device"])
                  for r in rt.cost.placement_report()]
        ok = all(r["observed_device_ok"] for r in rt.cost.placement_report())
    finally:
        rt.shutdown()
    vals = {k: np.asarray(v) for k, v in res.items()}
    return vals, {k: s[k] for k in COUNTERS}, homes, kinds, report, ok


@pytest.mark.parametrize("peer", [True, False], ids=["peer", "host"])
@pytest.mark.parametrize("policy", ["round-robin", "locality", "heft-5us",
                                    "heft-100us", "slo"])
def test_sparselu_placement_matches_reference(policy, peer):
    tv, tc, th, tk, tr, tok = _sparselu_run(T, policy, peer)
    jv, jc, jh, jk, jr, jok = _sparselu_run(J, policy, peer)
    assert len(th) == K * (K + 1) * (2 * K + 1) // 6
    assert th == jh
    assert tc == jc
    assert tk == jk
    assert tr == jr
    assert tok and jok
    if policy in ("heft-5us", "heft-100us", "slo"):
        assert len(tr) == len(th)            # every decision logged
    for k in jv:
        np.testing.assert_allclose(tv[k], jv[k], **FP32_TOL)


def test_sparselu_policies_bit_identical_within_the_port():
    ref = None
    for policy in ("round-robin", "locality", "heft-5us", "heft-100us", "slo"):
        vals = _sparselu_run(T, policy, True)[0]
        if ref is None:
            ref = vals
        for k in ref:
            np.testing.assert_array_equal(vals[k], ref[k])


# ---------------------------------------------------------------------------
# random DAGs: every policy bit-identical, host and peer modes alike
# ---------------------------------------------------------------------------
def _combine_table():
    table = T.KernelTable()
    table.register("combine", lambda x: {"out": x @ x * 1e-2 + 1.0})
    return table


@settings(max_examples=5, deadline=None)
@given(st.integers(0, 10_000), st.integers(4, 9), st.integers(2, 4))
def test_policies_bit_identical_on_random_dags(seed, n_tasks, n_dev):
    rng = np.random.default_rng(seed)
    Bs = 4
    spec = T.TensorSpec((Bs, Bs), torch.float32)
    init = torch.from_numpy(rng.standard_normal((Bs, Bs)).astype(np.float32))
    tasks = []
    for i in range(n_tasks):
        n_deps = int(rng.integers(0, min(i, 2) + 1))
        deps = tuple(f"t{j}" for j in
                     rng.choice(i, size=n_deps, replace=False)) if i else ()
        tasks.append(T.DagTask(
            f"t{i}", "combine", deps,
            (lambda init=init: lambda dv: T.MapSpec(
                to=({"x": next(iter(dv.values()))} if dv else {"x": init}),
                from_={"out": spec}))()))
    ref = None
    for peer in (False, True):
        for policy in ("round-robin", "locality", "heft", "slo"):
            rt = T.ClusterRuntime(T.RuntimeConfig(n_virtual=n_dev),
                                  table=_combine_table(), device="cpu")
            try:
                res = rt.wavefront_offload(list(tasks), nowait=True,
                                           peer=peer, policy=policy)
            finally:
                rt.shutdown()
            if ref is None:
                ref = res
            for k in ref:
                assert torch.equal(ref[k], res[k]), (policy, peer, k)


# ---------------------------------------------------------------------------
# the policies themselves
# ---------------------------------------------------------------------------
def test_resolve_policy_forms():
    assert isinstance(T.resolve_policy(None), T.RoundRobin)
    assert isinstance(T.resolve_policy("round-robin"), T.RoundRobin)
    assert isinstance(T.resolve_policy("locality"), T.LocalityAffinity)
    assert isinstance(T.resolve_policy("heft"), T.HeftPlacement)
    assert isinstance(T.resolve_policy("slo"), T.SloPlacement)
    assert isinstance(T.resolve_policy(T.HeftPlacement), T.HeftPlacement)
    p = T.HeftPlacement(default_task_s=1e-6)
    assert T.resolve_policy(p) is p
    assert p.estimates == "observed"
    assert T.HeftPlacement(use_observed=False).estimates == "frozen"
    with pytest.raises(ValueError, match="unknown placement policy"):
        T.resolve_policy("fifo")
    with pytest.raises(ValueError, match="estimates"):
        T.HeftPlacement(estimates="guessed")
    with pytest.raises(TypeError):
        T.resolve_policy(42)


def _ctx(pkg, D=3, cap=None):
    kw = {"device": "cpu"} if pkg is T else {}
    pool = pkg.DevicePool.virtual(D, capacity_bytes=cap, **kw)
    return pool, pkg.PlacementContext(pool=pool, cost=pool.cost, D=D)


@pytest.mark.parametrize("pkg", [T, J], ids=["torch", "jax"])
def test_locality_scores_present_tables_and_replicas(pkg):
    """Producer-less reads score through the present tables, producer reads
    through the replica map; no signal is round-robin."""
    pool, ctx = _ctx(pkg)
    try:
        ex = pkg.TargetExecutor(pool)
        value = (torch.ones(16) if pkg is T else jnp.ones(16))
        ex.enter_data(2, "e", w=value)
        pol = pkg.LocalityAffinity()
        node = pkg.TaskNode(name="n", kernel="k", reads=("w",))
        assert pol.place(ctx, node, 0, "t") == 2
        blind = pkg.TaskNode(name="m", kernel="k")
        assert [pol.place(ctx, blind, i, "t") for i in range(4)] == [0, 1, 2, 0]
        ctx.replicas["p"] = {0, 1}
        ctx.out_bytes["p"] = 1000
        ctx.load = {0: 2, 1: 0}
        dep = pkg.TaskNode(name="c", kernel="k", deps=("p",), reads=("p",))
        assert pol.place(ctx, dep, 0, "t") == 1      # tie broken by load
        ex.exit_data(2, "w")
        if pkg is T:
            ex.close()
    finally:
        pool.stop_all()


@pytest.mark.parametrize("pkg", [T, J], ids=["torch", "jax"])
def test_slo_backlog_charge_release_and_pressure(pkg):
    pool, ctx = _ctx(pkg, D=2, cap=1024)
    try:
        pol = pkg.SloPlacement(default_task_s=1.0, use_observed=False)
        pol.begin(ctx)
        node = pkg.TaskNode(name="n", kernel="k")
        first = pol.place(ctx, node, 0, "a")
        assert first == 0 and pol.backlog(0) == 1.0
        assert pol.place(ctx, node, 1, "b") == 1     # tail-first: spread
        pol.charge(0, 5.0)
        assert pol.backlog(0) == 6.0
        pol.release(0, 10.0)
        assert pol.backlog(0) == 0.0
        assert pol._pressure(ctx, 0) == 0.0
        rows = [(r["task"], r["device"]) for r in pool.cost.placement_report()]
        assert rows == [("a", 0), ("b", 1)]
    finally:
        pool.stop_all()


def test_heft_observed_reads_the_exec_seconds():
    """``estimates="observed"``: before any EXEC the estimate is cold (the
    default, counted); after one it is the mean EXEC seconds recorded."""
    mat = tbl._matrix(3, 16)
    rt = T.ClusterRuntime(T.RuntimeConfig(n_virtual=2),
                          table=tbl._make_table(3), device="cpu")
    try:
        res = tbl.wavefront(rt, mat, peer=True, policy="heft")
        assert rt.cost.summary()["cold_predictions"] >= 1
        assert rt.cost.kernel_observations("bmod") == 5
        assert rt.cost.kernel_time("bmod") > 0.0
        rows = rt.cost.placement_report()
        assert len(rows) == len(res) and all(r["observed_device_ok"]
                                             for r in rows)
        ref = tbl.serial(rt, mat)
    finally:
        rt.shutdown()
    assert torch.equal(tbl.assemble(res, 3), ref)


# ---------------------------------------------------------------------------
# the placement side of the cost model
# ---------------------------------------------------------------------------
def _cost_script(pkg):
    c = pkg.CostModel()
    out = [c.kernel_time("bmod"), c.kernel_time("bmod", default=5e-6)]
    c.record_compute(0, 0.5, tag="g:w0:a", kernel="bmod")
    c.record_compute(1, 0.25, tag="g:w0:b", kernel="bmod")
    c.record_compute(1, 0.125, tag="g:w0:b:again", kernel="lu0")
    out += [c.kernel_time("bmod"), c.kernel_time("lu0"), c.kernel_time("fwd"),
            c.kernel_observations("bmod"), c.kernel_observations("fwd")]
    c.record_placement("g:w0:a", 0, 0.5, policy="heft")
    c.record_placement("g:w0:b", 0, 0.75, policy="heft")
    report = c.placement_report()
    out.append(c.summary()["cold_predictions"])
    c.reset()
    out.append(c.summary()["cold_predictions"])
    return out, report


def test_cost_model_kernel_time_and_report_match_reference():
    got, report = _cost_script(T)
    want, jreport = _cost_script(J)
    assert got == want
    assert report == jreport
    assert [r["observed_device_ok"] for r in report] == [True, False]


def test_roofline_report_and_calibrated_estimates_follow_the_profile():
    c = T.CostModel()
    # no profile: the roofline rows come from the observations alone
    c.record_compute(0, 0.5, tag="g:w0:a", kernel="bmod")
    rep = c.placement_report(roofline=True)
    assert rep["placements"] == [] and [r["kernel"] for r in rep["roofline"]] == ["bmod"]
    assert rep["roofline"][0]["calibrated_s"] is None
    # a loaded profile seeds kernel_time and the funnel link
    prof = T.CalibrationProfile(
        n_devices=2, kernels={"bmod": T.KernelProfile("bmod", 4e-5, flops=2.0 * 128 ** 3,
                                                      bytes_accessed=4.0 * 128 * 128 * 4)},
        links={"funnel": T.LinkProfile("funnel", 1e10, 1e-5)})
    c.load_profile(prof, n_devices=2)
    assert c.profile is prof and c.link == prof.link_model("funnel")
    assert c.kernel_time("lu0") == T.DEFAULT_KERNEL_TIME_S
    row = c.roofline_summary()[0]
    assert row["calibrated_s"] == 4e-5 and row["model_ratio"] == 0.5 / 4e-5
    assert row["intensity"] == 2.0 * 128 ** 3 / (4.0 * 128 * 128 * 4)
    with pytest.raises(T.StaleProfileError, match="devices"):
        c.load_profile(prof, n_devices=4)
    # "calibrated" with no profile falls to default_task_s, as the reference
    pool, ctx = _ctx(T, D=2)
    try:
        pol = T.HeftPlacement(default_task_s=3e-3, estimates="calibrated")
        assert pol._estimate(ctx, "bmod") == 3e-3
        assert pool.cost.cold_predictions == 0
        # and with one, to the profile's seed
        pool.cost.load_profile(prof)
        assert pol._estimate(ctx, "bmod") == 4e-5
        assert pol._estimate(ctx, "lu0") == 3e-3
    finally:
        pool.stop_all()
