"""Stragglers and deadlines on both packages: command deadlines
(``DevicePool(deadline_s=)``, ``StragglerTimeout``), transport op timeouts,
``StragglerDetector`` with hedged ``run_graph``, and speculative
``offload_strips``.

Within the port, a run under hung or slow commands equals its fault-free run
bit for bit, as the reference claims for itself
(``tests/test_fault_tolerance.py``).  Across the packages the fault-free
values agree within fp32's 2e-5 (``tests/test_kernels.py``); where the
schedule does not depend on the clock (no fault, serial dispatch) the byte
counters and command sequences are the reference's.  The two timing tests
keep the reference's bounds.
"""
import collections
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import benchmarks.bots_sparselu as jbl  # noqa: E402
import repro.core as J  # noqa: E402
import repro.ft as JF  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.ft as TF  # noqa: E402
from repro.core.costmodel import CostModel as JCostModel  # noqa: E402
from repro_torch import comm_modes as cm  # noqa: E402
from repro_torch.bots import sparselu as tbl  # noqa: E402
from repro_torch.core.costmodel import CostModel as TCostModel  # noqa: E402

torch.set_num_threads(1)      # six test workers share the CPU

FP32_TOL = dict(rtol=2e-5, atol=2e-5)
COUNTERS = ("bytes_to", "bytes_from", "bytes_peer")
POLICIES = ("round-robin", "locality", "heft")
FT = {J: JF, T: TF}
KERNELS = ("src", "combine", "combine2")


# ---------------------------------------------------------------------------
# fixtures: the reference suite's kernels, diamond and sparselu
# ---------------------------------------------------------------------------
def _table(pkg):
    table = pkg.KernelTable()
    if pkg is T:
        table.register("src", lambda s: {"out": s * torch.ones((4, 4))})
    else:
        table.register("src", lambda s: {"out": s * jnp.ones((4, 4), jnp.float32)})
    table.register("combine", lambda x: {"out": x @ x * 1e-2 + 1.0})
    table.register("combine2", lambda x, y: {"out": x @ x * 1e-2 + y})
    table.register("double", lambda x: {"out": x * 2.0})
    table.register("square", lambda xs: {"out": xs * xs})
    return table


def _spec(pkg, shape):
    if pkg is T:
        return T.TensorSpec(shape, torch.float32)
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def _scalar(pkg, v):
    return torch.tensor(v, dtype=torch.float32) if pkg is T else jnp.float32(v)


def _arr(pkg, a):
    return torch.from_numpy(np.ascontiguousarray(a)) if pkg is T else jnp.asarray(a)


def _pool(pkg, n, table, **kw):
    if pkg is T:
        return T.DevicePool.virtual(n, table=table, device="cpu", **kw)
    return J.DevicePool.virtual(n, table=table, **kw)


def _diamond(pkg):
    """a → {b, c} → d."""
    sds = _spec(pkg, (4, 4))
    return pkg.TaskGraph([
        pkg.TaskNode("a", "src", (), lambda dv: pkg.MapSpec(
            to={"s": _scalar(pkg, 3.0)}, from_={"out": sds})),
        pkg.TaskNode("b", "combine", ("a",), lambda dv: pkg.MapSpec(
            to={"x": dv["a"]}, from_={"out": sds})),
        pkg.TaskNode("c", "combine", ("a",), lambda dv: pkg.MapSpec(
            to={"x": dv["a"]}, from_={"out": sds})),
        pkg.TaskNode("d", "combine2", ("b", "c"), lambda dv: pkg.MapSpec(
            to={"x": dv["b"], "y": dv["c"]}, from_={"out": sds})),
    ])


def _sparselu(pkg, K=4, B=32):
    if pkg is T:
        mat = tbl._matrix(K, B)
        return tbl._make_table(K), T.TaskGraph.from_tasks(tbl._build_dag(mat, K, B))
    mat = jbl._matrix(K, B)
    return jbl._make_table(K), J.TaskGraph.from_tasks(jbl._build_dag(mat, K, B))


def _host(res):
    return {k: np.asarray(v) for k, v in res.items()}


def _same_bits(ref, vals, what=""):
    assert set(ref) == set(vals)
    for k in ref:
        assert np.array_equal(ref[k], vals[k]), (what, k)


def _close(ref, vals):
    for k in ref:
        np.testing.assert_allclose(vals[k], ref[k], **FP32_TOL)


def _run(pkg, graph, table, *, n_dev=3, deadline_s=None, inject=None,
         wrap=None, **graph_kw):
    """One run on a fresh pool (optionally with a command deadline, seeded
    injection ``inject=dict(p=, seed=, ...)`` on every device, or one
    ``FlakyDevice`` ``wrap=(device, dict(...))``); returns the values, the
    pool's byte counters, its per-device command kinds and the pool (stopped)."""
    pool = _pool(pkg, n_dev, table, deadline_s=deadline_s)
    ex = pkg.TargetExecutor(pool)
    try:
        if inject is not None:
            FT[pkg].inject_flaky(pool, **inject)
        if wrap is not None:
            d, kw = wrap
            pool.devices[d] = FT[pkg].FlakyDevice(pool.devices[d], **kw)
        det = graph_kw.pop("detector", None)
        if det is not None:
            det = det(pool)
        res = pkg.run_graph(ex, graph, stragglers=det, **graph_kw)
        pool.sync()
        s = pool.cost.summary()
        kinds = {d: [c.op for c in pool.trace if c.device == d]
                 for d in range(n_dev)}
    finally:
        pool.stop_all()
    return _host(res), {k: s[k] for k in COUNTERS}, kinds, pool, det


def _detector(pkg, **kw):
    return lambda pool: FT[pkg].StragglerDetector(pool.cost, **kw)


# ---------------------------------------------------------------------------
# command deadlines: hung commands become recoverable StragglerTimeouts
# ---------------------------------------------------------------------------
def test_chaos_hang_bit_identical():
    """Seeded EXEC hangs under a command deadline, every policy, both edge
    routings, p ∈ {0.05, 0.2}: the hung commands blow the deadline, are
    recovered like any fault, and the values are the fault-free run's, which
    match the reference's."""
    table = _table(T)
    graph = _diamond(T)
    ref = _run(T, graph, table)[0]
    _close(_run(J, _diamond(J), _table(J))[0], ref)
    for peer in (False, True):
        for policy in POLICIES:
            for p in (0.05, 0.2):
                vals, *_ = _run(T, graph, table, deadline_s=0.15, policy=policy,
                                peer=peer, max_retries=60,
                                inject=dict(p=p, seed=101, ops=("EXEC",),
                                            mode="hang", hang_s=0.4))
                _same_bits(ref, vals, (policy, peer, p))


@pytest.mark.parametrize("op", ["EXEC", "XFER_FROM"])
def test_hang_deadline_classified_as_straggler(op):
    """A hung value-producing command surfaces as a StragglerTimeout, a
    DeviceFailure counted per op in ``pool.straggler_timeouts``, and the run
    finishes with the fault-free values."""
    table = _table(T)
    graph = _diamond(T)
    ref = _run(T, graph, table)[0]
    vals, _, _, pool, _ = _run(T, graph, table, deadline_s=0.1, max_retries=60,
                               inject=dict(p=0.6, seed=3, ops=(op,),
                                           mode="hang", hang_s=0.5))
    assert pool.straggler_timeouts.get(op, 0) >= 1
    assert issubclass(TF.StragglerTimeout, TF.DeviceFailure)
    assert TF.StragglerTimeout is T.StragglerTimeout
    _same_bits(ref, vals)


def test_blown_deadline_leaves_no_late_failure():
    """The timed-out command is not cancelled: it runs on, fails late, and
    neither its failure nor anything it stashed surfaces at a later sync."""
    table = _table(T)
    pool = _pool(T, 2, table, deadline_s=0.05)
    try:
        pool.devices[0] = TF.FlakyDevice(pool.devices[0], p=1.0, seed=0,
                                         ops=("EXEC",), mode="hang", hang_s=0.3)
        h = pool.alloc(0, (4, 4), torch.float32)
        pool.transfer_to(0, h, torch.ones(4, 4))
        with pytest.raises(T.StragglerTimeout) as err:
            pool.exec_kernel(0, "double", {"x": h})
        assert (err.value.op, err.value.device) == ("EXEC", 0)
        assert pool.straggler_timeouts == {"EXEC": 1}
        pool.sync()                       # waits for the hang; raises nothing
        got = pool.transfer_from(0, h)    # the device still serves
        assert torch.equal(got, torch.ones(4, 4))
    finally:
        pool.stop_all()


def test_slow_mode_stalls_match_reference():
    """SLOW is a straggler, not a fault: every EXEC stalls and completes; no
    failure, no blacklist; the stalls per device and op are the
    reference's (locality places the diamond the same way in both)."""
    got = {}
    for pkg in (J, T):
        vals, _, _, pool, _ = _run(
            pkg, _diamond(pkg), _table(pkg), policy="locality",
            inject=dict(p=1.0, seed=3, mode="slow", slow_s=0.05))
        got[pkg] = ([dict(d.stalls_by_op) for d in pool.devices], vals)
        assert sum(d.failures for d in pool.devices) == 0
        assert not pool.health.blacklist
    assert got[T][0] == got[J][0]
    assert sum(s.get("EXEC", 0) for s in got[T][0]) == 4
    _same_bits(_run(T, _diamond(T), _table(T))[0], got[T][1])
    _close(got[J][1], got[T][1])


# ---------------------------------------------------------------------------
# hedged run_graph
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("peer", [False, True])
def test_slow_device_hedged_duplicate_wins_bit_identical(peer):
    """A persistently slow device's tasks are hedged onto a healthy one; the
    duplicate wins, the loser's records are struck (each task's compute is
    counted once) and the values are the fault-free run's."""
    table = _table(T)
    graph = _diamond(T)
    ref = _run(T, graph, table)[0]
    vals, _, _, pool, det = _run(
        T, graph, table, policy="round-robin", peer=peer,
        wrap=(0, dict(p=1.0, seed=11, ops=("EXEC",), mode="slow", slow_s=0.5)),
        detector=_detector(T, k=3.0, grace_s=0.05, poll_s=0.01,
                           baseline={k: 0.01 for k in KERNELS}))
    rep = det.report()
    assert rep["hedge_wins"] >= 1, rep
    assert rep["hedges_launched"] <= det.max_hedges
    assert len(pool.cost.compute) == len(ref)
    # a hedge's records went onto the primary's tag, and no hedge tag stays
    assert not any("~hedge" in c.tag for c in pool.cost.compute)
    _same_bits(ref, vals, peer)


def test_no_hedges_and_no_overhead_at_p0():
    """A detector with nothing slow launches no hedge: values, byte counters
    and the commands each device ran equal the detector-free run's, and the
    counters equal the reference's."""
    table = _table(T)
    ref, ref_counters, ref_kinds, *_ = _run(T, _diamond(T), table,
                                            policy="heft", peer=True)
    vals, counters, kinds, _, det = _run(
        T, _diamond(T), table, policy="heft", peer=True,
        detector=_detector(T, k=3.0, grace_s=10.0))
    assert det.report()["hedges_launched"] == 0
    _same_bits(ref, vals)
    assert counters == ref_counters
    assert ({d: collections.Counter(k) for d, k in kinds.items()}
            == {d: collections.Counter(k) for d, k in ref_kinds.items()})
    jvals, jcounters, *_ = _run(J, _diamond(J), _table(J), policy="heft",
                                peer=True, detector=_detector(J, k=3.0, grace_s=10.0))
    assert counters == jcounters
    _close(jvals, vals)


def test_serial_dispatch_with_a_detector_matches_reference():
    """``nowait=False`` never polls: with a detector attached, sparselu's
    per-device command sequences and byte counters are the reference's and
    the detector-free run's, and no hedge launches."""
    runs = {}
    for pkg in (J, T):
        table, graph = _sparselu(pkg)
        runs[pkg] = _run(pkg, graph, table, n_dev=4, nowait=False,
                         detector=_detector(pkg, k=1.0, grace_s=0.0,
                                            baseline={"bmod": 0.0}))
    (jv, jc, jk, _, jdet), (tv, tc, tk, _, tdet) = runs[J], runs[T]
    assert tk == jk and tc == jc
    assert tdet.hedges_launched == jdet.hedges_launched == 0
    _close(jv, tv)
    table, graph = _sparselu(T)
    plain = _run(T, graph, table, n_dev=4, nowait=False)
    _same_bits(plain[0], tv)
    assert plain[1:3] == (tc, tk)


def test_chaos_sparselu_slow_hedging_bounds_makespan():
    """Sparselu at D=4 with a persistently slow device, peer-routed under
    locality: the hedged run's modeled makespan stays within 2× the
    fault-free run's (the loser's stalled records are struck, so each task
    is modeled once, at its winning copy's cost), bit for bit."""
    table, graph = _sparselu(T)
    pool0 = _pool(T, 4, table)
    try:
        ref = _host(T.run_graph(T.TargetExecutor(pool0), graph,
                                policy="locality", peer=True))
        ref_makespan = pool0.cost.makespan()
        baseline = {k: pool0.cost.kernel_time(k)
                    for k in ("lu0", "fwd", "bdiv", "bmod")
                    if pool0.cost.kernel_time(k)}
    finally:
        pool0.stop_all()
    vals, _, _, pool, det = _run(
        T, graph, table, n_dev=4, policy="locality", peer=True,
        wrap=(0, dict(p=1.0, seed=5, ops=("EXEC",), mode="slow", slow_s=0.3)),
        detector=_detector(T, k=4.0, grace_s=0.05, poll_s=0.01, max_hedges=64,
                           baseline=baseline))
    _same_bits(ref, vals)
    rep = det.report()
    assert rep["hedge_wins"] >= 1, rep
    assert pool.cost.makespan() <= 2.0 * ref_makespan, \
        (pool.cost.makespan(), ref_makespan, rep)


def _heft_observed_placement(slow_s):
    """Serial sparselu K=4, B=16 on two CPU devices under HEFT's observed
    estimates, device 0 stalling every EXEC for ``slow_s``: the placement
    report's devices and each compute record's (device, seconds)."""
    table, graph = _sparselu(T, K=4, B=16)
    pool = _pool(T, 2, table)
    try:
        pool.devices[0] = TF.FlakyDevice(pool.devices[0], p=1.0, seed=1,
                                         ops=("EXEC",), mode="slow", slow_s=slow_s)
        res = _host(T.run_graph(T.TargetExecutor(pool), graph, policy="heft",
                                nowait=False))
        pool.sync()
        placed = [r["device"] for r in pool.cost.placement_report()]
        records = [(c.device, c.seconds) for c in pool.cost.compute]
    finally:
        pool.stop_all()
    return res, placed, records


def test_heft_observed_placement_ignores_outside_waits_on_the_busy_clock(monkeypatch):
    """A CPU device times an EXEC on its busy clock (the worker's CPU time
    plus injected stalls), not on the wall clock the reference and the card
    use.  Where stalls decide HEFT's observed estimates, a worker kept
    waiting outside the device's work (as a preempted thread is) leaves the
    placement and each record's stall as they were; the wall clock counts
    the wait.  (The reference's own observed placement differs from run to
    run here: its EXEC seconds include XLA's compilation and load noise.)"""
    slow_s = wait_s = 0.05
    quiet = _heft_observed_placement(slow_s)
    execute = T.NodeDevice.execute

    def kept_waiting(self, cmd, table, payload=None):
        if cmd.op == "EXEC":
            time.sleep(wait_s)
        return execute(self, cmd, table, payload)

    monkeypatch.setattr(T.NodeDevice, "execute", kept_waiting)
    waited = _heft_observed_placement(slow_s)
    assert waited[1] == quiet[1]
    assert {0, 1} <= set(quiet[1])
    for d, seconds in quiet[2] + waited[2]:
        assert (seconds >= slow_s) == (d == 0), (d, seconds)
    _same_bits(quiet[0], waited[0])
    wall = time.perf_counter
    monkeypatch.setattr(T.NodeDevice, "busy_clock", lambda self: wall())
    monkeypatch.setattr(TF.FlakyDevice, "busy_clock", lambda self: wall())
    walled = _heft_observed_placement(slow_s)
    assert all(seconds >= wait_s for _, seconds in walled[2])
    _same_bits(quiet[0], walled[0])


def test_hedge_of_inputs_resident_on_the_stalled_device_waits_out_the_stall():
    """Peer mode: b reads a's output, resident only on the stalled device 0.
    b's hedge must fetch it from there, and that SEND runs on device 0's one
    worker after b's own stalled EXEC: whichever copy wins, the task lands
    no earlier than the stall's end.  (The threshold, 0.3 s, leaves b's
    primary time to queue its EXEC first.)"""

    class OnZero(T.RoundRobin):
        def place(self, ctx, node, ready_index, region_tag):
            return 0

    sds = _spec(T, (4, 4))
    graph = T.TaskGraph([
        T.TaskNode("a", "src", (), lambda dv: T.MapSpec(
            to={"s": _scalar(T, 3.0)}, from_={"out": sds})),
        T.TaskNode("b", "combine", ("a",), lambda dv: T.MapSpec(
            to={"x": dv["a"]}, from_={"out": sds})),
    ])
    table = _table(T)
    ref = _run(T, graph, table, peer=True)[0]
    # only b's kernel has an estimate: a is never hedged and stays on 0
    t0 = time.monotonic()
    vals, _, _, pool, det = _run(
        T, graph, table, peer=True, policy=OnZero(),
        wrap=(0, dict(p=1.0, seed=1, ops=("EXEC",), mode="slow", slow_s=0.6)),
        detector=_detector(T, k=3.0, grace_s=0.05, poll_s=0.01,
                           baseline={"combine": 0.1}))
    assert time.monotonic() - t0 >= 1.2          # a's stall, then b's
    rep = det.report()
    assert rep["hedges_launched"] == 1
    assert rep["primary_wins"] + rep["hedge_wins"] == 1
    order = [(c.op, c.tag) for c in pool.stream_traces[0]]
    assert order.index(("EXEC", "graph:w1:b")) < \
        [i for i, (op, tag) in enumerate(order) if op == "SEND"][0]
    assert len(pool.cost.compute) == 2
    _same_bits(ref, vals)


def test_wavefront_offload_passes_stragglers_through():
    """``ClusterRuntime.wavefront_offload`` (sparselu's BOTS entry point) hands
    ``stragglers=`` to ``run_graph``: hedges launch and the factorization is
    the fault-free one, bit for bit."""
    K, B = 4, 32
    mat = tbl._matrix(K, B)
    out = {}
    for slow in (False, True):
        rt = T.ClusterRuntime(T.RuntimeConfig(n_virtual=4),
                              table=tbl._make_table(K), device="cpu")
        try:
            det = None
            if slow:
                rt.pool.devices[0] = TF.FlakyDevice(
                    rt.pool.devices[0], p=1.0, seed=2, ops=("EXEC",),
                    mode="slow", slow_s=0.2)
                det = TF.StragglerDetector(rt.cost, k=3.0, grace_s=0.05,
                                           poll_s=0.01, max_hedges=64,
                                           baseline=out["baseline"])
            out[slow] = tbl.assemble(tbl.wavefront(rt, mat, stragglers=det), K)
            if not slow:
                out["baseline"] = {k: rt.cost.kernel_time(k)
                                   for k in ("lu0", "fwd", "bdiv", "bmod")}
            else:
                assert det.report()["hedge_wins"] >= 1
        finally:
            rt.shutdown()
    assert torch.equal(out[True], out[False])


# ---------------------------------------------------------------------------
# transport op timeouts
# ---------------------------------------------------------------------------
def _hung_send_pool(pkg, hang_s=0.5, busy_dst_s=None):
    """Two devices; device 0 hangs every SEND; optionally device 1 runs a
    stalled region first (its worker busy for ``busy_dst_s``)."""
    table = _table(pkg)
    pool = _pool(pkg, 2, table)
    pool.devices[0] = FT[pkg].FlakyDevice(pool.devices[0], p=1.0, seed=5,
                                          ops=("SEND",), mode="hang",
                                          hang_s=hang_s)
    busy = None
    if busy_dst_s is not None:
        pool.devices[1] = FT[pkg].FlakyDevice(pool.devices[1], p=1.0, seed=5,
                                              ops=("EXEC",), mode="slow",
                                              slow_s=busy_dst_s)
        busy = pkg.TargetExecutor(pool).target(
            "double", 1, pkg.MapSpec(to={"x": _arr(pkg, np.ones((4, 4), np.float32))},
                                     from_={"out": _spec(pkg, (4, 4))}),
            nowait=True)
        while not any(c.op == "EXEC" for c in pool.stream_traces[1]):
            time.sleep(0.005)             # the stalled EXEC holds device 1
    dt = torch.float32 if pkg is T else jnp.float32
    h0 = pool.alloc(0, (8,), dt, tag="src")
    pool.transfer_to(0, h0, _arr(pkg, np.arange(8, dtype=np.float32)))
    h1 = pool.alloc(1, (8,), dt, tag="dst")
    pool.transfer_to(1, h1, _arr(pkg, np.zeros(8, np.float32)))
    return pool, h0, h1, busy


def test_transport_op_timeout_falls_back_to_funnel():
    """retries=0 + op_timeout_s: a hung SEND times out, is counted, and the
    edge reroutes through the funnel; the timed-out pair settles later
    without failing an innocent sync — at once or after it settles."""
    for wait_s in (0.0, 0.7):
        pool, h0, h1, _ = _hung_send_pool(T)
        try:
            tr = T.PeerTransport(retries=0, op_timeout_s=0.1)
            tr.sendrecv(pool, 0, h0, 1, h1, tag="edge").result()
            got = pool.transfer_from(1, h1, tag="chk")
            assert tr.timeouts >= 1 and tr.fallbacks == 1
            assert np.array_equal(got.numpy(), np.arange(8, dtype=np.float32))
            time.sleep(wait_s)
            pool.sync()                   # raises nothing
        finally:
            pool.stop_all()


def test_funnel_fallback_never_inherits_the_hung_send_failure():
    """The reference's fallback fetch queues on the source behind the hung
    SEND; once the SEND fails, the fetch's own sync raises the SEND's
    stashed failure unless the RECV on the destination has already absorbed
    it.  A busy destination makes that order certain: the reference raises,
    the port (which disowns the timed-out pair) delivers."""
    pool, h0, h1, busy = _hung_send_pool(J, busy_dst_s=1.5)
    try:
        tr = J.PeerTransport(retries=0, op_timeout_s=0.1)
        with pytest.raises(JF.DeviceFailure, match="injected SEND hang"):
            tr.sendrecv(pool, 0, h0, 1, h1, tag="edge")
    finally:
        busy.result()
        time.sleep(0.1)
        pool.stop_all()
    pool, h0, h1, busy = _hung_send_pool(T, busy_dst_s=1.5)
    try:
        tr = T.PeerTransport(retries=0, op_timeout_s=0.1)
        tr.sendrecv(pool, 0, h0, 1, h1, tag="edge").result()
        got = pool.transfer_from(1, h1, tag="chk")
        assert (tr.timeouts, tr.fallbacks) == (1, 1)
        assert np.array_equal(got.numpy(), np.arange(8, dtype=np.float32))
        busy.result()
        pool.sync()
    finally:
        pool.stop_all()


def test_op_timeout_retries_back_off_as_the_reference():
    """Hung SENDs with retries=2: three timeouts, two seeded backoffs of the
    reference's length (its failure-driven run draws the same delays from
    the same seed), then the funnel."""
    pool, h0, h1, _ = _hung_send_pool(T, hang_s=0.2)
    try:
        tr = T.PeerTransport(retries=2, op_timeout_s=0.05, backoff_base_s=1e-4,
                             seed=42)
        tr.sendrecv(pool, 0, h0, 1, h1, tag="edge").result()
        got = pool.transfer_from(1, h1)
        assert np.array_equal(got.numpy(), np.arange(8, dtype=np.float32))
        assert (tr.timeouts, tr.backoffs, tr.fallbacks) == (3, 2, 1)
        pool.sync()
    finally:
        pool.stop_all()
    jpool = _pool(J, 2, _table(J))
    try:
        JF.inject_flaky(jpool, p=1.0, seed=1, ops=("SEND",))
        jtr = J.PeerTransport(retries=2, backoff_base_s=1e-4, seed=42)
        h0 = jpool.alloc(0, (8,), jnp.float32)
        jpool.transfer_to(0, h0, jnp.arange(8, dtype=jnp.float32))
        h1 = jpool.alloc(1, (8,), jnp.float32)
        jtr.sendrecv(jpool, 0, h0, 1, h1).result()
    finally:
        jpool.stop_all()
    assert jtr.backoffs == tr.backoffs and jtr.backoff_s == tr.backoff_s


def test_runtime_config_wires_deadlines_and_backoff():
    kw = dict(n_virtual=2, comm_mode="direct", command_deadline_s=5.0,
              transport_retries=1, transport_op_timeout_s=2.0,
              transport_backoff_seed=9)
    got = []
    for rt in (J.ClusterRuntime(J.RuntimeConfig(**kw), table=_table(J)),
               T.ClusterRuntime(T.RuntimeConfig(**kw), table=_table(T),
                                device="cpu")):
        try:
            assert isinstance(rt.transport, (J.PeerTransport, T.PeerTransport))
            got.append((rt.pool.deadline_s, rt.transport.op_timeout_s,
                        rt.transport.retries, rt.pool.straggler_timeouts))
        finally:
            rt.shutdown()
    assert got[0] == got[1] == (5.0, 2.0, 1, {})


# ---------------------------------------------------------------------------
# the detector
# ---------------------------------------------------------------------------
def test_straggler_threshold_ignores_cold_default():
    """No observation and no baseline: never hedge (kernel_time's fallback
    never returns None); a baseline gives k times it; both packages agree."""
    for cost_model, ft in ((JCostModel, JF), (TCostModel, TF)):
        cost = cost_model()
        det = ft.StragglerDetector(cost, min_observations=2, grace_s=0.0)
        assert det.threshold("axpy") is None
        det2 = ft.StragglerDetector(cost, min_observations=2, grace_s=0.0,
                                    baseline={"axpy": 1e-2})
        assert det2.threshold("axpy") == pytest.approx(3.0 * 1e-2)
        assert not det2.should_hedge("axpy", 0.02) and det2.should_hedge("axpy", 0.04)
    assert TF.__all__ == [n for n in JF.__all__ if n != "elastic_shardings"]


# ---------------------------------------------------------------------------
# speculative offload_strips
# ---------------------------------------------------------------------------
def _square_maps(pkg, data):
    def make_maps(start, length):
        return pkg.MapSpec(to={"xs": pkg.sec(data, start, length)},
                           from_={"out": _spec(pkg, (length,))})
    return make_maps


def _strips(pkg, total, speculate, *, n_dev=3, nowait=True, wrap=None):
    pool = _pool(pkg, n_dev, _table(pkg))
    ex = pkg.TargetExecutor(pool)
    try:
        if wrap is not None:
            pool.devices[wrap[0]] = FT[pkg].FlakyDevice(pool.devices[wrap[0]],
                                                        **wrap[1])
        data = _arr(pkg, np.arange(total, dtype=np.float32))
        out = pkg.offload_strips(ex, "square", total, _square_maps(pkg, data),
                                 speculate=speculate, nowait=nowait)
        pool.sync()
        cost = pool.cost
        model = (sorted((t.direction, t.nbytes) for t in cost.transfers),
                 sorted(c.tag for c in cost.compute), cost.comm_time())
    finally:
        pool.stop_all()
    return np.asarray(out), model, pool


@pytest.mark.parametrize("speculate", [False, True])
def test_offload_strips_square(speculate):
    data = np.arange(17, dtype=np.float32)
    out, model, _ = _strips(T, 17, speculate)
    jout, jmodel, _ = _strips(J, 17, speculate)
    np.testing.assert_allclose(out, data * data)
    assert np.array_equal(out, jout)
    assert model[0] == jmodel[0]


def test_offload_strips_speculation_strikes_loser_records():
    """For every strip exactly one copy's compute survives in the model;
    ``nowait=False`` wins over ``speculate``: no duplicate, same result."""
    data = np.arange(17, dtype=np.float32)
    for nowait in (True, False):
        out, model, pool = _strips(T, 17, True, nowait=nowait)
        np.testing.assert_allclose(out, data * data)
        assert len(pool.cost.compute) == 3
        assert model[1] == ["strips[0:6]", "strips[12:17]", "strips[6:12]"]


def test_noop_speculation_does_not_inflate_makespan():
    """With the losers struck, the modeled transfers, compute tags and comm
    time equal the run without speculation, and the reference's."""
    data = np.arange(33, dtype=np.float32)
    out_plain, plain, _ = _strips(T, 33, False)
    out_spec, spec, _ = _strips(T, 33, True)
    np.testing.assert_allclose(out_spec, data * data)
    assert np.array_equal(out_spec, out_plain)
    assert spec[:2] == plain[:2]
    assert spec[2] == pytest.approx(plain[2])
    jplain = _strips(J, 33, False)[1]
    assert plain[:2] == jplain[:2]
    assert plain[2] == pytest.approx(jplain[2])


def test_speculation_respawns_a_slow_strip():
    """Device 1 stalls every EXEC for 1 s: its strip is respawned on a
    device that finished and the copy wins; the image and the modeled
    traffic are the run without speculation's."""
    plain_out, plain, _ = _strips(T, 33, False)
    slow = (1, dict(p=1.0, seed=0, ops=("EXEC",), mode="slow", slow_s=1.0))
    out, spec, pool = _strips(T, 33, True, wrap=slow)
    assert np.array_equal(out, plain_out)
    assert spec[:2] == plain[:2] and spec[2] == pytest.approx(plain[2])
    assert any(c.op == "EXEC" and c.tag.startswith("strips:spec[")
               for c in pool.trace)
    # the stalled original lost: its record was struck
    won = [c.device for c in pool.cost.compute if c.tag == "strips[11:22]"]
    assert len(won) == 1 and won != [1], won


# ---------------------------------------------------------------------------
# the DP fabric under hangs and stalls (the reference's straggler drill)
# ---------------------------------------------------------------------------
def test_dps_under_hangs_and_stalls_is_bit_identical():
    """``comm_modes.dps`` with SEND/RECV hangs at p = 0.05 under a command
    deadline and transport op timeout, and EXEC stalls of 150 ms at p = 0.3
    (the reference's ``--hang-p 0.05 --slow-ms 150`` at its default seed):
    every mode's parameters equal the fault-free run's bit for bit."""
    kw = dict(d_model=32, n_batch=8, device="cpu")
    _, clean = cm.dps(**kw)
    rows, chaos = cm.dps(**kw, inject=cm.Inject(0.0, 0, hang_p=0.05, slow_ms=150))
    for mode in ("host", "host-mediated", "direct"):
        for k in ("w", "b"):
            assert torch.equal(chaos[mode][k], clean[mode][k]), (mode, k)
    assert sum(r["stalls"] for r in rows) > 0
    direct = rows[-1]
    assert set(direct["faults_by_op"]) <= {"SEND", "RECV"}
    assert direct["faults"] > 0 and direct["transport_timeouts"] > 0


def test_speculation_respawns_onto_a_device_that_finished():
    """Under a policy that is not round-robin a strip's index is not its
    device.  Strips placed in reverse (strip i on device 2 - i), devices 0
    and 1 stalling: only strip 0 (on device 2) lands early.  The port
    respawns the strips still running onto device 2; the reference respawns
    them onto device 0, the finished strip's index, which is still stalled."""
    data = np.arange(33, dtype=np.float32)
    devices = {}
    for pkg in (J, T):
        class Reversed(pkg.RoundRobin):
            def place(self, ctx, node, ready_index, region_tag):
                return ctx.D - 1 - ready_index

        pool = _pool(pkg, 3, _table(pkg))
        ex = pkg.TargetExecutor(pool)
        try:
            for d, slow_s in ((0, 0.15), (1, 0.3)):
                pool.devices[d] = FT[pkg].FlakyDevice(pool.devices[d], p=1.0, seed=0,
                                                      ops=("EXEC",), mode="slow",
                                                      slow_s=slow_s)
            out = pkg.offload_strips(ex, "square", 33,
                                     _square_maps(pkg, _arr(pkg, data)),
                                     speculate=True, policy=Reversed())
            np.testing.assert_allclose(np.asarray(out), data * data)
            pool.sync()
            devices[pkg] = {c.device for c in pool.trace
                            if c.op == "EXEC" and ":spec[" in c.tag}
        finally:
            pool.stop_all()
    assert devices[T] == {2}
    assert devices[J] == {0}
