"""Failures and recovery on both packages: seeded fault injection
(``FlakyDevice``/``inject_flaky``), ``with_retry``, self-healing present
entries, ``run_graph`` recovery with lineage replay, and ``PeerTransport``
retries with seeded backoff.

Within the port, a run under injected faults equals its fault-free run bit
for bit, as the reference claims for itself (``tests/test_fault_tolerance.py``).
Across the packages the fault-free values agree within fp32's 2e-5
(``tests/test_kernels.py``), and where the schedule is deterministic — serial
dispatch, host-mediated edges — the injected faults per device and op, the
byte counters and the per-device command sequences are the reference's:
the fault RNG is keyed ``(seed, device index)`` in both.  The reference runs
only fault-free or serially here, never under full chaos.
"""
import concurrent.futures as cf
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
import repro.ft as JF  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.ft as TF  # noqa: E402
from repro_torch import comm_modes as cm  # noqa: E402
from repro_torch.bots import sparselu as tbl  # noqa: E402

torch.set_num_threads(1)      # six test workers share the CPU

FP32_TOL = dict(rtol=2e-5, atol=2e-5)
COUNTERS = ("bytes_to", "bytes_from", "bytes_peer")
POLICIES = ("round-robin", "locality", "heft")
FT = {J: JF, T: TF}


# ---------------------------------------------------------------------------
# fixtures: the reference suite's kernels, diamond, random DAGs, sparselu
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
    return table


def _spec(pkg, shape):
    if pkg is T:
        return T.TensorSpec(shape, torch.float32)
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def _scalar(pkg, v):
    return torch.tensor(v, dtype=torch.float32) if pkg is T else jnp.float32(v)


def _arr(pkg, a):
    return torch.from_numpy(np.ascontiguousarray(a)) if pkg is T else jnp.asarray(a)


def _pool(pkg, n, table):
    if pkg is T:
        return T.DevicePool.virtual(n, table=table, device="cpu")
    return J.DevicePool.virtual(n, table=table)


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


def _random_tasks(pkg, seed, n_tasks):
    rng = np.random.default_rng(seed)
    sds = _spec(pkg, (4, 4))
    init = _arr(pkg, rng.standard_normal((4, 4)).astype(np.float32))
    tasks = []
    for i in range(n_tasks):
        n_deps = int(rng.integers(0, min(i, 2) + 1))
        deps = tuple(f"t{j}" for j in
                     rng.choice(i, size=n_deps, replace=False)) if i else ()
        tasks.append(pkg.DagTask(
            f"t{i}", "combine", deps,
            (lambda init=init: lambda dv: pkg.MapSpec(
                to=({"x": next(iter(dv.values()))} if dv else {"x": init}),
                from_={"out": sds}))()))
    return tasks


def _sparselu(pkg, K=4, B=32):
    if pkg is T:
        mat = tbl._matrix(K, B)
        return tbl._make_table(K), T.TaskGraph.from_tasks(tbl._build_dag(mat, K, B))
    mat = jbl._matrix(K, B)
    return jbl._make_table(K), J.TaskGraph.from_tasks(jbl._build_dag(mat, K, B))


def _faults(pool):
    """(injected faults, per-device failures_by_op)."""
    by_dev = [dict(getattr(d, "failures_by_op", {})) for d in pool.devices]
    return sum(sum(b.values()) for b in by_dev), by_dev


def _kinds(pool):
    return {d: [c.op for c in pool.trace if c.device == d] for d in range(len(pool))}


def _run_chaos(pkg, graph, table, *, policy="round-robin", peer=False, p=0.0,
               seed=0, ops=("EXEC",), n_dev=3, max_retries=30, nowait=True,
               devices=None):
    """One run on a fresh pool with injected faults; returns the values, the
    injected count, the blacklist, the counters, failures_by_op per device,
    the per-device command kinds, and whether the pool was left empty (no
    present entry, no live buffer)."""
    pool = _pool(pkg, n_dev, table)
    ex = pkg.TargetExecutor(pool)
    try:
        if p > 0:
            FT[pkg].inject_flaky(pool, p=p, seed=seed, ops=ops, devices=devices)
        res = pkg.run_graph(ex, graph, policy=policy, peer=peer, nowait=nowait,
                            max_retries=max_retries)
        injected, by_dev = _faults(pool)
        s = pool.cost.summary()
        pool.sync()
        clean = all(len(pool.present[d]) == 0
                    and not pool.devices[d].store.live_handles()
                    for d in range(n_dev))
        out = ({k: np.asarray(v) for k, v in res.items()}, injected,
               set(pool.health.blacklist), {k: s[k] for k in COUNTERS},
               by_dev, _kinds(pool), clean)
    finally:
        pool.stop_all()
    return out


def _same_bits(ref, vals, what=""):
    assert set(ref) == set(vals)
    for k in ref:
        assert np.array_equal(ref[k], vals[k]), (what, k)


def _close(ref, vals):
    for k in ref:
        np.testing.assert_allclose(vals[k], ref[k], **FP32_TOL)


def _seed_with_schedule(p, pattern, device=0):
    """A seed whose first draws on ``device`` fail (True) or pass (False) as
    ``pattern`` says — the same schedule in both packages."""
    for seed in range(10_000):
        u = np.random.default_rng((seed, device)).random(len(pattern))
        if [x < p for x in u] == list(pattern):
            return seed
    raise AssertionError("no seed found")


# ---------------------------------------------------------------------------
# seeded chaos: bit-identical under injection
# ---------------------------------------------------------------------------
@settings(max_examples=3, deadline=None)
@given(st.integers(0, 10_000), st.integers(5, 9))
def test_chaos_random_dags_bit_identical(seed, n_tasks):
    """Random DAGs under EXEC (host) and EXEC+SEND+RECV (peer) faults, every
    policy, p ∈ {0.05, 0.2}: bit for bit the fault-free run; the blacklist
    never exceeds the injected count; fault-free equals the reference."""
    table = _table(T)
    graph = T.TaskGraph.from_tasks(_random_tasks(T, seed, n_tasks))
    ref = _run_chaos(T, graph, table)[0]
    jref = _run_chaos(J, J.TaskGraph.from_tasks(_random_tasks(J, seed, n_tasks)),
                      _table(J))[0]
    _close(jref, ref)
    for peer in (False, True):
        ops = ("EXEC", "SEND", "RECV") if peer else ("EXEC",)
        for policy in POLICIES:
            for p in (0.05, 0.2):
                vals, injected, blacklist, *_, clean = _run_chaos(
                    T, graph, table, policy=policy, peer=peer, p=p, seed=seed,
                    ops=ops)
                _same_bits(ref, vals, (policy, peer, p))
                assert len(blacklist) <= injected, (policy, peer, p)
                assert clean, (policy, peer, p)


def test_chaos_sparselu_bit_identical():
    """Sparselu K=4, B=32, D=4 under all five ops at p=0.2, peer-routed, three
    policies: bit for bit the fault-free run, which matches the reference."""
    table, graph = _sparselu(T)
    ref = _run_chaos(T, graph, table, peer=True, n_dev=4)[0]
    jtable, jgraph = _sparselu(J)
    _close(_run_chaos(J, jgraph, jtable, peer=True, n_dev=4)[0], ref)
    for policy in POLICIES:
        vals, injected, blacklist, *_, clean = _run_chaos(
            T, graph, table, policy=policy, peer=True, p=0.2, seed=1234,
            ops=TF.FAULT_OPS, n_dev=4)
        assert injected > 0
        assert len(blacklist) <= injected
        assert clean, policy          # every pin released, every buffer freed
        _same_bits(ref, vals, policy)


def test_chaos_xfer_only_recovered():
    """Host-wire faults (XFER_TO/XFER_FROM) heal in place, both edge modes."""
    table = _table(T)
    graph = _diamond(T)
    ref = _run_chaos(T, graph, table)[0]
    for peer in (False, True):
        vals, injected, *_ = _run_chaos(T, graph, table, policy="locality",
                                        peer=peer, p=0.2, seed=77,
                                        ops=("XFER_TO", "XFER_FROM"))
        _same_bits(ref, vals, peer)


def test_flaky_p0_is_transparent():
    """A p=0 wrap changes nothing: values, and byte counters equal to the
    reference's own p=0 run."""
    got = {}
    for pkg in (J, T):
        vals, injected, blacklist, counters, *_ = _run_chaos(
            pkg, _diamond(pkg), _table(pkg), policy="heft", peer=True, p=0.0)
        pool = _pool(pkg, 3, _table(pkg))
        ex = pkg.TargetExecutor(pool)
        try:
            FT[pkg].inject_flaky(pool, p=0.0, seed=9, ops=("EXEC", "SEND", "RECV"))
            wrapped = pkg.run_graph(ex, _diamond(pkg), policy="heft", peer=True)
            s = pool.cost.summary()
            assert _faults(pool)[0] == 0 and not pool.health.blacklist
        finally:
            pool.stop_all()
        _same_bits(vals, {k: np.asarray(v) for k, v in wrapped.items()})
        assert {k: s[k] for k in COUNTERS} == counters
        got[pkg] = (vals, counters)
    _close(got[J][0], got[T][0])
    assert got[T][1] == got[J][1]


def test_dead_peer_wire_reroutes_through_funnel():
    """SEND always fails: every cross-device edge goes through the funnel,
    bit for bit, with strictly more host-wire bytes than the healthy run."""
    table = _table(T)
    graph = _diamond(T)
    ref, _, _, healthy, *_ = _run_chaos(T, graph, table, peer=True)
    vals, injected, _, counters, *_, clean = _run_chaos(
        T, graph, table, peer=True, p=1.0, seed=3, ops=("SEND",))
    assert injected > 0 and clean
    _same_bits(ref, vals)
    assert (counters["bytes_to"] + counters["bytes_from"]
            > healthy["bytes_to"] + healthy["bytes_from"])


# ---------------------------------------------------------------------------
# serial parity with the reference: the same faults, bytes and commands
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [1, 2])
def test_serial_chaos_matches_reference(seed):
    """Serial host-mediated sparselu under EXEC/XFER_TO/XFER_FROM faults at
    p=0.1, round-robin: one host thread fixes each device's command order,
    so both packages inject the same faults per device and op, move the
    same bytes, issue the same command sequences and blacklist the same
    devices; the values are the fault-free run's."""
    ops = ("EXEC", "XFER_TO", "XFER_FROM")
    runs = {}
    for pkg in (J, T):
        table, graph = _sparselu(pkg)
        runs[pkg] = _run_chaos(pkg, graph, table, p=0.1, seed=seed, ops=ops,
                               n_dev=4, nowait=False)
    (jv, jinj, jbl_, jc, jby, jk, _), (tv, tinj, tbl_, tc, tby, tk, _) = runs[J], runs[T]
    assert tinj == jinj > 0
    assert tby == jby
    assert tc == jc
    assert tk == jk
    assert tbl_ == jbl_
    _close(jv, tv)
    table, graph = _sparselu(T)
    _same_bits(_run_chaos(T, graph, table, n_dev=4, nowait=False)[0], tv)


def _lineage_graph(pkg):
    """a → {b, c}; d(a, c): d re-reads a after c's wave."""
    sds = _spec(pkg, (4, 4))
    return pkg.TaskGraph([
        pkg.TaskNode("a", "src", (), lambda dv: pkg.MapSpec(
            to={"s": _scalar(pkg, 3.0)}, from_={"out": sds})),
        pkg.TaskNode("b", "combine", ("a",), lambda dv: pkg.MapSpec(
            to={"x": dv["a"]}, from_={"out": sds})),
        pkg.TaskNode("c", "combine", ("a",), lambda dv: pkg.MapSpec(
            to={"x": dv["a"]}, from_={"out": sds})),
        pkg.TaskNode("d", "combine2", ("a", "c"), lambda dv: pkg.MapSpec(
            to={"x": dv["a"], "y": dv["c"]}, from_={"out": sds})),
    ])


def _losing_policy(pkg, ex):
    """Round-robin that drops a's resident output (as a lost device would)
    just before placing d, so d's rewrite finds the producer gone."""

    class Losing(pkg.RoundRobin):
        def place(self, ctx, node, ready_index, region_tag):
            if node.name == "d":
                ex.exit_data(0, "graph:a")
            return super().place(ctx, node, ready_index, region_tag)

    return Losing()


@pytest.mark.parametrize("how", ["lost-entry", "failed-fetch"])
def test_lineage_replay_matches_reference(how):
    """A producer whose resident output is gone (dropped before a consumer
    binds it) or unreadable (its final fetch fails once) is replayed from
    its dependencies: the same values as the fault-free run, at least one
    extra EXEC, and the reference's bytes and command sequences."""
    out = {}
    for pkg in (J, T):
        table = _table(pkg)
        free = _run_chaos(pkg, _lineage_graph(pkg), table, peer=True,
                          n_dev=2, nowait=False)
        pool = _pool(pkg, 2, table)
        ex = pkg.TargetExecutor(pool)
        try:
            policy = "round-robin"
            if how == "lost-entry":
                policy = _losing_policy(pkg, ex)
            else:
                seed = _seed_with_schedule(0.5, (True, False, False, False))
                FT[pkg].inject_flaky(pool, p=0.5, seed=seed, devices=[0],
                                     ops=("XFER_FROM",))
            res = pkg.run_graph(ex, _lineage_graph(pkg), policy=policy,
                                peer=True, nowait=False)
            s = pool.cost.summary()
            kinds = _kinds(pool)
            assert _faults(pool)[0] == (how == "failed-fetch")
            for d in range(2):
                assert len(pool.present[d]) == 0, pool.present[d].names()
        finally:
            pool.stop_all()
        vals = {k: np.asarray(v) for k, v in res.items()}
        _same_bits(free[0], vals, pkg.__name__)
        execs = sum(k.count("EXEC") for k in kinds.values())
        assert execs > sum(k.count("EXEC") for k in free[5].values())
        out[pkg] = (vals, {k: s[k] for k in COUNTERS}, kinds)
    _close(out[J][0], out[T][0])
    assert out[T][1] == out[J][1]
    assert out[T][2] == out[J][2]


# ---------------------------------------------------------------------------
# self-healing present entries (tensors are mutable)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bind", ["present", "to"])
def test_heal_sends_the_entered_value(bind):
    """``enter_data``'s XFER_TO fails; the region that binds the entry heals
    it by re-sending the entered value.  With ``present=`` the port's host
    tensor is first changed in place: the region still computes on the
    entered value, as the reference (immutable arrays) does."""
    seed = _seed_with_schedule(0.5, (True, False))
    out = {}
    for pkg in (J, T):
        pool = _pool(pkg, 1, _table(pkg))
        ex = pkg.TargetExecutor(pool)
        try:
            FT[pkg].inject_flaky(pool, p=0.5, seed=seed, ops=("XFER_TO",))
            x = _arr(pkg, np.arange(16, dtype=np.float32).reshape(4, 4))
            ex.enter_data(0, x=x)
            cf.wait([f for f in pool.present[0].get("x").write_futs])
            if bind == "present":
                if pkg is T:
                    x.add_(100.0)
                maps = pkg.MapSpec(present=("x",), from_={"out": _spec(pkg, (4, 4))})
            else:
                maps = pkg.MapSpec(to={"x": x}, from_={"out": _spec(pkg, (4, 4))})
            got = np.asarray(ex.target("double", 0, maps)["out"])
            pool.sync()
            assert pool.devices[0].failures_by_op == {"XFER_TO": 1}
            s = pool.cost.summary()
            ex.exit_data(0, "x")
        finally:
            pool.stop_all()
        out[pkg] = (got, {k: s[k] for k in COUNTERS})
    want = np.arange(16, dtype=np.float32).reshape(4, 4) * 2.0
    np.testing.assert_array_equal(out[T][0], want)
    np.testing.assert_array_equal(out[J][0], want)
    assert out[T][1] == out[J][1]


def test_heal_drops_a_device_ahead_entry_and_raises():
    """A device-ahead entry whose last write failed has no host value to
    re-send: binding it frees it, strikes its name and raises the failure
    (graph recovery replays the producer); the pool is left clean."""
    pool = _pool(T, 2, _table(T))
    ex = T.TargetExecutor(pool)
    try:
        ex.alloc_resident(0, "x", T.TensorSpec((4, 4), torch.float32))
        pool.devices[0] = TF.FlakyDevice(pool.devices[0], p=1.0, ops=("SEND",))
        ex.propagate_resident(0, 1, "x")
        cf.wait(pool.present[1].get("x").write_futs)
        with pytest.raises(T.DeviceFailure, match="SEND"):
            ex.target("double", 1, T.MapSpec(present=("x",),
                                             from_={"out": T.TensorSpec((4, 4), torch.float32)}))
        assert "x" not in pool.present[1]
        pool.absorb_failures()
        pool.sync()
        ex.exit_data(0, "x")
        pool.sync()
        assert [pool.devices[d].store.live_handles() for d in range(2)] == [[], []]
    finally:
        pool.stop_all()


def test_present_table_pop_entry_and_adopt_match_reference():
    got = {}
    for pkg in (J, T):
        a, b = pkg.PresentTable(), pkg.PresentTable()
        e = pkg.PresentEntry(name="w", handles=[3], treedef=None,
                             host_leaves=[None], specs=[_spec(pkg, (2,))])
        a.add(e)
        moved = a.pop_entry("w")
        got[pkg] = (moved is e, a.pop_entry("w"), "w" in a, b.adopt(moved),
                    b.adopt(moved), b.get("w") is e, len(b))
    assert got[T] == got[J] == (True, None, False, True, False, True, 1)


# ---------------------------------------------------------------------------
# the peer transport: retries, seeded backoff, funnel fallback
# ---------------------------------------------------------------------------
def _dead_send(pkg, tr, n=8):
    """device 0's SEND always fails; one sendrecv 0 → 1 through ``tr``."""
    pool = _pool(pkg, 2, _table(pkg))
    try:
        FT[pkg].inject_flaky(pool, p=1.0, seed=1, ops=("SEND",))
        dtype = torch.float32 if pkg is T else jnp.float32
        h0 = pool.alloc(0, (n,), dtype, tag="src")
        pool.transfer_to(0, h0, _arr(pkg, np.arange(n, dtype=np.float32)))
        h1 = pool.alloc(1, (n,), dtype, tag="dst")
        pool.transfer_to(1, h1, _arr(pkg, np.zeros(n, np.float32)))
        tr.sendrecv(pool, 0, h0, 1, h1, tag="edge").result()
        got = np.asarray(pool.transfer_from(1, h1, tag="chk"))
        failures = pool.devices[0].failures
        pool.sync()
        s = pool.cost.summary()
    finally:
        pool.stop_all()
    np.testing.assert_array_equal(got, np.arange(n, dtype=np.float32))
    return failures, {k: s[k] for k in COUNTERS}


def test_peer_transport_retries_then_falls_back():
    """retries=2: the initial send and two re-sends fail, then the funnel
    delivers the same bytes; the counters are the reference's."""
    tr = T.PeerTransport(retries=2, backoff_base_s=1e-5)
    failures, counters = _dead_send(T, tr)
    assert tr.fallbacks == 1 and failures == 3 and tr.backoffs == 2
    jtr = J.PeerTransport(retries=2, backoff_base_s=1e-5)
    assert _dead_send(J, jtr) == (failures, counters)


def test_transport_backoff_is_seeded_and_matches_reference():
    """The backoff draws come from ``(seed, 0xB0FF)``: the same seed gives
    the same seconds — the reference's, exactly — and another seed differs."""
    def run(pkg, seed):
        tr = pkg.PeerTransport(retries=3, backoff_base_s=1e-4, seed=seed)
        _dead_send(pkg, tr)
        return tr
    a, b, c = run(T, 42), run(T, 42), run(T, 7)
    assert a.backoffs == b.backoffs == 3 and a.fallbacks == 1
    assert a.backoff_s > 0 and a.backoff_s == b.backoff_s != c.backoff_s
    assert a.backoff_s == run(J, 42).backoff_s


def test_hier_mean_survives_dead_rack_leader_link():
    """Rack 1's leader fails every SEND/RECV: retries exhaust, the funnel
    carries its messages, and every device still holds the serial
    left-associated mean bit for bit."""
    topo = T.Topology.two_tier(2, 2)
    pool, handles, specs, values = cm.collective_pool(topo, 300, seed=13,
                                                      device="cpu")
    try:
        TF.inject_flaky(pool, p=1.0, seed=1, devices=[topo.leader(1)],
                        ops=("SEND", "RECV"))
        tr = T.PeerTransport(retries=1, backoff_base_s=1e-5, topology=topo)
        tr.allreduce_mean(pool, handles, specs)
        pool.sync()
        assert tr.fallbacks > 0
        serial = values[0][0]
        for v in values[1:]:
            serial = serial + v[0]
        serial = serial / topo.n_devices
        for d in range(topo.n_devices):
            assert torch.equal(pool.transfer_from(d, handles[d][0]), serial), d
    finally:
        pool.stop_all()


def test_peer_copy_recv_failure_surfaces_at_destination_sync():
    pool = _pool(T, 2, _table(T))
    try:
        hs = pool.alloc(0, (4,), torch.float32)
        pool.transfer_to(0, hs, torch.ones(4))
        hd = pool.alloc(1, (4,), torch.float32)
        pool.free(1, hd)                         # RECV will write a dead handle
        pool.peer_copy(0, hs, 1, hd)
        with pytest.raises(KeyError, match="not live"):
            pool.sync(1)
        pool.sync()            # the stash is cleared; the source is unharmed
    finally:
        pool.stop_all()


def test_runtime_config_wires_transport_retries():
    cfg = T.RuntimeConfig(n_virtual=2, comm_mode="direct", transport_retries=2,
                          transport_backoff_base_s=1e-4, transport_backoff_seed=9)
    rt = T.ClusterRuntime(cfg, table=_table(T), device="cpu")
    try:
        assert isinstance(rt.transport, T.PeerTransport)
        assert rt.transport.retries == 2
        assert rt.transport.backoff_base_s == 1e-4
        assert rt.transport.op_timeout_s is None
    finally:
        rt.shutdown()


def test_dp_fabric_under_send_recv_chaos_is_bit_identical():
    """``comm_modes`` under SEND/RECV faults at p=0.2 (direct runtimes retry
    3 times): the 8 steps' parameters equal the fault-free host-mediated
    run's bit for bit; direct + int8 gradients stay within max|g|/64."""
    _, clean = cm.dps(d_model=32, n_batch=8, device="cpu")
    rows, chaos = cm.dps(d_model=32, n_batch=8, device="cpu", inject=(0.2, 5))
    for mode in ("host", "host-mediated", "direct"):
        for k in ("w", "b"):
            assert torch.equal(chaos[mode][k], clean["host-mediated" if mode != "host"
                                                      else "host"][k]), (mode, k)
    assert rows[-1]["faults"] > 0
    rows, grads = cm.modes(d_model=32, n_batch=8, device_counts=(4,),
                           device="cpu", inject=(0.2, 5))
    ref = grads["host-mediated"]
    scale = max(float(ref[k].abs().max()) for k in ("w", "b"))
    for k in ("w", "b"):
        assert torch.allclose(grads["direct"][k], ref[k], rtol=1e-5, atol=1e-6)
        assert float((grads["direct+int8"][k] - ref[k]).abs().max()) <= scale / 64
    assert sum(r["faults"] for r in rows) > 0


# ---------------------------------------------------------------------------
# with_retry, injection mechanics and the health registry
# ---------------------------------------------------------------------------
def test_with_retry_composes_with_inflight_nowait_regions():
    """The retried region rides the nowait streams beside an innocent region;
    the handled failure never resurfaces at the innocent region's join."""
    table = _table(T)
    pool = _pool(T, 3, table)
    ex = T.TargetExecutor(pool)
    try:
        pool.devices[0] = TF.FlakyDevice(pool.devices[0], p=1.0, seed=0)
        sds = T.TensorSpec((4, 4), torch.float32)
        innocent = ex.target("src", 1, T.MapSpec(to={"s": torch.tensor(2.0)},
                                                 from_={"out": sds}),
                             nowait=True, tag="innocent")
        bl = set()
        out = TF.with_retry(ex, "src", 0, T.MapSpec(to={"s": torch.tensor(1.0)},
                                                    from_={"out": sds}),
                            blacklist=bl)
        assert torch.equal(out["out"], torch.ones(4, 4))
        assert 0 in bl and pool.devices[0].failures >= 1
        assert pool.health.failures(0) >= 1
        got = ex.drain([innocent])[0]
        assert torch.equal(got["out"], torch.full((4, 4), 2.0))
        for d in range(1, 3):
            pool.sync(d)
    finally:
        pool.stop_all()


def test_with_retry_strips_with_a_dead_device_equal_serial():
    """Strips over 4 devices, device 2 failing every EXEC (the card's
    mandelbrot case, small): the dead device never runs its kernel, the
    blacklist is {2}, and the image is the serial one."""
    table = _table(T)
    pool = _pool(T, 4, table)
    ex = T.TargetExecutor(pool)
    try:
        TF.inject_flaky(pool, p=1.0, devices=[2])
        data = torch.arange(16.0).reshape(16, 1).repeat(1, 4)
        blacklist, parts = set(), []
        for dev, (s, l) in enumerate(T.strip_partition(16, 4)):
            maps = T.MapSpec(to={"x": T.sec(data, s, l)},
                             from_={"out": T.TensorSpec((l, 4), torch.float32)})
            parts.append(TF.with_retry(ex, "double", dev, maps,
                                       blacklist=blacklist)["out"])
        assert torch.equal(torch.cat(parts), data * 2.0)
        assert blacklist == {2}
        assert pool.devices[2].failures_by_op == {"EXEC": 1}
        assert 2 not in {c.device for c in pool.cost.compute}
    finally:
        pool.stop_all()


def test_with_retry_all_devices_failed_raises():
    pool = _pool(T, 2, _table(T))
    ex = T.TargetExecutor(pool)
    try:
        TF.inject_flaky(pool, p=1.0, seed=0)
        with pytest.raises(T.DeviceFailure):
            TF.with_retry(ex, "src", 0, T.MapSpec(
                to={"s": torch.tensor(1.0)},
                from_={"out": T.TensorSpec((4, 4), torch.float32)}))
    finally:
        pool.stop_all()


def test_with_retry_surfaces_a_kernel_error_at_once():
    """Only injected-style DeviceFailures are retried: a kernel's own error
    (what a failed build or launch raises) surfaces on the first device."""
    table = _table(T)
    table.register("broken", lambda x: (_ for _ in ()).throw(
        RuntimeError("launch failed")))
    pool = _pool(T, 3, table)
    ex = T.TargetExecutor(pool)
    try:
        bl = set()
        with pytest.raises(RuntimeError, match="launch failed"):
            TF.with_retry(ex, "broken", 0, T.MapSpec(
                to={"x": torch.ones(2)},
                from_={"out": T.TensorSpec((2,), torch.float32)}), blacklist=bl)
        assert not bl and not pool.health.blacklist
        assert len(pool.cost.compute) == 0
    finally:
        pool.stop_all()


def test_flaky_device_rejects_ineligible_ops_and_modes():
    pool = _pool(T, 1, _table(T))
    try:
        with pytest.raises(ValueError, match="ALLOC"):
            TF.FlakyDevice(pool.devices[0], p=0.5, ops=("ALLOC",))
        with pytest.raises(ValueError, match="mode"):
            TF.FlakyDevice(pool.devices[0], p=0.5, mode="flaky")
        assert TF.FAULT_OPS == JF.FAULT_OPS and TF.FAULT_MODES == JF.FAULT_MODES
    finally:
        pool.stop_all()


def test_flaky_failures_by_op_accounts_every_fault():
    table, graph = _sparselu(T)
    _, injected, _, _, by_dev, _, clean = _run_chaos(
        T, graph, table, peer=True, p=0.2, seed=42, ops=TF.FAULT_OPS, n_dev=4)
    assert clean
    by_op = {}
    for b in by_dev:
        for op, n in b.items():
            by_op[op] = by_op.get(op, 0) + n
    assert set(by_op) <= set(TF.FAULT_OPS)
    assert sum(by_op.values()) == injected > 0


def test_slow_mode_counts_stalls_not_failures():
    """A slow command completes: stalls counted, no failure, no blacklist,
    the fault-free values."""
    table = _table(T)
    graph = _diamond(T)
    ref = _run_chaos(T, graph, table)[0]
    pool = _pool(T, 3, table)
    ex = T.TargetExecutor(pool)
    try:
        TF.inject_flaky(pool, p=1.0, seed=3, mode="slow", slow_s=0.01)
        res = T.run_graph(ex, graph, policy="locality")
        assert sum(d.stalls for d in pool.devices) > 0
        assert sum(d.stalls_by_op.get("EXEC", 0) for d in pool.devices) == 4
        assert _faults(pool)[0] == 0 and not pool.health.blacklist
    finally:
        pool.stop_all()
    _same_bits(ref, {k: np.asarray(v) for k, v in res.items()})


def test_health_registry_threshold_and_fallback():
    assert TF.HealthRegistry is T.HealthRegistry
    reg = TF.HealthRegistry(max_failures=2)
    reg.mark_failed(1)
    assert reg.is_healthy(1) and not reg.blacklist
    reg.mark_failed(1)
    assert not reg.is_healthy(1) and reg.blacklist == {1}
    assert reg.healthy(3) == [0, 2]
    for d in (0, 2):
        reg.mark_failed(d)
        reg.mark_failed(d)
    assert reg.healthy(3) == [0, 1, 2]
    reg.mark_healthy(1)
    assert reg.failures(1) == 0 and 1 not in reg.blacklist
