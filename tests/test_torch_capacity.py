"""Capacity-bounded present tables on both packages: LRU spill (device-ahead
content fetched to the host first) and transparent refetch.  Each unit case
of the reference's ``tests/test_taskgraph.py`` runs on both packages and the
port's table counters equal the reference's; a serial capped task graph
gives the reference's ``memory_report()`` and byte counters exactly; and a
cap changes traffic, never a result — bit for bit within the port, also for
a tensor changed in place while its entry is spilled."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.bots import mandelbrot as tbm  # noqa: E402
from repro_torch.bots import sparselu as tbl  # noqa: E402

torch.set_num_threads(1)      # six test workers share the CPU

FP32_TOL = dict(rtol=2e-5, atol=2e-5)
COUNTERS = ("bytes_to", "bytes_from", "bytes_peer")
TABLE_KEYS = ("evictions", "refetches", "bytes_reconciled", "bytes_refetched",
              "hits", "misses", "bytes_elided", "resident", "resident_bytes",
              "spilled", "capacity_bytes")
BLK = 16 * 4                               # 16 float32s per entry


class _Pkg:
    """The handful of calls the unit cases make, on either package."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.torch = pkg is T

    def arange(self, i=0):
        return (torch.arange(16.0) if self.torch else jnp.arange(16.0)) + i

    def ones(self):
        return torch.ones(16) if self.torch else jnp.ones(16)

    def zeros(self):
        return torch.zeros(16) if self.torch else jnp.zeros(16)

    def spec(self):
        return (T.TensorSpec((16,), torch.float32) if self.torch
                else jax.ShapeDtypeStruct((16,), jnp.float32))

    def pool(self, n=1, cap=None):
        table = self.pkg.KernelTable()
        table.register("double", lambda x: {"out": x * 2.0})
        table.register("double_a", lambda a: {"out": a * 2.0})
        kw = {"device": "cpu"} if self.torch else {}
        pool = self.pkg.DevicePool.virtual(n, table=table, capacity_bytes=cap,
                                           **kw)
        return pool, self.pkg.TargetExecutor(pool)

    def close(self, pool, ex):
        pool.stop_all()
        if self.torch:
            ex.close()


def _both(case):
    """Run ``case`` on each package; the port's returned record must equal
    the reference's (values compared as numpy)."""
    got = case(_Pkg(T))
    want = case(_Pkg(J))
    assert _np(got) == _np(want), (got, want)
    return got


def _np(rec):
    if isinstance(rec, dict):
        return {k: _np(v) for k, v in rec.items()}
    if isinstance(rec, (list, tuple)):
        return [_np(v) for v in rec]
    if hasattr(rec, "shape"):
        return np.asarray(rec).tolist()
    return rec


def _stats(table):
    s = table.stats()
    return {k: s[k] for k in TABLE_KEYS}


# ---------------------------------------------------------------------------
# the reference's unit cases, on both packages
# ---------------------------------------------------------------------------
def test_lru_eviction_reconciles_device_ahead_and_refetches():
    def case(p):
        pool, ex = p.pool(cap=2 * BLK)
        rec = {}
        try:
            a, b, c = (p.arange(i) for i in range(3))
            ex.enter_data(0, "e", a=a)
            ex.enter_data(0, "e", b=b)
            ex.target("double", 0, p.pkg.MapSpec(present={"x": "a"},
                                                  device_out={"out": "a"}))
            table = pool.present[0]
            assert table.get("a").device_ahead
            ex.enter_data(0, "e", c=c)
            rec["spilled"] = [n for n in sorted(table.names())
                              if table.get(n).spilled]
            rec["after_c"] = _stats(table)
            rec["b"] = ex.fetch_resident(0, "b")
            ex.enter_data(0, "e", d=p.zeros())     # evicts "a" (ahead)
            ent_a = table.get("a")
            assert ent_a.spilled and not ent_a.device_ahead
            rec["a"] = ex.fetch_resident(0, "a")
            out = ex.target("double", 0, p.pkg.MapSpec(
                present={"x": "a"}, from_={"out": p.spec()}))
            rec["out"] = out["out"]
            rec["a_spilled"] = table.get("a").spilled
            rec["end"] = _stats(table)
            rec["bytes"] = {k: pool.cost.summary()[k] for k in COUNTERS}
            ex.exit_data(0, "a", "b", "c", "d")
        finally:
            p.close(pool, ex)
        return rec

    rec = _both(case)
    assert rec["spilled"] == ["b"]
    assert rec["after_c"]["evictions"] == 1
    np.testing.assert_array_equal(rec["b"], np.arange(16.0) + 1)
    np.testing.assert_array_equal(rec["a"], np.arange(16.0) * 2.0)
    np.testing.assert_array_equal(rec["out"], np.arange(16.0) * 4.0)
    assert not rec["a_spilled"] and rec["end"]["refetches"] >= 1
    assert rec["end"]["bytes_reconciled"] >= BLK


def test_pinned_and_retained_entries_are_not_evicted():
    def case(p):
        pool, ex = p.pool(cap=2 * BLK)
        rec = {}
        try:
            ex.enter_data(0, "e", a=p.arange())
            ex.pin_resident(0, "a")
            ex.enter_data(0, "e", b=p.ones())
            table = pool.present[0]
            table.get("b").refcount += 1       # an in-flight region's hold
            try:
                ex.enter_data(0, "e", c=p.zeros())   # soft cap: over budget
                rec["spilled"] = [table.get(n).spilled for n in "ab"]
                rec["used"] = table.used_bytes()
                rec["victim"] = table.lru_victim().name
                ex.pin_resident(0, "a", pinned=False)
                rec["victim_unpinned"] = table.lru_victim().name
                rec["stats"] = _stats(table)
            finally:
                table.get("b").refcount -= 1
                ex.exit_data(0, "a", "b", "c")
            with pytest.raises(KeyError):
                ex.pin_resident(0, "a")
        finally:
            p.close(pool, ex)
        return rec

    rec = _both(case)
    assert rec["spilled"] == [False, False] and rec["used"] == 3 * BLK
    assert (rec["victim"], rec["victim_unpinned"]) == ("c", "a")


def test_spilled_entry_refetches_on_next_match():
    def case(p):
        pool, ex = p.pool(cap=BLK)
        rec = {}
        try:
            a, b = p.arange(), p.ones()
            ex.enter_data(0, "e", a=a)
            ex.enter_data(0, "e", b=b)                 # evicts "a"
            table = pool.present[0]
            rec["a_spilled"] = table.get("a").spilled
            out = ex.target("double_a", 0, p.pkg.MapSpec(
                to={"a": a}, from_={"out": p.spec()}))
            rec["out"] = out["out"]
            rec["mid"] = [table.get(n).spilled for n in "ab"]
            rec["mid_stats"] = _stats(table)
            ex.enter_data(0, "e", b=b)                 # revives "b"
            rec["end"] = [table.get(n).spilled for n in "ab"]
            rec["end_stats"] = _stats(table)
            rec["bytes"] = {k: pool.cost.summary()[k] for k in COUNTERS}
            ex.exit_data(0, "a", "b", "b")
        finally:
            p.close(pool, ex)
        return rec

    rec = _both(case)
    assert rec["a_spilled"] and rec["mid"] == [False, True]
    assert rec["end"] == [True, False]
    np.testing.assert_array_equal(rec["out"], np.arange(16.0) * 2)
    assert rec["mid_stats"]["refetches"] >= 1
    assert rec["mid_stats"]["resident_bytes"] <= BLK


def test_memory_report_shape():
    def case(p):
        kw = {"device": "cpu"} if p.torch else {}
        rt = p.pkg.ClusterRuntime(p.pkg.RuntimeConfig(
            n_virtual=2, device_capacity_bytes=1024), **kw)
        try:
            return rt.memory_report()
        finally:
            rt.shutdown()

    rep = _both(case)
    assert set(rep) == {0, 1}
    for row in rep.values():
        assert row["capacity_bytes"] == 1024
        for key in ("resident_bytes", "evictions", "refetches",
                    "bytes_reconciled", "bytes_refetched"):
            assert row[key] == 0


def _chain(pkg, Bs=8, length=5, seed=0):
    """The reference's ``_chain_tasks``: every step re-reads p0, so evicting
    p0 forces a refetch mid-graph."""
    rng = np.random.default_rng(seed)
    init_np = rng.standard_normal((Bs, Bs)).astype(np.float32)
    if pkg is T:
        init, spec = torch.from_numpy(init_np), T.TensorSpec((Bs, Bs), torch.float32)
    else:
        init, spec = jnp.asarray(init_np), jax.ShapeDtypeStruct((Bs, Bs), jnp.float32)
    tasks = [pkg.DagTask("p0", "combine", (),
                         lambda dv: pkg.MapSpec(to={"x": init}, from_={"out": spec}))]
    for w in range(1, length + 1):
        tasks.append(pkg.DagTask(
            f"p{w}", "combine2", (f"p{w-1}", "p0"),
            (lambda w=w: lambda dv: pkg.MapSpec(
                to={"x": dv[f"p{w-1}"], "y": dv["p0"]}, from_={"out": spec}))()))
        tasks.append(pkg.DagTask(
            f"f{w}", "combine", (f"p{w-1}",),
            (lambda w=w: lambda dv: pkg.MapSpec(
                to={"x": dv[f"p{w-1}"]}, from_={"out": spec}))()))
    return tasks


def _chain_table(pkg):
    table = pkg.KernelTable()
    table.register("combine", lambda x: {"out": x @ x * 1e-2 + 1.0})
    table.register("combine2", lambda x, y: {"out": x @ x * 1e-2 + y})
    return table


def _run_chain(pkg, *, policy, cap, n_dev, nowait):
    kw = {"device": "cpu"} if pkg is T else {}
    rt = pkg.ClusterRuntime(pkg.RuntimeConfig(n_virtual=n_dev,
                                              device_capacity_bytes=cap),
                            table=_chain_table(pkg), **kw)
    try:
        res = rt.wavefront_offload(_chain(pkg), nowait=nowait, peer=True,
                                   policy=policy)
        s = rt.cost.summary()
        return ({k: np.asarray(v) for k, v in res.items()},
                {k: s[k] for k in COUNTERS}, rt.memory_report())
    finally:
        rt.shutdown()


@pytest.mark.parametrize("policy", ["round-robin", "locality", "heft"])
def test_policies_bit_identical_under_capacity_pressure(policy):
    cap = 2 * 8 * 8 * 4                       # two 256-byte blocks a device
    ref = _run_chain(T, policy="round-robin", cap=None, n_dev=2, nowait=True)[0]
    vals, _, mem = _run_chain(T, policy=policy, cap=cap, n_dev=2, nowait=True)
    assert sum(m["evictions"] for m in mem.values()) >= 1, mem
    assert sum(m["refetches"] for m in mem.values()) >= 1, mem
    for k in ref:
        np.testing.assert_array_equal(vals[k], ref[k])


@pytest.mark.parametrize("n_dev,policy", [(1, "round-robin"), (2, "round-robin"),
                                          (2, "locality")])
def test_serial_capped_graph_memory_report_matches_reference(n_dev, policy):
    """Serial dispatch fixes the eviction order, so the counters are exact:
    ``memory_report()`` and the byte counters equal the reference's."""
    cap = 2 * 8 * 8 * 4
    tv, tc, tm = _run_chain(T, policy=policy, cap=cap, n_dev=n_dev, nowait=False)
    jv, jc, jm = _run_chain(J, policy=policy, cap=cap, n_dev=n_dev, nowait=False)
    assert sum(m["evictions"] for m in tm.values()) >= 1
    assert sum(m["refetches"] for m in tm.values()) >= 1
    assert tm == jm
    assert tc == jc
    for k in jv:
        np.testing.assert_allclose(tv[k], jv[k], **FP32_TOL)


# ---------------------------------------------------------------------------
# the port's own trap: tensors are mutable
# ---------------------------------------------------------------------------
def test_tensor_changed_in_place_after_spill_is_resent_not_revived():
    p = _Pkg(T)
    pool, ex = p.pool(cap=BLK)
    try:
        a = torch.arange(16.0)
        ex.enter_data(0, "e", a=a)
        ex.enter_data(0, "e", b=torch.ones(16))    # evicts "a"
        table = pool.present[0]
        assert table.get("a").spilled
        a.add_(100.0)                              # same object, new value
        out = ex.target("double_a", 0, T.MapSpec(to={"a": a},
                                                 from_={"out": p.spec()}))
        np.testing.assert_array_equal(out["out"].numpy(),
                                      (np.arange(16.0) + 100.0) * 2)
        assert table.refetches == 0 and table.get("a").spilled
        assert pool.cost.summary()["bytes_to"] == 3 * BLK
        ex.exit_data(0, "a", "b")
    finally:
        p.close(pool, ex)


@pytest.mark.parametrize("cap", [None, BLK], ids=["uncapped", "capped"])
def test_present_binding_after_in_place_change_sees_the_device_copy(cap):
    """``present`` binds the device copy, which an in-place change of the
    host tensor does not touch; a spill must not change that."""
    p = _Pkg(T)
    pool, ex = p.pool(cap=cap)
    try:
        a = torch.arange(16.0)
        ex.enter_data(0, "e", a=a)
        ex.enter_data(0, "e", b=torch.ones(16))
        assert pool.present[0].get("a").spilled == (cap is not None)
        a.add_(100.0)
        np.testing.assert_array_equal(ex.fetch_resident(0, "a").numpy(),
                                      np.arange(16.0))
        out = ex.target("double", 0, T.MapSpec(present={"x": "a"},
                                               from_={"out": p.spec()}))
        np.testing.assert_array_equal(out["out"].numpy(), np.arange(16.0) * 2)
        ex.exit_data(0, "a", "b")
    finally:
        p.close(pool, ex)


def test_alloc_resident_placeholder_reconciles_at_spill():
    """An ``alloc_resident`` entry has no host value: its spill fetches the
    device copy, and a ``propagate_resident`` from the spilled source sends
    that host view through the funnel — on both packages alike."""
    def case(p):
        pool, ex = p.pool(n=2, cap=BLK)
        rec = {}
        try:
            ex.alloc_resident(0, "acc", p.spec())
            ex.enter_data(0, "e", b=p.ones())       # evicts the placeholder
            rec["after"] = _stats(pool.present[0])
            ex.propagate_resident(0, 1, "acc")
            rec["dst"] = ex.fetch_resident(1, "acc")
            rec["bytes"] = {k: pool.cost.summary()[k] for k in COUNTERS}
            ex.exit_data(0, "acc", "b")
            ex.exit_data(1, "acc")
        finally:
            p.close(pool, ex)
        return rec

    rec = _both(case)
    assert rec["after"]["evictions"] == 1
    assert rec["after"]["bytes_reconciled"] == BLK
    np.testing.assert_array_equal(rec["dst"], np.zeros(16))


# ---------------------------------------------------------------------------
# the BOTS workloads under every policy and a cap
# ---------------------------------------------------------------------------
def test_capped_sparselu_wavefront_bit_identical():
    """The BOTS wavefront (resident wave pins, peer edges) under HEFT with a
    cap of four blocks a device equals the uncapped run bit for bit."""
    Ks, Bs = 4, 32
    mat = tbl._matrix(Ks, Bs)
    got = {}
    for cap in (None, 4 * Bs * Bs * 4):
        rt = T.ClusterRuntime(T.RuntimeConfig(n_virtual=4,
                                              device_capacity_bytes=cap),
                              table=tbl._make_table(Ks), device="cpu")
        try:
            res = tbl.wavefront(rt, mat, peer=True, policy=T.HeftPlacement(
                default_task_s=5e-6, use_observed=False))
            got[cap] = (tbl.assemble(res, Ks), rt.memory_report(),
                        rt.cost.summary())
        finally:
            rt.shutdown()
    (ref, _, s0), (capped, mem, s1) = got.values()
    assert torch.equal(ref, capped)
    assert sum(m["evictions"] for m in mem.values()) >= 1
    assert sum(m["refetches"] for m in mem.values()) >= 1
    assert s1["bytes_from"] >= s0["bytes_from"]


def test_mandelbrot_strips_equal_under_every_policy():
    """Strips carry no locality signal: the image and the bytes of every
    policy equal round-robin's."""
    H = W = 48
    table = tbm._make_table(W, H, 40)
    rows = tbm.all_rows(H)
    got = {}
    for policy in ("round-robin", "locality",
                   T.HeftPlacement(default_task_s=5e-6, use_observed=False)):
        rt = T.ClusterRuntime(T.RuntimeConfig(n_virtual=8), table=table,
                              device="cpu")
        try:
            img = tbm.strips(rt, rows, W, nowait=True, policy=policy)
            s = rt.cost.summary()
            got[str(policy)] = (img, s["bytes_to"], s["bytes_from"],
                                len({c.device for c in rt.cost.compute}))
        finally:
            rt.shutdown()
    (ref, *rest), *others = got.values()
    for img, *counts in others:
        assert torch.equal(img, ref)
        assert counts == rest
    assert rest[2] == 8
