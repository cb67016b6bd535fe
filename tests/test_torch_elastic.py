"""Elastic membership on both packages: ``DevicePool.add_device`` /
``remove_tail`` and ``rescale_pool``, on the CPU.

The reference's rescale cases (``tests/test_fault_tolerance.py:254-370`` and
``tests/test_scheduler.py::test_elastic_pool_rescale``) run on ``repro`` and
on ``repro_torch`` with ``device="cpu"``: each rescale report (``moved``,
``dropped``, ``reconciled_bytes``) is the reference's, the values agree
within fp32's 2e-5 across the packages (``tests/test_kernels.py``) and, as
the reference claims for itself, bit for bit within the port against a run
on a pool of fixed size.
"""
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
import repro.ft as JF  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.ft as TF  # noqa: E402
from repro_torch.bots import sparselu as tbl  # noqa: E402

torch.set_num_threads(1)      # six test workers share the CPU

FP32_TOL = dict(rtol=2e-5, atol=2e-5)
FT = {J: JF, T: TF}
#: every per-device list a pool keeps, in the order DevicePool.__init__ builds them
PER_DEVICE = ("devices", "mirrors", "locks", "present", "env_locks", "_queues",
              "_stopped", "_async_errors", "_last_write", "_readers",
              "_outstanding", "stream_traces", "_workers")


def _table(pkg):
    table = pkg.KernelTable()
    if pkg is T:
        table.register("src", lambda s: {"out": s * torch.ones((4, 4))})
    else:
        table.register("src", lambda s: {"out": s * jnp.ones((4, 4), jnp.float32)})
    table.register("combine", lambda x: {"out": x @ x * 1e-2 + 1.0})
    table.register("combine2", lambda x, y: {"out": x @ x * 1e-2 + y})
    table.register("bump", lambda state, s: {"state": state + s})
    table.register("sq2", lambda xs: {"out": xs * xs})
    table.register("use_global", lambda g, x: {"out": g + x})
    return table


def _spec(pkg, shape):
    if pkg is T:
        return T.TensorSpec(shape, torch.float32)
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def _arr(pkg, a):
    a = np.asarray(a, np.float32)
    return torch.from_numpy(a.copy()) if pkg is T else jnp.asarray(a)


def _runtime(pkg, n, table=None):
    table = _table(pkg) if table is None else table
    if pkg is T:
        return T.ClusterRuntime(T.RuntimeConfig(n_virtual=n), table=table, device="cpu")
    return J.ClusterRuntime(J.RuntimeConfig(n_virtual=n), table=table)


def _pool(pkg, n, table):
    if pkg is T:
        return T.DevicePool.virtual(n, table=table, device="cpu")
    return J.DevicePool.virtual(n, table=table)


def _diamond(pkg):
    sds = _spec(pkg, (4, 4))
    return pkg.TaskGraph([
        pkg.TaskNode("a", "src", (), lambda dv: pkg.MapSpec(
            to={"s": _arr(pkg, 3.0)}, from_={"out": sds})),
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
    init = _arr(pkg, rng.standard_normal((4, 4)))
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


def _np(vals):
    return {k: np.asarray(v) for k, v in vals.items()}


def _same_bits(ref, vals):
    assert set(ref) == set(vals)
    for k in ref:
        assert np.array_equal(ref[k], vals[k]), k


def _close(ref, vals):
    assert set(ref) == set(vals)
    for k in ref:
        np.testing.assert_allclose(vals[k], ref[k], **FP32_TOL)


def _lengths(pool):
    return {name: len(getattr(pool, name)) for name in PER_DEVICE}


# ---------------------------------------------------------------------------
# the reference's rescale cases, on both packages
# ---------------------------------------------------------------------------
def _shrink_drains(pkg):
    rt = _runtime(pkg, 3)
    try:
        for d in range(3):
            rt.ex.enter_data(d, **{f"state{d}": _arr(pkg, np.full(8, d + 1.0))})
        # an in-flight nowait region makes the departing device's entry
        # device-ahead: the rescale joins it, then drains the result
        rt.ex.target("bump", 2, pkg.MapSpec(
            present={"state": "state2"}, device_out={"state": "state2"},
            to={"s": _arr(pkg, 10.0)}), nowait=True, tag="bump")
        rep = FT[pkg].rescale_pool(rt, 2)
        moved = {m[0]: m for m in rep["moved"]}
        val = np.asarray(rt.ex.fetch_resident(moved["state2"][2], "state2"))
        return rep, val, len(rt.pool), _lengths(rt.pool) if pkg is T else None
    finally:
        rt.shutdown()


def test_rescale_shrink_drains_device_ahead_updates():
    """The device-ahead +10 on the departing device is reconciled through
    the spill path, relocated to a survivor and readable there; the report
    is the reference's."""
    jrep, jval, _, _ = _shrink_drains(J)
    rep, val, n, lengths = _shrink_drains(T)
    assert rep == jrep
    assert rep["from"] == 3 and rep["to"] == 2 and n == 2
    assert rep["moved"] == [("state2", 2, 0)] and rep["reconciled_bytes"] == 32
    assert np.array_equal(val, np.full(8, 13.0, np.float32)) and np.array_equal(val, jval)
    assert set(lengths.values()) == {2}, lengths


def test_rescale_shrink_mid_job_bit_identical():
    """A graph on 4 devices, a shrink to 2, the graph again: the survivors
    give the same bits; the report and values match the reference's."""
    out = {}
    for pkg in (J, T):
        rt = _runtime(pkg, 4)
        try:
            ref = _np(pkg.run_graph(rt.ex, _diamond(pkg), policy="locality", peer=True))
            rep = FT[pkg].rescale_pool(rt, 2)
            vals = _np(pkg.run_graph(rt.ex, _diamond(pkg), policy="locality", peer=True))
            assert len(rt.pool) == 2 and rep["to"] == 2
            _same_bits(ref, vals)
            out[pkg] = (rep, vals)
        finally:
            rt.shutdown()
    assert out[T][0] == out[J][0]
    _close(out[J][1], out[T][1])


def test_rescale_shrink_drains_resident_graph_outputs():
    """Entries resident on the departing devices (entered, not yet used)
    move to the least-loaded survivors in the reference's order, and a
    region on the new home binds them."""
    out = {}
    for pkg in (J, T):
        rt = _runtime(pkg, 4)
        try:
            for d in range(4):
                for i in range(d + 1):
                    rt.ex.enter_data(d, **{f"w{d}_{i}": _arr(pkg, np.full(4, d + i))})
            rep = FT[pkg].rescale_pool(rt, 2)
            used = [rt.pool.present[d].used_bytes() for d in range(2)]
            got = {}
            for name, _, to in rep["moved"]:
                got[name] = np.asarray(rt.ex.target("sq2", to, pkg.MapSpec(
                    present={"xs": name}, from_={"out": _spec(pkg, (4,))}))["out"])
            out[pkg] = (rep, used, got)
        finally:
            rt.shutdown()
    assert out[T][0] == out[J][0] and out[T][1] == out[J][1]
    assert len(out[T][0]["moved"]) == 7 and out[T][0]["reconciled_bytes"] == 0
    _same_bits(out[J][2], out[T][2])


def test_rescale_grow_joined_device_is_placed():
    """Grow 2 → 4: a round-robin graph run after the grow executes on the
    joined devices and equals the run on a fixed pool of 2 bit for bit."""
    out = {}
    for pkg in (J, T):
        graph = pkg.TaskGraph.from_tasks(_random_tasks(pkg, 5, 9))
        rt = _runtime(pkg, 2)
        try:
            pkg.run_graph(rt.ex, graph, policy="round-robin")
            rep = FT[pkg].rescale_pool(rt, 4)
            before = [sum(1 for c in rt.pool.trace if c.device == d) for d in range(4)]
            vals = _np(pkg.run_graph(rt.ex, graph, policy="round-robin"))
            grew = [sum(1 for c in rt.pool.trace if c.device == d) - b
                    for d, b in enumerate(before)]
            assert grew[2] > 0 and grew[3] > 0, grew
            pool = _pool(pkg, 2, _table(pkg))
            try:
                ref = _np(pkg.run_graph(pkg.TargetExecutor(pool), graph,
                                        policy="round-robin"))
            finally:
                pool.stop_all()
            _same_bits(ref, vals)
            out[pkg] = (rep, vals, grew)
        finally:
            rt.shutdown()
    assert out[T][0] == out[J][0] == {"from": 2, "to": 4, "moved": [], "dropped": [],
                                      "reconciled_bytes": 0}
    assert out[T][2] == out[J][2]
    _close(out[J][1], out[T][1])


def test_rescale_grow_mid_graph_next_wave_places_on_joined_device():
    """A device joining while a graph runs (inside a task's ``make_maps``,
    at wave-planning time) takes work from the next wave on."""
    out = {}
    for pkg in (J, T):
        rt = _runtime(pkg, 2)
        try:
            sds = _spec(pkg, (4, 4))
            state = {"grown": False}

            def growing_maps(dv, pkg=pkg, rt=rt, state=state, sds=sds):
                if not state["grown"]:
                    state["grown"] = True
                    FT[pkg].rescale_pool(rt, 3)
                return pkg.MapSpec(to={"x": next(iter(dv.values()))},
                                   from_={"out": sds})

            tasks = _random_tasks(pkg, 11, 4)
            tasks.append(pkg.DagTask("grow", "combine", ("t3",), growing_maps))
            for i in range(4):      # a wide last wave: round-robin wraps onto 2
                tasks.append(pkg.DagTask(
                    f"w{i}", "combine", ("grow",),
                    lambda dv, pkg=pkg, sds=sds: pkg.MapSpec(to={"x": dv["grow"]},
                                                             from_={"out": sds})))
            graph = pkg.TaskGraph.from_tasks(tasks)
            vals = _np(pkg.run_graph(rt.ex, graph, policy="round-robin"))
            assert state["grown"] and len(rt.pool) == 3
            execs = [sum(1 for c in rt.pool.trace if c.op == "EXEC" and c.device == d)
                     for d in range(3)]
            assert execs[2] > 0
            pool = _pool(pkg, 2, _table(pkg))
            try:
                ref = _np(pkg.run_graph(pkg.TargetExecutor(pool), graph,
                                        policy="round-robin"))
            finally:
                pool.stop_all()
            _same_bits(ref, vals)
            out[pkg] = (vals, execs)
        finally:
            rt.shutdown()
    assert out[T][1] == out[J][1]
    _close(out[J][0], out[T][0])


@pytest.mark.parametrize("pkg", [J, T], ids=["reference", "port"])
def test_rescale_rejects_zero(pkg):
    rt = _runtime(pkg, 2)
    try:
        with pytest.raises(ValueError, match="rescale"):
            FT[pkg].rescale_pool(rt, 0)
        assert FT[pkg].rescale_pool(rt, 2) == {"from": 2, "to": 2, "moved": [],
                                              "dropped": [], "reconciled_bytes": 0}
    finally:
        rt.shutdown()


def test_elastic_pool_rescale_strips():
    """``tests/test_scheduler.py::test_elastic_pool_rescale``: strips on 2
    devices, a grow to 4, strips again (now 4 of them)."""
    out = {}
    for pkg in (J, T):
        rt = _runtime(pkg, 2)
        try:
            data = _arr(pkg, np.arange(8.0))

            def make_maps(start, length, pkg=pkg, data=data):
                return pkg.MapSpec(to={"xs": pkg.sec(data, start, length)},
                                   from_={"out": _spec(pkg, (length,))})

            out2 = np.asarray(pkg.offload_strips(rt.ex, "sq2", 8, make_maps))
            FT[pkg].rescale_pool(rt, 4)
            out4 = np.asarray(pkg.offload_strips(rt.ex, "sq2", 8, make_maps))
            assert len(rt.pool) == 4 and np.array_equal(out2, out4)
            execs = sum(1 for c in rt.pool.trace if c.op == "EXEC")
            out[pkg] = (out4, execs)
        finally:
            rt.shutdown()
    assert np.array_equal(out[T][0], out[J][0]) and out[T][1] == out[J][1] == 6


# ---------------------------------------------------------------------------
# add_device / remove_tail
# ---------------------------------------------------------------------------
def test_per_device_lists_grow_and_shrink_together():
    """Every per-device list follows ``len(pool)`` through grows and
    shrinks, the departed workers are joined, the newcomers get clean
    health records and the pool's capacity."""
    pool = T.DevicePool.virtual(3, table=_table(T), device="cpu", capacity_bytes=4096)
    ex = T.TargetExecutor(pool)
    try:
        pool.health.mark_failed(2)
        pool.health.mark_failed(2)
        assert pool.health.blacklist == {2}
        workers = list(pool._workers)
        rt = type("RT", (), {"pool": pool, "ex": ex})()
        TF.rescale_pool(rt, 1)
        assert set(_lengths(pool).values()) == {1}
        assert not workers[1].is_alive() and not workers[2].is_alive()
        assert pool.health.blacklist == set()
        assert TF.rescale_pool(rt, 5)["to"] == 5
        assert set(_lengths(pool).values()) == {5}
        assert [p.capacity_bytes for p in pool.present] == [4096] * 5
        assert [d.index for d in pool.devices] == list(range(5))
        assert all(w.is_alive() for w in pool._workers)
        assert pool.add_device(hostname="late", capacity_bytes=128) == 5
        assert pool.devices[5].hostname == "late" and pool.present[5].capacity_bytes == 128
        x = torch.arange(4, dtype=torch.float32)
        for d in range(6):
            out = ex.target("sq2", d, T.MapSpec(to={"xs": x},
                                                from_={"out": T.TensorSpec((4,), torch.float32)}))
            assert torch.equal(out["out"], x * x)
    finally:
        ex.close()
        pool.stop_all()


def test_add_device_replays_declare_target_globals():
    """A joined device gets every installed global (paper §4.2): a region
    there binds it; the outputs, handles, bytes and commands are the
    reference's."""
    out = {}
    for pkg in (J, T):
        pool = _pool(pkg, 2, _table(pkg))
        ex = pkg.TargetExecutor(pool)
        try:
            pool.install_global("g", _arr(pkg, np.arange(4.0)))
            assert pool.add_device() == 2
            got = np.asarray(ex.target("use_global", 2, pkg.MapSpec(
                to={"x": _arr(pkg, np.ones(4))}, from_={"out": _spec(pkg, (4,))},
                use_globals=("g",)))["out"])
            s = pool.cost.summary()
            out[pkg] = (got, dict(pool.globals["g"]),
                        (s["bytes_to"], s["bytes_from"]),
                        [(c.op, c.device, c.handle, c.nbytes, c.kernel_index, c.tag)
                         for c in pool.trace])
        finally:
            pool.stop_all()
    assert np.array_equal(out[T][0], np.arange(4.0) + 1)
    for a, b in zip(out[J], out[T]):
        assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b


def test_remove_tail_refuses_every_device_and_raises_stashed_failures():
    """``remove_tail`` keeps one device at least; a failure stashed on a
    departing device surfaces, after the pool has shrunk."""
    pool = T.DevicePool.virtual(3, table=_table(T), device="cpu")
    try:
        with pytest.raises(ValueError, match="every device"):
            pool.remove_tail(3)
        pool.remove_tail(0)
        assert len(pool) == 3
        TF.inject_flaky(pool, p=1.0, devices=[2], ops=("XFER_TO",))
        h = pool.alloc(2, (4,), torch.float32)
        pool.transfer_to(2, h, torch.ones(4)).exception(timeout=30)
        with pytest.raises(TF.DeviceFailure, match="XFER_TO"):
            pool.remove_tail(1)
        assert set(_lengths(pool).values()) == {2}
        pool.sync()                      # nothing left stashed on the survivors
    finally:
        pool.stop_all()


def test_rescale_then_sparselu_on_the_survivors():
    """sparselu (K=4) over the peer fabric under locality on a pool shrunk
    from 4 to 2 after a run that left nothing resident: the serial kernel's
    bits, every bmod through the plain version on the CPU."""
    K, B = 4, 32
    mat = tbl._matrix(K, B)
    rt = T.ClusterRuntime(T.RuntimeConfig(n_virtual=4, comm_mode="direct"),
                          table=tbl._make_table(K), device="cpu")
    try:
        first = tbl.assemble(tbl.wavefront(rt, mat, peer=True, policy="locality"), K)
        rep = TF.rescale_pool(rt, 2)
        assert rep["moved"] == [] and rep["dropped"] == []
        again = tbl.assemble(tbl.wavefront(rt, mat, peer=True, policy="locality"), K)
        ser = tbl.serial(rt, mat)
    finally:
        rt.shutdown()
    assert torch.equal(first, ser) and torch.equal(again, ser)
