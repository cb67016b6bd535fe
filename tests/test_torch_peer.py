"""The runtime over the peer fabric on both packages: ``comm_mode="direct"``
data-parallel gradients and steps, device→device present-table fulfillment
(``alloc_resident`` / ``propagate_resident``) and peer-routed task graphs
(``run_graph(peer=True)``), the sparselu wavefront included, flat and on a
2 x 2 topology.  Same seeded numpy inputs through ``repro`` and
``repro_torch`` (``device="cpu"``): byte counters equal, values within the
stated tolerance, and bit-identical where the port claims it."""
import os
import sys
import threading

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
import repro_torch.core as T  # noqa: E402
from repro_torch import comm_modes as cm  # noqa: E402
from repro_torch.bots import sparselu as tbl  # noqa: E402

torch.set_num_threads(1)      # six test workers share the CPU

COUNTERS = ("bytes_to", "bytes_from", "bytes_peer", "bytes_peer_cross_rack")
# the port writes mse_grads out by hand, the reference differentiates it:
# the two round in different places, a few fp32 ulps apart
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _counters(rt):
    s = rt.cost.summary()
    return {k: s[k] for k in COUNTERS}


def _dp_table(pkg):
    if pkg is T:
        return cm.make_table()
    table = J.KernelTable()

    @table.kernel("mse_grads")
    def mse_grads(params, batch):
        def loss(p):
            pred = batch["x"] @ p["w"] + p["b"]
            return jnp.mean((pred - batch["y"]) ** 2)
        return {"grads": jax.grad(loss)(params)}

    return table


def _arr(pkg, a):
    return jnp.asarray(a) if pkg is J else torch.from_numpy(np.ascontiguousarray(a))


def _dp_inputs(pkg, d, nb, n, seed=1):
    rng = np.random.default_rng(0)
    params = {"w": _arr(pkg, rng.standard_normal((d, d)).astype(np.float32)),
              "b": _arr(pkg, np.zeros(d, np.float32))}
    rng = np.random.default_rng(seed)
    batches = [{"x": _arr(pkg, rng.standard_normal((nb, d)).astype(np.float32)),
                "y": _arr(pkg, rng.standard_normal((nb, d)).astype(np.float32))}
               for _ in range(n)]
    return params, batches


def _runtime(pkg, table, **cfg):
    if pkg is T:
        return T.ClusterRuntime(T.RuntimeConfig(**cfg), table=table, device="cpu")
    return J.ClusterRuntime(J.RuntimeConfig(**cfg), table=table)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# data_parallel_grads / data_parallel_step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode,compress,resident", [
    ("host-mediated", False, True), ("host-mediated", False, False),
    ("direct", False, True), ("direct", False, False),
    ("host-mediated", True, True), ("direct", True, True)])
def test_dp_grads_match_reference(mode, compress, resident):
    """Two exchanges per runtime: equal counters (the compression credits
    included), values within GRAD_TOL (int8: within the block bound)."""
    d, n = 24, 3
    out = {}
    for pkg in (J, T):
        params, batches = _dp_inputs(pkg, d, 4, n)
        rt = _runtime(pkg, _dp_table(pkg), n_virtual=n, comm_mode=mode,
                      compress=compress)
        try:
            gs = [rt.data_parallel_grads("mse_grads", params, batches,
                                         resident=resident) for _ in range(2)]
            out[pkg] = ([_np(g) for g in gs], _counters(rt),
                        sum(a.nbytes for a in rt.cost.adjustments))
            if pkg is T:
                rt.pool.sync()
                live = [(sorted(rt.pool.mirrors[dev].live_handles()),
                         sorted(rt.pool.devices[dev].store.live_handles()))
                        for dev in range(n)]
                assert all(a == b for a, b in live)
        finally:
            rt.shutdown()
    (gj, cj, aj), (gt, ct, at) = out[J], out[T]
    assert ct == cj and at == aj
    for a, b in zip(gt, gj):
        for k in ("w", "b"):
            if compress:
                bound = np.abs(b["w"]).max() / 64
                assert np.abs(a[k] - b[k]).max() <= bound, k
            else:
                np.testing.assert_allclose(a[k], b[k], **GRAD_TOL)


@pytest.mark.parametrize("n", [3, 4])
def test_dp_step_matches_reference_and_is_bit_identical_across_fabrics(n):
    """``data_parallel_step`` over 6 steps synced every 2: the port's direct
    and host-mediated parameters are bit-identical (also at D = 3, where the
    mean divides by 3), counters equal the reference's, parameters within
    GRAD_TOL of it."""
    d = 16
    got = {}
    for pkg in (J, T):
        params, batches = _dp_inputs(pkg, d, 2, n)
        for mode in ("host-mediated", "direct"):
            rt = _runtime(pkg, _dp_table(pkg), n_virtual=n, comm_mode=mode)
            try:
                p = None
                for _ in range(6):
                    p = rt.data_parallel_step("mse_grads", params, batches,
                                              sync_every=2)
                forced = rt.data_parallel_sync()
                got[pkg, mode] = (_np(p), _counters(rt), _np(forced))
            finally:
                rt.shutdown()
    for mode in ("host-mediated", "direct"):
        assert got[T, mode][1] == got[J, mode][1], mode
        for k in ("w", "b"):
            np.testing.assert_allclose(got[T, mode][0][k], got[J, mode][0][k],
                                       **GRAD_TOL)
    for i in (0, 2):
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[T, "direct"][i][k].view(np.uint32),
                                          got[T, "host-mediated"][i][k].view(np.uint32))


def test_runtime_options_left_for_later_items_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        _runtime(T, None, n_virtual=2, comm_mode="direct", transport_retries=2)
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        _runtime(T, None, n_virtual=2, device_capacity_bytes=1)
    with pytest.raises(ValueError, match="topology describes"):
        _runtime(T, None, n_virtual=3, topology=T.Topology.two_tier(2, 2))
    rt = _runtime(T, None, n_virtual=2, comm_mode="direct",
                  topology=T.Topology.two_tier(2, 1))
    try:
        assert isinstance(rt.transport, T.PeerTransport)
        assert rt.cost.topology is rt.transport.topology is rt.cfg.topology
        with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
            rt.calibrate()
    finally:
        rt.shutdown()


# ---------------------------------------------------------------------------
# alloc_resident / propagate_resident
# ---------------------------------------------------------------------------
def _ex_pool(pkg, n=2):
    table = pkg.KernelTable()
    table.register("bump", lambda a: {"a": a + 1})
    table.register("gen", lambda x: {"out": x @ x})
    table.register("consume", lambda lu, a: {"out": lu + 2 * a})
    pool = (T.DevicePool.virtual(n, table=table, device="cpu") if pkg is T
            else J.DevicePool.virtual(n, table=table))
    return pool, pkg.TargetExecutor(pool)


def test_propagate_resident_device_ahead_skips_host():
    """A device-ahead entry reaches the peer still device-ahead: peer bytes
    only, the same counters as the reference, the advanced value fetched."""
    out = {}
    for pkg in (J, T):
        pool, ex = _ex_pool(pkg)
        try:
            ex.ensure_resident(0, a=_arr(pkg, np.zeros(8, np.float32)))
            for _ in range(3):
                ex.target("bump", 0, pkg.MapSpec(present=("a",), device_out=("a",)))
            ex.propagate_resident(0, 1, "a")
            ent = pool.present[1].get("a")
            ahead = ent.device_ahead
            val = np.asarray(ex.fetch_resident(1, "a"))
            ex.exit_data(0, "a")
            ex.exit_data(1, "a")
            pool.sync()
            live = [pool.devices[d].store.live_handles() for d in range(2)]
            out[pkg] = (ahead, val, _counters(pool), live)
        finally:
            pool.stop_all()
    assert out[T][0] and out[J][0]
    np.testing.assert_array_equal(out[T][1], out[J][1])
    assert out[T][2] == out[J][2] and out[T][2]["bytes_peer"] == 32
    assert out[T][3] == [[], []]


@pytest.mark.parametrize("how", ["funnel", "int8-wire", "refresh"])
def test_propagate_resident_wires_match_reference(how):
    """Over the host funnel (fetch + re-send), under the modeled block-int8
    wire (accounted at the compressed size, value intact), and refreshing
    an entry the peer already holds."""
    x = np.arange(600, dtype=np.float32)
    out = {}
    for pkg in (J, T):
        pool, ex = _ex_pool(pkg)
        try:
            ex.ensure_resident(0, a=_arr(pkg, x))
            kw = {}
            if how == "funnel":
                kw["transport"] = pkg.HostFunnelTransport()
            elif how == "int8-wire":
                kw["compress_wire"] = True
            else:
                ex.ensure_resident(1, a=_arr(pkg, np.ones(600, np.float32)))
            ex.propagate_resident(0, 1, "a", **kw)
            ent = pool.present[1].get("a")
            out[pkg] = (np.asarray(ex.fetch_resident(1, "a")), _counters(pool),
                        ent.refcount, ent.version)
            ex.exit_data(0, "a")
            ex.exit_data(1, "a")
        finally:
            pool.stop_all()
    np.testing.assert_array_equal(out[T][0], x)
    np.testing.assert_array_equal(out[T][0], out[J][0])
    assert out[T][1:] == out[J][1:]


def test_propagate_resident_structure_mismatch_and_alloc_resident():
    pool, ex = _ex_pool(T)
    try:
        ex.ensure_resident(0, a=torch.ones(4))
        ex.ensure_resident(1, a=torch.ones(5))
        with pytest.raises(ValueError, match="structure differs"):
            ex.propagate_resident(0, 1, "a")
        with pytest.raises(KeyError, match="not resident"):
            ex.propagate_resident(1, 0, "nope")
        ex.alloc_resident(0, "g", {"w": T.TensorSpec((3, 2), torch.float32),
                                   "b": torch.zeros(2)})
        with pytest.raises(KeyError, match="already resident"):
            ex.alloc_resident(0, "g", torch.zeros(2))
        ent = pool.present[0].get("g")
        assert ent.device_ahead and ent.host_leaves == [None, None]
        got = ex.fetch_resident(0, "g")
        assert torch.equal(got["w"], torch.zeros(3, 2)) and not ent.device_ahead
        for d, names in ((0, ("a", "g")), (1, ("a",))):
            ex.exit_data(d, *names)
        pool.sync()
        assert [pool.devices[d].store.live_handles() for d in range(2)] == [[], []]
    finally:
        pool.stop_all()


# ---------------------------------------------------------------------------
# run_graph(peer=True)
# ---------------------------------------------------------------------------
def _fanout_dag(pkg, mat, ams):
    spec = (jax.ShapeDtypeStruct(mat.shape, jnp.float32) if pkg is J
            else T.TensorSpec(tuple(mat.shape), torch.float32))
    tasks = [pkg.DagTask("p", "gen", (),
                         lambda deps: pkg.MapSpec(to={"x": mat}, from_={"out": spec}))]
    for i, a in enumerate(ams):
        tasks.append(pkg.DagTask(
            f"c{i}", "consume", ("p",),
            (lambda a=a: lambda deps: pkg.MapSpec(
                to={"lu": deps["p"], "a": a}, from_={"out": spec}))()))
    return tasks


@pytest.mark.parametrize("nowait", [False, True])
def test_peer_fanout_graph_matches_reference(nowait):
    """The reference's fan-out DAG (``tests/test_peer_runtime.py``): results
    equal to the host-mediated run, counters equal to the reference's in
    both routings, fewer bytes to the devices under peer, every entry
    released."""
    rng = np.random.default_rng(0)
    mat = rng.standard_normal((16, 16)).astype(np.float32)
    ams = [rng.standard_normal((16, 16)).astype(np.float32) for _ in range(5)]
    out = {}
    for pkg in (J, T):
        for peer in (False, True):
            pool, ex = _ex_pool(pkg)
            try:
                res = pkg.wavefront_offload(
                    ex, _fanout_dag(pkg, _arr(pkg, mat), [_arr(pkg, a) for a in ams]),
                    nowait=nowait, peer=peer)
                assert all(len(pool.present[d]) == 0 for d in range(2))
                pool.sync()
                assert all(pool.devices[d].store.live_handles() == [] for d in range(2))
                out[pkg, peer] = ({k: np.asarray(v) for k, v in res.items()},
                                  _counters(pool))
            finally:
                pool.stop_all()
    for peer in (False, True):
        assert out[T, peer][1] == out[J, peer][1], peer
        for k, v in out[J, peer][0].items():
            np.testing.assert_allclose(out[T, peer][0][k], v, rtol=2e-5, atol=2e-5)
            np.testing.assert_array_equal(out[T, peer][0][k], out[T, False][0][k])
    assert out[T, True][1]["bytes_to"] < out[T, False][1]["bytes_to"]
    assert out[T, True][1]["bytes_from"] == out[T, False][1]["bytes_from"]


def test_peer_graph_misuse_and_failure_release_entries():
    pool, ex = _ex_pool(T)
    try:
        mat = torch.eye(4)
        spec = T.TensorSpec((4, 4), torch.float32)
        bad = [T.DagTask("p", "gen", (), lambda deps: T.MapSpec(to={"x": mat},
                                                                from_={"out": spec})),
               T.DagTask("c", "bump", ("p",), lambda deps: T.MapSpec(tofrom={"a": deps["p"]}))]
        with pytest.raises(TypeError, match="to= clause"):
            T.wavefront_offload(ex, bad, nowait=False, peer=True)
        pool.table.register("boom", lambda x: (_ for _ in ()).throw(
            ValueError("injected kernel failure")))
        tasks = _fanout_dag(T, mat, [mat + 1, mat + 2])
        tasks.append(T.DagTask("bad", "boom", ("p",),
                               lambda deps: T.MapSpec(to={"x": deps["p"]},
                                                      from_={"out": spec})))
        with pytest.raises(ValueError, match="injected"):
            T.wavefront_offload(ex, tasks, nowait=True, peer=True)
        pool.sync()
        for d in range(2):
            assert len(pool.present[d]) == 0, pool.present[d].names()
            assert pool.devices[d].store.live_handles() == [], d
    finally:
        pool.stop_all()


def test_peer_graph_device_failure_is_left_to_item_11():
    pool, ex = _ex_pool(T)
    try:
        spec = T.TensorSpec((2, 2), torch.float32)

        def fail(x):
            raise T.DeviceFailure("injected", device=1)

        pool.table.register("fail", fail)
        tasks = [T.DagTask("a", "gen", (), lambda deps: T.MapSpec(
                     to={"x": torch.eye(2)}, from_={"out": spec})),
                 T.DagTask("b", "fail", ("a",), lambda deps: T.MapSpec(
                     to={"x": deps["a"]}, from_={"out": spec}))]
        with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
            T.wavefront_offload(ex, tasks, nowait=True, peer=True)
        for d in range(2):
            assert len(pool.present[d]) == 0
    finally:
        pool.stop_all()


@pytest.mark.parametrize("topo", [None, (2, 2)], ids=["flat", "2x2"])
def test_peer_sparselu_matches_reference(topo):
    """sparselu K=4, B=32 on 4 devices, ``comm_mode="direct"`` with the
    DAG's edges peer-routed (under 2 x 2 racks, spine edges on the modeled
    int8 wire): blocks within tolerance of the reference and equal to the
    port's own serial factorization bit for bit; every byte counter equal
    to the reference's."""
    K, B, D = 4, 32, 4
    jmat, mat = jbl._matrix(K, B), tbl._matrix(K, B)
    cfg = {"n_virtual": D, "comm_mode": "direct"}
    jrt = J.ClusterRuntime(J.RuntimeConfig(
        **cfg, topology=None if topo is None else J.Topology.two_tier(*topo)),
        table=jbl._make_table(K))
    try:
        jres = jrt.wavefront_offload(jbl._build_dag(jmat, K, B), nowait=True,
                                     resident=True, peer=True)
        jcount = _counters(jrt)
    finally:
        jrt.shutdown()
    rt = T.ClusterRuntime(T.RuntimeConfig(
        **cfg, topology=None if topo is None else T.Topology.two_tier(*topo)),
        table=tbl._make_table(K), device="cpu")
    try:
        res = tbl.wavefront(rt, mat, peer=True)
        count = _counters(rt)
        ser = tbl.serial(rt, mat)
        stats = rt.memory_report()
    finally:
        rt.shutdown()
    assert count == jcount and count["bytes_peer"] > 0
    assert (count["bytes_peer_cross_rack"] > 0) == (topo is not None)
    for name in jres:
        np.testing.assert_allclose(res[name].numpy(), np.asarray(jres[name]),
                                   rtol=2e-5, atol=2e-5, err_msg=name)
    assert torch.equal(tbl.assemble(res, K), ser)
    assert all(s["resident"] == 0 for s in stats.values())
