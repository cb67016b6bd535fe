"""The fabric on both packages: block-int8 compression, the topology, the
cost model's per-pair peer pricing, SEND/RECV between virtual devices, the
collectives, and the byte columns of ``artifacts/bench/BENCH_comm.json`` and
``BENCH_topo.json`` reproduced by the port alone.  The same seeded numpy
inputs go through ``repro`` and ``repro_torch`` (``device="cpu"``); byte
counters must be equal, values bitwise where the reference claims it."""
import json
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core import compression as Jc
from repro_torch import comm_modes as cm
from repro_torch.core import compression as Tc
from repro_torch.kernels.q8_wire.ops import q8_roundtrip

torch.set_num_threads(1)      # six test workers share the CPU

BENCH = Path(__file__).resolve().parents[1] / "artifacts" / "bench"
COUNTERS = ("bytes_to", "bytes_from", "bytes_peer", "bytes_peer_cross_rack")


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _jbits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


def _counters(s):
    return {k: s[k] for k in COUNTERS}


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------
def _wire_input(n: int, seed: int) -> np.ndarray:
    """Gaussian values at three magnitudes, a zero block, exact halves of
    the scale (round half to even) and the block maximum."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * rng.choice([1e-4, 1.0, 3e3], size=n)).astype(np.float32)
    x[: min(n, 256)] = 0.0
    if n > 600:
        x[512:520] = np.array([127, 63.5, -63.5, 0.5, 1.5, 2.5, -2.5, -127],
                              np.float32)
    return x


@pytest.mark.parametrize("n,block", [(1, 256), (255, 256), (257, 256),
                                     (4096 * 3 + 7, 256), (1000, 64)])
def test_compress_matches_jax_bit_for_bit(n, block):
    x = _wire_input(n, seed=n)
    cj = Jc.compress(jnp.asarray(x), block)
    ct = Tc.compress(torch.from_numpy(x), block)
    np.testing.assert_array_equal(np.asarray(cj.q), ct.q.numpy())
    np.testing.assert_array_equal(_jbits(cj.scale), _bits(ct.scale))
    dj = Jc.decompress(cj, (n,))
    dt = Tc.decompress(ct, (n,))
    np.testing.assert_array_equal(_jbits(dj), _bits(dt))
    assert Tc.compressed_nbytes(ct) == Jc.compressed_nbytes(cj) \
        == Tc.int8_wire_nbytes(n, block) == Jc.int8_wire_nbytes(n, block)
    # the wire kernel's op on the CPU: the plain round trip
    np.testing.assert_array_equal(_bits(q8_roundtrip(torch.from_numpy(x), block)),
                                  _jbits(dj))


def test_error_feedback_contract_matches_jax():
    """compressed value + new residual == corrected value, on both
    packages, with equal bits through two rounds over a gradient tree."""
    rng = np.random.default_rng(3)
    g = {"w": rng.standard_normal((40, 33)).astype(np.float32),
         "b": rng.standard_normal(33).astype(np.float32)}
    gj = {k: jnp.asarray(v) for k, v in g.items()}
    gt = {k: torch.from_numpy(v) for k, v in g.items()}
    rj = {k: Jc.ef_init(v) for k, v in gj.items()}
    rt = {k: Tc.ef_init(v) for k, v in gt.items()}
    for _ in range(2):
        cj, rj_new = Jc.tree_ef_compress(gj, rj)
        ct, rt_new = Tc.tree_ef_compress(gt, rt)
        dj, dt = Jc.tree_decompress(cj, gj), Tc.tree_decompress(ct, gt)
        for k in g:
            np.testing.assert_array_equal(_jbits(dj[k]), _bits(dt[k]))
            np.testing.assert_array_equal(_jbits(rj_new[k]), _bits(rt_new[k]))
            np.testing.assert_array_equal(
                (dt[k] + rt_new[k]).numpy(), (gt[k] + rt[k]).numpy())
        rj, rt = rj_new, rt_new


# ---------------------------------------------------------------------------
# topology and the cost model's per-pair pricing
# ---------------------------------------------------------------------------
def _topologies(pkg):
    t = pkg.Topology.two_tier(2, 3, inter_bw_ratio=0.05)
    t.set_link(0, 4, pkg.LinkModel("slow", 1e7, 1e-3), directed=True)
    return [t, pkg.Topology.partition(7, 3), pkg.Topology.flat(4),
            pkg.Topology.two_tier(3, 2, inter_latency_s=7e-5, quantize_Bps=5e8,
                                  block=64)]


def test_topology_queries_and_edge_seconds_match_reference():
    for tj, tt in zip(_topologies(J), _topologies(T)):
        assert tt.describe() == tj.describe() and repr(tt) == repr(tj)
        assert (tt.n_devices, tt.n_racks, tt.leaders()) == \
            (tj.n_devices, tj.n_racks, tj.leaders())
        D = tt.n_devices
        for a in range(D):
            assert tt.leader_of(a) == tj.leader_of(a)
            for b in range(D):
                assert tt.link_between(a, b).__dict__ == tj.link_between(a, b).__dict__
                assert tt.cross_rack(a, b) == tj.cross_rack(a, b)
                for n in (0, 4, 1000, 4096, 1 << 20, 3 << 22):
                    assert tt.edge_seconds(a, b, n) == tj.edge_seconds(a, b, n)
                    assert tt.pair_time(a, b, n, 3) == tj.pair_time(a, b, n, 3)
    with pytest.raises(ValueError, match="contiguous"):
        T.Topology(((0, 2), (1, 3)))


def test_cost_model_prices_peer_pairs_like_reference():
    rng = np.random.default_rng(5)
    stream = [(int(rng.integers(0, 6)), int(rng.integers(0, 6)),
               int(rng.integers(1, 1 << 20)), str(rng.choice(["x", "c"])))
              for _ in range(60)]
    sums = []
    for pkg in (J, T):
        cost = pkg.CostModel(peer_link=pkg.LinkModel("p", 5e8, 2e-6),
                             topology=pkg.Topology.two_tier(2, 3))
        for src, dst, n, kind in stream:
            if kind == "c":
                cost.record_compute(src, n * 1e-9)
            if src != dst:
                cost.record_peer(src, dst, n)
        cost.record_transfer("to", 1, 4096)
        sums.append(cost.summary())
    assert sums[1].keys() == sums[0].keys()
    for k in sums[0]:
        assert sums[1][k] == pytest.approx(sums[0][k], rel=1e-12), k
    assert sums[1]["bytes_peer_cross_rack"] > 0


# ---------------------------------------------------------------------------
# the primitive: SEND/RECV between two virtual devices
# ---------------------------------------------------------------------------
def _pool(pkg, n):
    table = pkg.KernelTable()
    table.register("triple", lambda a: {"a": a * 3.0 + 1.0})
    if pkg is T:
        return T.DevicePool.virtual(n, table=table, device="cpu")
    return J.DevicePool.virtual(n, table=table)


def _install(pkg, pool, d, value: np.ndarray):
    v = jnp.asarray(value) if pkg is J else torch.from_numpy(value)
    h = pool.alloc(d, v.shape, v.dtype)
    pool.transfer_to(d, h, v)
    return h


def test_peer_copy_moves_values_and_counts_peer_bytes():
    outs = []
    for pkg in (J, T):
        pool = _pool(pkg, 2)
        try:
            hs = _install(pkg, pool, 0, np.arange(16, dtype=np.float32))
            hd = pool.alloc(1, (16,), jnp.float32 if pkg is J else torch.float32)
            pool.peer_copy(0, hs, 1, hd, tag="e")
            pool.peer_copy(1, hd, 0, hs, nbytes=20, tag="e")   # accounted size only
            got = [np.asarray(pool.transfer_from(d, h)) for d, h in ((1, hd), (0, hs))]
            ops = sorted(f"{c.op}@{c.device}>{c.peer}" for c in pool.trace
                         if c.op in ("SEND", "RECV"))
            outs.append((got, _counters(pool.cost.summary()), ops))
        finally:
            pool.stop_all()
    (gj, sj, oj), (gt, st, ot) = outs
    for a, b in zip(gj, gt):
        np.testing.assert_array_equal(a, b)
    assert st == sj and ot == oj and st["bytes_peer"] == 64 + 20
    with pytest.raises(ValueError, match="both device"):
        pool = _pool(T, 2)
        try:
            pool.peer_copy(0, 0, 0, 0)
        finally:
            pool.stop_all()


def test_peer_copy_orders_like_a_stream_writer_and_never_aliases():
    """SEND issued after a producer carries the produced value, a consumer
    EXEC after the RECV sees it, and rewriting the source afterwards leaves
    the received copy alone (RECV copies into the destination's own
    buffer)."""
    pool = _pool(T, 2)
    try:
        hs = _install(T, pool, 0, np.zeros(8, np.float32))
        hd = _install(T, pool, 1, np.full(8, -1.0, np.float32))
        gate = threading.Event()
        pool._submit(0, gate.wait)                  # stall device 0's stream
        pool.transfer_to(0, hs, torch.full((8,), 7.0))
        pool.peer_copy(0, hs, 1, hd)
        pool.transfer_to(0, hs, torch.full((8,), 5.0))   # rewrite the source
        threading.Timer(0.2, gate.set).start()
        out = pool.exec_kernel(1, "triple", buffers={"a": hd})
        assert torch.equal(out["a"], torch.full((8,), 22.0))
        pool.sync()
        src = pool.devices[0].store.read(hs)
        dst = pool.devices[1].store.read(hd)
        assert torch.equal(src, torch.full((8,), 5.0))
        assert torch.equal(dst, torch.full((8,), 7.0))
        assert dst.data_ptr() != src.data_ptr()
    finally:
        pool.stop_all()


@pytest.mark.parametrize("seed", range(3))
def test_peer_ring_is_deadlock_free_under_random_interleavings(seed):
    """Rings of peer copies issued in random orders while two workers are
    stalled, each followed by an on-device EXEC and writeback per device,
    all complete once released and match a serial replay."""
    rng = np.random.default_rng(seed)
    D = 4
    pool = _pool(T, D)
    pool.table.register("double", lambda b: {"b": b * 2.0})
    gates = [threading.Event() for _ in range(D)]
    try:
        ref = [np.full(8, float(d), np.float32) for d in range(D)]
        h = [_install(T, pool, d, ref[d]) for d in range(D)]
        tmp = [pool.alloc(d, (8,), torch.float32) for d in range(D)]
        for d in rng.permutation(D)[:2]:
            pool._submit(int(d), gates[int(d)].wait)
        threading.Timer(0.2, lambda: [g.set() for g in gates]).start()
        for _ in range(3):
            for d in map(int, rng.permutation(D)):
                pool.peer_copy(d, h[d], (d + 1) % D, tmp[(d + 1) % D])
            for d in map(int, rng.permutation(D)):
                out = pool.exec_kernel(d, "double", buffers={"b": tmp[d]})
                pool.transfer_to_writeback(d, h[d], out["b"])
            ref = [ref[(d - 1) % D] * 2.0 for d in range(D)]
        for d in range(D):
            np.testing.assert_array_equal(pool.transfer_from(d, h[d]).numpy(), ref[d])
    finally:
        for g in gates:
            g.set()
        pool.stop_all()


# ---------------------------------------------------------------------------
# collectives, on both packages
# ---------------------------------------------------------------------------
def _collective(pkg, D, values, run, topology=None):
    """Install ``values[d]`` (leaf lists) on D devices, ``run(transport,
    pool, handles, specs)``, sync; every device's leaves and the counters."""
    pool = _pool(pkg, D)
    if topology is not None:
        pool.cost.topology = topology
    try:
        handles = [[_install(pkg, pool, d, v) for v in values[d]] for d in range(D)]
        if pkg is J:
            specs = [jax.ShapeDtypeStruct(v.shape, jnp.float32) for v in values[0]]
        else:
            specs = [T.TensorSpec(v.shape, torch.float32) for v in values[0]]
        run(pkg.PeerTransport(topology=topology), pool, handles, specs)
        pool.sync()
        got = [[np.asarray(pool.transfer_from(d, h)) for h in handles[d]]
               for d in range(D)]
        return got, _counters(pool.cost.summary())
    finally:
        pool.stop_all()


def _values(D, seed, shapes=((5, 3), (70,))):
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal(s).astype(np.float32) for s in shapes]
            for _ in range(D)]


def _serial_sum(values, j):
    acc = values[0][j]
    for v in values[1:]:
        acc = acc + v[j]
    return acc


COLLECTIVES = {
    "ring": lambda tr, p, h, s: tr.ring_allreduce(p, h, s),
    "mean_root0": lambda tr, p, h, s: tr.allreduce_mean(p, h, s, root=0),
    "mean_root2": lambda tr, p, h, s: tr.allreduce_mean(p, h, s, root=2),
    "broadcast": lambda tr, p, h, s: tr.broadcast(p, h, s, root=1),
    "q8_ring": lambda tr, p, h, s: tr.ring_allreduce(
        p, h, s, wire_nbytes=tr.quantize_int8(p, h, s)),
}


@pytest.mark.parametrize("name", sorted(COLLECTIVES))
@pytest.mark.parametrize("topo", [None, (2, 2)], ids=["flat", "2x2"])
def test_collectives_match_reference(name, topo):
    D = 4
    values = _values(D, seed=len(name))
    tops = {pkg: None if topo is None else pkg.Topology.two_tier(*topo)
            for pkg in (J, T)}
    gj, sj = _collective(J, D, values, COLLECTIVES[name], tops[J])
    gt, st = _collective(T, D, values, COLLECTIVES[name], tops[T])
    assert st == sj
    for d in range(D):
        for j in range(2):
            if name.startswith(("mean", "broadcast")) or topo is not None:
                # the reference claims the serial association here (and a
                # broadcast moves bits): bitwise to the reference
                np.testing.assert_array_equal(gt[d][j].view(np.uint32),
                                              gj[d][j].view(np.uint32))
            else:
                np.testing.assert_allclose(gt[d][j], gj[d][j], rtol=2e-5, atol=2e-5)
    if name.startswith("mean"):
        for d in range(D):
            for j in range(2):
                want = (sum(v[j] for v in values) / D).astype(np.float32)
                np.testing.assert_array_equal(gt[d][j], want)
    if name == "ring" and topo is not None:
        for d in range(D):                      # hierarchical: serial sum, bitwise
            for j in range(2):
                np.testing.assert_array_equal(gt[d][j], _serial_sum(values, j))


def test_gather_and_scratch_are_freed():
    D = 3
    values = _values(D, seed=9)
    outs = []
    for pkg in (J, T):
        pool = _pool(pkg, D)
        try:
            handles = [[_install(pkg, pool, d, v) for v in values[d]] for d in range(D)]
            specs = ([jax.ShapeDtypeStruct(v.shape, jnp.float32) for v in values[0]]
                     if pkg is J else [T.TensorSpec(v.shape, torch.float32)
                                       for v in values[0]])
            tr = pkg.PeerTransport()
            scratch = tr.gather(pool, handles, specs, root=1)
            got = {d: [np.asarray(pool.transfer_from(1, h)) for h in hs]
                   for d, hs in scratch.items()}
            for hs in scratch.values():
                for h in hs:
                    pool.free(1, h)
            tr.ring_allreduce(pool, handles, specs)
            pool.sync()
            live = [sorted(pool.mirrors[d].live_handles()) for d in range(D)]
            outs.append((got, live, _counters(pool.cost.summary())))
        finally:
            pool.stop_all()
    (gj, lj, sj), (gt, lt, st) = outs
    assert sorted(gt) == sorted(gj) == [0, 2]
    for d in gt:
        for a, b in zip(gt[d], gj[d]):
            np.testing.assert_array_equal(a, b)
    assert lt == lj and st == sj


def test_unported_transport_options_raise():
    # retries (item 11a) and the op timeout (item 11b) construct with the
    # reference's defaults
    tr, ref = T.PeerTransport(retries=2), J.PeerTransport(retries=2)
    assert (tr.retries, tr.backoff_base_s, tr.backoff_cap_s) == \
        (ref.retries, ref.backoff_base_s, ref.backoff_cap_s)
    assert (tr.fallbacks, tr.backoffs, tr.backoff_s) == (0, 0, 0.0)
    tr, ref = T.PeerTransport(op_timeout_s=0.1), J.PeerTransport(op_timeout_s=0.1)
    assert (tr.op_timeout_s, tr.retries, tr.timeouts) == \
        (ref.op_timeout_s, ref.retries, ref.timeouts) == (0.1, 0, 0)


# ---------------------------------------------------------------------------
# the benchmark artifacts' byte columns, reproduced by the port alone
# ---------------------------------------------------------------------------
def _bench(name):
    return json.loads((BENCH / name).read_text())["sections"]


def _same_rows(got, want, keys, modeled=("comm_s", "peer_s")):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in keys:
            assert g[k] == w[k], (k, g, w)
        for k in modeled:
            if k in w:
                assert g[k] == pytest.approx(w[k], rel=1e-9), (k, g, w)


def test_bench_comm_modes_byte_columns():
    rows, grads = cm.modes(d_model=128, n_batch=16, device_counts=(2, 4), device="cpu")
    _same_rows(rows, _bench("BENCH_comm.json")["modes"],
               ("mode", "devices", "bytes_to", "bytes_from", "bytes_peer"))
    ref = grads["host-mediated"]
    for k in ("w", "b"):
        torch.testing.assert_close(grads["direct"][k], ref[k], rtol=1e-5, atol=1e-6)
        assert float((grads["direct+int8"][k] - ref[k]).abs().max()) <= \
            float(ref["w"].abs().max()) / 64


def test_bench_comm_dps_byte_columns_and_bitwise_params():
    rows, params = cm.dps(d_model=64, n_batch=8, n=4, steps=8, device="cpu")
    want = [r for r in _bench("BENCH_comm.json")["dps"] if not r["update"].startswith("ratio")]
    _same_rows(rows, want, ("update", "devices", "steps", "bytes_to",
                            "bytes_from", "bytes_peer"))
    for k in ("w", "b"):
        assert torch.equal(params["host-mediated"][k], params["direct"][k])


def test_bench_topo_collectives_byte_columns():
    rows, got = cm.collectives(shapes=((2, 4), (2, 2)), n_elem=1024, device="cpu")
    _same_rows(rows, _bench("BENCH_topo.json")["collectives"],
               ("mode", "racks", "per_rack", "devices", "elems", "bytes_peer",
                "bytes_cross_rack"))
    for out in got.values():
        vals = out["values"]
        serial = vals[0]
        for v in vals[1:]:
            serial = serial + v
        assert torch.equal(out["hier"], serial)
        torch.testing.assert_close(out["flat-ring"], serial, rtol=1e-5, atol=1e-6)
        assert float((out["hier+int8"] - serial).abs().max()) <= float(serial.abs().max()) / 64
        want = sum(vals) / len(vals)
        assert all(torch.equal(m, want) for m in out["mean:hier"] + out["mean:flat"])


def test_bench_topo_dp_ring_and_sparselu_byte_columns():
    rows, params = cm.dp_ring(d_model=32, n_batch=4, steps=2, device="cpu")
    _same_rows(rows, _bench("BENCH_topo.json")["dp_ring"],
               ("dispatch", "racks", "per_rack", "devices", "steps", "sync_every",
                "bytes_peer", "bytes_cross_rack"))
    for k in ("w", "b"):
        assert torch.equal(params["flat"][k], params["hier"][k])
    rows, _ = cm.sparselu_round_robin(K=3, B=16, shapes=((2, 2),), device="cpu")
    want = [r for r in _bench("BENCH_topo.json")["sparselu"]
            if r["policy"] == "round-robin"]
    _same_rows(rows, want, ("policy", "racks", "per_rack", "devices",
                            "bytes_peer", "bytes_cross_rack"))


def test_bench_topo_sparselu_heft_rows():
    """The HEFT rows of the sparselu section (``benchmarks/topo_collectives.py``'s
    menu: HEFT frozen at 5 us, priced blind on the flat peer link and aware
    through the topology), beside round-robin, from the port's
    ``topo_collectives.run_sparselu`` (which asserts the benchmark's own
    checks: every placement's results equal round-robin's bit for bit, and
    aware HEFT puts no more bytes on the spine than round-robin)."""
    from repro_torch import topo_collectives as tc
    rows, got = tc.run_sparselu(K=3, B=16, shapes=((2, 2),), device="cpu")
    _same_rows(rows, _bench("BENCH_topo.json")["sparselu"],
               ("policy", "racks", "per_rack", "devices", "bytes_peer", "bytes_cross_rack"))
    vals = got[(2, 2)]
    for name in ("heft-blind", "heft-aware"):
        assert vals[name].keys() == vals["round-robin"].keys()
        for k, v in vals["round-robin"].items():
            assert torch.equal(vals[name][k], v), (name, k)
    assert rows[2]["bytes_cross_rack"] <= rows[0]["bytes_cross_rack"]
