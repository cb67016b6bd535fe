"""The paper's Listings 1–2 and ``offload_strips`` (examples/quickstart.py)
on both packages: equal results, identical byte counters, and the same
``op@device`` command traces — exact for serial dispatch, per device as
multisets for ``nowait`` (host threads may interleave issue order)."""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro_torch.interop import from_numpy_tree, to_numpy_tree

torch.set_num_threads(1)      # six test workers share the CPU

SIZE = 1024


def _inputs():
    rng = np.random.default_rng(0)
    return {"a": rng.standard_normal(SIZE).astype(np.float32),
            "b": rng.standard_normal(SIZE).astype(np.float32)}


def _flow(pkg, flow: str, D: int):
    """Run one quickstart flow on ``pkg``; (result, bytes_to, bytes_from, trace)."""
    is_torch = pkg is T
    data = _inputs()
    if is_torch:
        a, b = from_numpy_tree([data["a"], data["b"]], "cpu")
        spec = lambda n: T.TensorSpec((n,), torch.float32)
        cat = lambda xs: torch.cat(xs)
        rt = T.ClusterRuntime(T.RuntimeConfig(n_virtual=D), table=_table(T),
                              device="cpu")
    else:
        a, b = jnp.asarray(data["a"]), jnp.asarray(data["b"])
        spec = lambda n: jax.ShapeDtypeStruct((n,), jnp.float32)
        cat = jnp.concatenate
        rt = J.ClusterRuntime(J.RuntimeConfig(n_virtual=D), table=_table(J))
    try:
        if flow == "listing1":
            out = rt.target("add_arrays", device=0, maps=pkg.MapSpec(
                to={"a": a, "b": b}, from_={"c": spec(SIZE)}))["c"]
        elif flow == "listing2":
            chunk = SIZE // D
            for d in range(D):
                rt.target("add_arrays", device=d, maps=pkg.MapSpec(
                    to={"a": pkg.sec(a, d * chunk, chunk),
                        "b": pkg.sec(b, d * chunk, chunk)},
                    from_={"c": spec(chunk)}), nowait=True)
            out = cat([p["c"] for p in rt.taskwait()])
        else:
            out = pkg.offload_strips(
                rt.ex, "add_arrays", SIZE,
                lambda s0, ln: pkg.MapSpec(
                    to={"a": pkg.sec(a, s0, ln), "b": pkg.sec(b, s0, ln)},
                    from_={"c": spec(ln)}),
                out_name="c", nowait=(flow == "strips_nowait"))
        s = rt.cost.summary()
        trace = [f"{c.op}@{c.device}" for c in rt.pool.trace]
    finally:
        rt.shutdown()
    res = to_numpy_tree(out) if is_torch else np.asarray(out)
    return res, s["bytes_to"], s["bytes_from"], trace


def _table(pkg):
    t = pkg.KernelTable()
    t.register("add_arrays", lambda a, b: {"c": a + b})
    return t


@pytest.mark.parametrize("D", [1, 4])
@pytest.mark.parametrize("flow", ["listing1", "listing2", "strips_serial",
                                  "strips_nowait"])
def test_quickstart_flow_matches_reference(flow, D):
    jres, jto, jfrom, jtrace = _flow(J, flow, D)
    tres, tto, tfrom, ttrace = _flow(T, flow, D)
    data = _inputs()
    np.testing.assert_array_equal(tres, data["a"] + data["b"])
    np.testing.assert_array_equal(tres, jres)
    assert (tto, tfrom) == (jto, jfrom)
    if flow in ("listing1", "strips_serial"):
        assert ttrace == jtrace
    else:
        per_dev = lambda tr: {d: collections.Counter(
            op for op in tr if op.endswith(f"@{d}")) for d in range(D)}
        assert per_dev(ttrace) == per_dev(jtrace)


def test_stream_orders_producer_before_consumer():
    """Per handle, the device stream executes ALLOC → XFER_TO → EXEC → FREE
    in order even when regions interleave on one device."""
    rt = T.ClusterRuntime(T.RuntimeConfig(n_virtual=1), table=_table(T),
                          device="cpu")
    try:
        x = torch.arange(64, dtype=torch.float32)
        futs = [rt.target("add_arrays", 0, T.MapSpec(
            to={"a": T.sec(x, 16 * i, 16), "b": T.sec(x, 16 * i, 16)},
            from_={"c": T.TensorSpec((16,), torch.float32)}), nowait=True)
            for i in range(4)]
        outs = rt.ex.drain(futs)
        rt.pool.sync()
        for i, o in enumerate(outs):
            assert torch.equal(o["c"], 2 * x[16 * i:16 * i + 16])
        executed = list(rt.pool.stream_traces[0])
        assert len(executed) == len(rt.pool.trace)
        assert rt.pool.mirrors[0].live_handles() == []
        assert rt.pool.devices[0].store.live_handles() == []
    finally:
        rt.shutdown()


def test_unported_options_raise_not_implemented():
    # the fabric (ROADMAP item 9) is ported: direct mode and peer graphs run
    rt = T.ClusterRuntime(T.RuntimeConfig(n_virtual=2, comm_mode="direct"),
                          device="cpu")
    assert T.wavefront_offload(rt.ex, [], peer=True) == {}
    rt.shutdown()
    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        T.ClusterRuntime(T.RuntimeConfig(n_virtual=2, comm_mode="direct",
                                         transport_retries=1), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        T.ClusterRuntime(T.RuntimeConfig(n_virtual=2, device_capacity_bytes=1),
                         device="cpu")
    rt = T.ClusterRuntime(T.RuntimeConfig(n_virtual=2), table=_table(T),
                          device="cpu")
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
            T.wavefront_offload(rt.ex, [], peer=True, stragglers=object())
        with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
            T.wavefront_offload(rt.ex, [], policy="heft")
        with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
            rt.calibrate()
        with pytest.raises(ValueError):
            T.resolve_policy("no-such-policy")
    finally:
        rt.shutdown()


def test_device_resident_chain_matches_reference():
    """``present``/``device_out`` keep a value on the device across regions
    (nothing crosses the wire) until ``fetch_resident``; same bytes and the
    same value as the reference."""
    x0 = np.arange(16, dtype=np.float32)

    def run(pkg, x, rt):
        rt.ex.enter_data(0, x=x)
        for _ in range(3):
            rt.target("double", 0, pkg.MapSpec(present=("x",),
                                                device_out=("x",)))
        out = rt.ex.fetch_resident(0, "x")
        rt.ex.exit_data(0, "x")
        s = rt.cost.summary()
        return out, (s["bytes_to"], s["bytes_from"])

    jt, tt = J.KernelTable(), T.KernelTable()
    jt.register("double", lambda x: {"x": 2 * x})
    tt.register("double", lambda x: {"x": 2 * x})
    jrt = J.ClusterRuntime(J.RuntimeConfig(n_virtual=1), table=jt)
    trt = T.ClusterRuntime(T.RuntimeConfig(n_virtual=1), table=tt, device="cpu")
    try:
        jout, jbytes = run(J, jnp.asarray(x0), jrt)
        tout, tbytes = run(T, from_numpy_tree(x0, "cpu"), trt)
        assert trt.memory_report()[0]["resident"] == 0
    finally:
        jrt.shutdown()
        trt.shutdown()
    np.testing.assert_array_equal(to_numpy_tree(tout), np.asarray(jout))
    np.testing.assert_array_equal(to_numpy_tree(tout), 8 * x0)
    assert tbytes == jbytes == (64.0, 64.0)


def test_nowait_regions_under_thread_stress():
    """Many nowait regions on few devices with a tiny switch interval: every
    result is right, byte counts are exact and no handle leaks."""
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    rt = T.ClusterRuntime(T.RuntimeConfig(n_virtual=3, max_host_threads=12),
                          table=_table(T), device="cpu")
    try:
        x = torch.arange(4 * 64, dtype=torch.float32)
        futs = [rt.target("add_arrays", i % 3, T.MapSpec(
            to={"a": T.sec(x, 4 * i, 4), "b": T.sec(x, 4 * i, 4)},
            from_={"c": T.TensorSpec((4,), torch.float32)}), nowait=True)
            for i in range(64)]
        outs = rt.ex.drain(futs)
        rt.pool.sync()
        for i, o in enumerate(outs):
            assert torch.equal(o["c"], 2 * x[4 * i:4 * i + 4])
        s = rt.cost.summary()
        assert (s["bytes_to"], s["bytes_from"]) == (64 * 32.0, 64 * 16.0)
        for d in range(3):
            assert rt.pool.mirrors[d].live_handles() == []
            assert rt.pool.devices[d].store.live_handles() == []
    finally:
        sys.setswitchinterval(old)
        rt.shutdown()


def test_pytree_map_matches_reference():
    """A dict-valued map flattens in ``jax.tree`` order: the same ALLOC/XFER
    sequence, handles, bytes and result as the reference."""
    rng = np.random.default_rng(5)
    tree = {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32),
            "extra": [rng.standard_normal(2).astype(np.float32), None]}

    def run(pkg, p, spec, rt):
        out = rt.target("affine", 0, pkg.MapSpec(to={"p": p},
                                                 from_={"y": spec}))["y"]
        trace = [(c.op, c.handle, c.nbytes) for c in rt.pool.trace]
        s = rt.cost.summary()
        return out, trace, (s["bytes_to"], s["bytes_from"])

    fn = lambda p: {"y": p["w"].sum(0) * 2 + p["b"] + p["extra"][0].sum()}
    jt, tt = J.KernelTable(), T.KernelTable()
    jt.register("affine", fn)
    tt.register("affine", fn)
    jrt = J.ClusterRuntime(J.RuntimeConfig(n_virtual=1), table=jt)
    trt = T.ClusterRuntime(T.RuntimeConfig(n_virtual=1), table=tt, device="cpu")
    try:
        jout, jtrace, jbytes = run(J, jax.tree.map(jnp.asarray, tree),
                                   jax.ShapeDtypeStruct((3,), jnp.float32), jrt)
        tout, ttrace, tbytes = run(T, from_numpy_tree(tree, "cpu"),
                                   T.TensorSpec((3,), torch.float32), trt)
    finally:
        jrt.shutdown()
        trt.shutdown()
    np.testing.assert_allclose(to_numpy_tree(tout), np.asarray(jout),
                               rtol=2e-5, atol=2e-5)
    assert ttrace == jtrace
    assert tbytes == jbytes
