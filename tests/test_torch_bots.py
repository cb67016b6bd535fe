"""The slice end to end: BOTS mandelbrot strips, the sparselu wavefront, the
fib recursion and the alignment strips on both packages, at small sizes on
the CPU — outputs within tolerance (fib exact) and byte counters identical
for every device count."""
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

import benchmarks.bots_alignment as jba  # noqa: E402
import benchmarks.bots_fib as jbf  # noqa: E402
import benchmarks.bots_mandelbrot as jbm  # noqa: E402
import benchmarks.bots_sparselu as jbl  # noqa: E402
import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.bots import alignment as tba  # noqa: E402
from repro_torch.bots import common as tcommon  # noqa: E402
from repro_torch.bots import fib as tbf  # noqa: E402
from repro_torch.bots import mandelbrot as tbm  # noqa: E402
from repro_torch.bots import sparselu as tbl  # noqa: E402
from repro_torch.interop import from_numpy_tree, to_numpy_tree  # noqa: E402

torch.set_num_threads(1)      # six test workers share the CPU


def _bytes(rt):
    s = rt.cost.summary()
    return s["bytes_to"], s["bytes_from"]


# ---------------------------------------------------------------------------
# mandelbrot strips
# ---------------------------------------------------------------------------
def _jax_strips(D, H, W, iters):
    rt = J.ClusterRuntime(J.RuntimeConfig(n_virtual=D),
                          table=jbm._make_table(W, H, iters))
    rows = jnp.arange(H, dtype=jnp.int32)
    try:
        img = J.offload_strips(rt.ex, "mandel_strip", H, lambda s, ln: J.MapSpec(
            to={"rows": J.sec(rows, s, ln)},
            from_={"out": jax.ShapeDtypeStruct((ln, W), jnp.int32)}),
            nowait=False)
        return np.asarray(img), _bytes(rt)
    finally:
        rt.shutdown()


@pytest.mark.parametrize("D", [1, 2, 4])
def test_mandelbrot_strips_match_reference(D):
    H = W = 64
    iters = 50
    jimg, jbytes = _jax_strips(D, H, W, iters)
    rt = T.ClusterRuntime(T.RuntimeConfig(n_virtual=D),
                          table=tbm._make_table(W, H, iters), device="cpu")
    try:
        img = tbm.strips(rt, tbm.all_rows(H), W)
        tbytes = _bytes(rt)
    finally:
        rt.shutdown()
    # escape-time boundary tolerance of the reference's kernel test
    assert float((to_numpy_tree(img) != jimg).mean()) < 0.005
    assert tbytes == jbytes


def test_mandelbrot_verify_strips_equal_serial():
    assert tbm.verify("small", n_devices=3, device="cpu") == (0, 0.0)


def test_run_curve_matches_reference_bytes():
    """The run_curve twin: same points, same byte counters per device count."""
    H = W = 24
    rows = tbm.all_rows(H)
    curve = tcommon.run_curve(
        "mandelbrot", "tiny", tbm._make_table(W, H, 20),
        lambda rt, n: tbm.strips(rt, rows, W),
        serial=lambda rt: tbm.serial(rt, rows, W),
        device_counts=(1, 2), warmup=False, repeats=1, device="cpu")
    assert [p.devices for p in curve.points] == [1, 2]
    for p in curve.points:
        _, jbytes = _jax_strips(p.devices, H, W, 20)
        assert (p.bytes_to, p.bytes_from) == jbytes
        assert p.makespan_s > 0 and p.speedup > 0
    assert "mandelbrot" in curve.render()


# ---------------------------------------------------------------------------
# sparselu wavefront
# ---------------------------------------------------------------------------
K, B = 3, 16


@pytest.mark.parametrize("D", [1, 2, 4])
def test_sparselu_wavefront_matches_reference(D):
    jmat = jbl._matrix(K, B)
    mat = tbl._matrix(K, B)
    np.testing.assert_array_equal(mat.numpy(), np.asarray(jmat))
    jrt = J.ClusterRuntime(J.RuntimeConfig(n_virtual=D), table=jbl._make_table(K))
    try:
        jres = J.wavefront_offload(jrt.ex, jbl._build_dag(jmat, K, B),
                                   nowait=True, resident=True)
        jbytes = _bytes(jrt)
    finally:
        jrt.shutdown()
    rt = T.ClusterRuntime(T.RuntimeConfig(n_virtual=D), table=tbl._make_table(K),
                          device="cpu")
    try:
        res = tbl.wavefront(rt, mat)
        tbytes = _bytes(rt)
        stats = rt.memory_report()
    finally:
        rt.shutdown()
    assert sorted(res) == sorted(jres)
    for name in jres:
        np.testing.assert_allclose(to_numpy_tree(res[name]), np.asarray(jres[name]),
                                   rtol=2e-5, atol=2e-5, err_msg=name)
    assert tbytes == jbytes
    assert all(s["resident"] == 0 for s in stats.values())


def test_sparselu_serial_kernel_matches_reference():
    mat = from_numpy_tree(np.asarray(jbl._matrix(K, B)), "cpu")
    port = tbl.factorize_serial(mat)
    ref = jbl._make_table(K).lookup(4).fn(jnp.asarray(mat.numpy()))["out"]
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_sparselu_verify_is_exact():
    """Distributed == serial, bit for bit, as the reference's verify()."""
    assert tbl.verify((K, B), n_devices=3, device="cpu") == 0.0


# ---------------------------------------------------------------------------
# fib: recursive unroll-then-offload
# ---------------------------------------------------------------------------
def _jax_fib(D, n):
    """The reference's offloaded fib (its run()'s workload) on D devices."""
    rt = J.ClusterRuntime(J.RuntimeConfig(n_virtual=D), table=jbf._make_table())
    try:
        out = J.recursive_offload(
            rt.ex, "fib_subtree", n, lambda k: [k - 1, k - 2] if k > 2 else None,
            lambda _k, kids: kids[0] + kids[1],
            lambda k: J.MapSpec(to={"n": jnp.asarray(k, jnp.int32)},
                                from_={"out": jax.ShapeDtypeStruct((), jnp.float32)}),
            nowait=False)
        return np.asarray(out), _bytes(rt)
    finally:
        rt.shutdown()


@pytest.mark.parametrize("D", [1, 2, 4])
def test_fib_matches_reference(D):
    n = tbf.SIZES["small"]
    jout, jbytes = _jax_fib(D, n)
    rt = T.ClusterRuntime(T.RuntimeConfig(n_virtual=D), table=tbf._make_table(),
                          device="cpu")
    try:
        out = tbf.offloaded(rt, n)
        tbytes = _bytes(rt)
    finally:
        rt.shutdown()
    assert out.dtype == torch.float32 and out.numpy() == jout == 21.0
    assert tbytes == jbytes


@pytest.mark.parametrize("n", [0, 1, 2, 5, 9])
def test_fib_leaf_matches_reference_kernel(n):
    """The table kernel on one device: the port's plain busy loop against
    the reference's jitted fori_loop."""
    table = jbf._make_table()
    ref = table.lookup(table.index_of("fib_subtree")).fn(jnp.asarray(n, jnp.int32))
    port = tbf._make_table().lookup(0).fn(torch.tensor(n, dtype=torch.int32))
    assert port["out"].numpy() == np.asarray(ref["out"])


def test_fib_run_curve_bytes_match_reference():
    jcurve = jbf.run("small", device_counts=(1, 2, 4))
    curve = tbf.run("small", device_counts=(1, 2, 4), device="cpu")
    assert [p.devices for p in curve.points] == [p.devices for p in jcurve.points]
    for p, jp in zip(curve.points, jcurve.points):
        assert (p.bytes_to, p.bytes_from) == (jp.bytes_to, jp.bytes_from)
    assert tbf.verify("small", n_devices=3, device="cpu")


# ---------------------------------------------------------------------------
# alignment strips over a resident reference bank
# ---------------------------------------------------------------------------
def _jax_alignment(D, m, R):
    """The reference's offloaded alignment (its run()'s workload) on D
    devices."""
    queries, refs, subst = jba._data(m, R)
    rt = J.ClusterRuntime(J.RuntimeConfig(n_virtual=D), table=jba._make_table())
    try:
        for d in range(D):
            rt.ex.ensure_resident(d, refs=refs, subst=subst)
        out = J.offload_strips(rt.ex, "align_strip", m, lambda s, ln: J.MapSpec(
            to={"queries": J.sec(queries, s, ln), "refs": refs, "subst": subst},
            from_={"out": jax.ShapeDtypeStruct((ln, R), jnp.float32)}), nowait=False)
        return np.asarray(out), _bytes(rt)
    finally:
        rt.shutdown()


@pytest.mark.parametrize("D", [1, 2, 4])
def test_alignment_matches_reference(D):
    m, R = tba.SIZES["small"]
    jout, jbytes = _jax_alignment(D, m, R)
    data = tba._data(m, R)
    for t, j in zip(data, jba._data(m, R)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    rt = T.ClusterRuntime(T.RuntimeConfig(n_virtual=D), table=tba._make_table(),
                          device="cpu")
    try:
        out = tba.offloaded(rt, *data)
        tbytes = _bytes(rt)
    finally:
        rt.shutdown()
    assert tuple(out.shape) == (m, R)
    np.testing.assert_allclose(out.numpy(), jout, rtol=2e-5, atol=2e-5)
    assert tbytes == jbytes


def test_alignment_scan_combines_in_the_reference_order():
    """The in-row scan's operator, max(a - 0.5, b), is not associative, so
    the combination order sets the bits: the port's gap_scan against
    ``jax.lax.associative_scan`` over odd and even lengths."""
    rng = np.random.default_rng(3)
    scan = jax.jit(lambda x: jax.lax.associative_scan(
        lambda a, b: jnp.maximum(a - 0.5, b), x, axis=-1))
    for n in (1, 2, 5, 33, 64):
        x = rng.standard_normal((4, n)).astype(np.float32) * 4
        ref = scan(jnp.asarray(x))
        np.testing.assert_array_equal(tba.gap_scan(torch.from_numpy(x)).numpy(),
                                      np.asarray(ref), err_msg=str(n))


def test_alignment_run_curve_bytes_match_reference():
    jcurve = jba.run("small", device_counts=(1, 2, 4))
    curve = tba.run("small", device_counts=(1, 2, 4), device="cpu")
    assert [p.devices for p in curve.points] == [p.devices for p in jcurve.points]
    for p, jp in zip(curve.points, jcurve.points):
        assert (p.bytes_to, p.bytes_from) == (jp.bytes_to, jp.bytes_from)
    assert tba.verify("small", n_devices=3, device="cpu")
