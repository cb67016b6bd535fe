"""The slice end to end: BOTS mandelbrot strips and the sparselu wavefront on
both packages, at small sizes on the CPU — outputs within tolerance and
byte counters identical for every device count."""
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

import benchmarks.bots_mandelbrot as jbm  # noqa: E402
import benchmarks.bots_sparselu as jbl  # noqa: E402
import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.bots import common as tcommon  # noqa: E402
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
