"""Declare-target globals (paper §4.2) on both packages, on the CPU.

The reference's cases (``tests/test_device_model.py::test_declare_target_globals``
and ``tests/test_dep_stream.py::test_install_global_after_ensure_resident``)
and a task graph whose tasks name a global run on ``repro`` and on
``repro_torch`` with ``device="cpu"``: equal outputs, handles, byte counters
and command traces (issue order, serial dispatch).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T

torch.set_num_threads(1)      # six test workers share the CPU


def _table(pkg):
    table = pkg.KernelTable()

    @table.kernel("use_global")
    def use_global(g, x):
        return {"out": g + x}

    @table.kernel("add_global")
    def add_global(w, x, y):        # adds only: no multiply-add to fuse
        return {"out": x + w + y}

    return table


class _Side:
    """One package's pool, executor and array constructors."""

    def __init__(self, pkg, n_dev: int) -> None:
        self.pkg = pkg
        if pkg is T:
            self.pool = T.DevicePool.virtual(n_dev, table=_table(T), device="cpu")
        else:
            self.pool = J.DevicePool.virtual(n_dev, table=_table(J))
        self.ex = pkg.TargetExecutor(self.pool)

    def arr(self, x: np.ndarray):
        x = np.asarray(x, np.float32)
        return torch.from_numpy(x.copy()) if self.pkg is T else jnp.asarray(x)

    def spec(self, n: int):
        if self.pkg is T:
            return T.TensorSpec((n,), torch.float32)
        return jax.ShapeDtypeStruct((n,), jnp.float32)

    def use_global(self, device: int, x, name: str = "g") -> np.ndarray:
        out = self.ex.target("use_global", device, self.pkg.MapSpec(
            to={"x": self.arr(x)}, from_={"out": self.spec(len(x))},
            use_globals=(name,)))
        return np.asarray(out["out"])

    def trace(self) -> list:
        return [(c.op, c.device, c.handle, c.nbytes, c.kernel_index, c.tag)
                for c in self.pool.trace]

    def bytes(self) -> tuple:
        s = self.pool.cost.summary()
        return s["bytes_to"], s["bytes_from"], s["bytes_peer"]

    def close(self) -> None:
        self.pool.stop_all()


def _both(n_dev: int, body):
    """Run ``body(side)`` on each package; returns (reference's, port's)."""
    got = []
    for pkg in (J, T):
        side = _Side(pkg, n_dev)
        try:
            got.append((body(side), side.trace(), side.bytes()))
        finally:
            side.close()
    (jres, jtrace, jbytes), (tres, ttrace, tbytes) = got
    assert ttrace == jtrace
    assert tbytes == jbytes
    return jres, tres


def test_global_survives_region_teardown_on_both_packages():
    """``test_device_model.py::test_declare_target_globals``: installed once
    at the same handle on every device, used without a transfer, and still
    live after the region ends."""
    def body(side):
        pool = side.pool
        h = side.pool.install_global("g", side.arr(np.full(8, 2.0)))
        live = [pool.mirrors[d].live_handles() for d in range(len(pool))]
        out = side.use_global(1, np.ones(8))
        pool.sync()
        after = (pool.mirrors[1].live_handles(),
                 sorted(pool.devices[1].store.live_handles()))
        return h, live, out, after

    (jh, jlive, jout, jafter), (th, tlive, tout, tafter) = _both(3, body)
    assert th == jh
    assert tlive == jlive == [[th]] * 3
    np.testing.assert_array_equal(tout, jout)
    np.testing.assert_array_equal(tout, np.full(8, 3.0, np.float32))
    assert tafter == jafter == ([th], [th])


def test_install_global_after_ensure_resident_on_both_packages():
    """``test_dep_stream.py::test_install_global_after_ensure_resident``:
    handles diverge once a buffer is pinned on one device; the lookup works
    on every device; re-install is idempotent; mirror and store agree after
    ``sync``."""
    def body(side):
        pool, ex = side.pool, side.ex
        ex.ensure_resident(0, keep=side.arr(np.ones(4)))   # device 0's slot 0 taken
        pool.install_global("g", side.arr(np.full(8, 2.0)))
        handles = dict(pool.globals["g"])
        outs = [side.use_global(d, np.ones(8)) for d in range(3)]
        pool.install_global("g", side.arr(np.full(8, 9.0)))
        reinstalled = dict(pool.globals["g"])
        outs.append(side.use_global(1, np.ones(8)))
        ex.exit_data(0, "keep")
        pool.sync()
        agree = [sorted(pool.mirrors[d].live_handles())
                 == sorted(pool.devices[d].store.live_handles()) for d in range(3)]
        return handles, reinstalled, outs, agree

    (jh, jre, jouts, jagree), (th, tre, touts, tagree) = _both(3, body)
    assert th == jh and tre == jre
    assert th[0] != th[1]
    for t, j, want in zip(touts, jouts, (3.0, 3.0, 3.0, 10.0)):
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(t, np.full(8, want, np.float32))
    assert tagree == jagree == [True] * 3


@pytest.mark.parametrize("peer", [False, True])
def test_graph_tasks_name_a_global_on_both_packages(peer):
    """A two-wave task graph whose every task binds the global ``w``
    (``run_graph`` passes ``use_globals`` through, peer-routed too): equal
    results, bytes and command traces, serial dispatch."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal(16).astype(np.float32)
    xs = [rng.standard_normal(16).astype(np.float32) for _ in range(3)]

    def body(side):
        side.pool.install_global("w", side.arr(w))
        zero = side.arr(np.zeros(16))

        def task(name, deps, x):
            def maps(got):
                y = got[deps[0]] if deps else zero
                return side.pkg.MapSpec(to={"x": side.arr(x), "y": y},
                                        from_={"out": side.spec(16)},
                                        use_globals=("w",))
            return side.pkg.DagTask(name, "add_global", tuple(deps), maps)

        tasks = [task("a", (), xs[0]), task("b", (), xs[1]), task("c", ("a",), xs[2])]
        res = side.pkg.wavefront_offload(side.ex, tasks, nowait=False, peer=peer)
        return {k: np.asarray(v) for k, v in res.items()}

    jres, tres = _both(2, body)
    assert sorted(tres) == sorted(jres) == ["a", "b", "c"]
    for k in jres:
        np.testing.assert_array_equal(tres[k], jres[k])
    np.testing.assert_array_equal(tres["c"], xs[2] + w + (xs[0] + w + 0))


def test_map_spec_all_names_matches_reference():
    kw = dict(to={"a": 1}, from_={"b": 2}, tofrom={"c": 3}, alloc={"d": 4},
              use_globals=("g",), present={"p": "entry"}, device_out=("o",))
    assert T.MapSpec(**kw).all_names() == J.MapSpec(**kw).all_names()


def test_install_global_copies_the_value():
    """Tensors are mutable: a change to the caller's tensor after the
    install reaches no device (a ``jax.Array`` cannot change)."""
    side = _Side(T, 2)
    try:
        g = torch.full((8,), 2.0)
        side.pool.install_global("g", g)
        g.add_(5.0)
        for d in range(2):
            np.testing.assert_array_equal(side.use_global(d, np.ones(8)),
                                          np.full(8, 3.0, np.float32))
    finally:
        side.close()
