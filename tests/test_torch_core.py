"""Parity of the port's core modules with ``repro.core``, on the CPU.

Inputs are built once with numpy from a seed and fed to both packages; the
port runs with ``device="cpu"``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import costmodel as jcost
from repro.core import kernel_table as jkt
from repro.core import mediary as jmed
from repro_torch.core import _tree
from repro_torch.core import costmodel as tcost
from repro_torch.core import kernel_table as tkt
from repro_torch.core import mediary as tmed
from repro_torch.core import ClusterRuntime, MapSpec, RuntimeConfig, TensorSpec

torch.set_num_threads(1)      # six test workers share the CPU


# ---------------------------------------------------------------------------
# kernel table
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("names", [["add_arrays"],
                                   ["lu0", "fwd", "bdiv", "bmod",
                                    "sparselu_serial"]])
def test_kernel_table_fingerprint_matches_reference(names):
    jt, tt = jkt.KernelTable(), tkt.KernelTable()
    for n in names:
        jt.register(n, lambda x: x, signature="unary")
        tt.register(n, lambda x: x, signature="unary")
    assert tt.fingerprint() == jt.fingerprint()
    assert [tt.index_of(n) for n in names] == [jt.index_of(n) for n in names]
    assert [tt.class_index_of(n) for n in names] == \
        [jt.class_index_of(n) for n in names]


def test_switch_dispatch_is_host_index_dispatch():
    tt = tkt.KernelTable()
    tt.register("double", lambda x: 2 * x, signature="s")
    tt.register("other", lambda x: x, signature="t")
    tt.register("square", lambda x: x * x, signature="s")
    dispatch = tt.switch_dispatch("s")
    x = torch.tensor([3.0])
    assert float(dispatch(tt.class_index_of("double"), x)) == 6.0
    assert float(dispatch(tt.class_index_of("square"), x)) == 9.0
    with pytest.raises(ValueError):
        tt.switch_dispatch("missing")


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------
def _record_stream(mod, seed):
    cm = mod.CostModel(mod.PAPER_ETHERNET)
    rng = np.random.default_rng(seed)
    for i in range(60):
        kind = int(rng.integers(0, 4))
        dev = int(rng.integers(0, 4))
        tag = f"r{i % 7}[{i}]" if i % 3 else f"r{i % 7}:x"
        if kind == 0:
            cm.record_transfer("to" if rng.random() < 0.5 else "from", dev,
                               int(rng.integers(1, 1 << 20)),
                               n_messages=int(rng.integers(1, 3)), tag=tag)
        elif kind == 1:
            cm.record_compute(dev, float(rng.random() * 1e-2), tag=tag,
                              kernel=f"k{dev}")
        elif kind == 2:
            cm.record_peer(dev, (dev + 1) % 4, int(rng.integers(1, 1 << 16)),
                           tag=tag)
        else:
            cm.record_adjustment("from", dev, -int(rng.integers(0, 1 << 10)),
                                 tag=tag)
    return cm


@pytest.mark.parametrize("seed", [0, 1])
def test_costmodel_summary_matches_reference(seed):
    jc, tc = _record_stream(jcost, seed), _record_stream(tcost, seed)
    assert tc.summary() == jc.summary()
    assert [(s.start, s.end, s.lane) for s in tc.timeline()] == \
        [(s.start, s.end, s.lane) for s in jc.timeline()]
    assert tc.discard_tag("r3") == jc.discard_tag("r3")
    assert tc.rename_tag("r4", "q4") == jc.rename_tag("r4", "q4")
    assert tc.summary() == jc.summary()


# ---------------------------------------------------------------------------
# mediary handles
# ---------------------------------------------------------------------------
def test_mediary_handle_sequence_matches_reference():
    rng = np.random.default_rng(3)
    jstore, jmirror = jmed.MediaryStore(), jmed.HostMirror()
    tstore, tmirror = tmed.MediaryStore(torch.device("cpu")), tmed.HostMirror()
    live_j, live_t, seq_j, seq_t = [], [], [], []
    for _ in range(200):
        if live_j and rng.random() < 0.45:
            k = int(rng.integers(0, len(live_j)))
            hj, ht = live_j.pop(k), live_t.pop(k)
            jstore.free(hj), jmirror.free(hj)
            tstore.free(ht), tmirror.free(ht)
            seq_j.append(("F", hj))
            seq_t.append(("F", ht))
        else:
            shape = tuple(int(s) for s in rng.integers(1, 5, size=2))
            hj = jmirror.reserve(shape, jnp.float32)
            assert jstore.alloc(shape, jnp.float32) == hj
            ht = tmirror.reserve(shape, torch.float32)
            assert tstore.alloc(shape, torch.float32) == ht
            assert tmirror.nbytes(ht) == jmirror.nbytes(hj)
            assert torch.count_nonzero(tstore.read(ht)) == 0   # calloc
            live_j.append(hj)
            live_t.append(ht)
            seq_j.append(("A", hj))
            seq_t.append(("A", ht))
    assert seq_t == seq_j
    assert tstore.live_handles() == jstore.live_handles()


# ---------------------------------------------------------------------------
# present-table elision on a mutable tensor
# ---------------------------------------------------------------------------
def test_inplace_mutation_of_resident_tensor_is_resent():
    """Identity alone would serve a stale device copy after ``add_``: the
    ``_version`` counter makes the region re-send the leaf."""
    table = __import__("repro_torch.core", fromlist=["KernelTable"]).KernelTable()
    table.register("scale", lambda x: {"y": 2 * x})
    rt = ClusterRuntime(RuntimeConfig(n_virtual=1), table=table, device="cpu")
    try:
        x = torch.arange(8, dtype=torch.float32)
        nbytes = x.numel() * 4
        maps = lambda: MapSpec(to={"x": x},
                               from_={"y": TensorSpec((8,), torch.float32)})
        rt.ex.enter_data(0, x=x)
        sent = rt.cost.bytes_moved("to")
        assert sent == nbytes
        y = rt.target("scale", 0, maps())["y"]
        assert torch.equal(y, 2 * x)
        assert rt.cost.bytes_moved("to") == sent          # elided
        x.add_(1)                                          # same object
        y = rt.target("scale", 0, maps())["y"]
        assert torch.equal(y, 2 * x)                       # fresh content
        assert rt.cost.bytes_moved("to") == sent + nbytes  # region re-sent it
        rt.ex.ensure_resident(0, x=x)                      # refresh the entry
        assert rt.cost.bytes_moved("to") == sent + 2 * nbytes
        rt.ex.ensure_resident(0, x=x)                      # unchanged: no-op
        assert rt.cost.bytes_moved("to") == sent + 2 * nbytes
        x.mul_(3)
        y = rt.target("scale", 0, maps())["y"]
        assert torch.equal(y, 2 * x)
        assert rt.cost.bytes_moved("to") == sent + 3 * nbytes
        rt.ex.ensure_resident(0, x=x)
        y = rt.target("scale", 0, maps())["y"]
        assert torch.equal(y, 2 * x)
        assert rt.cost.bytes_moved("to") == sent + 4 * nbytes  # elided again
        rt.ex.exit_data(0, "x")
        assert rt.memory_report()[0]["resident"] == 0
    finally:
        rt.shutdown()


# ---------------------------------------------------------------------------
# pytree leaf order
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_leaf_order_matches_jax(seed):
    rng = np.random.default_rng(seed)
    v = lambda: rng.standard_normal(2).astype(np.float32)
    tree = {"zeta": [v(), {"b": v(), "a": (v(), None, v())}],
            "alpha": v(), "mid": {"y": [], "x": [v(), [v()]]},
            "none": None}
    leaves, treedef = _tree.flatten(tree)
    ref = jax.tree.leaves(tree)
    assert len(leaves) == len(ref) == treedef.num_leaves
    for a, b in zip(leaves, ref):
        assert a is b
    back = _tree.unflatten(treedef, leaves)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert _tree.flatten(back)[1] == treedef
    assert _tree.flatten({"other": 1})[1] != treedef
