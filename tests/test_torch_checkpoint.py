"""Checkpoints and resumable runs on both packages, on the CPU.

The reference's cases (``tests/test_checkpoint.py``: the tree round trip,
``latest_step``, the manager, the missing leaf, and the graph checkpoints)
run on ``repro_torch`` with ``device="cpu"``.  The on-disk format is the
reference's: a tree saved by either package restores in the other bit for
bit, bfloat16 included, with equal manifests, and a graph frontier the
reference saved resumes in the port, whose serial host-mediated resume
issues the reference's commands and moves its bytes.  The kill-and-resume
drill (``benchmarks/resume_smoke.py``) gives the reference's row.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))

import repro.checkpoint as JC  # noqa: E402
import repro.core as J  # noqa: E402
import repro_torch.checkpoint as TC  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch import resume_smoke as trs  # noqa: E402

torch.set_num_threads(1)      # six test workers share the CPU

#: the isolation tests' setting for a child interpreter: one thread
_ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _np_tree():
    """The reference suite's tree (``tests/test_checkpoint.py::_tree``), as
    numpy: nested dicts, a bfloat16 leaf and a 0-d int32 leaf."""
    return {"params": {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
                       "b": np.linspace(-2, 2, 4).astype(np.float32)},
            "opt": {"mu": {"w": np.zeros((3, 4), np.float32),
                           "b": np.full(4, 0.1, np.float32)},
                    "count": np.asarray(7, np.int32)}}


def _jax_tree():
    t = jax.tree.map(jnp.asarray, _np_tree())
    t["params"]["b"] = t["params"]["b"].astype(jnp.bfloat16)
    return t


def _torch_tree():
    t = jax.tree.map(lambda a: torch.from_numpy(a.copy()), _np_tree())
    t["params"]["b"] = t["params"]["b"].to(torch.bfloat16)
    return t


def _bits(x):
    """A leaf's dtype name and raw bytes, from either package."""
    if isinstance(x, torch.Tensor):
        return (str(x.dtype).split(".")[1],
                x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    a = np.asarray(x)
    return str(a.dtype), a.tobytes()


def _same_tree_bits(a, b):
    fa, fb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert tuple(x.shape) == tuple(y.shape)
        assert _bits(x) == _bits(y)


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# the tree format
# ---------------------------------------------------------------------------
def test_roundtrip_exact(tmp_path):
    tree = _torch_tree()
    TC.save_pytree(str(tmp_path), 5, tree, extra={"loss": 1.25})
    tpl = jax.tree.map(lambda t: T.TensorSpec(t.shape, t.dtype), tree,
                       is_leaf=lambda x: isinstance(x, torch.Tensor))
    got, step, extra = TC.restore_pytree(str(tmp_path), template=tpl, device="cpu")
    assert step == 5 and extra["loss"] == 1.25
    assert got["opt"]["count"].shape == () and got["opt"]["count"].dtype == torch.int32
    assert got["params"]["b"].dtype == torch.bfloat16
    _same_tree_bits(got, tree)
    # a template of tensors casts to their dtypes, in torch
    got32, _, _ = TC.restore_pytree(str(tmp_path), template={"params": {
        "b": torch.zeros(4)}}, device="cpu")
    assert torch.equal(got32["params"]["b"], tree["params"]["b"].float())


def test_roundtrip_lists_and_empty_leaves(tmp_path):
    tree = {"l": [torch.zeros(0), torch.tensor(True), (torch.arange(3),)],
            "h": torch.full((2, 2), 1.5, dtype=torch.float16)}
    TC.save_pytree(str(tmp_path), 0, tree)
    got, _, extra = TC.restore_pytree(str(tmp_path), template=tree, device="cpu")
    assert extra == {} and sorted(_manifest(str(tmp_path), 0)["leaves"]) == [
        "h", "l/0", "l/1", "l/2/0"]
    assert isinstance(got["l"][2], tuple)
    _same_tree_bits(got, tree)


def test_latest_step_ignores_tmp(tmp_path):
    TC.save_pytree(str(tmp_path), 1, {"x": torch.zeros(2)})
    TC.save_pytree(str(tmp_path), 3, {"x": torch.zeros(2)})
    os.makedirs(tmp_path / "step_00000009.tmp")      # a write cut short
    assert TC.latest_step(str(tmp_path)) == 3
    assert TC.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        TC.restore_pytree(str(tmp_path / "none"), template={}, device="cpu")


def test_manager_retention_and_async(tmp_path):
    mgr = TC.CheckpointManager(TC.CheckpointConfig(str(tmp_path), keep=2,
                                                   save_every=10))
    x = torch.zeros(3)
    for s in (10, 20, 30):
        x.fill_(float(s))
        mgr.save(s, {"x": x}, blocking=False)
        x.fill_(-1.0)          # the save copied the tree before returning
    mgr.wait()
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000020", "step_00000030"]
    got, step, _ = mgr.restore({"x": T.TensorSpec((3,), torch.float32)}, device="cpu")
    assert step == 30 and torch.equal(got["x"], torch.full((3,), 30.0))
    assert mgr.latest_step() == 30
    assert mgr.should_save(40) and not mgr.should_save(41) and not mgr.should_save(0)


def test_manager_surfaces_a_failed_write(tmp_path):
    mgr = TC.CheckpointManager(TC.CheckpointConfig(str(tmp_path)))
    (tmp_path / "step_00000001.tmp").write_text("")   # in the write's way
    mgr.save(1, {"x": torch.zeros(2)}, blocking=False)
    with pytest.raises(FileExistsError):
        mgr.wait()
    mgr.wait()                 # raised once
    assert mgr.latest_step() is None


def test_restore_missing_leaf_raises(tmp_path):
    TC.save_pytree(str(tmp_path), 1, {"x": torch.zeros(2)})
    with pytest.raises(KeyError):
        TC.restore_pytree(str(tmp_path), template={"y": T.TensorSpec((2,), torch.float32)},
                          device="cpu")


def test_restore_defaults_to_the_card(tmp_path, monkeypatch):
    TC.save_pytree(str(tmp_path), 1, {"x": torch.zeros(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TC.restore_pytree(str(tmp_path), template={"x": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trs.run(2, 8, 2, str(tmp_path / "ck"))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_packages(tmp_path, writer):
    """A tree saved by one package restores in the other bit for bit
    (bfloat16 and the 0-d int32 leaf included); the manifests of the two
    packages' saves are equal as parsed JSON, and so are their files' keys."""
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    JC.save_pytree(jdir, 4, _jax_tree(), extra={"wave": 3})
    TC.save_pytree(tdir, 4, _torch_tree(), extra={"wave": 3})
    assert _manifest(jdir, 4) == _manifest(tdir, 4)
    keys = [sorted(np.load(os.path.join(d, "step_00000004", "proc_0.npz")).files)
            for d in (jdir, tdir)]
    assert keys[0] == keys[1] and "opt/count|:" in keys[0]
    if writer == "reference":
        got, step, extra = TC.restore_pytree(jdir, template=_torch_tree(), device="cpu")
        _same_tree_bits(got, _torch_tree())
    else:
        got, step, extra = JC.restore_pytree(
            tdir, template=jax.eval_shape(lambda: _jax_tree()))
        _same_tree_bits(got, _jax_tree())
    assert step == 4 and extra == {"wave": 3}


# ---------------------------------------------------------------------------
# resumable TaskGraph runs
# ---------------------------------------------------------------------------
def _graph_table(pkg, kernel="matmul"):
    t = pkg.KernelTable()
    if kernel == "matmul":
        t.register("ck_combine", lambda x: {"out": x @ x * 1e-2 + 1.0})
    else:            # elementwise: exactly rounded, so both packages agree bit for bit
        t.register("ck_combine", lambda x: {"out": x * 0.5 + 1.0})
    return t


def _graph_tasks(pkg, length=5, B=8):
    init = np.arange(B * B, dtype=np.float32).reshape(B, B) * np.float32(1e-2)
    if pkg is T:
        init, sds = torch.from_numpy(init), T.TensorSpec((B, B), torch.float32)
    else:
        init, sds = jnp.asarray(init), jax.ShapeDtypeStruct((B, B), jnp.float32)
    tasks = [pkg.DagTask("p0", "ck_combine", (),
                         lambda dv: pkg.MapSpec(to={"x": init}, from_={"out": sds}))]
    for w in range(1, length):
        tasks.append(pkg.DagTask(
            f"p{w}", "ck_combine", (f"p{w-1}",),
            (lambda w=w: lambda dv: pkg.MapSpec(to={"x": dv[f"p{w-1}"]},
                                                from_={"out": sds}))()))
    return tasks


def _rt(pkg, table, n=2):
    if pkg is T:
        return T.ClusterRuntime(T.RuntimeConfig(n_virtual=n), table=table, device="cpu")
    return J.ClusterRuntime(J.RuntimeConfig(n_virtual=n), table=table)


def _halt(pkg, ckdir, *, peer=False, halt_after=2, kernel="matmul", tag="ckg"):
    rt = _rt(pkg, _graph_table(pkg, kernel))
    try:
        with pytest.raises(pkg.GraphInterrupted):
            rt.wavefront_offload(_graph_tasks(pkg), nowait=True, peer=peer, tag=tag,
                                 checkpoint=pkg.GraphCheckpoint(
                                     ckdir, every_waves=1, halt_after=halt_after))
        # the halt released every pinned peer entry
        assert all(len(p) == 0 for p in rt.pool.present)
    finally:
        rt.shutdown()


@pytest.mark.parametrize("peer", [False, True])
def test_graph_checkpoint_halt_resume_bit_identical(tmp_path, peer):
    """Kill at wave k (``halt_after``), resume on a fresh pool: the results
    are the uninterrupted run's bit for bit, and the prefix is not run."""
    ckdir = str(tmp_path / "ck")
    _halt(T, ckdir, peer=peer)
    vals, extra = T.load_graph_checkpoint(ckdir)
    assert extra["completed"] == ["p0", "p1"] and extra["wave"] == 1
    assert sorted(vals) == ["p0", "p1"] and vals["p0"].device.type == "cpu"
    rt2 = _rt(T, _graph_table(T))
    try:
        res = rt2.wavefront_offload(_graph_tasks(T), nowait=True, peer=peer,
                                    tag="ckg", resume_from=ckdir)
        assert sum(1 for tr in rt2.pool.stream_traces for c in tr if c.op == "EXEC") == 3
    finally:
        rt2.shutdown()
    rt3 = _rt(T, _graph_table(T))
    try:
        ref = rt3.wavefront_offload(_graph_tasks(T), nowait=True, peer=peer, tag="ckg")
    finally:
        rt3.shutdown()
    for k in ref:
        assert torch.equal(res[k], ref[k]), k


def test_graph_checkpoint_retention_and_extra(tmp_path):
    """``keep=N`` prunes old steps; the manifest carries the resume's
    metadata; the checkpoint object counts the saves and their bytes."""
    ckdir = str(tmp_path / "ck")
    ck = T.GraphCheckpoint(ckdir, every_waves=1, keep=2)
    rt = _rt(T, _graph_table(T))
    try:
        rt.wavefront_offload(_graph_tasks(T), nowait=True, tag="ckg", checkpoint=ck)
    finally:
        rt.shutdown()
    steps = sorted(d for d in os.listdir(ckdir) if d.startswith("step_"))
    assert steps == ["step_00000004", "step_00000005"]    # 5 waves saved, 2 kept
    vals, extra = T.load_graph_checkpoint(ckdir)
    assert extra["graph_tag"] == "ckg" and extra["out_name"] == "out"
    assert sorted(vals) == sorted(extra["completed"]) == [f"p{i}" for i in range(5)]
    assert ck.saves == 5 and ck.bytes_written == (1 + 2 + 3 + 4 + 5) * 8 * 8 * 4
    assert ck.save_s > 0
    # every_waves=2 saves after waves 2 and 4, and at the final wave
    ck2 = T.GraphCheckpoint(str(tmp_path / "ck2"), every_waves=2, keep=None)
    rt = _rt(T, _graph_table(T))
    try:
        rt.wavefront_offload(_graph_tasks(T), nowait=True, tag="ckg", checkpoint=ck2)
    finally:
        rt.shutdown()
    assert sorted(os.listdir(ck2.directory)) == [
        "step_00000002", "step_00000004", "step_00000005"]


def test_graph_checkpoint_resume_rejects_unknown_task(tmp_path):
    """A checkpoint naming a task the graph lacks is another graph's: the
    resume fails loudly."""
    ckdir = str(tmp_path / "ck")
    _halt(T, ckdir, halt_after=1, tag="other")
    t = _graph_table(T)
    t.register("src2", lambda s: {"out": s * torch.ones((4, 4))})
    rt2 = _rt(T, t)
    other = [T.DagTask("q0", "src2", (), lambda dv: T.MapSpec(
        to={"s": torch.tensor(1.0)}, from_={"out": T.TensorSpec((4, 4), torch.float32)}))]
    try:
        with pytest.raises(ValueError, match="not in this graph"):
            rt2.wavefront_offload(other, nowait=True, resume_from=ckdir)
    finally:
        rt2.shutdown()
    with pytest.raises(FileNotFoundError):
        T.load_graph_checkpoint(str(tmp_path / "none"))


def test_graph_checkpoint_fresh_process_resume(tmp_path):
    """Checkpoint in this process, resume in a new interpreter that imports
    only ``repro_torch``: the uninterrupted run's bits."""
    ckdir = str(tmp_path / "ck")
    _halt(T, ckdir)
    rt2 = _rt(T, _graph_table(T))
    try:
        ref = rt2.wavefront_offload(_graph_tasks(T), nowait=True, tag="ckg")
    finally:
        rt2.shutdown()
    child = f"""
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None
import torch
import repro_torch.core as T
t = T.KernelTable(); t.register("ck_combine", lambda x: {{"out": x @ x * 1e-2 + 1.0}})
init = torch.arange(64, dtype=torch.float32).reshape(8, 8) * 1e-2
sds = T.TensorSpec((8, 8), torch.float32)
tasks = [T.DagTask("p0", "ck_combine", (),
                   lambda dv: T.MapSpec(to={{"x": init}}, from_={{"out": sds}}))]
for w in range(1, 5):
    tasks.append(T.DagTask(f"p{{w}}", "ck_combine", (f"p{{w-1}}",),
        (lambda w=w: lambda dv: T.MapSpec(to={{"x": dv[f"p{{w-1}}"]}},
                                          from_={{"out": sds}}))()))
rt = T.ClusterRuntime(T.RuntimeConfig(n_virtual=2), table=t, device="cpu")
res = rt.wavefront_offload(tasks, nowait=True, tag="ckg", resume_from={ckdir!r})
print(res["p4"].numpy().tobytes().hex())
rt.shutdown()
"""
    env = {**os.environ, **_ONE_THREAD,
           "PYTHONPATH": os.path.abspath(os.path.join(ROOT, "src"))}
    out = subprocess.run([sys.executable, "-c", child], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == ref["p4"].numpy().tobytes().hex()


def _serial_resume(pkg, ckdir, peer):
    """A serial (``nowait=False``) resume from ``ckdir``: the values, the
    command trace and the byte counters."""
    rt = _rt(pkg, _graph_table(pkg, "elementwise"))
    try:
        res = rt.wavefront_offload(_graph_tasks(pkg), nowait=False, peer=peer,
                                   tag="ckg", resume_from=ckdir)
        s = rt.cost.summary()
        return ({k: np.asarray(v) for k, v in res.items()},
                [(c.op, c.device, c.handle, c.nbytes, c.kernel_index, c.tag)
                 for c in rt.pool.trace],
                (s["bytes_to"], s["bytes_from"], s["bytes_peer"]))
    finally:
        rt.shutdown()


@pytest.mark.parametrize("peer", [False, True])
def test_reference_frontier_resumes_in_the_port(tmp_path, peer):
    """The reference halts at wave 2; the port resumes from its directory to
    the reference's uninterrupted bits (an elementwise kernel, exactly
    rounded in both), seeding the reference's values bit for bit.  A serial
    resume issues the reference's own resume's commands and moves its
    bytes."""
    ckdir = str(tmp_path / "ck")
    _halt(J, ckdir, peer=peer, kernel="elementwise")
    jvals, _ = J.load_graph_checkpoint(ckdir)
    tvals, _ = T.load_graph_checkpoint(ckdir)
    _same_tree_bits(tvals, jvals)
    rt = _rt(J, _graph_table(J, "elementwise"))
    try:
        jref = rt.wavefront_offload(_graph_tasks(J), nowait=True, peer=peer, tag="ckg")
    finally:
        rt.shutdown()
    jres, jtrace, jbytes = _serial_resume(J, ckdir, peer)
    tres, ttrace, tbytes = _serial_resume(T, ckdir, peer)
    for k in jref:
        assert np.array_equal(tres[k], np.asarray(jref[k])), k
        assert np.array_equal(tres[k], jres[k]), k
    assert ttrace == jtrace
    assert tbytes == jbytes
    assert sum(1 for c in ttrace if c[0] == "EXEC") == 3


def test_port_frontier_resumes_in_the_reference(tmp_path):
    """The other way round: the port halts, the reference resumes."""
    ckdir = str(tmp_path / "ck")
    _halt(T, ckdir, kernel="elementwise")
    jres, jtrace, _ = _serial_resume(J, ckdir, False)
    tres, ttrace, _ = _serial_resume(T, ckdir, False)
    for k in tres:
        assert np.array_equal(tres[k], jres[k]), k
    assert ttrace == jtrace


# ---------------------------------------------------------------------------
# the kill-and-resume drill
# ---------------------------------------------------------------------------
def test_resume_smoke_matches_reference(tmp_path, monkeypatch):
    """``resume_smoke.run(4, 32, 4)`` on both packages: the port's resume in
    a fresh interpreter equals its uninterrupted run bit for bit with 9
    EXECs, and every field of the reference's row is the reference's."""
    import resume_smoke as jrs
    for k, v in _ONE_THREAD.items():
        monkeypatch.setenv(k, v)
    jrow = jrs.run(4, 32, 4, str(tmp_path / "j" / "ck"))
    row = trs.run(4, 32, 4, str(tmp_path / "t" / "ck"), device="cpu")
    assert {k: row[k] for k in jrow} == jrow
    assert row["identical"] and row["execs_resumed"] == 9
    assert row["tasks"] - row["tasks_completed_at_kill"] == 9
    assert row["saves"] == row["waves_before_kill"] == 5
    assert row["snapshot_bytes"] == row["tasks_completed_at_kill"] * 32 * 32 * 4
    assert row["child_bmod_path_launches"] == {"cp_async": 0, "elementwise": 0}
    assert row["child_bytes_to"] > 0 and row["child_bytes_from"] == row["tasks"] * 32 * 32 * 4
    # held to given final blocks instead of an uninterrupted run
    mat = trs.bl._matrix(4, 32)
    rt = T.ClusterRuntime(T.RuntimeConfig(n_virtual=1), table=trs.bl._make_table(4),
                          device="cpu")
    try:
        ser = trs.bl.serial(rt, mat)
    finally:
        rt.shutdown()
    row2 = trs.run(4, 32, 4, str(tmp_path / "t2" / "ck"), device="cpu", reference=ser)
    assert row2["identical"] and row2["uninterrupted_wall_s"] is None
    assert row2["execs_resumed"] == 9
