"""The trainer on the port, on the CPU: ``Model.init_abstract``, checkpoint
restore repeating a run's trajectory (float32 and int8 optimizer state), a
port checkpoint restored and served by the reference, the entry point
``repro_torch.launch.train`` (resume, and SIGTERM: checkpoint and exit 0),
the runtime as the data-parallel trainer in both fabrics (learning, and the
reference's byte counters), and the kernel routes' refusal of gradients.

Every comparison of a run with its resumed or restored twin is bit for bit.
"""
import functools
import json
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointConfig as JCheckpointConfig
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs.registry import get_smoke_config as j_smoke
from repro.core import ClusterRuntime as JClusterRuntime
from repro.core import KernelTable as JKernelTable
from repro.core import RuntimeConfig as JRuntimeConfig
from repro.models.model import Model as JModel
from repro.optim import AdamW as JAdamW
from repro.optim import AdamWConfig as JAdamWConfig
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager, restore_pytree
from repro_torch.configs import get_smoke_config
from repro_torch.core import ClusterRuntime, KernelTable, RuntimeConfig, _tree
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels.flash_attention.ops import gqa_flash_attention
from repro_torch.kernels.flash_decode.ops import gqa_flash_decode
from repro_torch.kernels.grouped_matmul.ops import expert_ffn_matmul
from repro_torch.kernels.ssd_scan.ops import ssd_chunked_scan
from repro_torch.launch import train as launch_train
from repro_torch.models import Model
from repro_torch.optim import AdamW, AdamWConfig, cosine_warmup
from repro_torch.serve import Request, ServeConfig, ServeEngine
from repro_torch.train import lm_grads_kernel, make_train_step

torch.set_num_threads(1)      # six test workers share the CPU

ROOT = Path(__file__).resolve().parents[1]


def _batch(cfg, seed: int, B: int = 2, S: int = 16):
    """A torch batch from numpy draws (tokens, labels, frontend stubs)."""
    rng = np.random.default_rng(seed)
    nb = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
          "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        nb["embeds"] = rng.standard_normal((B, cfg.frontend_seq, cfg.d_model)
                                           ).astype(np.float32)
    elif cfg.is_encdec:
        nb["enc_embeds"] = rng.standard_normal((B, S // 2, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in nb.items()}


def _synthetic(cfg, seq=32, batch=8, **kw):
    return SyntheticLM(DataConfig(vocab=cfg.vocab, seq=seq, global_batch=batch, **kw))


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_init_abstract_and_n_params():
    """The meta tree has init's structure, shapes and dtypes, and no
    storage; n_params is the config's count."""
    model = Model(get_smoke_config("zamba2-2.7b"))
    real = model.init(torch.Generator().manual_seed(0), device="cpu")
    meta = model.init_abstract()
    rf, rdef = _tree.flatten(real)
    mf, mdef = _tree.flatten(meta)
    assert rdef == mdef and all(m.is_meta for m in mf)
    assert [(m.shape, m.dtype) for m in mf] == [(r.shape, r.dtype) for r in rf]
    total, active = model.n_params()
    assert total == sum(r.numel() for r in rf) and active <= total


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_crash_and_restore_repeats_the_trajectory(tmp_path, state_dtype):
    """Ten steps uninterrupted against five, a checkpoint, a crash (all
    state dropped) and five more from the restore through init_abstract's
    template: the same losses and parameters, bit for bit."""
    cfg = get_smoke_config("mamba2-130m")
    model = Model(cfg)
    opt = AdamW(AdamWConfig(lr=cosine_warmup(3e-3, 2, 10), state_dtype=state_dtype))
    step = make_train_step(model, opt)
    data = _synthetic(cfg, seq=16, batch=4)

    def run(params, state, steps):
        losses = []
        for i in steps:
            params, state, m = step(params, state, _torch_batch(data.batch(i)))
            losses.append(float(m["loss"]))
        return params, state, losses

    p0 = model.init(torch.Generator().manual_seed(0), device="cpu")
    full_p, _, full = run(p0, opt.init(p0), range(10))
    p, s, first = run(p0, opt.init(p0), range(5))
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), keep=1, save_every=5))
    mgr.save(5, {"params": p, "opt": s}, blocking=False)
    mgr.wait()
    del p, s
    abstract = model.init_abstract()
    state, at, _ = mgr.restore({"params": abstract, "opt": opt.init(abstract)},
                               device="cpu")
    assert at == 5
    p, s, rest = run(state["params"], state["opt"], range(5, 10))
    assert first + rest == full
    assert all(torch.equal(a.view(-1).view(torch.uint8), b.view(-1).view(torch.uint8))
               for a, b in zip(_tree.leaves(p), _tree.leaves(full_p)))


def test_port_checkpoint_restores_in_reference_and_serves(tmp_path):
    """Train internvl2-2b's smoke config on the port, checkpoint it, restore
    it in the reference: the same bits, and the reference serves the same
    greedy tokens as the port does with its live parameters."""
    cfg32 = dict(param_dtype="float32", compute_dtype="float32", remat="none")
    jm = JModel(j_smoke("internvl2-2b").replace(**cfg32))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_smoke_config("internvl2-2b").replace(**cfg32))
    tp = tm.load_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    cfg = tm.cfg
    opt = AdamW(AdamWConfig(lr=1e-3))
    step = make_train_step(tm, opt)
    data = _synthetic(cfg, seq=24, batch=4, frontend_seq=4, d_model=cfg.d_model)
    params, state = tp, opt.init(tp)
    for i in range(4):
        params, state, m = step(params, state, _torch_batch(data.batch(i)))
    assert np.isfinite(float(m["loss"]))
    CheckpointManager(CheckpointConfig(str(tmp_path), keep=1, save_every=1)).save(
        4, {"params": params})
    restored, at, _ = JCheckpointManager(JCheckpointConfig(str(tmp_path))).restore(
        {"params": jax.eval_shape(lambda: jp)})
    assert at == 4
    for (path, want), got in zip(_tree.flatten_with_path(params)[0],
                                 jax.tree.leaves(restored["params"])):
        np.testing.assert_array_equal(np.asarray(got), want.numpy(), err_msg=str(path))
    prompts = [[1, 2, 3], [4, 5]]
    ref = JServeEngine(jm, restored["params"], JServeConfig(batch=2, max_len=48),
                       frontend_seq=4).serve([JRequest(i, p, 5) for i, p in enumerate(prompts)])
    mine = ServeEngine(tm, params, ServeConfig(batch=2, max_len=48), frontend_seq=4,
                       device="cpu").serve([Request(i, p, 5) for i, p in enumerate(prompts)])
    assert {i: r.tokens for i, r in mine.items()} == {i: r.tokens for i, r in ref.items()}
    assert all(len(r.tokens) == 5 for r in mine.values())


# ---------------------------------------------------------------------------
# the trainer entry point
# ---------------------------------------------------------------------------
_ARGS = ["--arch", "mamba2-130m", "--preset", "smoke", "--device", "cpu",
         "--seq", "16", "--global-batch", "4", "--log-every", "1"]


def _metrics(path):
    with open(path) as f:
        return {r["step"]: r for r in map(json.loads, f)}


def _final_params(directory, step):
    flat = _tree.leaves(restore_pytree(
        str(directory), step=step, template={"params": Model(
            get_smoke_config("mamba2-130m")).init_abstract()}, device="cpu")[0])
    return [t.view(-1).view(torch.uint8) for t in flat]


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_launch_train_resumes_bit_for_bit(tmp_path, state_dtype):
    """``main`` for 10 steps, checkpointing every 5; then a fresh directory
    holding only step 5, resumed with ``--resume``: steps 6-10 log the same
    losses and end on the same parameters."""
    args = [*_ARGS, "--steps", "10", "--save-every", "5", "--keep", "5",
            "--state-dtype", state_dtype]
    assert launch_train.main([*args, "--ckpt-dir", str(tmp_path / "a"),
                              "--metrics", str(tmp_path / "a.jsonl")]) == 0
    os.makedirs(tmp_path / "b")
    shutil.copytree(tmp_path / "a" / "step_00000005", tmp_path / "b" / "step_00000005")
    assert launch_train.main([*args, "--ckpt-dir", str(tmp_path / "b"), "--resume",
                              "--metrics", str(tmp_path / "b.jsonl")]) == 0
    full, resumed = _metrics(tmp_path / "a.jsonl"), _metrics(tmp_path / "b.jsonl")
    assert sorted(resumed) == list(range(6, 11))
    assert all(resumed[s]["loss"] == full[s]["loss"] for s in resumed)
    assert all(np.isfinite(r["loss"]) for r in full.values())
    a, b = _final_params(tmp_path / "a", 10), _final_params(tmp_path / "b", 10)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_launch_train_checkpoints_on_sigterm(tmp_path):
    """A child trainer sent SIGTERM after step 3 finishes its step,
    checkpoints and exits 0; resumed in this process it ends where an
    uninterrupted run does, bit for bit."""
    args = [*_ARGS, "--steps", "30", "--save-every", "100"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    child = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *args,
         "--ckpt-dir", str(tmp_path / "b"), "--metrics", str(tmp_path / "b.jsonl")],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in child.stdout:
            lines.append(line)
            if line.startswith("[train] step") and int(line.split()[2]) >= 3:
                child.send_signal(signal.SIGTERM)
                break
        out = "".join(lines) + child.stdout.read()
        assert child.wait(timeout=120) == 0, out
    finally:
        if child.poll() is None:
            child.kill()
    assert "checkpoint-and-exit" in out
    stopped = max(_metrics(tmp_path / "b.jsonl"))
    assert 3 <= stopped < 30
    assert launch_train.main([*args, "--ckpt-dir", str(tmp_path / "b"), "--resume",
                              "--metrics", str(tmp_path / "b.jsonl")]) == 0
    assert launch_train.main([*args, "--ckpt-dir", str(tmp_path / "a"),
                              "--metrics", str(tmp_path / "a.jsonl")]) == 0
    full, resumed = _metrics(tmp_path / "a.jsonl"), _metrics(tmp_path / "b.jsonl")
    assert sorted(resumed) == list(range(1, 31))
    assert all(resumed[s]["loss"] == full[s]["loss"] for s in full)
    a, b = _final_params(tmp_path / "a", 30), _final_params(tmp_path / "b", 30)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# the runtime as the data-parallel trainer
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _reference_dp_init():
    return JModel(j_smoke("mamba2-130m").replace(remat="none")).init(
        jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _reference_dp_bytes(mode: str):
    """The reference's DP trainer (``tests/test_system.py``) in ``mode``,
    its kernel jitted once: the byte counters after six exchanges."""
    jm = JModel(j_smoke("mamba2-130m").replace(remat="none"))
    grad = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))
    table = JKernelTable()
    table.register("lm_grads", lambda params, batch: {"grads": grad(params, batch)})
    rt = JClusterRuntime(JRuntimeConfig(n_virtual=2, comm_mode=mode), table=table)
    data = SyntheticLM(DataConfig(vocab=jm.cfg.vocab, seq=16, global_batch=4))
    params = _reference_dp_init()
    opt = JAdamW(JAdamWConfig(lr=3e-3))
    state = opt.init(params)
    try:
        for i in range(6):
            b = jax.tree.map(jnp.asarray, data.batch(i))
            halves = [jax.tree.map(lambda x: x[:2], b), jax.tree.map(lambda x: x[2:], b)]
            mean = rt.data_parallel_grads("lm_grads", params, halves)
            params, state, _ = opt.update(mean, state, params)
        s = rt.cost.summary()
    finally:
        rt.shutdown()
    return {k: s[k] for k in ("bytes_to", "bytes_from", "bytes_peer")}


@pytest.mark.parametrize("mode", ["host-mediated", "direct"])
def test_runtime_trains_the_model_data_parallel(mode):
    """mamba2-130m's smoke model through ``data_parallel_grads`` on D=2
    (``lm_grads_kernel``: ``torch.autograd.grad`` on each device's worker
    thread) plus a host AdamW step, from the reference's initial parameters:
    it learns, and the fabric moves the reference's bytes."""
    cfg = get_smoke_config("mamba2-130m")
    model = Model(cfg)
    table = KernelTable()
    table.register("lm_grads", lm_grads_kernel(model))
    rt = ClusterRuntime(RuntimeConfig(n_virtual=2, comm_mode=mode), table=table,
                        device="cpu")
    data = _synthetic(cfg, seq=16, batch=4)
    params = model.load_numpy(jax.tree.map(np.asarray, _reference_dp_init()), device="cpu")
    opt = AdamW(AdamWConfig(lr=3e-3))
    state = opt.init(params)
    losses = []
    try:
        for i in range(6):
            b = _torch_batch(data.batch(i))
            halves = [{k: v[:2] for k, v in b.items()}, {k: v[2:] for k, v in b.items()}]
            mean = rt.data_parallel_grads("lm_grads", params, halves)
            params, state, _ = opt.update(mean, state, params)
            with torch.no_grad():
                losses.append(float(model.loss(params, b)[0]))
        s = rt.cost.summary()
    finally:
        rt.shutdown()
    assert losses[-1] < losses[0], losses
    assert {k: s[k] for k in ("bytes_to", "bytes_from", "bytes_peer")} == \
        _reference_dp_bytes(mode)


# ---------------------------------------------------------------------------
# the kernel routes refuse gradients
# ---------------------------------------------------------------------------
def _kernel_calls():
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g).requires_grad_(True)

    return {
        "flash_decode": lambda: gqa_flash_decode(r(2, 1, 4, 16), r(2, 8, 2, 16),
                                                 r(2, 8, 2, 16), 5),
        "flash_attention": lambda: gqa_flash_attention(r(2, 8, 4, 16), r(2, 8, 2, 16),
                                                       r(2, 8, 2, 16)),
        "ssd_scan": lambda: ssd_chunked_scan(r(1, 8, 2, 4), torch.rand(1, 8, 2),
                                             -torch.rand(2), r(1, 8, 1, 4), r(1, 8, 1, 4),
                                             chunk=4),
        "grouped_matmul": lambda: expert_ffn_matmul(r(2, 3, 8), r(2, 8, 5)),
    }


@pytest.mark.parametrize("kernel", ["flash_decode", "flash_attention", "ssd_scan",
                                    "grouped_matmul"])
def test_kernel_wrappers_refuse_gradients(kernel):
    """Each K3-K6 wrapper raises under grad mode when an input requires
    grad, naming the kernel; under ``no_grad`` it runs."""
    call = _kernel_calls()[kernel]
    with pytest.raises(RuntimeError, match=f"{kernel}.*use_kernels=False"):
        call()
    with torch.no_grad():
        call()


@pytest.mark.parametrize("arch", ["minitron-4b", "moonshot-v1-16b-a3b", "mamba2-130m"])
def test_a_loss_through_the_kernel_route_raises(arch):
    """A train step of a ``use_kernels=True`` model raises instead of
    dropping the kernel inputs' gradients; the plain route trains."""
    cfg = get_smoke_config(arch)
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    tb = _batch(cfg, seed=4)
    opt = AdamW(AdamWConfig())
    with pytest.raises(RuntimeError, match="use_kernels=False"):
        make_train_step(Model(cfg.replace(use_kernels=True)), opt)(
            params, opt.init(params), tb)
    _, _, m = make_train_step(Model(cfg), opt)(params, opt.init(params), tb)
    assert np.isfinite(float(m["loss"]))
