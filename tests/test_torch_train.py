"""Training on the port against the reference on the CPU: AdamW and its
schedule, the int8 moments as tree nodes, ``cross_entropy_loss``,
``Model.loss`` and its gradients for every family, ``make_train_step`` with
microbatches, and loss descent.  The trainer around them (checkpoints, the
entry point, the runtime as the data-parallel trainer, the kernel routes'
refusal of gradients) is held in ``test_torch_trainer.py``.

Inputs are numpy arrays from seeds; the reference's parameters cross to the
port with ``Model.load_numpy``.  Tolerances: AdamW params 1e-6 relative,
losses 2e-5 relative, gradients 1e-4 of each leaf's norm, one train step's
parameters 1e-4 absolute; the microbatch bound and the descent bound are
the reference's own (``tests/test_train.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import get_smoke_config as j_smoke
from repro.models import layers as jl
from repro.models.model import Model as JModel
from repro.optim import AdamW as JAdamW
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim.schedule import cosine_warmup as j_cosine_warmup
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.core import _tree
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import Model
from repro_torch.models import layers as tl
from repro_torch.models.model import build_model
from repro_torch.optim import AdamW, AdamWConfig, cosine_warmup
from repro_torch.optim.adamw import _decode
from repro_torch.train import make_train_step

torch.set_num_threads(1)      # six test workers share the CPU

GRAD_ARCHS = ("minitron-4b", "moonshot-v1-16b-a3b", "mamba2-130m", "zamba2-2.7b",
              "internvl2-2b", "seamless-m4t-large-v2")


def _fp32(cfg):
    return cfg.replace(param_dtype="float32", compute_dtype="float32", remat="none")


@functools.lru_cache(maxsize=None)
def _pair(arch: str):
    """(reference model, its fp32 params, port model, port params: the
    reference's)."""
    jm = JModel(_fp32(j_smoke(arch)))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(_fp32(get_smoke_config(arch)))
    tp = tm.load_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _batch(cfg, seed: int, B: int = 2, S: int = 16):
    """The same batch for both packages: (jnp dict, torch dict)."""
    rng = np.random.default_rng(seed)
    nb = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
          "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        nb["embeds"] = rng.standard_normal((B, cfg.frontend_seq, cfg.d_model)
                                           ).astype(np.float32)
    elif cfg.is_encdec:
        nb["enc_embeds"] = rng.standard_normal((B, S // 2, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads(arch: str):
    """The reference's (loss, metrics, grads) at the smoke config in fp32,
    as numpy: one compiled ``value_and_grad`` per config."""
    jm, jp, _, _ = _pair(arch)
    jb, _ = _batch(jm.cfg, seed=1)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, jb)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


# ---------------------------------------------------------------------------
# AdamW and its schedule
# ---------------------------------------------------------------------------
def _adam_inputs():
    rng = np.random.default_rng(0)
    p = {"w": rng.standard_normal((16, 40)).astype(np.float32),
         "b": rng.standard_normal((40,)).astype(np.float32)}
    gs = [{k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
           for k, v in p.items()} for _ in range(3)]
    return p, gs


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_matches_reference(state_dtype):
    """Three steps from the same fp32 params and gradients: params within
    1e-6 relative, the pre-clip grad_norm, and the moments (fp32: within
    1e-5 of their largest value; bf16: one rounding step; int8: decoded,
    within one quantization step of the reference's)."""
    p, gs = _adam_inputs()
    cfg = dict(lr=1e-2, weight_decay=0.1, clip_norm=1.0, state_dtype=state_dtype)
    jopt, topt = JAdamW(JAdamWConfig(**cfg)), AdamW(AdamWConfig(**cfg))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for g in gs:
        jp, js, jm = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts, tm = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-6)
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6)
    assert int(ts["count"]) == int(js["count"]) == 3
    for name in ("mu", "nu"):
        for k in p:
            mine = _decode(ts[name][k], state_dtype).numpy()
            if state_dtype == "int8":
                ref = js[name][k]
                theirs = np.asarray(ref.q, np.float32) * np.asarray(ref.scale)[:, None]
                theirs = theirs.reshape(-1)[:mine.size].reshape(mine.shape)
                step = np.repeat(np.asarray(ref.scale), 256)[:mine.size].reshape(mine.shape)
                assert np.all(np.abs(mine - theirs) <= step * (1 + 1e-6))
            elif state_dtype == "bfloat16":     # one bf16 rounding step
                theirs = np.asarray(js[name][k], np.float32)
                assert np.all(np.abs(mine - theirs) <= np.abs(theirs) * 2.0 ** -7)
            else:
                theirs = np.asarray(js[name][k], np.float32)
                np.testing.assert_allclose(mine, theirs, rtol=1e-5,
                                           atol=1e-5 * np.abs(theirs).max())


def test_adamw_matches_numpy_oracle():
    """The reference's numpy oracle of one step (no clipping)."""
    cfg = AdamWConfig(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.1, clip_norm=0.0)
    opt = AdamW(cfg)
    pw = np.asarray([[1.0, -2.0], [3.0, 0.5]], np.float32)
    gw = np.asarray([[0.1, -0.2], [0.3, 0.0]], np.float32)
    p = {"w": torch.from_numpy(pw)}
    new_p, _, _ = opt.update({"w": torch.from_numpy(gw)}, opt.init(p), p)
    m, v = (1 - cfg.b1) * gw, (1 - cfg.b2) * gw * gw
    want = pw - cfg.lr * ((m / (1 - cfg.b1)) / (np.sqrt(v / (1 - cfg.b2)) + cfg.eps)
                          + cfg.weight_decay * pw)
    np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-6)


def test_adamw_reports_the_pre_clip_norm():
    opt = AdamW(AdamWConfig(lr=1e-2, clip_norm=1.0))
    p = {"w": torch.zeros(4)}
    _, _, metrics = opt.update({"w": torch.full((4,), 100.0)}, opt.init(p), p)
    np.testing.assert_allclose(float(metrics["grad_norm"]), 200.0, rtol=1e-6)


def test_cosine_warmup_matches_reference():
    mine = cosine_warmup(1.0, warmup_steps=10, total_steps=110, min_ratio=0.1)
    ref = j_cosine_warmup(1.0, warmup_steps=10, total_steps=110, min_ratio=0.1)
    for step in (0, 5, 10, 60, 110):
        np.testing.assert_allclose(float(mine(step)), float(ref(step)), rtol=1e-5)
    assert float(mine(0)) == 0.0


def test_int8_moments_are_tree_nodes():
    """An int8 moment flattens to its payload and scales (paths ``q`` and
    ``scale``) and comes back with its shape, so a checkpoint can hold it."""
    opt = AdamW(AdamWConfig(state_dtype="int8"))
    state = opt.init({"w": torch.ones(3, 5)})
    flat, tdef = _tree.flatten_with_path(state)
    assert [p for p, _ in flat] == [("count",), ("mu", "w", "q"), ("mu", "w", "scale"),
                                    ("nu", "w", "q"), ("nu", "w", "scale")]
    back = _tree.unflatten(tdef, [leaf for _, leaf in flat])
    assert back["mu"]["w"].shape == (3, 5)
    assert _tree.subtrees_at(_tree.flatten({"w": 0})[1], state["mu"]) == [state["mu"]["w"]]


# ---------------------------------------------------------------------------
# losses and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss_matches_reference(masked):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.4).astype(np.float32) if masked else None
    ref = jl.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                None if mask is None else jnp.asarray(mask))
    mine = tl.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                 None if mask is None else torch.from_numpy(mask))
    assert mine.dtype == torch.float32
    assert _rel(float(mine), float(ref)) <= 2e-5
    if masked:       # an all-zero mask divides by 1, not by 0
        zero = tl.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                     torch.zeros(3, 7))
        assert float(zero) == 0.0


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_model_loss_matches_reference(arch):
    """Every smoke config in fp32: loss, ce and moe_aux within 2e-5."""
    jm, jp, tm, tp = _pair(arch)
    if arch in GRAD_ARCHS:
        loss, metrics, _ = _reference_loss_and_grads(arch)
    else:
        jb, _ = _batch(jm.cfg, seed=1)
        jl_, jmet = jax.jit(jm.loss)(jp, jb)
        loss, metrics = float(jl_), {k: float(v) for k, v in jmet.items()}
    _, tb = _batch(jm.cfg, seed=1)
    with torch.no_grad():
        mine, mmet = tm.loss(tp, tb)
    assert _rel(float(mine), loss) <= 2e-5, (float(mine), loss)
    for k in ("ce", "moe_aux"):
        assert abs(float(mmet[k]) - metrics[k]) <= 2e-5 * max(abs(metrics[k]), 1e-30), k


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_match_reference(arch):
    """Per leaf, ||g_port - g_ref|| <= 1e-4 ||g_ref|| against ``jax.grad``
    of the reference's ``Model.loss``, in fp32."""
    _, ref_grads = _reference_loss_and_grads(arch)[::2]
    jm, _, tm, tp = _pair(arch)
    _, tb = _batch(jm.cfg, seed=1)
    flat, tdef = _tree.flatten(tp)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    loss, _ = tm.loss(_tree.unflatten(tdef, leaves), tb)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    ref_flat, _ = _tree.flatten_with_path(ref_grads)
    assert len(ref_flat) == len(grads)
    for (path, want), got, p in zip(ref_flat, grads, flat):
        got = torch.zeros_like(p) if got is None else got
        err = np.linalg.norm(got.numpy().astype(np.float64) - want)
        assert err <= 1e-4 * np.linalg.norm(want.astype(np.float64)), (path, err)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _reference_step(microbatches: int):
    jm, jp, _, _ = _pair("minitron-4b")
    jb, _ = _batch(jm.cfg, seed=2, B=4)
    opt = JAdamW(JAdamWConfig(lr=1e-3))
    p, _, m = jax.jit(j_make_train_step(jm, opt, microbatches=microbatches))(
        jp, opt.init(jp), jb)
    return jax.tree.map(np.asarray, p), {k: float(v) for k, v in m.items()}


def _port_step(microbatches: int):
    jm, _, tm, tp = _pair("minitron-4b")
    _, tb = _batch(jm.cfg, seed=2, B=4)
    opt = AdamW(AdamWConfig(lr=1e-3))
    return make_train_step(tm, opt, microbatches=microbatches)(tp, opt.init(tp), tb)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    """One step of minitron-4b's smoke config in fp32, batch 4: loss within
    2e-5, the new params within 1e-4, every metric present."""
    ref_p, ref_m = _reference_step(microbatches)
    p, _, m = _port_step(microbatches)
    assert set(m) == {"loss", "ce", "moe_aux", "grad_norm", "lr"}
    for k in ("loss", "ce", "grad_norm"):
        assert _rel(float(m[k]), ref_m[k]) <= 2e-5, k
    for (path, want), got in zip(_tree.flatten_with_path(ref_p)[0], _tree.leaves(p)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4, err_msg=str(path))
    assert not any(t.requires_grad for t in _tree.leaves(p))


def test_microbatch_equivalence():
    """The reference's own bound within the port: loss within 1e-5, params
    within 5e-5 of the one-batch step."""
    p1, _, m1 = _port_step(1)
    p2, _, m2 = _port_step(2)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    assert max(float((a - b).abs().max())
               for a, b in zip(_tree.leaves(p1), _tree.leaves(p2))) < 5e-5


def _synthetic(cfg, seq=32, batch=8, **kw):
    return SyntheticLM(DataConfig(vocab=cfg.vocab, seq=seq, global_batch=batch, **kw))


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_loss_decreases_on_synthetic_data():
    """The reference's descent bound on the port: mamba2-130m's smoke
    config (bf16), 30 steps at lr 3e-3."""
    cfg = get_smoke_config("mamba2-130m")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    opt = AdamW(AdamWConfig(lr=3e-3))
    state = opt.init(params)
    step = make_train_step(model, opt)
    data = _synthetic(cfg)
    losses = []
    for i in range(30):
        params, state, m = step(params, state, _torch_batch(data.batch(i)))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5, losses
