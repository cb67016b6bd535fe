"""The port's LM stack against the reference on the CPU: interop, layers,
attention, and whole-model forward / prefill / decode logits.

The reference's parameters cross to the port through
``params_from_numpy`` (bf16 bit for bit), inputs are numpy arrays from
seeds, and both packages run the same smoke configs.  Tolerances: fp32
logits 1e-4, bf16 4e-2 (``tests/test_kernels.py:21-25``).
"""
import functools
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import (ARCHS as J_ARCHS, SHAPES as J_SHAPES,
                                    get_config as j_get_config,
                                    get_smoke_config as j_smoke,
                                    shape_cells as j_shape_cells)
from repro.models import attention as jatt
from repro.models import layers as jl
from repro.models.config import param_count as j_param_count
from repro.models.model import Model as JModel
from repro_torch.configs import (ARCHS, SHAPES, get_config, get_smoke_config,
                                 shape_cells, smoke_batch)
from repro_torch.interop import from_numpy_tree, params_from_numpy, to_numpy_tree
from repro_torch.models import Model, param_count
from repro_torch.models import attention as tatt
from repro_torch.models import layers as tl

torch.set_num_threads(1)      # six test workers share the CPU

DENSE = ("minitron-4b", "gemma-7b", "qwen2-72b", "gemma3-4b")
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=4e-2, atol=4e-2)}


def _close(port, ref, dtype):
    np.testing.assert_allclose(to_numpy_tree(port), np.asarray(ref, np.float32),
                               **TOL[dtype])


@functools.lru_cache(maxsize=None)
def _pair(arch: str, dtype: str, use_kernels: bool = False):
    """(reference model, its params, port model, port params) for a smoke
    config in ``dtype``; the port's params are the reference's."""
    jcfg = j_smoke(arch).replace(param_dtype=dtype, compute_dtype=dtype)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = get_smoke_config(arch).replace(param_dtype=dtype, compute_dtype=dtype,
                                          use_kernels=use_kernels)
    tm = Model(tcfg)
    tp = tm.load_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _inputs(cfg, seed: int, B: int = 2, S: int = 24):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    extra = ("embeds", cfg.frontend_seq) if cfg.family == "vlm" else \
        ("enc_embeds", 8) if cfg.is_encdec else None
    if extra:
        e = rng.standard_normal((B, extra[1], cfg.d_model)).astype(np.float32)
        jb[extra[0]] = jnp.asarray(e, cfg.compute_dtype)
        tb[extra[0]] = torch.from_numpy(e).to(getattr(torch, cfg.compute_dtype))
    return jb, tb


# ---------------------------------------------------------------------------
# interop and configs
# ---------------------------------------------------------------------------
def test_bf16_round_trips_bit_for_bit():
    rng = np.random.default_rng(0)
    a = np.asarray(jnp.asarray(rng.standard_normal((7, 5)) * 100, jnp.bfloat16))
    t = from_numpy_tree({"w": [a]}, "cpu")["w"][0]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                  a.view(np.uint16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_keeps_keys_shapes_and_dtypes(dtype):
    _, jp, _, tp = _pair("qwen2-72b", dtype)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jflat) == len(tl_leaves(tp))
    for path, leaf in jflat:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape and str(t.dtype) == f"torch.{leaf.dtype}"
        np.testing.assert_array_equal(to_numpy_tree(t), np.asarray(leaf, np.float32))


def tl_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tl_leaves(v)]
    return [tree]


def test_registry_matches_reference():
    assert sorted(ARCHS) == sorted(J_ARCHS)
    assert {k: tuple(vars(v).values()) for k, v in SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in J_SHAPES.items()}
    for arch in ARCHS:
        ours, theirs = asdict(get_config(arch)), asdict(j_get_config(arch))
        assert ours.pop("use_kernels") == theirs.pop("use_pallas")
        assert ours == theirs
        assert shape_cells(arch) == j_shape_cells(arch)
        assert param_count(get_config(arch)) == j_param_count(j_get_config(arch))
    b = smoke_batch(get_smoke_config("internvl2-2b"), torch.Generator().manual_seed(0))
    assert b["embeds"].shape == (2, 8, 64) and b["tokens"].dtype == torch.int32


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_reference(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    jx, tx = jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    js, ts = jnp.asarray(scale, dtype), torch.from_numpy(scale).to(getattr(torch, dtype))
    _close(tl.rms_norm(tx, ts), jl.rms_norm(jx, js), dtype)
    for act in ("swiglu", "geglu", "gelu", "relu2"):
        up = None if act in ("gelu", "relu2") else tx * 0.5
        jup = None if up is None else jx * 0.5
        _close(tl.activate(tx, up, act), jl.activate(jx, jup, act), dtype)
    pos = rng.integers(0, 50, (2, 6)).astype(np.int32)
    for p in (pos[0], pos):                                   # [S] and [B,S]
        _close(tl.apply_rope(tx, torch.from_numpy(p), 1e4),
               jl.apply_rope(jx, jnp.asarray(p), 1e4), dtype)
    w = rng.standard_normal((16, 40)).astype(np.float32) * 0.1
    mp = {"w_in": w, "w_gate": w[::-1].copy(), "w_out": w.T.copy()}
    jmp = {k: jnp.asarray(v, dtype) for k, v in mp.items()}
    tmp = params_from_numpy(jax.tree.map(np.asarray, jmp), "cpu")
    for act in ("swiglu", "relu2"):
        p = tmp if act == "swiglu" else {k: v for k, v in tmp.items() if k != "w_gate"}
        jp_ = jmp if act == "swiglu" else {k: v for k, v in jmp.items() if k != "w_gate"}
        _close(tl.mlp_apply(p, tx, act), jl.mlp_apply(jp_, jx, act), dtype)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    jt = {"table": jnp.asarray(table, dtype)}
    tt = params_from_numpy(jax.tree.map(np.asarray, jt), "cpu")
    _close(tl.embed_apply(tt, torch.from_numpy(pos)), jl.embed_apply(jt, jnp.asarray(pos)),
           dtype)
    _close(tl.unembed_apply(tt, tx[:, :, 0], softcap=5.0),
           jl.unembed_apply(jt, jx[:, :, 0], softcap=5.0), dtype)


def test_embed_scale_rounds_to_the_activation_dtype():
    """sqrt(3072) is 55.43 but 55.5 in bf16, and the reference scales by
    the rounded factor."""
    table = np.ones((3, 3072), np.float32)
    jt = {"table": jnp.asarray(table, jnp.bfloat16)}
    out = tl.embed_apply(params_from_numpy(jax.tree.map(np.asarray, jt), "cpu"),
                         torch.tensor([[1]]))
    assert float(out[0, 0, 0]) == 55.5
    assert float(jl.embed_apply(jt, jnp.asarray([[1]]))[0, 0, 0]) == 55.5


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _attn_cases():
    """Inputs of one minitron smoke layer (fp32) and the reference's
    ``attn_apply`` outputs: prefill unpadded and pad-masked, decode at an
    int and at a [B] position, and a pad-masked decode."""
    jm, jp, _, _ = _pair("minitron-4b", "float32")
    cfg = jm.cfg
    jlp = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    rng = np.random.default_rng(2)
    B, S, Smax = 2, 12, 20
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pad = np.ones((B, S), bool)
    pad[0, :3] = False
    cases = [dict(x=x, positions=np.arange(S, dtype=np.int32)),
             dict(x=x, positions=np.arange(S, dtype=np.int32), k_valid=pad)]
    cache = rng.standard_normal((B, Smax, cfg.n_kv, cfg.head_dim)).astype(np.float32)
    x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    pad = np.ones((B, Smax), bool)
    pad[1, 2:5] = False
    rows = np.array([5, 9], np.int32)
    cases += [dict(x=x1, positions=np.array([7], np.int32), cache=cache, cache_pos=7),
              dict(x=x1, positions=rows[:, None], cache=cache, cache_pos=rows),
              dict(x=x1, positions=rows[:, None], cache=cache, cache_pos=rows,
                   k_valid=pad)]
    out = []
    for c in cases:
        kw = {k: jnp.asarray(v) for k, v in c.items() if k not in ("x", "cache")}
        if "cache" in c:
            kw["cache"] = (jnp.asarray(c["cache"]), jnp.asarray(c["cache"]))
        jo, jcache = jatt.attn_apply(jlp, jnp.asarray(c["x"]), cfg, **kw)
        out.append((c, np.asarray(jo), None if jcache is None else np.asarray(jcache[0])))
    return out


@pytest.mark.parametrize("use_kernels", [False, True])
def test_attn_apply_matches_reference(use_kernels):
    """One attention layer against the reference's; with ``use_kernels``
    the port's gate takes the kernels' plain versions where it admits them
    (unpadded prefill, unpadded decode)."""
    _, _, _, tp = _pair("minitron-4b", "float32")
    cfg = get_smoke_config("minitron-4b").replace(
        param_dtype="float32", compute_dtype="float32", use_kernels=use_kernels)
    tlp = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    for c, jo, jck in _attn_cases():
        kw = {k: (v if isinstance(v, int) else torch.from_numpy(v))
              for k, v in c.items() if k not in ("x", "cache")}
        if "cache" in c:
            kw["cache"] = (torch.from_numpy(c["cache"].copy()),
                           torch.from_numpy(c["cache"].copy()))
        o, tcache = tatt.attn_apply(tlp, torch.from_numpy(c["x"]), cfg, **kw)
        _close(o, jo, "float32")
        if jck is not None:
            _close(tcache[0], jck, "float32")


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_model_logits_match_reference(arch, dtype):
    """Prefill and two decode steps (an int position, then a [B] position
    vector) on the reference's own parameters; forward too, in fp32."""
    jm, jp, tm, tp = _pair(arch, dtype)
    jb, tb = _inputs(jm.cfg, seed=3)
    if dtype == "float32":
        _close(tm.forward(tp, tb)[0], jm.forward(jp, jb)[0], dtype)
    jlog, jc, jpos = jm.prefill(jp, jb, cache_len=32)
    tlog, tc, tpos = tm.prefill(tp, tb, cache_len=32)
    _close(tlog, jlog, dtype)
    _close(tc[0][0], jc[0][0], dtype)
    tok = np.random.default_rng(4).integers(0, jm.cfg.vocab, (2, 1)).astype(np.int32)
    jlog, jc = jm.decode_step(jp, jnp.asarray(tok), jc, jpos)
    tlog, tc = tm.decode_step(tp, torch.from_numpy(tok), tc, tpos)
    _close(tlog, jlog, dtype)
    posv = np.full(2, tpos + 1, np.int32)
    jlog, _ = jm.decode_step(jp, jnp.asarray(tok), jc, jnp.asarray(posv))
    tlog, _ = tm.decode_step(tp, torch.from_numpy(tok), tc, torch.from_numpy(posv))
    _close(tlog, jlog, dtype)


@pytest.mark.parametrize("arch", ["minitron-4b", "gemma3-4b"])
def test_padded_prefill_and_decode_match_reference(arch):
    jm, jp, tm, tp = _pair(arch, "float32")
    jb, tb = _inputs(jm.cfg, seed=5, S=16)
    pw = np.array([0, 5], np.int32)
    jlog, jc, jpos = jm.prefill(jp, jb, cache_len=24, pad_width=jnp.asarray(pw))
    tlog, tc, tpos = tm.prefill(tp, tb, cache_len=24, pad_width=torch.from_numpy(pw))
    _close(tlog, jlog, "float32")
    tok = np.array([[3], [7]], np.int32)
    posv = np.array([16, 16], np.int32)
    jlog, _ = jm.decode_step(jp, jnp.asarray(tok), jc, jnp.asarray(posv),
                             pad_width=jnp.asarray(pw))
    tlog, _ = tm.decode_step(tp, torch.from_numpy(tok), tc, torch.from_numpy(posv),
                             pad_width=torch.from_numpy(pw))
    _close(tlog, jlog, "float32")


@pytest.mark.parametrize("arch", ["internvl2-2b", "seamless-m4t-large-v2"])
def test_frontend_families_match_reference(arch):
    """vlm (a frontend-stub prefix) and encdec (encoder + cross-attention)."""
    jm, jp, tm, tp = _pair(arch, "float32")
    jb, tb = _inputs(jm.cfg, seed=6, S=12)
    _close(tm.forward(tp, tb)[0], jm.forward(jp, jb)[0], "float32")
    jlog, jc, jpos = jm.prefill(jp, jb, cache_len=32)
    tlog, tc, tpos = tm.prefill(tp, tb, cache_len=32)
    _close(tlog, jlog, "float32")
    tok = np.array([[3], [7]], np.int32)
    jlog, _ = jm.decode_step(jp, jnp.asarray(tok), jc, jpos)
    tlog, _ = tm.decode_step(tp, torch.from_numpy(tok), tc, tpos)
    _close(tlog, jlog, "float32")


@pytest.mark.parametrize("arch", ["minitron-4b", "seamless-m4t-large-v2"])
def test_make_cache_matches_reference(arch):
    """Empty self-KV [L,B,S,K,Dh]; for enc-dec, the per-layer projected
    encoder memory."""
    from repro.models.transformer import encode as j_encode
    from repro_torch.models.transformer import encode as t_encode
    jm, jp, tm, tp = _pair(arch, "float32")
    jmem = tmem = None
    if jm.cfg.is_encdec:
        jb, tb = _inputs(jm.cfg, seed=8)
        jmem = j_encode(jp, jm.cfg, jb["enc_embeds"])
        tmem = t_encode(tp, tm.cfg, tb["enc_embeds"])
    jc = jm.make_cache(jp, 2, 16, memory=jmem)
    tc = tm.make_cache(tp, 2, 16, memory=tmem)
    assert [tuple(t.shape) for t in tc[0]] == [a.shape for a in jc[0]]
    assert all(int(t.abs().sum()) == 0 for t in tc[0])
    assert (tc[1] is None) == (jc[1] is None)
    if jc[1] is not None:
        for t, a in zip(tc[1], jc[1]):
            _close(t, a, "float32")


@pytest.mark.parametrize("arch", DENSE)
def test_kernel_route_equals_plain_route_on_cpu(arch):
    """``use_kernels=True`` on CPU tensors takes the kernels' plain versions
    (flash attention in prefill and forward, flash decode in decode)."""
    _, _, tm, tp = _pair(arch, "float32")
    km = Model(tm.cfg.replace(use_kernels=True))
    _, tb = _inputs(tm.cfg, seed=7)
    torch.testing.assert_close(km.forward(tp, tb)[0], tm.forward(tp, tb)[0],
                               rtol=1e-4, atol=1e-4)
    lk, ck, pos = km.prefill(tp, tb, cache_len=32)
    lp, cp, _ = tm.prefill(tp, tb, cache_len=32)
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=1e-4)
    tok = torch.tensor([[3], [7]], dtype=torch.int32)
    for p in (pos, torch.tensor([pos, pos], dtype=torch.int32) + 1):
        lk, ck = km.decode_step(tp, tok, ck, p)
        lp, cp = tm.decode_step(tp, tok, cp, p)
        torch.testing.assert_close(lk, lp, rtol=1e-4, atol=1e-4)


def test_init_makes_the_reference_tree():
    """Random init (from a torch generator) has the reference's keys,
    shapes and dtypes."""
    jm, jp, _, _ = _pair("qwen2-72b", "bfloat16")
    tp = Model(get_smoke_config("qwen2-72b")).init(torch.Generator().manual_seed(0),
                                                   device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jflat) == len(tl_leaves(tp))
    for path, leaf in jflat:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape and str(t.dtype) == f"torch.{leaf.dtype}"
