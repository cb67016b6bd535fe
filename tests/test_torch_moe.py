"""The port's MoE family against the reference on the CPU: the grouped-matmul
kernel K6's plain version (against the Pallas kernel in interpret mode and
the jnp oracle), the router, dispatch and combine, ``moe_apply`` with its
options, and whole-model forward / prefill / decode on both MoE smoke
configs (moonshot-v1-16b-a3b, kimi-k2-1t-a32b).

Inputs are numpy arrays from seeds; parameters are the reference's, carried
across by ``params_from_numpy``.  Tolerances: ``tests/test_kernels.py:21-25``
for modules (fp32 2e-5, bf16 4e-2), the model tests' 1e-4 / 4e-2 for
logits, and ``tests/test_kernels.py:138-140`` for K6.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as j_smoke
from repro.kernels.grouped_matmul.ops import expert_ffn_matmul as j_expert_ffn_matmul
from repro.kernels.grouped_matmul.ref import grouped_matmul_ref as j_gmm_ref
from repro.models import moe as jmoe
from repro.models.model import Model as JModel
from repro_torch.configs import get_smoke_config
from repro_torch.interop import params_from_numpy, to_numpy_tree
from repro_torch.kernels.grouped_matmul import ops as gmm_ops
from repro_torch.kernels.grouped_matmul.grouped_matmul import gmm_path, grouped_matmul_cuda
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref
from repro_torch.models import Model
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)      # six test workers share the CPU

MOE = ("moonshot-v1-16b-a3b", "kimi-k2-1t-a32b")
MODULE_TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=4e-2, atol=4e-2)}
LOGITS_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=4e-2, atol=4e-2)}
GMM_TOL = {"float32": dict(rtol=1e-4, atol=1e-3), "bfloat16": dict(rtol=3e-2, atol=3e-1)}
MOE_FIELDS = {f.name for f in dataclasses.fields(type(get_smoke_config(MOE[0]).moe))}


def _close(port, ref, tol):
    np.testing.assert_allclose(to_numpy_tree(port), np.asarray(ref, np.float32), **tol)


def _cfgs(arch: str, dtype: str, overrides=()):
    """(reference config, port config) of a smoke config in ``dtype`` with
    ``overrides`` ((field, value) pairs of the model or its MoE config)."""
    out = []
    for cfg in (j_smoke(arch), get_smoke_config(arch)):
        moe_kw = {k: v for k, v in overrides if k in MOE_FIELDS}
        kw = {k: v for k, v in overrides if k not in MOE_FIELDS}
        out.append(cfg.replace(param_dtype=dtype, compute_dtype=dtype,
                               moe=dataclasses.replace(cfg.moe, **moe_kw), **kw))
    return out


@functools.lru_cache(maxsize=None)
def _layer(arch: str, dtype: str, overrides=()):
    """One MoE layer's parameters, the reference's and the same on the port."""
    jcfg, tcfg = _cfgs(arch, dtype, overrides)
    jp = jmoe.moe_init(jax.random.PRNGKey(1), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(cfg, seed: int, shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, cfg.compute_dtype), torch.from_numpy(x).to(
        getattr(torch, cfg.compute_dtype))


# ---------------------------------------------------------------------------
# K6 grouped matmul
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("E,C,D,F", [(4, 32, 64, 32), (8, 16, 128, 64), (2, 128, 256, 128),
                                     (8, 1, 64, 32), (3, 3, 96, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_plain_vs_pallas_and_oracle(E, C, D, F, dtype):
    """The reference's shapes, C = 1 (a decode step) and a ragged shape."""
    rng = np.random.default_rng(E * C + D + F)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    w = rng.standard_normal((E, D, F)).astype(np.float32)
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    tx, tw = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w))
    port = gmm_ops.expert_ffn_matmul(tx, tw)
    assert port.dtype == tx.dtype and tuple(port.shape) == (E, C, F)
    assert torch.equal(port, grouped_matmul_ref(tx, tw))
    pallas = j_expert_ffn_matmul(jx, jw, interpret=True, block_c=16, block_f=32,
                                 block_d=64)
    _close(port, pallas, GMM_TOL[dtype])
    _close(port, j_gmm_ref(jx, jw), GMM_TOL[dtype])


def test_grouped_matmul_wrappers_refuse_what_they_do_not_take():
    x, w = torch.zeros(2, 3, 4), torch.zeros(2, 4, 5)
    with pytest.raises(ValueError, match="CUDA"):
        grouped_matmul_cuda(x, w)
    with pytest.raises(ValueError, match="unsupported device"):
        gmm_ops.expert_ffn_matmul(x.to("meta"), w.to("meta"))


@pytest.mark.parametrize("E,C,D,F,dtype,path", [
    (64, 1, 2048, 1408, torch.bfloat16, "small_c"),     # moonshot's decode
    (64, 16, 2048, 1408, torch.bfloat16, "small_c"),
    (64, 17, 2048, 1408, torch.bfloat16, "wgmma"),
    (64, 240, 2048, 1408, torch.bfloat16, "wgmma"),     # moonshot's prefill
    (64, 60, 1408, 2048, torch.bfloat16, "wgmma"),      # one prompt admitted
    (2, 8, 7168, 64, torch.bfloat16, "wgmma"),          # x[e] outgrows shared memory
    (64, 1, 2048, 1408, torch.float32, "cuda_core"),
    (64, 240, 2048, 1408, torch.float32, "cuda_core"),
    (3, 3, 96, 100, torch.bfloat16, "cuda_core"),       # rows not on 16 bytes
    (3, 300, 96, 100, torch.bfloat16, "cuda_core"),
])
def test_gmm_path_is_chosen_from_dtype_shape_and_strides(E, C, D, F, dtype, path):
    """K6's launcher picks its kernel up front, on any device (meta here:
    no memory)."""
    x = torch.empty(E, C, D, dtype=dtype, device="meta")
    w = torch.empty(E, D, F, dtype=dtype, device="meta")
    assert gmm_path(x, w) == path


def test_gmm_path_refuses_what_no_kernel_takes():
    x, w = torch.zeros(2, 3, 8, dtype=torch.bfloat16), torch.zeros(2, 8, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        gmm_path(x, w.float())
    with pytest.raises(ValueError, match="contiguous"):
        gmm_path(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match="shapes"):
        gmm_path(x, w[:, :4].contiguous())
    misaligned = torch.zeros(2 * 3 * 8 + 1, dtype=torch.bfloat16)[1:].view(2, 3, 8)
    assert gmm_path(misaligned, w) == "cuda_core"


@pytest.mark.parametrize("T", [1, 24])        # one decode row (C = 1) and a prefill
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_leaves_empty_capacity_rows_exactly_zero(T, dtype, monkeypatch):
    """The invariant K6's small-C path relies on to skip an expert: on
    moonshot's smoke config, every capacity slot that no token fills is
    exactly zero in the xe that meets w_gate and w_in, and in the SwiGLU
    output that meets w_out.  One row (top-2 of 4 experts) leaves whole
    experts empty, the case the kernel skips."""
    jcfg, tcfg, jp, tp = _layer("moonshot-v1-16b-a3b", dtype)
    tcfg = tcfg.replace(use_kernels=True)
    m = tcfg.moe
    seen = []
    real = tmoe.expert_ffn_matmul

    def recording(x, w):
        seen.append(x.clone())
        return real(x, w)

    monkeypatch.setattr(tmoe, "expert_ffn_matmul", recording)
    _, txt = _x(jcfg, 5, (T, tcfg.d_model))
    _, idx = tmoe.router_topk(txt.float() @ tp["router"].float(), m.top_k)
    C = int(np.ceil(T * m.top_k / m.n_experts * m.capacity_factor))
    _, dest, keep = tmoe._dispatch(tp, txt, idx, C, tcfg)
    filled = torch.zeros(m.n_experts * C + 1, dtype=torch.bool)
    filled[dest[keep]] = True
    empty = ~filled[:-1].view(m.n_experts, C)
    assert empty.any() and (T > 1 or empty.all(dim=1).any())
    assert [tuple(x.shape[:2]) for x in seen] == [(m.n_experts, C)] * 3
    for x in seen:                               # xe, xe, then the SwiGLU output
        assert torch.equal(x[empty], torch.zeros_like(x[empty]))
        assert not torch.equal(x[~empty], torch.zeros_like(x[~empty]))


# ---------------------------------------------------------------------------
# router, dispatch, combine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("E,k", [(4, 2), (8, 2), (64, 6)])
def test_router_topk_matches_reference(E, k):
    logits = np.random.default_rng(E).standard_normal((40, E)).astype(np.float32) * 3
    jw, ji = jmoe.router_topk(jnp.asarray(logits), k)
    tw, ti = tmoe.router_topk(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw, jw, MODULE_TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_dispatch_and_combine_match_reference(arch, dtype):
    """``dest`` and ``keep`` equal the reference's exactly, at the config's
    capacity and at C = 2, which drops assignments; ye and y within the
    module tolerance."""
    jcfg, tcfg, jp, tp = _layer(arch, dtype)
    m = jcfg.moe
    T = 24
    jxt, txt = _x(jcfg, 4, (T, jcfg.d_model))
    logits = jxt.astype(jnp.float32) @ jp["router"].astype(jnp.float32)
    jw, ji = jmoe.router_topk(logits, m.top_k)
    tw, ti = torch.from_numpy(np.array(jw)), torch.from_numpy(np.array(ji)).long()
    capacity = int(np.ceil(T * m.top_k / m.n_experts * m.capacity_factor))
    for C in (capacity, 2):
        jye, jdest, jkeep = jmoe._dispatch(jp, jxt, ji, C, jcfg)
        tye, tdest, tkeep = tmoe._dispatch(tp, txt, ti, C, tcfg)
        np.testing.assert_array_equal(tdest.numpy(), np.asarray(jdest))
        np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
        assert bool(tkeep.all()) == (C == capacity)
        _close(tye, jye, MODULE_TOL[dtype])
        jy = jmoe._combine(jye, jdest, jkeep, jw, T, jxt.dtype)
        ty = tmoe._combine(tye, tdest, tkeep, tw, T, txt.dtype)
        assert ty.dtype == txt.dtype
        _close(ty, jy, MODULE_TOL[dtype])


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------
APPLY_CASES = [(arch, dtype, use_kernels, ())
               for arch in MOE for dtype in ("float32", "bfloat16")
               for use_kernels in (False, True)] + [
    ("moonshot-v1-16b-a3b", "float32", True, (("capacity_factor", 0.5),)),
    ("kimi-k2-1t-a32b", "float32", True, (("moe_dispatch_groups", 2),)),
    ("kimi-k2-1t-a32b", "bfloat16", True, (("moe_dispatch_groups", 2),
                                           ("moe_combine_replicated", True))),
    ("moonshot-v1-16b-a3b", "bfloat16", False, (("n_shared_experts", 1),)),
]


def _case_id(case):
    arch, dtype, use_kernels, overrides = case
    extra = "-".join(f"{k}={v}" for k, v in overrides)
    return "-".join(filter(None, (arch.split("-")[0], dtype,
                                  "kernels" if use_kernels else "plain", extra)))


@pytest.mark.parametrize("case", APPLY_CASES, ids=_case_id)
def test_moe_apply_matches_reference(case):
    """y and the aux loss; the kernel route (``use_kernels``: K6's plain
    version on the CPU) against the reference's einsum oracle; forced
    capacity drops, two dispatch groups, the replicated combine and a
    shared expert."""
    arch, dtype, use_kernels, overrides = case
    jcfg, tcfg, jp, tp = _layer(arch, dtype, overrides)
    tcfg = tcfg.replace(use_kernels=use_kernels)
    jx, tx = _x(jcfg, 5, (2, 12, jcfg.d_model))
    jy, jaux = jmoe.moe_apply(jp, jx, jcfg)
    ty, taux = tmoe.moe_apply(tp, tx, tcfg)
    assert ty.dtype == tx.dtype and taux.dtype == torch.float32
    _close(ty, jy, MODULE_TOL[dtype])
    _close(taux, jaux, MODULE_TOL["float32"])


def test_moe_init_makes_the_reference_tree():
    """Random init (from a torch generator) has the reference's keys,
    shapes and dtypes, shared experts included."""
    jcfg, tcfg = _cfgs(MOE[0], "bfloat16", (("n_shared_experts", 1),))
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    tp = Model(tcfg).init(torch.Generator().manual_seed(0), device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jflat) == len(jax.tree_util.tree_leaves(tp))
    for path, leaf in jflat:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape and str(t.dtype) == f"torch.{leaf.dtype}"


def test_normal_init_fills_every_slice(monkeypatch):
    """Drawn a run of leading-dim slices at a time, every slice still gets
    its own N(0, std²) draws in the leaf's dtype."""
    monkeypatch.setattr(tl, "_DRAW_VALUES", 1000)
    gen = torch.Generator().manual_seed(0)
    for shape in ((6, 2, 400), (9, 300), (4,)):
        t = tl.normal_init(gen, shape, torch.bfloat16, std=0.5)
        assert tuple(t.shape) == shape and t.dtype == torch.bfloat16
        rows = t.float().reshape(shape[0], -1)
        if rows.shape[1] > 1:
            assert ((rows.std(dim=1) - 0.5).abs() < 0.1).all()
            assert len({tuple(r.tolist()) for r in rows}) == shape[0]


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _pair(arch: str, dtype: str):
    jcfg, tcfg = _cfgs(arch, dtype)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(tcfg)
    return jm, jp, tm, tm.load_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_model_logits_match_reference(arch, dtype):
    """forward logits and aux; prefill, then decode at an int position and
    at a [B] position vector; on the plain route and the kernel route."""
    jm, jp, tm, tp = _pair(arch, dtype)
    toks = np.random.default_rng(3).integers(0, jm.cfg.vocab, (2, 24)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    jlog, jaux = jm.forward(jp, jb)
    jpre, jc, jpos = jm.prefill(jp, jb, cache_len=32)
    tok = np.random.default_rng(4).integers(0, jm.cfg.vocab, (2, 1)).astype(np.int32)
    jdec, jc = jm.decode_step(jp, jnp.asarray(tok), jc, jpos)
    posv = np.full(2, jpos + 1, np.int32)
    jdec2, _ = jm.decode_step(jp, jnp.asarray(tok), jc, jnp.asarray(posv))
    for use_kernels in (False, True):
        model = Model(tm.cfg.replace(use_kernels=use_kernels))
        tlog, taux = model.forward(tp, tb)
        _close(tlog, jlog, LOGITS_TOL[dtype])
        _close(taux, jaux, MODULE_TOL["float32"])
        tpre, tc, tpos = model.prefill(tp, tb, cache_len=32)
        assert tpos == jpos
        _close(tpre, jpre, LOGITS_TOL[dtype])
        tdec, tc = model.decode_step(tp, torch.from_numpy(tok), tc, tpos)
        _close(tdec, jdec, LOGITS_TOL[dtype])
        tdec2, _ = model.decode_step(tp, torch.from_numpy(tok), tc, torch.from_numpy(posv))
        _close(tdec2, jdec2, LOGITS_TOL[dtype])
