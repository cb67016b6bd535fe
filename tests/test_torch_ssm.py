"""The port's SSM and hybrid families against the reference on the CPU: the
SSD-scan kernel K5's plain version (against the Pallas kernel in interpret
mode, the jnp oracle ``ssd_chunked`` and the sequential recurrence),
``rms_norm_gated``, the Mamba2 mixer in prefill and decode, whole-model
forward / prefill / decode on both smoke configs (mamba2-130m, zamba2-2.7b),
and greedy tokens of the serve engine in both modes.

Inputs are numpy arrays from seeds; parameters are the reference's, carried
across by ``params_from_numpy``.  Tolerances: ``tests/test_kernels.py:21-25``
(fp32 2e-5, bf16 4e-2) for the scan and the modules, the model tests' 1e-4 /
4e-2 for logits.  The reference's models run the jnp oracle, never their
Pallas K5 (``repro/models/ssm.py:11-12``), so the port's model is held
against ``ssd_chunked``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as j_smoke
from repro.kernels.ssd_scan.ops import ssd_chunked_pallas
from repro.kernels.ssd_scan.ref import ssd_naive_ref as j_naive_ref
from repro.kernels.ssd_scan.ref import ssd_scan_ref as j_scan_ref
from repro.models import layers as jl
from repro.models import ssm as jssm
from repro.models.model import Model as JModel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.interop import params_from_numpy, to_numpy_tree
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_naive_ref, ssd_scan_ref
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_cuda
from repro_torch.models import Model
from repro_torch.models import layers as tl
from repro_torch.models import ssm as tssm
from repro_torch.serve import Request, ServeConfig, ServeEngine
from repro_torch.serve.engine import _leaves

torch.set_num_threads(1)      # six test workers share the CPU

STATE = ("mamba2-130m", "zamba2-2.7b")
MODULE_TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=4e-2, atol=4e-2)}
LOGITS_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=4e-2, atol=4e-2)}


def _close(port, ref, tol):
    np.testing.assert_allclose(to_numpy_tree(port), np.asarray(ref, np.float32), **tol)


def _scan_inputs(seed: int, b: int, S: int, H: int, P: int, G: int, N: int, dtype: str):
    """(jax operands, torch operands) of one SSD scan: the reference's own
    distributions (``tests/test_kernels.py:82-87``), made with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, S, H)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    B = rng.standard_normal((b, S, G, N)).astype(np.float32)
    C = rng.standard_normal((b, S, G, N)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j = (jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(B, jdt),
         jnp.asarray(C, jdt))
    t = (torch.from_numpy(x).to(tdt), torch.from_numpy(dt), torch.from_numpy(A),
         torch.from_numpy(B).to(tdt), torch.from_numpy(C).to(tdt))
    return j, t


# ---------------------------------------------------------------------------
# K5 SSD scan: the plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,chunk,G", [(64, 16, 2), (96, 32, 2), (128, 128, 2),
                                       (50, 16, 1), (37, 8, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_plain_vs_pallas_and_oracle(S, chunk, G, dtype):
    """The reference's shapes (b 2, H 4, P 16, G 2, N 8), a ragged S (50 and
    37, zero-padded tail) and one group; through the ops wrapper (CPU: the
    plain version)."""
    (jx, jdt, jA, jB, jC), (x, dt, A, B, C) = _scan_inputs(S + chunk + G, 2, S, 4, 16,
                                                           G, 8, dtype)
    y, h = ssd_ops.ssd_chunked_scan(x, dt, A, B, C, chunk=chunk)
    assert y.dtype == x.dtype and h.dtype == torch.float32
    assert tuple(y.shape) == (2, S, 4, 16) and tuple(h.shape) == (2, 4, 8, 16)
    jy, jh = jssm.ssd_chunked(jx, jdt, jA, jB, jC, chunk=chunk)
    _close(y, jy, MODULE_TOL[dtype])
    _close(h, jh, MODULE_TOL[dtype])
    py, ph = ssd_chunked_pallas(jx, jdt, jA, jB, jC, chunk=chunk, interpret=True)
    _close(y, py, MODULE_TOL[dtype])
    _close(h, ph, MODULE_TOL[dtype])


def test_ssd_plain_matches_sequential_recurrence():
    """Chunked == the literal per-step recurrence (an independent oracle),
    in the kernel layout, with an initial state carried by ``h0``."""
    _, (x, dt, A, B, C) = _scan_inputs(7, 1, 40, 3, 8, 3, 4, "float32")
    xk, dtk = x[0].transpose(0, 1), dt[0].transpose(0, 1)          # [BH, S, ...]
    Bk, Ck = B[0].transpose(0, 1), C[0].transpose(0, 1)
    yn, hn = ssd_naive_ref(xk, dtk, A, Bk, Ck)
    ys, hs = ssd_scan_ref(xk, dtk, A, Bk, Ck, chunk=16)
    torch.testing.assert_close(ys, yn, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(hs, hn, rtol=1e-4, atol=1e-4)
    y1, h1 = ssd_chunked(x[:, :24], dt[:, :24], A, B[:, :24], C[:, :24], chunk=8)
    y2, h2 = ssd_chunked(x[:, 24:], dt[:, 24:], A, B[:, 24:], C[:, 24:], chunk=8, h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), yn.transpose(0, 1)[None],
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h2, hn[None], rtol=1e-4, atol=1e-4)


def test_ssd_kernel_layout_refs_match_reference():
    (jx, jdt, jA, jB, jC), (x, dt, A, B, C) = _scan_inputs(3, 1, 20, 3, 4, 3, 5, "float32")
    args_j = (jx[0].transpose(1, 0, 2), jdt[0].T, jA, jB[0].transpose(1, 0, 2),
              jC[0].transpose(1, 0, 2))
    args_t = (x[0].transpose(0, 1), dt[0].T, A, B[0].transpose(0, 1), C[0].transpose(0, 1))
    for port, ref in ((ssd_naive_ref(*args_t), j_naive_ref(*args_j)),
                      (ssd_scan_ref(*args_t, chunk=8), j_scan_ref(*args_j, chunk=8))):
        for p, r in zip(port, ref):
            _close(p, r, MODULE_TOL["float32"])


def test_ssd_wrappers_refuse_what_they_do_not_take():
    _, (x, dt, A, B, C) = _scan_inputs(0, 1, 8, 2, 16, 1, 16, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(x, dt, A, B, C)
    with pytest.raises(ValueError, match="unsupported device"):
        ssd_ops.ssd_chunked_scan(*(t.to("meta") for t in (x, dt, A, B, C)))


# ---------------------------------------------------------------------------
# layers and the Mamba2 mixer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_gated_matches_reference(dtype):
    rng = np.random.default_rng(11)
    x, z = (rng.standard_normal((3, 5, 48)).astype(np.float32) * 2 for _ in range(2))
    scale = rng.standard_normal(48).astype(np.float32) * 0.1
    ref = jl.rms_norm_gated(jnp.asarray(x, dtype), jnp.asarray(z, dtype),
                            jnp.asarray(scale, dtype), 1e-6)
    tdt = getattr(torch, dtype)
    port = tl.rms_norm_gated(torch.from_numpy(x).to(tdt), torch.from_numpy(z).to(tdt),
                             torch.from_numpy(scale).to(tdt), 1e-6)
    assert port.dtype == tdt
    _close(port, ref, MODULE_TOL[dtype])


@functools.lru_cache(maxsize=None)
def _mixer(arch: str, dtype: str):
    jcfg = j_smoke(arch).replace(param_dtype=dtype, compute_dtype=dtype)
    tcfg = get_smoke_config(arch).replace(param_dtype=dtype, compute_dtype=dtype)
    jp = jssm.mamba2_init(jax.random.PRNGKey(2), jcfg)
    # non-trivial decay, skip and step-size leaves (init makes them 0 / 1)
    rng = np.random.default_rng(2)
    nh = jp["A_log"].shape[0]
    for name in ("A_log", "D", "dt_bias"):
        jp[name] = jnp.asarray(rng.standard_normal(nh).astype(np.float32) * 0.5)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", STATE)
def test_mamba2_apply_prefill_and_decode_match_reference(arch, dtype, use_kernels):
    """Prefill (S = 20: a ragged last chunk of 16) with ``return_state``,
    then two decode steps; outputs, conv and SSM states."""
    jcfg, tcfg, jp, tp = _mixer(arch, dtype)
    tcfg = tcfg.replace(use_kernels=use_kernels)
    rng = np.random.default_rng(5)
    xin = rng.standard_normal((2, 22, jcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(xin, dtype), torch.from_numpy(xin).to(getattr(torch, dtype))
    jout, (jconv, jssm_s) = jssm.mamba2_apply(jp, jx[:, :20], jcfg, return_state=True)
    tout, (tconv, tssm_s) = tssm.mamba2_apply(tp, tx[:, :20], tcfg, return_state=True)
    assert tout.dtype == tx.dtype and tssm_s.dtype == torch.float32
    _close(tout, jout, MODULE_TOL[dtype])
    _close(tconv, jconv, MODULE_TOL[dtype])
    _close(tssm_s, jssm_s, MODULE_TOL[dtype])
    tconv, tssm_s = tconv.clone(), tssm_s.clone()
    for t in (20, 21):
        jout, (jconv, jssm_s) = jssm.mamba2_apply(jp, jx[:, t:t + 1], jcfg,
                                                  conv_state=jconv, ssm_state=jssm_s)
        tout, (tconv, tssm_s) = tssm.mamba2_apply(tp, tx[:, t:t + 1], tcfg,
                                                  conv_state=tconv, ssm_state=tssm_s)
        _close(tout, jout, MODULE_TOL[dtype])
        _close(tconv, jconv, MODULE_TOL[dtype])
        _close(tssm_s, jssm_s, MODULE_TOL[dtype])


def test_softplus_is_the_references():
    """``logaddexp(x, 0)``, exact above 20 where ``F.softplus`` turns linear."""
    x = np.array([-30.0, -3.0, 0.0, 0.5, 19.9, 20.5, 40.0], np.float32)
    np.testing.assert_array_equal(tssm.softplus(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.nn.softplus(jnp.asarray(x))))


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _pair(arch: str, dtype: str):
    jcfg = j_smoke(arch).replace(param_dtype=dtype, compute_dtype=dtype)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_smoke_config(arch).replace(param_dtype=dtype, compute_dtype=dtype))
    return jm, jp, tm, tm.load_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", STATE)
def test_state_model_logits_and_caches_match_reference(arch, dtype):
    """forward logits; prefill logits and every cache leaf (conv, ssm and,
    for the hybrid, attn_k / attn_v); decode at an int position and at a
    [B] position vector; on the plain route and the kernel route."""
    jm, jp, tm, tp = _pair(arch, dtype)
    toks = np.random.default_rng(3).integers(0, jm.cfg.vocab, (2, 21)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    jlog, _ = jm.forward(jp, jb)
    jpre, jc, jpos = jm.prefill(jp, jb, cache_len=32)
    tok = np.random.default_rng(4).integers(0, jm.cfg.vocab, (2, 1)).astype(np.int32)
    jdec, jc2 = jm.decode_step(jp, jnp.asarray(tok), jc, jpos)
    posv = np.full(2, jpos + 1, np.int32)
    jdec2, _ = jm.decode_step(jp, jnp.asarray(tok), jc2, jnp.asarray(posv))
    for use_kernels in (False, True):
        model = Model(tm.cfg.replace(use_kernels=use_kernels))
        tlog, taux = model.forward(tp, tb)
        _close(tlog, jlog, LOGITS_TOL[dtype])
        assert float(taux) == 0.0
        tpre, tc, tpos = model.prefill(tp, tb, cache_len=32)
        assert tpos == jpos
        _close(tpre, jpre, LOGITS_TOL[dtype])
        assert set(tc) == set(jc)
        for name in jc:
            assert tc[name].dtype == getattr(torch, str(jc[name].dtype)), name
            _close(tc[name], jc[name], MODULE_TOL[dtype])
        tdec, tc = model.decode_step(tp, torch.from_numpy(tok), tc, tpos)
        _close(tdec, jdec, LOGITS_TOL[dtype])
        tdec2, _ = model.decode_step(tp, torch.from_numpy(tok), tc, torch.from_numpy(posv))
        _close(tdec2, jdec2, LOGITS_TOL[dtype])


@pytest.mark.parametrize("arch", STATE)
def test_state_model_init_makes_the_reference_tree(arch):
    """Random init (from a torch generator) has the reference's keys,
    shapes and dtypes: fp32 A_log / D / dt_bias, the hybrid's [G, k, ...]
    stacking and its nested shared block."""
    jm, jp, _, _ = _pair(arch, "bfloat16")
    tp = Model(get_smoke_config(arch)).init(torch.Generator().manual_seed(0), device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jflat) == len(jax.tree_util.tree_leaves(tp))
    for path, leaf in jflat:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape and str(t.dtype) == f"torch.{leaf.dtype}"


@pytest.mark.parametrize("arch", STATE)
def test_state_prefill_refuses_pad_width(arch):
    _, _, tm, tp = _pair(arch, "float32")
    toks = torch.ones(2, 6, dtype=torch.int32)
    with pytest.raises(ValueError, match="left-pads"):
        tm.prefill(tp, {"tokens": toks}, pad_width=torch.tensor([0, 2], dtype=torch.int32))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
LENS = (5, 9, 5, 12, 7)          # ragged: two equal lengths share one prefill


def _requests(vocab: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(1, vocab, L).tolist(), 4 + 2 * i) for i, L in enumerate(LENS)]


@functools.lru_cache(maxsize=None)
def _reference(arch: str, mode: str):
    jm, jp, _, _ = _pair(arch, "float32")
    out = JServeEngine(jm, jp, JServeConfig(batch=2, max_len=48, mode=mode)).serve(
        [JRequest(i, p, max_new_tokens=n) for i, p, n in _requests(jm.cfg.vocab)])
    return {rid: r.tokens for rid, r in out.items()}


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("mode", ["continuous", "wave"])
@pytest.mark.parametrize("arch", STATE)
def test_state_greedy_tokens_match_reference(arch, mode, use_kernels):
    """Ragged prompts through two slots (exact-length prefill groups, per-leaf
    slot insertion) and in waves of two (left-padded, unmasked, as the
    reference serves them); on both routes."""
    _, _, tm, tp = _pair(arch, "float32")
    model = Model(tm.cfg.replace(use_kernels=use_kernels))
    reqs = [Request(i, p, max_new_tokens=n) for i, p, n in _requests(tm.cfg.vocab)]
    out = ServeEngine(model, tp, ServeConfig(batch=2, max_len=48, mode=mode),
                      device="cpu").serve(reqs)
    got = {rid: r.tokens for rid, r in out.items()}
    assert got == _reference(arch, mode)
    assert all(len(got[i]) == 4 + 2 * i for i in got)


@pytest.mark.parametrize("arch", STATE + ("minitron-4b",))
def test_cache_batch_axes_are_where_the_batch_sits(arch):
    """The batch axis the model states for each cache leaf (the hybrid's
    conv and SSM states [G, k, B, ...] on axis 2, every other leaf on axis
    1) is the one axis where the caches of 1 and of 3 rows differ."""
    model = Model(get_smoke_config(arch))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    one, three = (_leaves(model.make_cache(params, b, 48)) for b in (1, 3))
    axes = _leaves(model.cache_batch_axes())
    assert len(axes) == len(one) == len(three)
    for ax, c1, c3 in zip(axes, one, three):
        assert [i for i, (m, n) in enumerate(zip(c1.shape, c3.shape)) if m != n] == [ax]
    if arch == "zamba2-2.7b":
        assert axes == [2, 2, 1, 1]
