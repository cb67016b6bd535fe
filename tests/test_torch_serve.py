"""The port's ServeEngine against the reference's on the CPU: greedy tokens
in continuous and wave modes, on fp32 smoke configs with the reference's
parameters.  Ragged prompts exercise bucketed, pad-masked prefill and
masked decode; ``deadline_ms=0`` exercises shedding."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as j_smoke
from repro.models.model import Model as JModel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.models import Model
from repro_torch.serve import Request, ServeConfig, ServeEngine

torch.set_num_threads(1)      # six test workers share the CPU

FRONTEND = {"internvl2-2b": 8, "seamless-m4t-large-v2": 4}


@functools.lru_cache(maxsize=None)
def _pair(arch: str):
    jcfg = j_smoke(arch).replace(param_dtype="float32", compute_dtype="float32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_smoke_config(arch).replace(param_dtype="float32",
                                              compute_dtype="float32"))
    tp = tm.load_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


LENS = (5, 9, 3, 12, 7)          # ragged: bucketed, pad-masked prefill


def _requests(vocab: int, lens=LENS, seed: int = 1):
    """(rid, prompt, budget) triples: five requests through two slots."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(1, vocab, L).tolist(), 4 + 2 * i)
            for i, L in enumerate(lens)]


@functools.lru_cache(maxsize=None)
def _reference(arch: str, mode: str, lens=LENS):
    """The reference engine's {rid: tokens} (batch 2, cache 48)."""
    jm, jp, _, _ = _pair(arch)
    out = JServeEngine(jm, jp, JServeConfig(batch=2, max_len=48, mode=mode),
                       frontend_seq=FRONTEND.get(arch, 0)).serve(
        [JRequest(i, p, max_new_tokens=n) for i, p, n in _requests(jm.cfg.vocab, lens)])
    return {rid: r.tokens for rid, r in out.items()}


def _port(arch: str, mode: str, reqs, use_kernels: bool = False, **kw):
    _, _, tm, tp = _pair(arch)
    model = Model(tm.cfg.replace(use_kernels=use_kernels))
    return ServeEngine(model, tp, ServeConfig(batch=2, max_len=48, mode=mode, **kw),
                       frontend_seq=FRONTEND.get(arch, 0), device="cpu").serve(reqs)


def _tokens(results):
    return {rid: r.tokens for rid, r in results.items()}


@pytest.mark.parametrize("arch,mode", [
    (arch, mode) for arch in ("minitron-4b", "qwen2-72b", "gemma3-4b", "kimi-k2-1t-a32b")
    for mode in ("continuous", "wave")] + [
    ("internvl2-2b", "continuous"), ("seamless-m4t-large-v2", "wave"),
    ("moonshot-v1-16b-a3b", "wave")])
def test_greedy_tokens_match_reference(arch, mode):
    """Ragged prompts through two slots / waves of two; the vlm and enc-dec
    frontends in one mode each (their logits are held in
    ``test_torch_models.py``); the MoE family (logits held in
    ``test_torch_moe.py``): kimi in both modes, and moonshot, whose smoke
    model repeats one token per request, in one."""
    vocab = _pair(arch)[2].cfg.vocab
    reqs = [Request(i, p, max_new_tokens=n) for i, p, n in _requests(vocab)]
    got = _tokens(_port(arch, mode, reqs))
    assert got == _reference(arch, mode)
    assert all(len(got[i]) == 4 + 2 * i for i in got)


@pytest.mark.parametrize("mode", ["continuous", "wave"])
def test_kernel_route_serves_the_same_tokens_on_cpu(mode):
    """``use_kernels=True`` takes flash attention in unpadded prefill and
    flash decode in every unpadded decode (their plain versions on the
    CPU): equal-length prompts use both, ragged ones the masked paths; the
    tokens equal the plain route's and the reference's."""
    vocab = _pair("minitron-4b")[2].cfg.vocab
    for lens in ((8, 8, 8, 8), LENS):
        reqs = [Request(i, p, max_new_tokens=n) for i, p, n in _requests(vocab, lens)]
        kernel = _tokens(_port("minitron-4b", mode, reqs, use_kernels=True))
        assert kernel == _tokens(_port("minitron-4b", mode, reqs))
        if lens == LENS:
            assert kernel == _reference("minitron-4b", mode)


@pytest.mark.parametrize("mode", ["continuous", "wave"])
def test_expired_deadline_is_shed(mode):
    """``deadline_ms=0`` is past on arrival: shed with no tokens; the other
    requests are served as the reference serves them."""
    vocab = _pair("minitron-4b")[2].cfg.vocab
    reqs = [Request(i, p, max_new_tokens=n) for i, p, n in _requests(vocab)]
    reqs.insert(2, Request(9, [1, 2, 3], max_new_tokens=4, deadline_ms=0.0))
    out = _port("minitron-4b", mode, reqs)
    assert out[9].timed_out and out[9].tokens == []
    assert {rid: r.tokens for rid, r in out.items() if rid != 9} == \
        _reference("minitron-4b", mode)


def test_midstream_eos_frees_the_slot():
    """A request that meets ``eos`` stops there and frees its slot; the
    others are served as without it."""
    vocab = _pair("minitron-4b")[2].cfg.vocab
    reqs = [Request(i, p, max_new_tokens=n) for i, p, n in _requests(vocab)]
    full = _reference("minitron-4b", "continuous")
    eos = full[1][1]
    got = _tokens(_port("minitron-4b", "continuous", reqs, eos=eos))
    for rid, toks in full.items():
        cut = toks.index(eos) + 1 if eos in toks else len(toks)
        assert got[rid] == toks[:cut], rid


def test_streaming_api_and_sampling():
    """submit/step/drain give serve()'s tokens; temperature sampling is
    reproducible from the config's seed (its tokens are not JAX's)."""
    _, _, tm, tp = _pair("minitron-4b")
    reqs = [Request(i, p, max_new_tokens=n) for i, p, n in _requests(tm.cfg.vocab)]
    eng = ServeEngine(tm, tp, ServeConfig(batch=2, max_len=48), device="cpu")
    eng.submit(*reqs)
    assert _tokens(eng.drain()) == _reference("minitron-4b", "continuous")
    hot = [_tokens(_port("minitron-4b", "continuous", reqs, temperature=1.0, seed=3))
           for _ in range(2)]
    assert hot[0] == hot[1]
    assert all(0 <= t < tm.cfg.vocab for toks in hot[0].values() for t in toks)


def test_engine_refuses_what_it_does_not_serve():
    _, _, tm, tp = _pair("minitron-4b")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeEngine(tm, tp, ServeConfig(), runtime=object(), device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        ServeEngine(tm, tp, ServeConfig(max_len=8), device="cpu").submit(
            Request(0, [1] * 6, max_new_tokens=4))
    with pytest.raises(ValueError, match="mode"):
        ServeEngine(tm, tp, ServeConfig(mode="pool"), device="cpu")
