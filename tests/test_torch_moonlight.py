"""The DeepSeek-V3 decoder (Moonlight-16B-A3B's architecture) on the CPU at
a tiny size, against the benchmark's plain reference
(``portbench/references/moonlight-16b-a3b.py``, loaded by path): latent
attention (MLA) with its latent cache, a leading dense layer, sigmoid
routing with a selection bias, dropless experts with per-expert counts on
K6's plain route, and two shared experts.  Float32 weights from a seed on
both sides.

Tolerance: 1e-4 on logits of magnitude ~5 (TOL).  Both sides compute in
float32 the same equations in another order (the port absorbs the key
up-projection into the query in decode, batches heads and experts, and
sums its combine in another order): their logits differ by ~1e-6.  A
model that routes otherwise (softmax scores, no bias, a capacity that
drops) differs by 6 to 8 here, which the teeth tests hold above 100 x TOL.
"""
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels.grouped_matmul.ops import expert_ffn_matmul
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref
from repro_torch.models import (DeepSeekMoEConfig, MLAConfig, Model, ModelConfig,
                                MoEConfig, param_count)
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import layer_params

torch.set_num_threads(1)      # six test workers share the CPU

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4

TINY = ModelConfig(
    name="tiny-moonlight", family="moe", n_layers=3, d_model=64, n_heads=4, n_kv=4,
    d_ff=96, vocab=128, act="swiglu", tie_embeddings=False, rope_theta=50000.0,
    rms_eps=1e-5, param_dtype="float32", compute_dtype="float32", use_kernels=True,
    moe=DeepSeekMoEConfig(n_experts=8, top_k=2, d_ff_expert=24, n_shared_experts=2,
                          scoring="sigmoid", selection_bias=True,
                          routed_scale=2.446, dropless=True, first_dense_layers=1,
                          mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                                        qk_rope_head_dim=8, v_head_dim=16)))


def _reference():
    """The benchmark's plain reference, by path (it imports ``pb.reference``)."""
    bench = str(ROOT / "portbench")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    path = ROOT / "portbench" / "references" / "moonlight-16b-a3b.py"
    spec = importlib.util.spec_from_file_location("moonlight_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


def _conf(cfg, **moe):
    """The configuration as a configuration file holds it, ``moe`` fields
    replaced."""
    conf = json.loads(json.dumps(dataclasses.asdict(cfg)))
    conf["moe"].update(moe)
    return conf


def _init(cfg, seed=0):
    """Seeded weights at std 0.25 (the model's own init draws 0.02, under
    which a model of width 64 computes logits of ~1e-2), embedding and
    norms as the model draws them."""
    p = Model(cfg).init(torch.Generator().manual_seed(seed), device="cpu")

    def scale(tree, path=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                scale(v, f"{path}{k}.")
            elif "norm" not in k and f"{path}{k}" != "embed.table":
                v.mul_(12.5)
    scale(p)
    return p


@pytest.fixture(scope="module")
def params():
    return _init(TINY)


def _tokens(seed, n):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, TINY.vocab, n))


def _ref_logits(params, tokens, **moe):
    with torch.no_grad():
        return REF.logits(params, _conf(TINY, **moe), tokens, torch.arange(len(tokens)))


def test_config_and_parameters():
    """The tiny model holds one dense layer apart, MLA's leaves in every
    layer, the selection bias, and ``param_count`` counts every leaf."""
    p = Model(TINY).init(torch.Generator().manual_seed(0), device="cpu")
    assert p["dense_layers"]["mlp"]["w_in"].shape == (1, 64, 96)
    assert p["layers"]["moe"]["w_in"].shape == (2, 8, 64, 24)
    assert p["layers"]["moe"]["bias"].shape == (2, 8)
    assert set(p["layers"]["attn"]) == {"wq", "wkv_a", "kv_norm", "wkv_b", "wo"}

    def count(t):
        return sum(count(v) for v in t.values()) if isinstance(t, dict) else t.numel()
    assert param_count(TINY)[0] == count(p)
    assert TINY.mla.cache_width == 40 and TINY.first_dense_layers == 1


@pytest.mark.parametrize("use_kernels", [True, False])
def test_full_forward_matches_reference(params, use_kernels):
    toks = _tokens(1, 40)
    logits, aux = Model(TINY.replace(use_kernels=use_kernels)).forward(
        params, {"tokens": toks[None]})
    torch.testing.assert_close(logits[0], _ref_logits(params, toks), rtol=0, atol=TOL)
    assert float(aux) == 0.0                # the sigmoid router has no aux loss


@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_then_decode_through_the_latent_cache(params, use_kernels):
    """Two rows of prompt lengths 13 and 21 prefill apart into one latent
    cache (the engine's slot copy), then 10 decode steps at each row's own
    fill, teacher-forced: every step's logits are the reference's full
    forward's."""
    model = Model(TINY.replace(use_kernels=use_kernels))
    lens, steps, S = (13, 21), 10, 48
    seqs = [_tokens(10 + b, L + steps) for b, L in enumerate(lens)]
    cache = model.make_cache(params, 2, S)
    assert model.cache_batch_axes() == ((1,), None)
    (latent,), cross = cache
    assert cross is None and latent.shape == (3, 2, S, 40)
    got = [[] for _ in lens]
    with torch.no_grad():
        for b, L in enumerate(lens):
            lg, one, fill = model.prefill(params, {"tokens": seqs[b][None, :L]}, cache_len=S)
            latent[:, b].copy_(one[0][0][:, 0])
            assert fill == L
            got[b].append(lg[0, -1])
        pos = torch.tensor(lens, dtype=torch.int32)
        for t in range(steps - 1):
            tok = torch.stack([seqs[b][L + t] for b, L in enumerate(lens)]).int()[:, None]
            out, cache = model.decode_step(params, tok, cache, pos)
            for b in range(2):
                got[b].append(out[b, -1])
            pos = pos + 1
    for b, L in enumerate(lens):
        ref = _ref_logits(params, seqs[b][:L + steps - 1])[L - 1:]
        torch.testing.assert_close(torch.stack(got[b]), ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("variant", [
    {"scoring": "softmax"}, {"selection_bias": False},
    {"dropless": False, "capacity_factor": 1.25}])
def test_the_tolerance_has_teeth(params, variant):
    """The reference with softmax routing, without the selection bias, or
    with a capacity of 1.25 that drops assignments lies farther from the
    port than the tolerance."""
    toks = _tokens(1, 40)
    logits, _ = Model(TINY).forward(params, {"tokens": toks[None]})
    gap = (logits[0] - _ref_logits(params, toks, **variant)).abs().max()
    assert gap > 100 * TOL, (variant, float(gap))


def _moe_layer(cfg, seed=0):
    return layer_params(_init(cfg, seed)["layers"]["moe"], 0)


@pytest.mark.parametrize("T", [1, 6, 40])
def test_dropless_dispatch_equals_capacity_of_every_token(T):
    """Dropless dispatch (C = T, expert GEMMs told each expert's count) gives
    what capacity E / k (C = T too, nothing dropped, the buffer zeroed)
    gives on the plain path, bit for bit; K6's plain route with counts as
    well."""
    m = TINY.moe
    p = _moe_layer(TINY)
    x = torch.randn(1, T, TINY.d_model, generator=torch.Generator().manual_seed(T))
    capacity = TINY.replace(moe=dataclasses.replace(
        m, dropless=False, capacity_factor=m.n_experts / m.top_k), use_kernels=False)
    assert tmoe.buffer_rows(capacity, T) == tmoe.buffer_rows(TINY, T) == T
    want, _ = tmoe.moe_apply(p, x, capacity)
    for use_kernels in (False, True):
        got, aux = tmoe.moe_apply(p, x, TINY.replace(use_kernels=use_kernels))
        assert aux is None
        assert torch.equal(got, want), use_kernels


def test_counts_out_holds_the_tokens_per_expert():
    m = TINY.moe
    p = _moe_layer(TINY)
    x = torch.randn(2, 9, TINY.d_model, generator=torch.Generator().manual_seed(4))
    out = torch.full((m.n_experts,), -1, dtype=torch.int32)
    y, _ = tmoe.moe_apply(p, x, TINY, counts_out=out)
    logits = x.reshape(18, -1) @ p["router"]
    _, idx = tmoe.select_experts(logits, p["bias"], m)
    assert torch.equal(out, torch.bincount(idx.flatten(), minlength=m.n_experts).int())
    y2, _ = tmoe.moe_apply(p, x, TINY)
    assert torch.equal(y, y2)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_dead_rows_are_routed_to_no_expert(use_kernels):
    """A row outside ``live`` (a free serving slot) adds no assignment to the
    counts and gets no routed output (the shared experts' alone); the live
    rows get what a batch of them alone gets, bit for bit."""
    m = TINY.moe
    cfg = TINY.replace(use_kernels=use_kernels)
    p = _moe_layer(TINY)
    x = torch.randn(6, 1, TINY.d_model, generator=torch.Generator().manual_seed(6))
    live = torch.tensor([True, False, True, True, False, False])
    out = torch.full((m.n_experts,), -1, dtype=torch.int32)
    y, _ = tmoe.moe_apply(p, x, cfg, counts_out=out, live=live)
    alone = torch.full((m.n_experts,), -1, dtype=torch.int32)
    want, _ = tmoe.moe_apply(p, x[live], cfg, counts_out=alone)
    assert torch.equal(out, alone) and int(out.sum()) == 3 * m.top_k
    assert torch.equal(y[live], want)
    h = x.reshape(6, -1)
    shared = tmoe.activate(h @ p["shared_gate"], h @ p["shared_in"], "swiglu") @ p["shared_out"]
    assert torch.equal(y.reshape(6, -1)[~live], shared[~live])
    with pytest.raises(ValueError):
        tmoe.moe_apply(p, x, cfg.replace(moe=dataclasses.replace(m, dropless=False)), live=live)


def test_select_experts_is_deepseek_v3s_router():
    """Selection by score + bias, weights the bare sigmoid scores over
    their sum, times the routed scale."""
    m = TINY.moe
    logits = torch.tensor([[0.0, 2.0, 1.0, -1.0, 0.5, 0.1, 0.2, 0.3]])
    bias = torch.tensor([0.0, 0.0, 0.0, 5.0, 0.0, 0.0, 0.0, 0.0])
    w, idx = tmoe.select_experts(logits, bias, m)
    assert idx.tolist() == [[3, 1]]                # the bias lifts expert 3 first
    s = torch.sigmoid(logits[0, [3, 1]])
    torch.testing.assert_close(w[0], s / s.sum() * 2.446)


@pytest.mark.parametrize("arch", sorted(a for a in ARCHS
                                        if get_smoke_config(a).family == "moe"))
def test_defaults_leave_the_registry_moe_unchanged(arch):
    """A registry MoE config holds the reference's plain ``MoEConfig`` (its
    fields and ``asdict`` the reference's); a ``DeepSeekMoEConfig`` made of
    those fields alone is one; and its layer computes what the softmax
    router and capacity dispatch compute, bit for bit, with the same aux."""
    cfg = get_smoke_config(arch).replace(param_dtype="float32", compute_dtype="float32")
    assert type(cfg.moe) is MoEConfig and cfg.mla is None and cfg.first_dense_layers == 0
    assert DeepSeekMoEConfig(**dataclasses.asdict(cfg.moe)) == cfg.moe
    m = cfg.moe
    p = _moe_layer(cfg, 1)
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator().manual_seed(2))
    y, aux = tmoe.moe_apply(p, x, cfg)
    xt = x.reshape(16, -1)
    logits = xt @ p["router"]
    w, idx = tmoe.router_topk(logits, m.top_k)
    C = int(np.ceil(16 * m.top_k / m.n_experts * m.capacity_factor))
    want = tmoe._dispatch_combine(p, xt, w, idx, C, cfg)
    if m.n_shared_experts:
        want = want + (tmoe.activate(xt @ p["shared_gate"], xt @ p["shared_in"], "swiglu")
                       @ p["shared_out"])
    assert torch.equal(y.reshape(16, -1), want)
    counts = torch.bincount(idx.flatten(), minlength=m.n_experts).float()
    probs = torch.softmax(logits, -1).mean(0)
    torch.testing.assert_close(aux, m.n_experts * (counts / (16 * m.top_k) * probs).sum())


def test_grouped_matmul_counts_on_the_plain_route():
    """K6's wrapper on CPU tensors takes ``counts``: the counted rows are
    the plain product's, whatever the rows past a count hold (NaN here),
    and those rows come back zero."""
    E, C, D, F = 4, 6, 16, 8
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(E, C, D, generator=gen)
    w = torch.randn(E, D, F, generator=gen)
    counts = torch.tensor([0, 6, 2, 5], dtype=torch.int32)
    rows = torch.arange(C)[None, :, None]
    counted = rows < counts[:, None, None]
    out = expert_ffn_matmul(torch.where(counted, x, float("nan")), w, counts=counts)
    want = grouped_matmul_ref(x, w)
    assert torch.equal(out[counted.expand(E, C, F)], want[counted.expand(E, C, F)])
    assert not out[~counted.expand(E, C, F)].any()
    assert torch.equal(expert_ffn_matmul(x, w), want)


def test_expert_counters_round_to_k6s_row_tiles():
    """On the card the counted rows round up to the path's row tile (64 on
    the tensor-core path, 1 on the small-C path); the plain route computes
    every row of the buffer; capacity cuts the real rows."""
    counts = np.array([[3, 0, 70, 1], [0, 0, 0, 100]])
    cfg = TINY.replace(param_dtype="bfloat16", compute_dtype="bfloat16",
                       moe=dataclasses.replace(TINY.moe, n_experts=4))
    card, cpu = torch.device("cuda"), torch.device("cpu")
    assert tmoe.expert_counters(counts, 100, cfg, card) == (2, 4, 174, 64 + 128 + 64 + 128)
    assert tmoe.expert_counters(counts, 100, cfg, cpu) == (2, 4, 174, 2 * 4 * 100)
    assert tmoe.expert_counters(counts[:1, :], 8, cfg, card) == (1, 3, 12, 3 + 8 + 1)
    capped = cfg.replace(moe=dataclasses.replace(cfg.moe, dropless=False, capacity_factor=1.0))
    C = tmoe.buffer_rows(capped, 100)                        # 50
    assert tmoe.expert_counters(counts, 100, capped, card) == (2, 4, 3 + 50 + 1 + 50, 8 * C)
