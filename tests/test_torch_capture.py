"""What the captured decode step (``serve/graph.py``) needs of the port, held
on the CPU: ``decode_step`` gives the same bits whether ``pos`` is an int, a
0-dim tensor or a [B] tensor, and one decode step reads nothing back to the
host (no ``aten._local_scalar_dense``), for every served family; a CPU engine
decodes eagerly; and the BOTS fib leaf's busy loop (``csrc/busy_loop.cu``'s
plain version) against a numpy loop."""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import _build
from repro_torch.kernels.busy_loop.ref import (ADD, LANES, MUL, busy_iters,
                                               busy_loop_ref, fib_f32,
                                               fib_subtree_ref)
from repro_torch.models import Model
from repro_torch.models.layers import dtype_of
from repro_torch.serve import Request, ServeConfig, ServeEngine
from repro_torch.serve.graph import CapturedStep

torch.set_num_threads(1)      # six test workers share the CPU

# every family the engine serves (tests/test_torch_serve.py, and the ssm and
# hybrid families in test_torch_ssm.py), with the frontend lengths that
# test_torch_serve.py gives the vlm and enc-dec models
SERVED = ("minitron-4b", "qwen2-72b", "gemma3-4b", "kimi-k2-1t-a32b",
          "moonshot-v1-16b-a3b", "internvl2-2b", "seamless-m4t-large-v2",
          "zamba2-2.7b", "mamba2-130m")
FRONTEND = {"internvl2-2b": 8, "seamless-m4t-large-v2": 4}
UNMASKABLE = ("zamba2-2.7b", "mamba2-130m")     # state scans take no pad mask
B, S, MAX_LEN = 3, 6, 24


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [] if tree is None else [tree]


def _clone(tree):
    if isinstance(tree, tuple):
        return tuple(_clone(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return None if tree is None else tree.clone()


def _prefilled(arch: str, use_kernels: bool = False, masked: bool = False):
    """A smoke model after one prefill of B prompts, with zero frontend
    embeddings as the engine stubs them: (model, params, cache, pos, next
    token, pad widths or None, pad offset)."""
    model = Model(get_smoke_config(arch).replace(use_kernels=use_kernels))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    cfg = model.cfg
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (B, S)).astype(np.int32))
    batch = {"tokens": toks}
    front = FRONTEND.get(arch, 0)
    if front:
        batch["enc_embeds" if cfg.is_encdec else "embeds"] = torch.zeros(
            B, front, cfg.d_model, dtype=dtype_of(cfg.compute_dtype))
    pw = torch.tensor([0, 2, 5], dtype=torch.int32) if masked else None
    logits, cache, pos = model.prefill(params, batch, cache_len=MAX_LEN, pad_width=pw)
    tok = torch.argmax(logits[:, -1].float(), dim=-1).to(torch.int32)[:, None]
    offset = 0 if cfg.is_encdec else front
    return model, params, cache, pos, tok, pw, offset


CASES = [(arch, False, False) for arch in SERVED] + [
    ("minitron-4b", True, False), ("minitron-4b", False, True),
    ("minitron-4b", True, True), ("moonshot-v1-16b-a3b", True, False),
    ("zamba2-2.7b", True, False), ("gemma3-4b", True, True),
    ("internvl2-2b", False, True), ("seamless-m4t-large-v2", True, True)]


@pytest.mark.parametrize("arch,use_kernels,masked", CASES)
def test_decode_step_gives_the_same_bits_for_every_pos_form(arch, use_kernels, masked):
    """Two decode steps from one prefill with ``pos`` as an int, a 0-dim
    tensor and a [B] tensor: logits and every cache leaf equal bit for bit
    (the kernel route runs the kernels' plain versions here; ``masked``
    continues a pad-masked prefill)."""
    model, params, cache, pos, tok, pw, offset = _prefilled(arch, use_kernels, masked)
    forms = {"int": lambda p: p, "0-dim": lambda p: torch.tensor(p, dtype=torch.int32),
             "[B]": lambda p: torch.full((B,), p, dtype=torch.int32)}
    got = {}
    for name, form in forms.items():
        c, t, outs = _clone(cache), tok, []
        for step in range(2):
            logits, c = model.decode_step(params, t, c, form(pos + step), pad_width=pw,
                                          pad_offset=offset)
            outs.append(logits)
            t = torch.argmax(logits[:, -1].float(), dim=-1).to(torch.int32)[:, None]
        got[name] = outs + _leaves(c)
    for name in ("0-dim", "[B]"):
        assert len(got[name]) == len(got["int"])
        for a, b in zip(got[name], got["int"]):
            assert a.dtype == b.dtype and torch.equal(a, b), name


class _Ops(TorchDispatchMode):
    """Records the name of every aten op dispatched."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", SERVED)
@pytest.mark.parametrize("masked", [False, True])
def test_decode_step_reads_nothing_back_to_the_host(arch, masked):
    """One decode step of each served family, with ``pos`` and the pad
    widths as the engine passes them ([B] tensors), calls no
    ``aten._local_scalar_dense`` (a read of a tensor's value on the host,
    which would fail a CUDA graph's capture)."""
    masked = masked and arch not in UNMASKABLE
    model, params, cache, pos, tok, pw, offset = _prefilled(arch, masked=masked)
    posv = torch.full((B,), pos, dtype=torch.int32)
    with _Ops() as ops:
        logits, _ = model.decode_step(params, tok, cache, posv, pad_width=pw,
                                      pad_offset=offset)
    assert ops.names and torch.isfinite(logits.float()).all()
    reads = [n for n in ops.names if "_local_scalar_dense" in n or n.startswith("aten.item")]
    assert reads == []


def test_cpu_engine_decodes_eagerly():
    """A CPU engine never captures (the eager keyword is moot there), and a
    captured step refuses a device that is not a card."""
    model = Model(get_smoke_config("minitron-4b"))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    reqs = [Request(i, [3 + i, 4, 5], max_new_tokens=4) for i in range(3)]
    for mode in ("continuous", "wave"):
        eng = ServeEngine(model, params, ServeConfig(batch=2, max_len=16, mode=mode),
                          device="cpu")
        out = eng.serve(reqs)
        assert all(len(r.tokens) == 4 for r in out.values())
        stats = eng.graph_stats
        assert stats["decodes"] > 0 and stats["graphs"] == stats["replays"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        CapturedStep(lambda: None, torch.device("cpu"))


def test_launch_counts_taken_out_and_added_back():
    """The bookkeeping a captured step does with the launch counters: the
    change over a span, taken out, then added once per replay."""
    a, b = _build.LaunchCounter(), _build.LaunchCounter()
    before = _build.launch_counts()
    a.add()
    a.add()
    b.add()
    delta = _build.counts_since(before)
    assert delta == {a: 2, b: 1}
    _build.add_counts(delta, -1)
    assert (a.count, b.count) == (0, 0)
    for _ in range(3):
        _build.add_counts(delta)
    assert (a.count, b.count) == (6, 3)


# ---------------------------------------------------------------------------
# the BOTS fib leaf's busy loop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("iters", [0, 1, 7, 5000])
def test_busy_loop_plain_version_matches_a_numpy_loop(iters):
    acc = np.ones(LANES, np.float32)
    for _ in range(iters):
        acc = acc * np.float32(MUL) + np.float32(ADD)
    assert acc.dtype == np.float32
    np.testing.assert_array_equal(busy_loop_ref(iters).numpy(), acc)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 8, 9])
def test_fib_leaf_plain_version(n):
    """fib(n) exactly, after (2 fib(n) - 1) * 600 busy steps."""
    fib = [0, 1]
    while len(fib) <= n:
        fib.append(fib[-1] + fib[-2])
    out, acc = fib_subtree_ref(torch.tensor(n, dtype=torch.int32))
    assert out.dtype == torch.float32 and float(out) == fib[n] == float(fib_f32(n))
    assert busy_iters(fib_f32(n)) == (2 * fib[n] - 1) * 600
    assert torch.equal(acc, busy_loop_ref(max(busy_iters(fib_f32(n)), 0)))
