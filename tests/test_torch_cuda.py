"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the BOTS workloads and the LM server (dense, MoE, SSM and
hybrid; its decode steps captured as CUDA graphs, against the eager route)
launching them end to end; the peer fabric (SEND/RECV between the virtual
devices' streams, the data-parallel fabrics) with the block-int8 wire
kernel; and recovery under seeded faults (chaos sparselu).

Every test here needs a card and is marked ``cuda``; whether a card is
present is decided inside the fixture, so every worker collects the same
tests and they skip without one.  This file imports neither JAX nor the
reference package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch import comm_modes as cm
from repro_torch import perf_gate as tpg
from repro_torch import run as trun
from repro_torch import serve_load as tsl
from repro_torch.bots import alignment as tba
from repro_torch.bots import fib as tbf
from repro_torch.bots import mandelbrot as tbm
from repro_torch.bots import sparselu as tbl
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.block_lu import block_lu as k2
from repro_torch.kernels.block_lu.ops import bmod_op
from repro_torch.kernels.block_lu.block_lu import bmod_cuda
from repro_torch.kernels.block_lu.ref import bmod_ref
from repro_torch.kernels.busy_loop import busy_loop as kb
from repro_torch.kernels.busy_loop.ops import fib_subtree
from repro_torch.kernels.busy_loop.ref import fib_subtree_ref
from repro_torch.kernels.flash_attention import flash_attention as k4
from repro_torch.kernels.flash_attention.ops import gqa_flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.flash_decode import flash_decode as k3
from repro_torch.kernels.flash_decode.ops import gqa_flash_decode
from repro_torch.kernels.flash_decode.flash_decode import (decode_path, flash_decode_cuda,
                                                           split_plan)
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.kernels.grouped_matmul import grouped_matmul as k6
from repro_torch.kernels.grouped_matmul.ops import expert_ffn_matmul
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref
from repro_torch.core import (ClusterRuntime, DevicePool, KernelTable, MapSpec,
                               RuntimeConfig, TargetExecutor, TensorSpec)
from repro_torch.kernels.mandelbrot import mandelbrot as k1
from repro_torch.kernels.mandelbrot.ops import mandelbrot_rows
from repro_torch.kernels.mandelbrot.ref import mandelbrot_rows_ref
from repro_torch.kernels.q8_wire import q8_wire as kq
from repro_torch.kernels.q8_wire.ops import q8_roundtrip
from repro_torch.kernels.q8_wire.ref import q8_roundtrip_ref
from repro_torch.kernels.ssd_scan import ssd_scan as k5
from repro_torch.kernels.ssd_scan.ops import ssd_chunked_scan
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_cluster_ref
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_path, ssd_plan, ssd_scan_cuda
from repro_torch.models import Model
from repro_torch.models.moe import moe_apply
from repro_torch.serve import Request, ServeConfig, ServeEngine
from repro_torch.configs import get_config
from repro_torch.core import _tree
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.train import make_train_step

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)      # six test workers share the CPU


@pytest.fixture
def cuda_device():
    """The card, decided at run time; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    torch.backends.cuda.matmul.allow_tf32 = False   # full-fp32 plain versions
    return torch.device("cuda", 0)


def test_mandelbrot_cuda_matches_plain(cuda_device):
    rows = torch.arange(5, 301, 3, dtype=torch.int32, device=cuda_device)
    before = k1.launches.count
    out = mandelbrot_rows(rows, 257, 320, 120)
    torch.cuda.synchronize()
    assert k1.launches.count == before + 1
    assert torch.equal(out, mandelbrot_rows_ref(rows, 257, 320, 120))


@pytest.mark.parametrize("rows,width,total", [(range(21, 58), 97, 80),
                                              (range(2290, 2311), 4600, 4600),
                                              (range(517, 600), 1000, 1200)])
def test_mandelbrot_cuda_chunked_ragged_bit_for_bit(cuda_device, rows, width, total):
    """Against the plain version, bit for bit: max_iter 0, 1, around the
    chunk and off 300; widths not a multiple of 32; strips that start
    mid-image, one of them the band around cy = 0 of the main path's
    4600 x 4600 image (c near -2 on its left edge).  Every launch is on the
    chunked path, and a second call gives the same bits."""
    k = k1.CHUNK
    rows = torch.tensor(list(rows), dtype=torch.int32, device=cuda_device)
    before = (k1.launches.count, k1.path_launches["chunked"].count)
    calls = 0
    for max_iter in (0, 1, k - 1, k, k + 1, 299, 301):
        out = k1.mandelbrot_rows_cuda(rows, width, total, max_iter)
        again = k1.mandelbrot_rows_cuda(rows, width, total, max_iter)
        calls += 2
        plain = mandelbrot_rows_ref(rows, width, total, max_iter)
        assert torch.equal(out, plain), (width, max_iter, int((out != plain).sum()))
        assert torch.equal(out, again)
    assert (k1.launches.count, k1.path_launches["chunked"].count) == \
        (before[0] + calls, before[1] + calls)


def test_declare_target_global_region_on_the_card_equals_cpu(cuda_device):
    """A global installed after a pinned buffer (device 0's handle shifts),
    bound by regions on every virtual device, re-installed: the card's
    outputs, handles and bytes equal the same run's on the CPU."""
    g0 = np.random.default_rng(0).standard_normal(64).astype(np.float32)

    def run(device):
        table = KernelTable()

        @table.kernel("use_global")
        def use_global(g, x):
            return {"out": g + x}

        pool = DevicePool.virtual(3, table=table, device=device)
        ex = TargetExecutor(pool)
        try:
            ex.ensure_resident(0, keep=torch.ones(4))
            outs = []
            for scale in (1.0, 3.0):            # install, then re-install
                pool.install_global("g", torch.from_numpy(g0 * scale))
                for d in range(3):
                    outs.append(ex.target("use_global", d, MapSpec(
                        to={"x": torch.full((64,), float(d))},
                        from_={"out": TensorSpec((64,), torch.float32)},
                        use_globals=("g",)))["out"].cpu())
            s = pool.cost.summary()
            return outs, dict(pool.globals["g"]), (s["bytes_to"], s["bytes_from"])
        finally:
            pool.stop_all()

    card, host = run(cuda_device), run("cpu")
    assert card[1:] == host[1:]
    assert card[1][0] != card[1][1]
    for a, b in zip(card[0], host[0]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("M,N,K", [(128, 128, 128), (96, 96, 96), (200, 72, 136),
                                   (64, 64, 64)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 4e-2)])
def test_bmod_cuda_matches_plain(cuda_device, M, N, K, dtype, tol):
    rng = np.random.default_rng(M * N + K)
    a, l, u = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda_device, dtype) for s in ((M, N), (M, K), (K, N)))
    before = k2.launches.count
    out = bmod_op(a, l, u)
    torch.cuda.synchronize()
    assert k2.launches.count == before + 1
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), bmod_ref(a, l, u).float(),
                               rtol=tol, atol=tol)


def _bmod_inputs(device, M, N, K, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device, dtype)
            for s in ((M, N), (M, K), (K, N))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bmod_cuda_paths_and_determinism(cuda_device, dtype):
    """B = 128 runs 16 CTAs on the cp.async path; an operand whose rows are
    not whole 16-byte chunks takes the elementwise path and agrees with the
    plain version; two calls give the same bits."""
    a, l, u = _bmod_inputs(cuda_device, 128, 128, 128, dtype)
    assert k2.bmod_path(l, u) == "cp_async"
    before = k2.path_launches["cp_async"].count
    first, second = bmod_cuda(a, l, u), bmod_cuda(a, l, u)
    torch.cuda.synchronize()
    assert k2.path_launches["cp_async"].count == before + 2
    assert torch.equal(first, second)
    a, l, u = _bmod_inputs(cuda_device, 37, 29, 13, dtype, seed=1)
    assert k2.bmod_path(l, u) == "elementwise"
    before = k2.path_launches["elementwise"].count
    out = bmod_cuda(a, l, u)
    torch.cuda.synchronize()
    assert k2.path_launches["elementwise"].count == before + 1
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), bmod_ref(a, l, u).float(), rtol=tol, atol=tol)


def test_bmod_cuda_is_bitwise_equal_across_streams_and_threads(cuda_device):
    """Two worker threads, each launching on its own stream at once (as two
    virtual devices do), get the bits of a launch on the default stream."""
    import threading
    a, l, u = _bmod_inputs(cuda_device, 128, 128, 128, torch.float32, seed=2)
    want = bmod_cuda(a, l, u)
    torch.cuda.synchronize()
    got, barrier = {}, threading.Barrier(2)

    def work(i):
        stream = torch.cuda.Stream(cuda_device)
        with torch.cuda.stream(stream):
            barrier.wait()
            outs = [bmod_cuda(a, l, u) for _ in range(50)]
        stream.synchronize()
        got[i] = outs

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(torch.equal(o, want) for outs in got.values() for o in outs)


def test_bots_verify_on_card(cuda_device):
    before = (k1.launches.count, k2.launches.count)
    assert tbm.verify("small", n_devices=4, device="cuda") == (0, 0.0)
    assert tbl.verify("large", n_devices=4, device="cuda") == 0.0
    assert k1.launches.count > before[0] and k2.launches.count > before[1]


# ---------------------------------------------------------------------------
# K4 flash attention and K3 flash decode
# ---------------------------------------------------------------------------
TOL = {torch.float32: 1e-4, torch.bfloat16: 4e-2}


def _rand(rng, shape, device, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)


@pytest.mark.parametrize("Sq,d,window", [(512, 128, 0), (512, 128, 128), (200, 128, 0),
                                         (96, 64, 0), (130, 256, 48), (512, 80, 0),
                                         (200, 80, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_cuda_matches_plain(cuda_device, Sq, d, window, dtype):
    """Model layout in, the plain version in the kernel's layout as the
    reference; r = 3 query heads per kv head."""
    rng = np.random.default_rng(Sq + d + window)
    B, K, r = 2, 2, 3
    q = _rand(rng, (B, Sq, K * r, d), cuda_device, dtype)
    k = _rand(rng, (B, Sq, K, d), cuda_device, dtype)
    v = _rand(rng, (B, Sq, K, d), cuda_device, dtype)
    path = "wgmma" if dtype == torch.bfloat16 and d != 256 else "cuda_core"
    before = k4.launches.count, k4.path_launches[path].count
    out = gqa_flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert (k4.launches.count, k4.path_launches[path].count) == (before[0] + 1, before[1] + 1)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), _attention_ref(q, k, v, window).float(),
                               rtol=tol, atol=tol)


def _attention_ref(q, k, v, window):
    """The plain version, run in the kernels' (batch·kv head, group) layout
    and returned in the model layout."""
    B, Sq, H, d = q.shape
    K = k.shape[2]
    r = H // K
    qk = q.reshape(B, Sq, K, r, d).permute(0, 2, 3, 1, 4).reshape(B * K, r, Sq, d)
    kk = k.permute(0, 2, 1, 3).reshape(B * K, -1, d)
    vk = v.permute(0, 2, 1, 3).reshape(B * K, -1, d)
    ref = flash_attention_ref(qk, kk, vk, causal=True, window=window)
    return ref.reshape(B, K, r, Sq, d).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, d)


# the edges of K4's tiles at every head dim, window and group, then the
# unpadded prefill lengths of minitron-4b.chat's prompts (d = 128, 24 heads
# over 8): a prime near the median and the clip
WGMMA_CASES = [(Sq, d, window, r) for r in (1, 3) for window in (0, 48, 128)
               for d in (64, 80, 128) for Sq in (1, 63, 64, 65, 127, 129, 200, 512)] + [
    (1021, 128, 0, 3), (2048, 128, 0, 3)]


@pytest.mark.parametrize("Sq,d,window,r", WGMMA_CASES,
                         ids=[f"{r}-{w}-{d}-{Sq}" for Sq, d, w, r in WGMMA_CASES])
def test_flash_attention_wgmma_matches_plain(cuda_device, Sq, d, window, r):
    """K4's tensor-core path (bf16) over the edges of its tiles: query
    lengths around the 64-row warpgroup and the 128-row CTA, windows shorter
    and longer than a 64-key stage, GQA groups of 1 and 3; and at the
    lengths a served chat prompt prefills unpadded."""
    rng = np.random.default_rng(Sq * 7 + d + window + r)
    B, K = 2, 2
    q = _rand(rng, (B, Sq, K * r, d), cuda_device, torch.bfloat16)
    k = _rand(rng, (B, Sq, K, d), cuda_device, torch.bfloat16)
    v = _rand(rng, (B, Sq, K, d), cuda_device, torch.bfloat16)
    before = k4.path_launches["wgmma"].count
    out = gqa_flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert k4.path_launches["wgmma"].count == before + 1
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), _attention_ref(q, k, v, window).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [80, 128])
def test_flash_attention_wgmma_reads_fused_projection_views(cuda_device, d):
    """q, k, v as strided views of one fused [B, S, (H + 2K)·d] projection,
    read in place by the tensor maps."""
    rng = np.random.default_rng(d)
    B, S, H, K = 2, 200, 6, 2
    qkv = _rand(rng, (B, S, (H + 2 * K) * d), cuda_device, torch.bfloat16)
    q, k, v = (t.unflatten(-1, (-1, d)) for t in qkv.split([H * d, K * d, K * d], -1))
    assert not q.is_contiguous()
    before = k4.path_launches["wgmma"].count
    out = gqa_flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert k4.path_launches["wgmma"].count == before + 1
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), _attention_ref(q, k, v, 0).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_cuda_matches_plain(cuda_device, d, dtype):
    """Per-row kv_len from 0 (the mean of every value row) to past S."""
    rng = np.random.default_rng(d)
    B, S, K, r = 6, 300, 2, 3
    q = _rand(rng, (B, 1, K * r, d), cuda_device, dtype)
    kc = _rand(rng, (B, S, K, d), cuda_device, dtype)
    vc = _rand(rng, (B, S, K, d), cuda_device, dtype)
    lens = torch.tensor([0, 1, 63, 64, 299, 300], dtype=torch.int32, device=cuda_device)
    before = k3.launches.count
    out = gqa_flash_decode(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert k3.launches.count == before + 1
    ref = flash_decode_ref(q.reshape(B * K, r, d),
                           kc.permute(0, 2, 1, 3).reshape(B * K, S, d),
                           vc.permute(0, 2, 1, 3).reshape(B * K, S, d),
                           lens[:, None].expand(B, K).reshape(B * K)).reshape(B, 1, K * r, d)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


# the serve paths' decode shapes (B, K, r, d) over a 1024-row cache:
# minitron-4b, moonshot-v1-16b-a3b, zamba2-2.7b's shared block
DECODE_SERVE = {"minitron": (4, 8, 3, 128), "moonshot": (4, 16, 1, 128), "zamba2": (4, 32, 1, 80)}


def _decode_ref(q, kc, vc, lens):
    """The plain version on the model layout: q [B, H, d], caches [B, S, K, d]."""
    B, H, d = q.shape
    S, K = kc.shape[1], kc.shape[2]
    return flash_decode_ref(q.reshape(B * K, H // K, d),
                            kc.permute(0, 2, 1, 3).reshape(B * K, S, d),
                            vc.permute(0, 2, 1, 3).reshape(B * K, S, d),
                            lens[:, None].expand(B, K).reshape(B * K)).reshape(B, H, d)


@pytest.mark.parametrize("shape", list(DECODE_SERVE), ids=str)
@pytest.mark.parametrize("n_split", [None, 1, 2, 16])
def test_flash_decode_split_matches_plain_at_serve_shapes(cuda_device, shape, n_split):
    """bf16 at each serve shape, split as the launcher picks (more than one
    split each) and at other counts; per-sequence kv_len 0, mid-split, a
    split boundary and the whole cache."""
    B, K, r, d = DECODE_SERVE[shape]
    S = 1024
    rng = np.random.default_rng(K * r + d)
    q = _rand(rng, (B, K * r, d), cuda_device, torch.bfloat16)
    kc, vc = (_rand(rng, (B, S, K, d), cuda_device, torch.bfloat16) for _ in range(2))
    n, rows = split_plan(B * K, S, torch.cuda.get_device_properties(0).multi_processor_count,
                         n_split)
    if n_split is None:
        assert n > 1 and decode_path(q, kc) == "split"
    lens = torch.tensor([0, rows // 2 + 1, rows, S], dtype=torch.int32, device=cuda_device)
    path = "split" if n > 1 else "single"
    before = k3.path_launches[path].count
    out = flash_decode_cuda(q, kc, vc, lens, n_split=n_split)
    torch.cuda.synchronize()
    assert k3.path_launches[path].count == before + 1
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), _decode_ref(q, kc, vc, lens).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_split_edges_and_large_groups(cuda_device, dtype):
    """kv_len on each side of every split boundary, 0 and past S; r = 16 at
    d = 256 and r = 5 at d = 64 (the wide-group kernel)."""
    tol = TOL[dtype]
    for (K, r, d) in ((1, 16, 256), (2, 5, 64)):
        S = 512
        rng = np.random.default_rng(r * d)
        n, rows = split_plan(1, S, 132, 4)
        lens_list = [0, 1, S, S + 7] + [b + o for b in range(rows, S, rows) for o in (-1, 0, 1)]
        B = len(lens_list)
        q = _rand(rng, (B, K * r, d), cuda_device, dtype)
        kc, vc = (_rand(rng, (B, S, K, d), cuda_device, dtype) for _ in range(2))
        lens = torch.tensor(lens_list, dtype=torch.int32, device=cuda_device)
        for n_split in (None, 4):
            out = flash_decode_cuda(q, kc, vc, lens, n_split=n_split)
            torch.cuda.synchronize()
            torch.testing.assert_close(out.float(), _decode_ref(q, kc, vc, lens).float(),
                                       rtol=tol, atol=tol)


def test_flash_decode_reads_strided_cache_views_and_repeats_bitwise(cuda_device):
    """K and V as views of one [B, S, 2, K, d] buffer (strided rows), and a
    cache longer than the live rows; two calls give the same bits."""
    B, K, r, d, S = 4, 8, 3, 128, 1000
    rng = np.random.default_rng(5)
    kv = _rand(rng, (B, S, 2, K, d), cuda_device, torch.bfloat16)
    kc, vc = kv[:, :, 0], kv[:, :, 1]
    assert not kc.is_contiguous()
    q = _rand(rng, (B, K * r, d), cuda_device, torch.bfloat16)
    lens = torch.tensor([3, 500, 999, 1000], dtype=torch.int32, device=cuda_device)
    first = flash_decode_cuda(q, kc, vc, lens)
    second = flash_decode_cuda(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(first.float(), _decode_ref(q, kc, vc, lens).float(),
                               rtol=tol, atol=tol)


def test_flash_decode_replays_from_a_cuda_graph(cuda_device):
    """The decode call captured once (its workspace from the graph's pool)
    and replayed after kv_len and the query change in place on the card
    gives an eager call's bits: nothing of the call was read on the host."""
    B, K, r, d, S = 4, 8, 3, 128, 1024
    rng = np.random.default_rng(6)
    q = _rand(rng, (B, K * r, d), cuda_device, torch.bfloat16)
    kc, vc = (_rand(rng, (B, S, K, d), cuda_device, torch.bfloat16) for _ in range(2))
    lens = torch.tensor([1, 64, 700, 1024], dtype=torch.int32, device=cuda_device)
    flash_decode_cuda(q, kc, vc, lens)               # build and load outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_decode_cuda(q, kc, vc, lens)
    for new_lens in ([1024, 0, 129, 5], [300, 301, 128, 127]):
        lens.copy_(torch.tensor(new_lens, dtype=torch.int32))
        q.copy_(_rand(rng, (B, K * r, d), cuda_device, torch.bfloat16))
        graph.replay()
        eager = flash_decode_cuda(q, kc, vc, lens)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def test_attention_kernels_refuse_unsupported_head_dim(cuda_device):
    q = torch.zeros(1, 8, 3, 96, device=cuda_device)
    k = torch.zeros(1, 8, 1, 96, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        gqa_flash_attention(q, k, k)
    with pytest.raises(ValueError, match="head dim"):
        gqa_flash_decode(q[:, :1], k, k, 4)


def test_two_layer_serve_launches_both_kernels(cuda_device):
    """A 2-layer model (head dim 64, r = 3) served in wave mode with equal
    prompts: one prefill (K4 per layer) and budget-1 decodes (K3 per
    layer); its fp32 tokens equal the plain route's."""
    cfg = get_smoke_config("minitron-4b").replace(
        n_heads=6, n_kv=2, d_head=64, param_dtype="float32", compute_dtype="float32")
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(1, cfg.vocab, 16).tolist(), max_new_tokens=8)
            for i in range(3)]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = Model(cfg).init(gen)
    tokens = {}
    for use in (True, False):
        model = Model(cfg.replace(use_kernels=use))
        before = (k4.launches.count, k3.launches.count)
        eng = ServeEngine(model, params, ServeConfig(batch=3, max_len=32, mode="wave"))
        tokens[use] = {rid: r.tokens for rid, r in eng.serve(reqs).items()}
        launched = (k4.launches.count - before[0], k3.launches.count - before[1])
        assert launched == ((2, 2 * 7) if use else (0, 0))
    assert tokens[True] == tokens[False]
    assert all(len(t) == 8 for t in tokens[True].values())


def test_continuous_kernel_route_prefills_on_wgmma_and_decodes_unmasked(cuda_device):
    """A 2-layer bf16 model (head dim 128, r = 3) served continuously with
    ragged prompts: each prefill group (one per length) runs K4 on wgmma in
    both layers, no decode signature is pad-masked, and the captured
    route's tokens equal the eager route's."""
    cfg = get_smoke_config("minitron-4b").replace(
        n_heads=6, n_kv=2, d_head=128, param_dtype="bfloat16",
        compute_dtype="bfloat16", use_kernels=True)
    rng = np.random.default_rng(3)
    lens = (16, 13, 21, 13, 9)
    reqs = [Request(i, rng.integers(1, cfg.vocab, L).tolist(), max_new_tokens=6)
            for i, L in enumerate(lens)]
    params = Model(cfg).init(torch.Generator(device=cuda_device).manual_seed(0))
    tokens = {}
    for eager in (True, False):
        eng = ServeEngine(Model(cfg), params, ServeConfig(batch=3, max_len=48),
                          eager=eager)
        groups = []
        split = eng._prefill_groups
        eng._prefill_groups = lambda admits: groups.extend(split(admits)) or split(admits)
        before = k4.path_launches["wgmma"].count, k4.launches.count
        tokens[eager] = {rid: r.tokens for rid, r in eng.serve(reqs).items()}
        torch.cuda.synchronize()
        assert (k4.path_launches["wgmma"].count - before[0],
                k4.launches.count - before[1]) == (2 * len(groups),) * 2
        assert len(groups) == len(lens)
        assert all(S == len(r.prompt) for m, S in groups for r, _ in m)
        if not eager:
            assert eng._graphs and not any(key[-1] for key in eng._graphs)
    assert tokens[True] == tokens[False]
    assert all(len(t) == 6 for t in tokens[True].values())


@pytest.mark.parametrize("E,C,D,F", [(64, 240, 2048, 1408), (64, 1, 2048, 1408),
                                     (64, 240, 1408, 2048), (3, 3, 96, 100)])
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-4, 1e-3),
                                             (torch.bfloat16, 3e-2, 3e-1)])
def test_grouped_matmul_cuda_matches_plain(cuda_device, E, C, D, F, dtype, rtol, atol):
    """K6 at the moonshot serve path's shapes (prefill C = 240, decode C = 1,
    the down projection) and a ragged one; tolerances of
    ``tests/test_kernels.py:138-140``."""
    gen = torch.Generator(device=cuda_device).manual_seed(E + C + D + F)
    x = torch.randn(E, C, D, generator=gen, device=cuda_device).to(dtype)
    w = torch.randn(E, D, F, generator=gen, device=cuda_device).to(dtype)
    path = ("cuda_core" if dtype == torch.float32 or F % 8 else
            "small_c" if C <= 16 else "wgmma")
    before = k6.launches.count, k6.path_launches[path].count
    out = expert_ffn_matmul(x, w)
    torch.cuda.synchronize()
    assert (k6.launches.count, k6.path_launches[path].count) == (before[0] + 1, before[1] + 1)
    assert out.dtype == dtype and tuple(out.shape) == (E, C, F)
    torch.testing.assert_close(out.float(), grouped_matmul_ref(x, w).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("C", [1, 2, 15, 16, 17, 60, 64, 240, 257])
@pytest.mark.parametrize("empty", ["every third", "all", "all but one"])
def test_grouped_matmul_bf16_paths_with_empty_experts(cuda_device, C, empty):
    """K6 in bf16 on moonshot's gate/up widths with 8 experts, some of whose
    x are all zero: C <= 16 takes the small-C path (which skips an empty
    expert's weights), above it the tensor-core path; both within the
    reference's K6 tolerance."""
    E, D, F = 8, 2048, 1408
    gen = torch.Generator(device=cuda_device).manual_seed(C)
    x = torch.randn(E, C, D, generator=gen, device=cuda_device).to(torch.bfloat16)
    w = torch.randn(E, D, F, generator=gen, device=cuda_device).to(torch.bfloat16)
    if empty == "every third":
        x[::3] = 0
    elif empty == "all":
        x.zero_()
    else:
        x[: E // 2] = 0
        x[E // 2 + 1:] = 0
    path = "small_c" if C <= 16 else "wgmma"
    before = k6.path_launches[path].count
    out = expert_ffn_matmul(x, w)
    torch.cuda.synchronize()
    assert k6.path_launches[path].count == before + 1
    ref = grouped_matmul_ref(x, w)
    torch.testing.assert_close(out.float(), ref.float(), rtol=3e-2, atol=3e-1)
    empty_experts = (x == 0).flatten(1).all(1)
    assert not out[empty_experts].any()


def _routed_counts(gen, T: int, E: int, k: int, device) -> torch.Tensor:
    """Tokens per expert of T tokens that each pick k of E experts at random."""
    idx = torch.rand(T, E, generator=gen, device=device).topk(k, dim=-1).indices
    return torch.bincount(idx.flatten(), minlength=E).to(torch.int32)


@pytest.mark.parametrize("C,D,F,path", [
    (1020, 2048, 1408, "wgmma"), (1020, 1408, 2048, "wgmma"),     # a 1,020-token prefill
    (32, 2048, 1408, "wgmma"), (32, 1408, 2048, "wgmma"),         # 32 slots: C > SMALL_C
    (16, 2048, 1408, "small_c")])
def test_grouped_matmul_counts_match_plain_on_counted_rows(cuda_device, C, D, F, path):
    """K6 with per-expert counts at the moonlight-16b-a3b chat cell's
    shapes (64 experts, top-6, dropless C = T): every counted row equals the
    plain version's, while the rows past each count hold NaN, which no
    counted row may read; the prefill (C = 1,020) and the 32-slot decode
    (C = 32 > SMALL_C = 16) take the tensor-core path, C = 16 the small-C
    path.  Tolerance: the reference's bf16 K6 tolerance."""
    E = 64
    gen = torch.Generator(device=cuda_device).manual_seed(C + D)
    counts = _routed_counts(gen, C, E, 6, cuda_device)
    x = torch.randn(E, C, D, generator=gen, device=cuda_device).to(torch.bfloat16)
    rows = torch.arange(C, device=cuda_device)[None, :, None]
    x = torch.where(rows < counts[:, None, None], x, float("nan")).to(torch.bfloat16)
    w = torch.randn(E, D, F, generator=gen, device=cuda_device).to(torch.bfloat16)
    assert k6.gmm_path(x, w) == path
    before = k6.path_launches[path].count
    out = expert_ffn_matmul(x, w, counts=counts)
    torch.cuda.synchronize()
    assert k6.path_launches[path].count == before + 1
    ref = grouped_matmul_ref(torch.nan_to_num(x), w, counts)
    counted = (rows < counts[:, None, None]).expand(E, C, F)
    torch.testing.assert_close(out.float()[counted], ref.float()[counted],
                               rtol=3e-2, atol=3e-1)


def test_grouped_matmul_counts_capture_in_a_graph(cuda_device):
    """K6 with counts replays from a CUDA graph with new counts written in
    place: the counts are read on the card, not baked in at capture."""
    E, C, D, F = 8, 64, 256, 128
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(E, C, D, generator=gen, device=cuda_device).to(torch.bfloat16)
    w = torch.randn(E, D, F, generator=gen, device=cuda_device).to(torch.bfloat16)
    counts = torch.full((E,), C, dtype=torch.int32, device=cuda_device)
    expert_ffn_matmul(x, w, counts=counts)          # builds and loads the kernel
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = expert_ffn_matmul(x, w, counts=counts)
    new = torch.tensor([0, 1, 5, 64, 17, 0, 63, 2], dtype=torch.int32, device=cuda_device)
    counts.copy_(new)
    out.fill_(7.0)
    graph.replay()
    torch.cuda.synchronize()
    rows = torch.arange(C, device=cuda_device)[None, :, None]
    ref = grouped_matmul_ref(x, w)
    counted = (rows < new[:, None, None]).expand(E, C, F)
    torch.testing.assert_close(out.float()[counted], ref.float()[counted],
                               rtol=3e-2, atol=3e-1)
    assert (out[~counted] == 7.0).all()             # past a count: not written


def test_dropless_moe_routes_live_rows_only_in_a_graph(cuda_device):
    """A dropless MoE layer on K6 (32 rows, C = 32: the tensor-core path)
    captured in a CUDA graph with its live-row mask read on the card: after
    a new mask is written in place and the graph replayed, the counts hold
    the live rows' assignments only, the dead rows get no routed output and
    the live rows what a batch of them alone gets.  Tolerance: the
    reference's bf16 K6 tolerance (the batch alone runs other tiles)."""
    from repro_torch.models import DeepSeekMoEConfig, ModelConfig
    from repro_torch.models import moe as tmoe
    cfg = ModelConfig(name="moe", family="moe", n_layers=1, d_model=256, n_heads=4,
                      n_kv=4, d_ff=256, vocab=64, act="swiglu", param_dtype="bfloat16",
                      compute_dtype="bfloat16", use_kernels=True,
                      moe=DeepSeekMoEConfig(n_experts=8, top_k=2, d_ff_expert=128,
                                            n_shared_experts=2,
                                            scoring="sigmoid", selection_bias=True,
                                            routed_scale=2.446, dropless=True))
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    p = tmoe.moe_init(gen, cfg)
    x = torch.randn(32, 1, 256, generator=gen, device=cuda_device).to(torch.bfloat16)
    live = torch.ones(32, dtype=torch.bool, device=cuda_device)
    counts = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    tmoe.moe_apply(p, x, cfg, counts, live)          # builds and loads the kernel
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, _ = tmoe.moe_apply(p, x, cfg, counts, live)
    new = torch.rand(32, generator=gen, device=cuda_device) < 0.4
    live.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    alone = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    want, _ = tmoe.moe_apply(p, x[new], cfg.replace(use_kernels=False), alone)
    assert torch.equal(counts, alone) and int(counts.sum()) == 2 * int(new.sum())
    torch.testing.assert_close(y[new].float(), want.float(), rtol=3e-2, atol=3e-1)
    h = x.reshape(32, 256)                           # a dead row: the shared experts' alone
    shared = tmoe.activate(h @ p["shared_gate"], h @ p["shared_in"], "swiglu") @ p["shared_out"]
    assert torch.equal(y.reshape(32, 256)[~new], shared[~new])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 4e-2)])
def test_mla_prefill_and_absorbed_decode_on_the_card(cuda_device, dtype, tol):
    """Latent attention at Moonlight-16B-A3B's widths (16 heads, a 512-wide
    latent and a 64-wide rope key, q/k 192, v 128) on the card: a prefill
    of 300 tokens (SDPA held to the memory-efficient backend) and a prefill
    of 292 followed by 8 absorbed decode steps through the latent cache,
    inside a captured graph, give the same outputs at the last 8 positions.
    Tolerances: the float32 path's rounding, and the reference's bf16
    tolerance."""
    from repro_torch.models import DeepSeekMoEConfig, MLAConfig, ModelConfig
    from repro_torch.models.mla import mla_decode, mla_init, mla_prefill
    cfg = ModelConfig(name="mla", family="moe", n_layers=1, d_model=2048, n_heads=16,
                      n_kv=16, d_ff=1024, vocab=64, rope_theta=50000.0,
                      compute_dtype=str(dtype).split(".")[1],
                      moe=DeepSeekMoEConfig(n_experts=2, top_k=1, d_ff_expert=8,
                                            mla=MLAConfig(512, 128, 64, 128)))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    p = mla_init(gen, cfg, dtype=dtype)
    S, n = 300, 8
    x = torch.randn(1, S, 2048, generator=gen, device=cuda_device).to(dtype)
    pos = torch.arange(S, dtype=torch.int32, device=cuda_device)
    want, _ = mla_prefill(p, x, cfg, positions=pos)
    _, lat = mla_prefill(p, x[:, :S - n], cfg, positions=pos[:S - n])
    cache = torch.zeros(1, 512, 576, dtype=dtype, device=cuda_device)
    cache[:, :S - n] = lat
    fill = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    xt = torch.zeros(1, 1, 2048, dtype=dtype, device=cuda_device)
    step = lambda: mla_decode(p, xt, cfg, cache, positions=fill[:, None], cache_pos=fill)
    xt.copy_(x[:, S - n:S - n + 1]); fill.fill_(S - n)
    outs = [step().clone()]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    for t in range(S - n + 1, S):
        xt.copy_(x[:, t:t + 1]); fill.fill_(t)
        graph.replay()
        outs.append(out.clone())
    got = torch.cat(outs, dim=1).float()
    ref = want[:, S - n:].float()
    assert (got - ref).abs().max() <= tol * ref.abs().max()


def _moe_cfg():
    """moonshot's smoke config with a head dim the attention kernels take."""
    return get_smoke_config("moonshot-v1-16b-a3b").replace(
        d_head=64, param_dtype="float32", compute_dtype="float32")


def test_moe_layer_never_waits_for_the_card(cuda_device):
    """A decode-sized and a prefill-sized MoE layer on the kernel route
    make no host synchronization (the decode step is host-bound)."""
    cfg = _moe_cfg().replace(use_kernels=True)
    params = Model(cfg).init(torch.Generator(device=cuda_device).manual_seed(0))
    p = {k: v[0] for k, v in params["layers"]["moe"].items()}
    for shape in ((4, 1, cfg.d_model), (2, 16, cfg.d_model)):
        x = torch.randn(*shape, device=cuda_device)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux = moe_apply(p, x, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.isfinite(y).all() and torch.isfinite(aux)


def test_bf16_moe_layer_takes_the_new_paths_without_waiting(cuda_device):
    """In bf16 the MoE layer's expert GEMMs take the small-C path at a
    decode shape (C = 4) and the tensor-core path at a prefill shape (C =
    32), and still make no host synchronization."""
    cfg = _moe_cfg().replace(use_kernels=True, param_dtype="bfloat16",
                             compute_dtype="bfloat16")
    params = Model(cfg).init(torch.Generator(device=cuda_device).manual_seed(0))
    p = {k: v[0] for k, v in params["layers"]["moe"].items()}
    for shape, path in (((4, 1, cfg.d_model), "small_c"), ((2, 16, cfg.d_model), "wgmma")):
        x = torch.randn(*shape, device=cuda_device).to(torch.bfloat16)
        before = k6.path_launches[path].count
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux = moe_apply(p, x, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert k6.path_launches[path].count == before + 3
        assert torch.isfinite(y).all() and torch.isfinite(aux)


def test_two_layer_moe_serve_launches_the_kernels(cuda_device):
    """A 2-layer MoE model served in wave mode with equal prompts: K6 three
    times per layer in the prefill and in every decode, K4 once per layer,
    K3 once per layer per decode; its fp32 tokens equal the plain route's."""
    cfg = _moe_cfg()
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(1, cfg.vocab, 16).tolist(), max_new_tokens=8)
            for i in range(3)]
    params = Model(cfg).init(torch.Generator(device=cuda_device).manual_seed(0))
    tokens = {}
    for use in (True, False):
        model = Model(cfg.replace(use_kernels=use))
        before = (k6.launches.count, k4.launches.count, k3.launches.count)
        eng = ServeEngine(model, params, ServeConfig(batch=3, max_len=32, mode="wave"))
        tokens[use] = {rid: r.tokens for rid, r in eng.serve(reqs).items()}
        launched = (k6.launches.count - before[0], k4.launches.count - before[1],
                    k3.launches.count - before[2])
        assert launched == ((3 * 2 * 8, 2, 2 * 7) if use else (0, 0, 0))
    assert tokens[True] == tokens[False]
    assert all(len(t) == 8 for t in tokens[True].values())


# ---------------------------------------------------------------------------
# K5 SSD scan
# ---------------------------------------------------------------------------
# (b, S, H, P, G, N, the model's chunk): zamba2-2.7b's prefill, mamba2-130m's
# (N = 128), a ragged S, two groups, and the smoke configs' shape
SSD_SHAPES = [(4, 512, 80, 64, 1, 64, 256), (4, 512, 24, 64, 1, 128, 256),
              (4, 509, 80, 64, 1, 64, 256), (2, 300, 8, 64, 2, 64, 256),
              (2, 37, 8, 16, 1, 16, 16)]


def ssd_inputs(gen, b, S, H, P, G, N, dtype, device):
    """x, B, C as the Mamba2 mixer hands them over: slices of one [b, S,
    H·P + 2·G·N] projection (strided, read in place); dt = softplus(randn),
    A = -exp(0.3 randn), as the reference's own test draws them."""
    xbc = torch.randn(b, S, H * P + 2 * G * N, generator=gen, device=device).to(dtype)
    x, B, C = torch.split(xbc, [H * P, G * N, G * N], dim=-1)
    dt = torch.nn.functional.softplus(torch.randn(b, S, H, generator=gen, device=device))
    A = -torch.exp(0.3 * torch.randn(H, generator=gen, device=device))
    return (x.reshape(b, S, H, P), dt, A, B.reshape(b, S, G, N), C.reshape(b, S, G, N))


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=lambda s: "-".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_cuda_matches_plain(cuda_device, shape, dtype):
    """fp32: y and the final state within 1e-3 of the plain version (its
    256-step cumsums reach ~200, whose ulp moves every decay exp(cum_i -
    cum_j) by ~1e-5 relative; the kernel sums 64-step chunks).  bf16: the
    plain version rounds the state entering each chunk to bf16 before the
    inter-chunk term and the kernel does not, so y is held by relative L2
    (1e-2) against it, and elementwise (4e-2) against the plain version on
    fp32 upcasts of the same inputs rounded once to bf16, which is the
    kernel's own arithmetic; the fp32 final state within 4e-2."""
    b, S, H, P, G, N, chunk = shape
    gen = torch.Generator(device=cuda_device).manual_seed(S + H + N)
    x, dt, A, B, C = ssd_inputs(gen, b, S, H, P, G, N, dtype, cuda_device)
    before = k5.launches.count
    y, h = ssd_chunked_scan(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert k5.launches.count == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    yp, hp = ssd_chunked(x, dt, A, B, C, chunk=chunk)
    if dtype == torch.float32:
        torch.testing.assert_close(y, yp, rtol=1e-3, atol=1e-3)
        torch.testing.assert_close(h, hp, rtol=1e-3, atol=1e-3)
        return
    rel = float((y.float() - yp.float()).norm() / yp.float().norm())
    assert rel <= 1e-2, rel
    y32, h32 = ssd_chunked(*(t.float() for t in (x, dt, A, B, C)), chunk=chunk)
    torch.testing.assert_close(y.float(), y32.to(dtype).float(), rtol=4e-2, atol=4e-2)
    torch.testing.assert_close(h, hp, rtol=4e-2, atol=4e-2)
    torch.testing.assert_close(h, h32, rtol=4e-2, atol=4e-2)


def test_ssd_scan_cuda_refuses_what_it_does_not_take(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x, dt, A, B, C = ssd_inputs(gen, 1, 16, 4, 64, 1, 64, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="one CUDA device"):
        ssd_scan_cuda(x, dt.cpu(), A, B, C)
    with pytest.raises(ValueError, match="dtype"):
        ssd_scan_cuda(x, dt, A, B.to(torch.bfloat16), C)
    for P, N in ((32, 64), (64, 32), (64, 256)):
        x2, dt2, A2, B2, C2 = ssd_inputs(gen, 1, 16, 2, P, 1, N, torch.float32, cuda_device)
        with pytest.raises(ValueError, match="not among"):
            ssd_scan_cuda(x2, dt2, A2, B2, C2)


# (S, cluster asked): clusters of 1, 2, 3, 5 and 8 CTAs with one to eight
# chunks each, ragged tails; zamba2's and mamba2's widths (H, N)
SSD_SWEEP = [(64, None), (300, None), (300, 5), (509, None), (509, 3), (512, None),
             (512, 8), (2048, None), (4096, None)]


@pytest.mark.parametrize("S,cluster", SSD_SWEEP, ids=lambda v: str(v))
@pytest.mark.parametrize("H,N", [(80, 64), (24, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_cuda_sweep_over_clusters(cuda_device, S, cluster, H, N, dtype):
    """Every cluster size and run length against the plain version at the
    limits of test_ssd_scan_cuda_matches_plain, and against the kernel's own
    decomposition (ssd_cluster_ref: bf16 with its hi/lo pairs, 4e-2
    elementwise; fp32 1e-3), on the path ssd_path names."""
    gen = torch.Generator(device=cuda_device).manual_seed(S + N)
    args = ssd_inputs(gen, 2, S, H, 64, 1, N, dtype, cuda_device)
    path = ssd_path(args[0], args[3])
    assert path == ("wgmma" if dtype == torch.bfloat16 else "fma")
    before = k5.path_launches[path].count
    y, h = ssd_scan_cuda(*args, cluster=cluster)
    torch.cuda.synchronize()
    assert k5.path_launches[path].count == before + 1
    assert ssd_plan(S, cluster)[0] <= 8
    yp, hp = ssd_chunked(*args, chunk=256)
    yc, hc = ssd_cluster_ref(*args, cluster=cluster, split_bf16=dtype == torch.bfloat16)
    tol = 1e-3 if dtype == torch.float32 else 4e-2
    torch.testing.assert_close(y.float(), yc.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, hc, rtol=tol, atol=tol)
    torch.testing.assert_close(h, hp, rtol=tol, atol=tol)
    if dtype == torch.float32:
        torch.testing.assert_close(y, yp, rtol=tol, atol=tol)
    else:
        rel = float((y.float() - yp.float()).norm() / yp.float().norm())
        assert rel <= 1e-2, rel
        y32, _ = ssd_chunked(*(t.float() for t in args), chunk=256)
        torch.testing.assert_close(y.float(), y32.to(dtype).float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_cuda_repeats_bitwise(cuda_device, dtype):
    """The fold runs in cluster order, without atomics: the same inputs give
    the same bits, call after call, at every cluster size."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    args = ssd_inputs(gen, 4, 509, 80, 64, 1, 64, dtype, cuda_device)
    for cluster in (None, 1, 3, 8):
        y, h = ssd_scan_cuda(*args, cluster=cluster)
        for _ in range(3):
            y2, h2 = ssd_scan_cuda(*args, cluster=cluster)
            assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "mamba2-130m"])
def test_two_group_state_serve_launches_the_kernels(cuda_device, arch):
    """A small ssm / hybrid model (P = N = 16; the hybrid's attention head
    dim 80) served in wave mode with equal prompts and in continuous mode
    with ragged ones: K5 in every Mamba2 layer of every prefill, K4 in every
    shared block of the wave prefill, K3 in every shared block of every
    decode; its fp32 tokens equal the plain route's."""
    cfg = get_smoke_config(arch).replace(param_dtype="float32", compute_dtype="float32")
    if cfg.family == "hybrid":
        cfg = cfg.replace(d_head=80)
    G = cfg.n_layers // cfg.hybrid_group if cfg.family == "hybrid" else 0
    rng = np.random.default_rng(0)
    params = Model(cfg).init(torch.Generator(device=cuda_device).manual_seed(0))
    for mode, lens in (("wave", (16, 16, 16)), ("continuous", (16, 13, 21, 13))):
        reqs = [Request(i, rng.integers(1, cfg.vocab, L).tolist(), max_new_tokens=8)
                for i, L in enumerate(lens)]
        tokens = {}
        for use in (True, False):
            model = Model(cfg.replace(use_kernels=use))
            before = (k5.launches.count, k4.launches.count, k3.launches.count)
            eng = ServeEngine(model, params, ServeConfig(batch=3, max_len=48, mode=mode))
            tokens[use] = {rid: r.tokens for rid, r in eng.serve(reqs).items()}
            got = (k5.launches.count - before[0], k4.launches.count - before[1],
                   k3.launches.count - before[2])
            if not use:
                assert got == (0, 0, 0)
            elif mode == "wave":
                assert got == (cfg.n_layers, G, G * 7)
            else:
                prefills = got[0] // cfg.n_layers
                assert prefills >= 3 and got[0] == prefills * cfg.n_layers
                assert got[1] == prefills * G
                assert (got[2] > 0 and got[2] % G == 0) if G else got[2] == 0
        assert tokens[True] == tokens[False]
        assert all(len(t) == 8 for t in tokens[True].values())


# ---------------------------------------------------------------------------
# the decode step as a captured CUDA graph (serve/graph.py)
# ---------------------------------------------------------------------------
SERVED_FRONTEND = {"internvl2-2b": 8, "seamless-m4t-large-v2": 4}


def _served_cfg(arch):
    """fp32 smoke configs of the served families, with head dims the
    attention kernels take (dense, vlm and enc-dec d = 64 with r = 3, the
    hybrid's d = 80, the MoE's d = 64)."""
    cfg = get_smoke_config(arch).replace(param_dtype="float32", compute_dtype="float32",
                                         use_kernels=True)
    if cfg.family in ("dense", "vlm", "encdec"):
        cfg = cfg.replace(n_heads=6, n_kv=2, d_head=64)
    if cfg.family == "hybrid":
        cfg = cfg.replace(d_head=80)
    if cfg.family == "moe":
        cfg = cfg.replace(d_head=64)
    return cfg


def _kernel_counts():
    mods = (k3, k4, k5, k6)
    return ({m.__name__: m.launches.count for m in mods},
            {m.__name__: _paths(m) for m in mods})


def _paths(mod):
    return {p: c.count for p, c in mod.path_launches.items()}


def _delta(after, before):
    return ({k: after[0][k] - before[0][k] for k in after[0]},
            {k: {p: after[1][k][p] - before[1][k][p] for p in after[1][k]}
             for k in after[1]})


@pytest.mark.parametrize("arch", ["minitron-4b", "qwen2-72b", "gemma3-4b", "kimi-k2-1t-a32b",
                                  "moonshot-v1-16b-a3b", "internvl2-2b",
                                  "seamless-m4t-large-v2", "zamba2-2.7b", "mamba2-130m"])
@pytest.mark.parametrize("mode,lens", [("wave", (16, 16, 16)),
                                       ("continuous", (16, 13, 21, 13, 9))])
def test_captured_decode_serves_the_eager_tokens_and_counts(cuda_device, arch, mode, lens):
    """Each served family (fp32, its smoke depth; the vlm and enc-dec models
    with their zero frontend stubs, gemma3 with its sliding windows) in
    both modes: the captured route's greedy tokens equal the eager route's,
    every decode after a signature's first replays a graph, and the launch
    counts per kernel and per path equal the eager serve's."""
    cfg = _served_cfg(arch)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(1, cfg.vocab, L).tolist(), max_new_tokens=8)
            for i, L in enumerate(lens)]
    params = Model(cfg).init(torch.Generator(device=cuda_device).manual_seed(0))
    tokens, counts = {}, {}
    for eager in (True, False):
        eng = ServeEngine(Model(cfg), params, ServeConfig(batch=3, max_len=48, mode=mode),
                          frontend_seq=SERVED_FRONTEND.get(arch, 0), eager=eager)
        before = _kernel_counts()
        tokens[eager] = {rid: r.tokens for rid, r in eng.serve(reqs).items()}
        torch.cuda.synchronize()
        counts[eager] = _delta(_kernel_counts(), before)
        stats = eng.graph_stats
        if eager:
            assert stats["decodes"] >= 7 and stats["graphs"] == stats["replays"] == 0
        else:
            assert stats["graphs"] >= 1 and stats["replays"] > 0
            assert stats["decodes"] == stats["graphs"] + stats["replays"]
    assert tokens[True] == tokens[False]
    assert all(len(t) == 8 for t in tokens[False].values())
    assert counts[True] == counts[False]


def test_captured_wave_decode_keeps_no_state_of_an_earlier_wave(cuda_device):
    """Waves of one size share a graph and its static cache: a ragged wave
    after an equal-length one, and the first wave again, serve the eager
    route's tokens."""
    cfg = _served_cfg("minitron-4b")
    rng = np.random.default_rng(2)
    waves = [[Request(i, rng.integers(1, cfg.vocab, L).tolist(), max_new_tokens=6)
              for i, L in enumerate(lens)] for lens in ((12, 12), (20, 7), (12, 12))]
    waves[2] = waves[0]
    params = Model(cfg).init(torch.Generator(device=cuda_device).manual_seed(1))
    got = {}
    for eager in (True, False):
        eng = ServeEngine(Model(cfg), params, ServeConfig(batch=2, max_len=32, mode="wave"),
                          eager=eager)
        got[eager] = [{rid: r.tokens for rid, r in eng.serve(w).items()} for w in waves]
    assert got[True] == got[False]
    assert got[False][0] == got[False][2]


def test_captured_engine_is_freed_with_its_last_reference(cuda_device):
    """A served engine's graphs hold no reference back to it: dropping the
    engine frees it (and with it its static caches and graphs) at once, not
    at the next garbage collection."""
    cfg = _served_cfg("minitron-4b")
    params = Model(cfg).init(torch.Generator(device=cuda_device).manual_seed(0))
    reqs = [Request(i, [5, 6, 7, 8], max_new_tokens=4) for i in range(2)]
    for mode in ("wave", "continuous"):
        gc.disable()                    # only reference counts may free it
        try:
            eng = ServeEngine(Model(cfg), params,
                              ServeConfig(batch=2, max_len=16, mode=mode))
            eng.serve(reqs)
            assert eng.graph_stats["replays"] > 0
            ref = weakref.ref(eng)
            del eng
            assert ref() is None
        finally:
            gc.enable()


def test_failed_capture_raises(cuda_device):
    """A decode step that reads a value on the host cannot be captured: the
    engine raises and does not fall back to the eager route."""
    cfg = _served_cfg("minitron-4b")
    params = Model(cfg).init(torch.Generator(device=cuda_device).manual_seed(0))
    model = Model(cfg)
    real = model.decode_step

    def reads_back(params, token, cache, pos, **kw):
        int(pos.max())                          # a host read
        return real(params, token, cache, pos, **kw)

    model.decode_step = reads_back
    reqs = [Request(i, [5, 6, 7, 8], max_new_tokens=4) for i in range(2)]
    eng = ServeEngine(model, params, ServeConfig(batch=2, max_len=16, mode="wave"))
    with pytest.raises(RuntimeError):
        eng.serve(reqs)
    torch.cuda.synchronize()
    out = ServeEngine(model, params, ServeConfig(batch=2, max_len=16, mode="wave"),
                      eager=True).serve(reqs)
    assert all(len(r.tokens) == 4 for r in out.values())


def test_fib_leaf_cuda_matches_plain(cuda_device):
    """The busy-loop kernel against its plain version: fib(n) and every
    lane's accumulator bit for bit, and the BOTS fib and alignment
    workloads' offloaded runs equal their serial runs."""
    for n in (0, 1, 2, 8, 12):
        before = kb.launches.count
        out, acc = fib_subtree(torch.tensor(n, dtype=torch.int32, device=cuda_device))
        torch.cuda.synchronize()
        assert kb.launches.count == before + 1
        ref_out, ref_acc = fib_subtree_ref(torch.tensor(n, dtype=torch.int32))
        assert torch.equal(out.cpu(), ref_out) and torch.equal(acc.cpu(), ref_acc)
    assert tbf.verify("small", n_devices=4)
    assert tba.verify("small", n_devices=4)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 4099, 1 << 20, 1000003])
def test_q8_wire_cuda_matches_plain_bitwise(cuda_device, n):
    """The block-int8 wire kernel against its plain version, at ragged
    lengths: the round trip bit for bit (on the card and against the CPU),
    one launch; a zero block and exact halves of the scale included."""
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randn(n, generator=gen, device=cuda_device) * 3.0
    x[: min(n, 300)] = 0.0
    if n > 1000:
        x[600:604] = torch.tensor([127.0, 63.5, -0.5, 2.5], device=cuda_device)
    before = kq.launches.count
    out = q8_roundtrip(x)
    torch.cuda.synchronize()
    assert kq.launches.count == before + 1
    assert torch.equal(out.view(torch.int32), q8_roundtrip_ref(x).view(torch.int32))
    assert torch.equal(out.cpu().view(torch.int32),
                       q8_roundtrip_ref(x.cpu()).view(torch.int32))
    with pytest.raises(ValueError):
        q8_roundtrip(x.to(torch.bfloat16))
    with pytest.raises(ValueError):
        q8_roundtrip(x, block=64)


def test_peer_copy_between_streams_while_the_source_is_rewritten(cuda_device):
    """SEND/RECV between two virtual devices' streams: the receiver gets the
    value the source held at the SEND (a kernel's output on the source
    stream, or a fresh ALLOC's zeros), in a buffer of its own, however the
    source is rewritten afterwards."""
    table = KernelTable()
    table.register("dbl", lambda a: {"a": a * 2.0})
    pool = DevicePool.virtual(2, table=table, device=cuda_device)
    try:
        for _ in range(3):
            big = torch.randn(1 << 22)
            hs = pool.alloc(0, big.shape, big.dtype)
            hd = pool.alloc(1, big.shape, big.dtype)
            hz = pool.alloc(0, big.shape, big.dtype)
            pool.peer_copy(0, hz, 1, hd)                   # a fresh ALLOC's zeros
            assert not bool(pool.transfer_from(1, hd).any())
            pool.transfer_to(0, hs, big)
            out = pool.exec_kernel(0, "dbl", buffers={"a": hs})
            pool.transfer_to_writeback(0, hs, out["a"])
            pool.peer_copy(0, hs, 1, hd)
            pool.transfer_to(0, hs, torch.zeros(1 << 22))  # rewrite the source
            assert torch.equal(pool.transfer_from(1, hd), big * 2.0)
            pool.sync()
            src = pool.devices[0].store.read(hs)
            dst = pool.devices[1].store.read(hd)
            assert dst.data_ptr() != src.data_ptr() and not bool(src.any())
            for dev, h in ((0, hs), (1, hd), (0, hz)):
                pool.free(dev, h)
        pool.sync()
    finally:
        pool.stop_all()


@pytest.mark.parametrize("n", [2, 3])
def test_dp_fabrics_on_the_card(cuda_device, n):
    """data_parallel_grads host-mediated / direct / direct + int8 (the wire
    kernel on every device) and data_parallel_step in both fabrics, at small
    D: direct within rtol 1e-5, int8 within max|g|/64, step parameters
    bit-identical (at D = 3 the mean divides by 3)."""
    d = 256
    params, batches = cm.make_params(d), cm.make_batches(d, 16, n)
    grads, steps = {}, {}
    for mode, compress in (("host-mediated", False), ("direct", False),
                           ("direct+int8", True)):
        rt = ClusterRuntime(RuntimeConfig(n_virtual=n, comm_mode=mode.split("+")[0],
                                          compress=compress),
                            table=cm.make_table(), device=cuda_device)
        try:
            before = kq.launches.count
            grads[mode] = rt.data_parallel_grads("mse_grads", params, batches)
            assert kq.launches.count - before == (2 * n if compress else 0)
            if not compress:
                for _ in range(4):
                    p = rt.data_parallel_step("mse_grads", params, batches,
                                              sync_every=2)
                steps[mode] = p
        finally:
            rt.shutdown()
    ref = grads["host-mediated"]
    for k in ("w", "b"):
        torch.testing.assert_close(grads["direct"][k], ref[k], rtol=1e-5, atol=1e-6)
        assert float((grads["direct+int8"][k] - ref[k]).abs().max()) <= \
            float(ref["w"].abs().max()) / 64
        assert torch.equal(steps["direct"][k], steps["host-mediated"][k])



# ---------------------------------------------------------------------------
# placement and capacity-bounded present tables on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["locality", "heft", "slo"])
def test_placed_sparselu_keeps_k2_on_cp_async(cuda_device, policy):
    """A policy-placed peer wavefront equals the serial factorization bit for
    bit, and every bmod launch stays on the cp_async path."""
    K, B = 5, 96
    mat = tbl._matrix(K, B)
    rt = ClusterRuntime(RuntimeConfig(n_virtual=4, comm_mode="direct"),
                        table=tbl._make_table(K), device=cuda_device)
    try:
        ser = tbl.serial(rt, mat)
        before = (k2.launches.count, k2.path_launches["cp_async"].count)
        res = tbl.wavefront(rt, mat, peer=True, policy=policy)
        launches = k2.launches.count - before[0]
        assert launches == sum(m * m for m in range(K))
        assert k2.path_launches["cp_async"].count - before[1] == launches
        assert all(r["observed_device_ok"] for r in rt.cost.placement_report())
    finally:
        rt.shutdown()
    assert torch.equal(tbl.assemble(res, K), ser)


def test_chaos_sparselu_on_the_card_is_bit_identical(cuda_device):
    """Sparselu K=4, B=32, D=4 over the peer fabric with every eligible op
    failing at p = 0.2 (seeded): bit for bit the fault-free run on the card,
    every bmod launch — re-executions included — on the cp_async path."""
    from repro_torch.ft import FAULT_OPS, inject_flaky
    K, B = 4, 32
    mat = tbl._matrix(K, B)
    got = {}
    for p in (0.0, 0.2):
        rt = ClusterRuntime(RuntimeConfig(n_virtual=4, comm_mode="direct"),
                            table=tbl._make_table(K), device=cuda_device)
        try:
            if p:
                inject_flaky(rt.pool, p=p, seed=1234, ops=FAULT_OPS)
            before = (k2.launches.count, k2.path_launches["cp_async"].count)
            res = tbl.wavefront(rt, mat, peer=True, max_retries=30)
            launches = k2.launches.count - before[0]
            assert launches >= sum(m * m for m in range(K))
            assert k2.path_launches["cp_async"].count - before[1] == launches
            faults = sum(getattr(d, "failures", 0) for d in rt.pool.devices)
            assert len(rt.pool.health.blacklist) <= faults
        finally:
            rt.shutdown()
        got[p] = (tbl.assemble(res, K), faults)
    assert got[0.2][1] > 0
    assert torch.equal(got[0.2][0], got[0.0][0])


@pytest.mark.parametrize("peer", [False, True])
def test_hedged_sparselu_on_the_card_is_bit_identical(cuda_device, peer):
    """Sparselu K=4, B=32, D=4 with device 0 stalling every EXEC for 50 ms,
    hedged by a StragglerDetector: hedges launch and win, every loser's
    compute record is struck, every bmod launch — hedges included — is on
    cp_async, and the factorization is the serial kernel's bit for bit."""
    from repro_torch.ft import FlakyDevice, StragglerDetector
    K, B = 4, 32
    mat = tbl._matrix(K, B)
    rt = ClusterRuntime(RuntimeConfig(n_virtual=4,
                                      comm_mode="direct" if peer else "host-mediated"),
                        table=tbl._make_table(K), device=cuda_device)
    try:
        ser = tbl.serial(rt, mat)
        rt.cost.reset()
        baseline = {k: 1e-3 for k in ("lu0", "fwd", "bdiv", "bmod")}
        rt.pool.devices[0] = FlakyDevice(rt.pool.devices[0], p=1.0, seed=3,
                                         ops=("EXEC",), mode="slow", slow_s=0.05)
        det = StragglerDetector(rt.cost, k=3.0, grace_s=0.01, poll_s=0.002,
                                max_hedges=64, baseline=baseline)
        before = (k2.launches.count, k2.path_launches["cp_async"].count)
        res = tbl.wavefront(rt, mat, peer=peer, stragglers=det)
        launches = k2.launches.count - before[0]
        assert k2.path_launches["cp_async"].count - before[1] == launches
        assert launches >= sum(m * m for m in range(K))
        assert len(rt.cost.compute) == len(tbl._build_dag(mat, K, B))
        assert det.report()["hedge_wins"] >= 1
    finally:
        rt.shutdown()
    assert torch.equal(tbl.assemble(res, K), ser)


def test_speculated_strips_on_the_card_equal_plain(cuda_device):
    """Mandelbrot 256² at D=4 with device 1 stalling every EXEC for 0.2 s,
    ``offload_strips(speculate=True)``: the stalled strip is respawned, every
    K1 launch is chunked, and the image is the plain version's bit for bit."""
    from repro_torch.ft import FlakyDevice
    n, it = 256, 300
    rt = ClusterRuntime(RuntimeConfig(n_virtual=4), table=tbm._make_table(n, n, it),
                        device=cuda_device)
    try:
        rt.pool.devices[1] = FlakyDevice(rt.pool.devices[1], p=1.0, seed=0,
                                         ops=("EXEC",), mode="slow", slow_s=0.2)
        before = (k1.launches.count, k1.path_launches["chunked"].count)
        img = tbm.strips(rt, tbm.all_rows(n), n, nowait=True, speculate=True)
        launches = k1.launches.count - before[0]
        assert k1.path_launches["chunked"].count - before[1] == launches > 4
        assert any(c.op == "EXEC" and ":spec[" in c.tag for c in rt.pool.trace)
    finally:
        rt.shutdown()
    rows = torch.arange(n, dtype=torch.int32, device=cuda_device)
    assert torch.equal(img, mandelbrot_rows_ref(rows, n, n, it).cpu())


def test_capped_sparselu_equals_uncapped_on_the_card(cuda_device):
    """A cap of four blocks a device forces spills (device-ahead blocks
    fetched to the host first) and refetches on the devices' streams; the
    factorization stays bit for bit the uncapped one."""
    from repro_torch.core import HeftPlacement
    K, B = 5, 96
    mat = tbl._matrix(K, B)
    got, mem = {}, None
    for cap in (None, 4 * B * B * 4):
        rt = ClusterRuntime(RuntimeConfig(n_virtual=4, comm_mode="direct",
                                          device_capacity_bytes=cap),
                            table=tbl._make_table(K), device=cuda_device)
        try:
            got[cap] = tbl.assemble(tbl.wavefront(rt, mat, peer=True, policy=HeftPlacement(
                default_task_s=5e-6, use_observed=False)), K)
            mem = rt.memory_report()
        finally:
            rt.shutdown()
    assert sum(m["evictions"] for m in mem.values()) >= 1
    assert sum(m["refetches"] for m in mem.values()) >= 1
    assert torch.equal(got[None], got[4 * B * B * 4])


def test_checkpoint_round_trip_on_the_card(cuda_device, tmp_path):
    """A bf16 and fp32 tree on the card saves (copied to the host first) and
    restores onto the card bit for bit."""
    from repro_torch.checkpoint import restore_pytree, save_pytree
    g = torch.Generator(device=cuda_device).manual_seed(0)
    tree = {"w": torch.randn(64, 80, generator=g, device=cuda_device),
            "b": torch.randn(80, generator=g, device=cuda_device).to(torch.bfloat16),
            "n": {"count": torch.tensor(7, dtype=torch.int32, device=cuda_device)}}
    save_pytree(str(tmp_path), 3, tree)
    got, step, _ = restore_pytree(str(tmp_path), template=tree, device=cuda_device)
    assert step == 3
    for k, want in (("w", tree["w"]), ("b", tree["b"]), ("count", tree["n"]["count"])):
        have = got["n"]["count"] if k == "count" else got[k]
        assert have.device == want.device and have.dtype == want.dtype
        assert torch.equal(have.view(-1).view(torch.uint8), want.view(-1).view(torch.uint8))


def test_added_device_gets_its_own_stream_and_runs_k2(cuda_device):
    """``add_device`` on a card pool: the newcomer's stream differs from
    every other device's, and a bmod region there launches K2 (cp_async):
    the same bits as a launch on the default stream, and its plain version's
    values within the bmod tolerance."""
    table = KernelTable()
    table.register("bmod", lambda a, l, u: {"out": bmod_op(a, l, u)})
    pool = DevicePool.virtual(2, table=table, device=cuda_device)
    ex = TargetExecutor(pool)
    try:
        new = pool.add_device()
        streams = [d.stream for d in pool.devices]
        assert new == 2 and streams[2] is not None
        assert len({s.cuda_stream for s in streams}) == 3
        g = torch.Generator().manual_seed(1)
        a, l, u = (torch.randn(128, 128, generator=g) for _ in range(3))
        before = (k2.launches.count, k2.path_launches["cp_async"].count)
        out = ex.target("bmod", new, MapSpec(to={"a": a, "l": l, "u": u},
                                             from_={"out": TensorSpec((128, 128),
                                                                      torch.float32)}))
        assert (k2.launches.count, k2.path_launches["cp_async"].count) == \
            (before[0] + 1, before[1] + 1)
        on_card = [t.to(cuda_device) for t in (a, l, u)]
        assert torch.equal(out["out"], bmod_cuda(*on_card).cpu())
        tol = TOL[torch.float32]
        torch.testing.assert_close(out["out"], bmod_ref(*on_card).cpu(), rtol=tol, atol=tol)
    finally:
        ex.close()
        pool.stop_all()


def test_calibrate_on_the_card_seeds_k2_and_fits_links(cuda_device):
    """``calibrate`` on a D=2 pool on the card with a bmod (K2) entry: a
    positive seed on the EXEC clock, FLOPs and bytes counted on the CPU
    copy, warm-up and reps launching K2 on ``cp_async``, fitted funnel and
    peer links, and no calibration record left in the cost model."""
    table = KernelTable()
    table.register("bmod", lambda a, l, u: {"out": bmod_op(a, l, u)})
    rt = ClusterRuntime(RuntimeConfig(n_virtual=2, comm_mode="direct"), table=table,
                        device=cuda_device)
    try:
        g = torch.Generator().manual_seed(0)
        ops = tuple(torch.randn(128, 128, generator=g) for _ in range(3))
        before = k2.path_launches["cp_async"].count
        prof = rt.calibrate({"bmod": ops}, reps=4, warmup=2, sizes=(1 << 14, 1 << 20))
        assert k2.path_launches["cp_async"].count - before == 6
        kp = prof.kernels["bmod"]
        assert kp.seconds > 0 and kp.reps == 4
        assert (kp.flops, kp.bytes_accessed) == (2.0 * 128 ** 3, 4.0 * 128 * 128 * 4)
        assert {"funnel", "funnel:to", "funnel:from", "peer"} <= set(prof.links)
        assert all(lp.bandwidth_Bps > 0 for lp in prof.links.values())
        assert prof.host["gpu"] == torch.cuda.get_device_name(cuda_device)
        assert rt.cost.kernel_time("bmod") == kp.seconds
        for records in ("transfers", "peers", "compute", "events", "placements"):
            assert getattr(rt.cost, records) == [], records
    finally:
        rt.shutdown()


def test_pool_serving_on_the_card_gives_the_local_tokens(cuda_device):
    """Pool-mode serving of a 2-layer fp32 model (head dim 64) on a D=2
    pool on the card, with the kernels on: each prefill launches K4 per
    layer and each decode K3 per layer, from the devices' worker threads,
    and the greedy tokens equal the local ``batch=1`` wave engine's."""
    cfg = get_smoke_config("minitron-4b").replace(
        n_heads=6, n_kv=2, d_head=64, param_dtype="float32", compute_dtype="float32",
        use_kernels=True)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(1, cfg.vocab, 16).tolist(), max_new_tokens=4 + 2 * i)
            for i in range(4)]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    model = Model(cfg)
    params = model.init(gen)
    local = ServeEngine(model, params, ServeConfig(batch=1, max_len=32, mode="wave"),
                        eager=True).serve(reqs)
    rt = ClusterRuntime(RuntimeConfig(n_virtual=2), table=KernelTable(), device=cuda_device)
    try:
        before = (k4.launches.count, k3.launches.count)
        eng = ServeEngine(model, params, ServeConfig(batch=2, max_len=32), runtime=rt,
                          policy="round-robin")
        out = eng.serve(reqs)
        rt.pool.sync()
        launched = (k4.launches.count - before[0], k3.launches.count - before[1])
    finally:
        rt.shutdown()
    assert {r: o.tokens for r, o in out.items()} == {r: o.tokens for r, o in local.items()}
    assert launched == (2 * len(reqs), 2 * sum(r.max_new_tokens - 1 for r in reqs))


def test_paper_claims_run_on_the_card(cuda_device):
    """``run.run_all`` on the card over sparselu and mandelbrot small at
    D = 1, 2: the CPU run's byte columns, an exact verification, every K1
    launch ``chunked`` and every K2 launch ``cp_async``."""
    before = (k1.path_launches["chunked"].count, k1.launches.count,
              k2.path_launches["cp_async"].count, k2.launches.count)
    curves, err = trun.run_all(repeats=1, plan=(("sparselu", "small", (1, 2)),
                                                ("mandelbrot", "small", (1, 2))))
    k1_chunked, k1_all, k2_async, k2_all = (
        k1.path_launches["chunked"].count - before[0], k1.launches.count - before[1],
        k2.path_launches["cp_async"].count - before[2], k2.launches.count - before[3])
    assert err == 0.0
    cols = {c.name: [(p.devices, p.bytes_to, p.bytes_from) for p in c.points]
            for c in curves}
    assert cols["sparselu"] == [(1, 999424.0, 491520.0), (2, 1015808.0, 491520.0)]
    assert cols["mandelbrot"] == [(1, 1664.0, 692224.0), (2, 1664.0, 692224.0)]
    assert all(p.speedup > 0 for c in curves for p in c.points)
    assert k1_all > 0 and k1_chunked == k1_all
    assert k2_all > 0 and k2_async == k2_all


def test_serve_load_sections_on_the_card(cuda_device):
    """Both open-loop sections on the card at a 2-layer fp32 model (head
    dim 64) with the kernels on: the reference's request and token counts,
    and identical tokens (continuous vs wave, SLO vs round-robin).  The
    timing-dependent checks are reported, not held."""
    cfg = get_smoke_config("minitron-4b").replace(
        n_heads=6, n_kv=2, d_head=64, param_dtype="float32", compute_dtype="float32",
        use_kernels=True)
    model = Model(cfg)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    before = (k4.launches.count, k3.launches.count)
    s1 = tsl.run_continuous_vs_wave(n=16, model=model, params=params)
    s2 = tsl.run_slo_vs_roundrobin(n=30, reps=1, model=model, params=params)
    assert (k4.launches.count - before[0]) > 0 and (k3.launches.count - before[1]) > 0
    for sec, engines, counts in ((s1, ("wave", "continuous"), (16, 183)),
                                 (s2, ("round-robin", "slo"), (30, 655))):
        for e in engines:
            assert (sec[e]["requests"], sec[e]["tokens"]) == counts
        assert sec["checks"]["tokens_identical"]


def test_calibration_gate_on_the_card(cuda_device):
    """The calibration gate with the pool on the card: both arms bit for
    bit, every K2 launch ``cp_async``, the win at least 20%."""
    before = (k2.path_launches["cp_async"].count, k2.launches.count)
    fails, detail = tpg.calibration_gate()
    launched = (k2.path_launches["cp_async"].count - before[0], k2.launches.count - before[1])
    assert fails == [] and detail["bit_identical"]
    assert detail["win_pct"] >= 20.0
    assert launched[1] > 0 and launched[0] == launched[1]


def test_runtimes_reuse_the_streams_of_stopped_devices(cuda_device):
    """A stopped device hands its worker, and the worker's stream, back and
    the next runtime's devices take them, so PyTorch's per-(handle, stream)
    cuBLAS workspaces (32 MiB each, kept for the process's life) are not
    made anew for every runtime."""
    mat = tbl._matrix(4, 64)

    def once():
        rt = ClusterRuntime(RuntimeConfig(n_virtual=4), table=tbl._make_table(4),
                            device=cuda_device)
        streams = [d.stream for d in rt.pool.devices]
        try:
            tbl.wavefront(rt, mat)
        finally:
            rt.shutdown()
        assert all(d.stream is None for d in rt.pool.devices)
        return {id(s) for s in streams}

    first = once()
    assert once() == first and once() == first


def test_runtimes_leave_the_card_memory_flat(cuda_device):
    """Ten D=8 runtimes in turn, each running a cuBLAS matmul on every
    device: the card's allocated bytes after the tenth shutdown equal those
    after the second, byte for byte (each device's worker thread keeps its
    cuBLAS handle and its stream, so no new workspace is made), and no idle
    worker keeps a finished pool alive."""
    table = KernelTable()
    table.register("mm", lambda a, b: {"out": a @ b})
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(256, 256, generator=g), torch.randn(256, 256, generator=g)
    spec = TensorSpec((256, 256), torch.float32)
    after = []
    for _ in range(10):
        rt = ClusterRuntime(RuntimeConfig(n_virtual=8), table=table, device=cuda_device)
        try:
            outs = [rt.ex.target("mm", d, MapSpec(to={"a": a, "b": b}, from_={"out": spec}))
                    for d in range(8)]
        finally:
            rt.shutdown()
        assert all(torch.allclose(o["out"], a @ b, rtol=1e-5, atol=1e-4) for o in outs)
        pool = weakref.ref(rt.pool)
        del rt, outs
        gc.collect()
        assert pool() is None
        torch.cuda.synchronize()
        after.append(torch.cuda.memory_allocated(cuda_device))
    assert after[9] == after[1], after


@pytest.mark.parametrize("kernel", ["flash_decode", "flash_attention", "ssd_scan",
                                    "grouped_matmul"])
def test_kernel_wrappers_refuse_gradients_on_the_card(cuda_device, kernel):
    """On CUDA tensors each K3-K6 wrapper raises under grad mode when an
    input requires grad, before it launches; under ``no_grad`` it launches."""
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device,
                           dtype=torch.bfloat16).requires_grad_(True)

    calls = {
        "flash_decode": (k3, lambda: gqa_flash_decode(r(2, 1, 4, 64), r(2, 64, 2, 64),
                                                      r(2, 64, 2, 64), 40)),
        "flash_attention": (k4, lambda: gqa_flash_attention(r(2, 64, 4, 64),
                                                            r(2, 64, 2, 64),
                                                            r(2, 64, 2, 64))),
        "ssd_scan": (k5, lambda: ssd_chunked_scan(
            r(1, 64, 2, 64), torch.rand(1, 64, 2, device=cuda_device),
            -torch.rand(2, device=cuda_device), r(1, 64, 1, 64), r(1, 64, 1, 64))),
        "grouped_matmul": (k6, lambda: expert_ffn_matmul(r(2, 16, 64), r(2, 64, 64))),
    }
    mod, call = calls[kernel]
    before = mod.launches.count
    with pytest.raises(RuntimeError, match=f"{kernel}.*use_kernels=False"):
        call()
    assert mod.launches.count == before
    with torch.no_grad():
        call()
    torch.cuda.synchronize()
    assert mod.launches.count > before


def test_full_width_train_step_is_deterministic(cuda_device):
    """mamba2-130m at its full config (bf16), batch 8 x 256: one train step
    run twice from the same state gives the same loss, gradient norm and
    parameters, bit for bit."""
    model = Model(get_config("mamba2-130m"))
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device)
    opt = AdamW(AdamWConfig(lr=3e-4))
    state = opt.init(params)
    pf = Prefetcher(SyntheticLM(DataConfig(vocab=model.cfg.vocab, seq=256, global_batch=8)),
                    device=cuda_device, max_steps=1)
    (batch,) = list(pf)
    pf.close()
    step = make_train_step(model, opt)
    runs = [step(params, state, batch) for _ in range(2)]
    torch.cuda.synchronize()
    (p1, _, m1), (p2, _, m2) = runs
    assert np.isfinite(float(m1["loss"]))
    for k in ("loss", "grad_norm"):
        assert torch.equal(m1[k], m2[k]), k
    assert all(torch.equal(a.view(-1).view(torch.int16), b.view(-1).view(torch.int16))
               if a.dtype == torch.bfloat16 else torch.equal(a, b)
               for a, b in zip(_tree.leaves(p1), _tree.leaves(p2)))


def test_launch_serve_on_the_card_equals_the_engine(cuda_device):
    """``repro_torch.launch.serve`` on mamba2-130m's smoke config on the
    card (K5 takes its P = N = 16; the attention families' smoke head dims
    are not the attention kernels'): its tokens equal a ``ServeEngine``
    driven directly with the same weights and requests."""
    from repro_torch.launch import serve as tserve
    from repro_torch.serve import ServeEngine
    out = {}
    assert tserve.main(["--arch", "mamba2-130m", "--requests", "5", "--max-new", "8"],
                       out=out) == 0
    got = {rid: r.tokens for rid, r in out["results"].items()}
    eng = ServeEngine(out["model"], out["params"], out["serve_config"],
                      frontend_seq=out["frontend_seq"], device=cuda_device)
    assert got == {rid: r.tokens for rid, r in eng.serve(out["requests"]).items()}
    assert all(len(t) == 8 for t in got.values())


def test_dryrun_leaves_the_card_memory_unchanged(cuda_device, tmp_path):
    from repro_torch.launch import dryrun
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    assert dryrun.main(["--all", "--out", str(tmp_path)]) == 0
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
    assert len(list(tmp_path.iterdir())) == 32


def test_kernels_bench_rows_time_the_kernels_on_the_card(cuda_device):
    from repro_torch import kernels_bench
    rows = kernels_bench.timed_rows(device=cuda_device, reps=5)
    name = torch.cuda.get_device_name(cuda_device)
    for r in rows:
        assert np.isfinite(r["ms"]) and r["ms"] > 0 and np.isfinite(r["plain_ms"])
        assert r["card"] == name and r["path"] == "wgmma"
    assert rows[0]["max_abs_err_vs_plain"] < 4e-2
