"""The port's kernel modules against the reference's Pallas kernels (run in
interpret mode on the CPU), their jnp oracles and the JAX table kernels:
K1 mandelbrot, K2 bmod, K4 flash attention and K3 flash decode.

On the CPU each ``ops`` wrapper runs its plain PyTorch version; the CUDA
kernels are held against those plain versions on the card in
``test_torch_cuda.py``.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks.bots_mandelbrot import _make_table as jax_mandel_table  # noqa: E402
from repro.kernels.block_lu.block_lu import bmod as pallas_bmod  # noqa: E402
from repro.kernels.block_lu.ref import (bdiv_ref as j_bdiv, bmod_ref as j_bmod,  # noqa: E402
                                        fwd_ref as j_fwd, lu0_ref as j_lu0)
from repro.kernels.flash_attention.flash_attention import flash_attention as pallas_fa  # noqa: E402
from repro.kernels.flash_attention.ops import gqa_flash_attention as j_gqa_fa  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref  # noqa: E402
from repro.kernels.flash_decode.flash_decode import flash_decode as pallas_fd  # noqa: E402
from repro.kernels.flash_decode.ops import gqa_flash_decode as j_gqa_fd  # noqa: E402
from repro.kernels.flash_decode.ref import flash_decode_ref as j_decode_ref  # noqa: E402
from repro.kernels.mandelbrot.mandelbrot import mandelbrot as pallas_mandelbrot  # noqa: E402
from repro.kernels.mandelbrot.ref import mandelbrot_ref as j_mandelbrot_ref  # noqa: E402
from repro_torch.core import strip_partition  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.block_lu import ops as lu_ops  # noqa: E402
from repro_torch.kernels.block_lu.block_lu import bmod_cuda, bmod_path  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (HEAD_DIMS,  # noqa: E402
                                                            attention_path,
                                                            flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.flash_decode import ops as fd_ops  # noqa: E402
from repro_torch.kernels.flash_decode.flash_decode import (decode_path,  # noqa: E402
                                                           flash_decode_cuda, split_plan)
from repro_torch.kernels.flash_decode.ref import (flash_decode_ref,  # noqa: E402
                                                  flash_decode_split_ref)
from repro_torch.kernels.mandelbrot import ops as mb_ops  # noqa: E402
from repro_torch.kernels.mandelbrot.mandelbrot import CHUNK, mandelbrot_rows_cuda  # noqa: E402
from repro_torch.kernels.mandelbrot.ref import (mandelbrot_chunked_ref,  # noqa: E402
                                                mandelbrot_rows_ref)

# tolerances of the repo's kernel tests (tests/test_kernels.py:21-25)
FP32 = dict(rtol=2e-5, atol=2e-5)
TOL = {"float32": FP32, "bfloat16": dict(rtol=4e-2, atol=4e-2)}

torch.set_num_threads(1)      # six test workers share the CPU


# ---------------------------------------------------------------------------
# K1 mandelbrot
# ---------------------------------------------------------------------------
def _mismatch(a, b) -> float:
    return float((np.asarray(a) != np.asarray(b)).mean())


def test_mandelbrot_plain_vs_pallas_and_oracle():
    """Escape time is chaotic at the set boundary: like the reference's own
    kernel test, tolerate float-order flips on < 0.5% of pixels."""
    port = mb_ops.mandelbrot_strip(64, 64, max_iter=50, device="cpu").numpy()
    assert _mismatch(port, pallas_mandelbrot(64, 64, max_iter=50,
                                             interpret=True)) < 0.005
    assert _mismatch(port, j_mandelbrot_ref(64, 64, max_iter=50)) < 0.005


@pytest.mark.parametrize("H,W,iters", [(64, 64, 50), (40, 72, 30)])
def test_mandelbrot_plain_equals_jax_table_kernel(H, W, iters):
    """Same fp32 operations in the same order as ``mandel_strip(rows)``:
    the counts are equal pixel for pixel."""
    rows = np.arange(3, H, 2, dtype=np.int32)      # an arbitrary strip
    jfn = jax_mandel_table(W, H, iters).lookup(0).fn
    ref = np.asarray(jfn(jnp.asarray(rows))["out"])
    port = mb_ops.mandelbrot_rows(torch.from_numpy(rows), W, H, iters).numpy()
    np.testing.assert_array_equal(port, ref)


def test_mandelbrot_strips_tile_the_image():
    full = mb_ops.mandelbrot_strip(64, 32, max_iter=30, device="cpu")
    parts = [mb_ops.mandelbrot_strip(ln, 32, max_iter=30, row_offset=s,
                                     total_height=64, device="cpu")
             for s, ln in strip_partition(64, 3)]
    assert torch.equal(torch.cat(parts), full)


@pytest.fixture(scope="module")
def mandel_full_width():
    """Rows of the main path's 4600 x 4600 image at max_iter 300: every 64th
    row, the band around cy = 0 (c near -2, where |c| passes 2 on the left
    edge) and the last row (the corners reach |c| = 2.39)."""
    n = 4600
    rows = torch.tensor(sorted({*range(0, n, 64), *range(2292, 2308), n - 1}),
                        dtype=torch.int32)
    return rows, n, mandelbrot_rows_ref(rows, n, n, 300)


def test_mandelbrot_chunked_steps_equal_plain_at_full_width(mandel_full_width):
    """The CUDA kernel's decomposition (escape tested once a chunk, the
    escaped chunk replayed exactly) gives the plain version's counts, bit
    for bit, across the main path's image."""
    rows, n, plain = mandel_full_width
    assert torch.equal(mandelbrot_chunked_ref(rows, n, n, 300, CHUNK), plain)


def test_mandelbrot_chunk_is_the_sources():
    """The wrapper's CHUNK is the chunk the source builds by default."""
    src = (_build.CSRC / "mandelbrot.cu").read_text()
    assert f"#define MANDELBROT_CHUNK {CHUNK}\n" in src
    assert "constexpr int kChunk = MANDELBROT_CHUNK;" in src


_SASS = """\
\t\tFunction : _ZN12_GLOBAL__N_122mandelbrot_rows_kernelEPKiPiiiffffi
        /*0000*/                   LDC R1, c[0x0][0x28] ;            /* 0x00000a00ff017b82 */
                                                                     /* 0x000fe40000000800 */
.L_x_0:
        /*0010*/                   FMUL R2, R3, R3 ;
        /*0020*/                   FADD.FTZ R4, R2, -R5 ;
        /*0030*/              @!P0 FSETP.GTU.AND P0, PT, R2, 4, PT ;
        /*0040*/               @P0 BRA `(.L_x_0) ;
        /*0050*/                   BRA 0x10 ;
        /*0060*/                   EXIT ;
.L_x_1:
        /*0070*/                   BRA `(.L_x_1);
\t\tFunction : _ZN12_GLOBAL__N_113busy_loop_kernelEPfi
        /*0000*/                   BRA 0x0 ;
"""


def test_sass_loops_reads_backward_branches():
    """Each backward branch of the named function is a loop, by label or by
    address; a branch to itself (the padding after EXIT) and the other
    functions are not."""
    loops = _build.sass_loops(_SASS, "mandelbrot_rows_kernel")
    assert loops == [
        {"start": 16, "end": 64, "instructions": 4, "BRA": 1, "FADD": 1, "FMUL": 1, "FSETP": 1},
        {"start": 16, "end": 80, "instructions": 5, "BRA": 2, "FADD": 1, "FMUL": 1, "FSETP": 1}]
    assert _build.sass_loops(_SASS, "busy_loop_kernel") == []


@pytest.mark.parametrize("max_iter", [0, 1, CHUNK - 1, CHUNK, CHUNK + 1, 299, 301])
def test_mandelbrot_chunked_steps_ragged(max_iter):
    """max_iter of 0, 1, around the chunk and off 300; a width not a
    multiple of 32; a strip that starts mid-image."""
    rows = torch.arange(21, 58, dtype=torch.int32)
    assert torch.equal(mandelbrot_chunked_ref(rows, 97, 80, max_iter, CHUNK),
                       mandelbrot_rows_ref(rows, 97, 80, max_iter))


# ---------------------------------------------------------------------------
# K2 bmod and the solves
# ---------------------------------------------------------------------------
def _randn(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("M,N,K", [(64, 64, 64), (128, 64, 32), (96, 96, 96)])
def test_bmod_plain_vs_pallas_and_oracle(M, N, K):
    a, l, u = _randn(M + N + K, (M, N), (M, K), (K, N))
    port = lu_ops.bmod_op(*map(torch.from_numpy, (a, l, u))).numpy()
    ja, jl, ju = map(jnp.asarray, (a, l, u))
    pallas = pallas_bmod(ja, jl, ju, interpret=True, block_m=32, block_n=32,
                         block_k=32)
    np.testing.assert_allclose(port, np.asarray(pallas), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(port, np.asarray(j_bmod(ja, jl, ju)),
                               rtol=1e-4, atol=1e-4)


def test_bmod_plain_bf16_vs_oracle():
    a, l, u = _randn(7, (32, 48), (32, 16), (16, 48))
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (a, l, u)]
    port = lu_ops.bmod_op(*tb)
    assert port.dtype == torch.bfloat16
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (a, l, u)]
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(j_bmod(*jb), np.float32),
                               rtol=4e-2, atol=4e-2)


@pytest.mark.parametrize("n", [16, 40])
def test_solves_match_reference(n):
    rng = np.random.default_rng(n)
    a = (rng.standard_normal((n, n)) + np.eye(n) * 2 * n).astype(np.float32)
    b, c = _randn(n + 1, (n, n), (n, n))
    lu_t = lu_ops.lu0_op(torch.from_numpy(a))
    lu_j = j_lu0(jnp.asarray(a))
    np.testing.assert_allclose(lu_t.numpy(), np.asarray(lu_j), **FP32)
    np.testing.assert_allclose(lu_ops.fwd_op(lu_t, torch.from_numpy(b)).numpy(),
                               np.asarray(j_fwd(lu_j, jnp.asarray(b))), **FP32)
    np.testing.assert_allclose(lu_ops.bdiv_op(lu_t, torch.from_numpy(c)).numpy(),
                               np.asarray(j_bdiv(lu_j, jnp.asarray(c))), **FP32)
    for fn in (lu_ops.fwd_op, lu_ops.bdiv_op):
        assert fn(lu_t, torch.from_numpy(b)).is_contiguous()


# ---------------------------------------------------------------------------
# K4 flash attention and K3 flash decode
# ---------------------------------------------------------------------------
def _same_inputs(seed, shapes, dtype):
    """The same numpy draws as a JAX array and a torch tensor of ``dtype``."""
    arrs = _randn(seed, *shapes)
    return ([jnp.asarray(a, dtype) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


def _check(port, ref, dtype):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("Sq,Skv,causal,window", [(64, 64, True, 0), (64, 64, True, 32),
                                                  (32, 64, False, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_vs_pallas_and_oracle(Sq, Skv, causal, window, dtype):
    """r = 3 query rows per kv row; causal, a window of 32, and Sq != Skv."""
    (jq, jk, jv), (q, k, v) = _same_inputs(Sq + window, [(2, 3, Sq, 32), (2, Skv, 32),
                                                         (2, Skv, 32)], dtype)
    port = flash_attention_ref(q, k, v, causal=causal, window=window, block_kv=32)
    assert port.dtype == q.dtype
    _check(port, pallas_fa(jq, jk, jv, causal=causal, window=window, block_q=32,
                           block_kv=32, interpret=True), dtype)
    _check(port, j_attention_ref(jq, jk, jv, causal=causal, window=window), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_vs_pallas_and_oracle(dtype):
    """Ragged per-row kv_len, including 0 (every score -1e30: the mean of
    every value row) and the whole cache."""
    (jq, jk, jv), (q, k, v) = _same_inputs(11, [(5, 3, 32), (5, 96, 32), (5, 96, 32)],
                                           dtype)
    lens = np.array([0, 1, 33, 64, 96], np.int32)
    port = flash_decode_ref(q, k, v, torch.from_numpy(lens), block_kv=32)
    _check(port, pallas_fd(jq, jk, jv, jnp.asarray(lens), block_kv=32,
                           interpret=True), dtype)
    _check(port, j_decode_ref(jq, jk, jv, jnp.asarray(lens)), dtype)
    _check(port[0], jnp.broadcast_to(jv[0].astype(jnp.float32).mean(0), (3, 32)), dtype)


# K3's split rule: S = 96 cut into splits of whole 16-row tiles, one cache row
# per kv_len: 0 (the uniform mean), 1, each side of the 16/32/48-row split
# boundaries, S and past S.  With n_split > 1 the short rows leave whole
# splits past kv_len (kv_len = 1: every split but the first).
SPLIT_S, SPLIT_TILE = 96, 16
SPLIT_LENS = np.array([0, 1, 15, 16, 17, 31, 32, 33, 47, 48, 49, 95, 96, 97, 200], np.int32)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def decode_refs(request):
    """Inputs of one dtype, with the Pallas kernel's (interpreted) and the
    plain version's outputs on them, computed once for every split count."""
    dtype, n = request.param, len(SPLIT_LENS)
    (jq, jk, jv), (q, k, v) = _same_inputs(13, [(n, 3, 32), (n, SPLIT_S, 32),
                                                (n, SPLIT_S, 32)], dtype)
    pallas = np.asarray(pallas_fd(jq, jk, jv, jnp.asarray(SPLIT_LENS), block_kv=32,
                                  interpret=True), np.float32)
    lens = torch.from_numpy(SPLIT_LENS)
    plain = flash_decode_ref(q, k, v, lens, block_kv=32).float().numpy()
    return dtype, (q, k, v, lens), pallas, plain


@pytest.mark.parametrize("n_split", [1, 2, 3, 8])
def test_flash_decode_split_rule_vs_pallas_and_plain(decode_refs, n_split):
    """Per-split online softmax, empty splits past kv_len, and the fold in
    split order give the Pallas kernel's and the plain version's output."""
    dtype, (q, k, v, lens), pallas, plain = decode_refs
    port = flash_decode_split_ref(q, k, v, lens, n_split=n_split, tile=SPLIT_TILE)
    assert port.dtype == q.dtype
    _check(port, pallas, dtype)
    _check(port, plain, dtype)
    _check(port[0], v[0].float().mean(0).expand(3, -1).numpy(), dtype)


@pytest.mark.parametrize("bk,S,n_split,plan", [
    (32, 1024, None, (16, 64)),     # minitron-4b's decode: 4 sequences x 8 kv heads
    (64, 1024, None, (8, 128)),     # moonshot-v1-16b-a3b: x 16 kv heads
    (128, 1024, None, (8, 128)),    # zamba2-2.7b's shared block: x 32 heads
    (32, 300, None, (5, 64)),       # a ragged cache: one split per 64-row unit
    (32, 64, None, (1, 64)),        # one unit: nothing to split
    (512, 1024, None, (8, 128)),    # enough CTAs, but no split past two units
    (2048, 256, None, (2, 128)),    # the same
    (4, 0, None, (1, 64)),          # an empty cache
    (32, 1024, 3, (3, 384)),        # a count asked for
    (32, 1024, 100, (16, 64)),      # at most one split per unit
])
def test_decode_split_plan(bk, S, n_split, plan):
    """Splits are whole 64-row units, none past the cache, at most two units
    long and about four CTAs per SM of an H100 (132), unless a count is
    asked for."""
    assert split_plan(bk, S, 132, n_split) == plan
    n, rows = plan
    assert (n - 1) * rows < max(S, 1) <= n * rows or S == 0


def test_decode_path_is_chosen_from_shapes_alone():
    """K3's path is planned up front from the shapes (meta tensors here, an
    H100's SM count): minitron-4b's decode splits, a 64-row cache does not,
    and a bad split count is refused."""
    q = torch.empty(4, 24, 128, dtype=torch.bfloat16, device="meta")
    k = torch.empty(4, 1024, 8, 128, dtype=torch.bfloat16, device="meta")
    assert decode_path(q, k) == "split"
    assert decode_path(q, k, n_split=1) == "single"
    assert decode_path(q, k[:, :64]) == "single"
    for bad in (0, -1, 2.0):
        with pytest.raises(ValueError, match="n_split"):
            decode_path(q, k, n_split=bad)


def test_bmod_path_follows_row_alignment():
    """K2 stages with cp.async when l and u rows are whole 16-byte chunks
    (every sparselu block, and the ragged 200 x 72 x 136 case), else with
    plain loads."""
    for (M, N, K), dtype in (((128, 128, 128), torch.float32), ((96, 96, 96), torch.float32),
                             ((200, 72, 136), torch.float32), ((200, 72, 136), torch.bfloat16)):
        l, u = torch.zeros(M, K, dtype=dtype), torch.zeros(K, N, dtype=dtype)
        assert bmod_path(l, u) == "cp_async"
    assert bmod_path(torch.zeros(5, 7), torch.zeros(7, 4)) == "elementwise"
    shifted = torch.zeros(8 * 8 + 1)[1:].view(8, 8)
    assert bmod_path(shifted, torch.zeros(8, 8)) == "elementwise"


def test_gqa_wrappers_match_the_reference_wrappers():
    """The model-layout wrappers (CPU: the plain versions) against the
    reference's (Pallas, interpreted): flash attention with a window, and
    flash decode with a scalar and a per-sequence kv_len."""
    B, S, H, K, d = 2, 64, 6, 2, 32
    (jq, jk, jv), (q, k, v) = _same_inputs(12, [(B, S, H, d), (B, S, K, d),
                                                (B, S, K, d)], "float32")
    for window in (0, 16):
        _check(fa_ops.gqa_flash_attention(q, k, v, causal=True, window=window,
                                          block_kv=32),
               j_gqa_fa(jq, jk, jv, causal=True, window=window, block_q=32,
                        block_kv=32, interpret=True), "float32")
    for kv_len in (40, np.array([17, 64], np.int32)):
        jl = jnp.asarray(kv_len, jnp.int32)
        tl = kv_len if np.ndim(kv_len) == 0 else torch.from_numpy(kv_len)
        _check(fd_ops.gqa_flash_decode(q[:, :1], k, v, tl, block_kv=32),
               j_gqa_fd(jq[:, :1], jk, jv, jl, block_kv=32, interpret=True), "float32")


# ---------------------------------------------------------------------------
# wrappers: no fallback, checked inputs
# ---------------------------------------------------------------------------
def test_cuda_launchers_refuse_cpu_tensors():
    x = torch.zeros(4, 4)
    with pytest.raises(ValueError):
        bmod_cuda(x, x, x)
    with pytest.raises(ValueError):
        mandelbrot_rows_cuda(torch.arange(4, dtype=torch.int32), 8, 8, 10)
    q = torch.zeros(1, 8, 3, 64)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q[:, :, :1], q[:, :, :1])
    with pytest.raises(ValueError):
        flash_decode_cuda(q[:, 0], q[:, :, :1], q[:, :, :1],
                          torch.ones(1, dtype=torch.int32))


def test_attention_launchers_take_head_dim_80():
    """d = 80 (zamba2-2.7b's shared attention block: 2560 / 32) passes the
    launchers' head-dim check, and then they refuse the CPU tensor; an
    unsupported d is refused by the check itself."""
    assert 80 in HEAD_DIMS
    for d, match in ((80, "CUDA device"), (96, "head dim")):
        q = torch.zeros(1, 8, 3, d)
        with pytest.raises(ValueError, match=match):
            flash_attention_cuda(q, q[:, :, :1], q[:, :, :1])
        with pytest.raises(ValueError, match=match):
            flash_decode_cuda(q[:, 0], q[:, :, :1], q[:, :, :1],
                              torch.ones(1, dtype=torch.int32))


@pytest.mark.parametrize("d,dtype,path", [
    (128, torch.bfloat16, "wgmma"), (80, torch.bfloat16, "wgmma"), (64, torch.bfloat16, "wgmma"),
    (256, torch.bfloat16, "cuda_core"), (128, torch.float32, "cuda_core"),
    (80, torch.float32, "cuda_core"), (256, torch.float32, "cuda_core")])
def test_attention_path_is_chosen_from_dtype_shape_and_strides(d, dtype, path):
    """K4's launcher picks its kernel up front, on any device (meta here):
    bf16 at d = 64, 80, 128 on the tensor cores, the rest on CUDA cores; a
    fused projection's strided views take the same path."""
    q = torch.empty(4, 512, 24, d, dtype=dtype, device="meta")
    k = torch.empty(4, 512, 8, d, dtype=dtype, device="meta")
    assert attention_path(q, k, k) == path
    qkv = torch.empty(4, 512, 40 * d, dtype=dtype, device="meta")
    fq, fk, fv = (t.unflatten(-1, (-1, d)) for t in qkv.split([24 * d, 8 * d, 8 * d], -1))
    assert attention_path(fq, fk, fv) == path


def test_attention_path_refuses_what_no_kernel_takes():
    q = torch.zeros(1, 8, 3, 96, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        attention_path(q, q[:, :, :1], q[:, :, :1])
    q = torch.zeros(1, 8, 3, 80, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        attention_path(q, q[:, :, :1].float(), q[:, :, :1])
    with pytest.raises(ValueError, match="shapes"):
        attention_path(q, q[:, :4, :1], q[:, :, :1])
    odd = torch.zeros(1 * 8 * 3 * 80 + 1, dtype=torch.bfloat16)[1:].view(1, 8, 3, 80)
    with pytest.raises(ValueError, match="16-byte"):
        attention_path(odd, odd[:, :, :1], odd[:, :, :1])


def test_build_digest_covers_the_shared_headers(monkeypatch, tmp_path):
    """An edited ``csrc/*.cuh`` (the TMA / mbarrier / wgmma helpers) gives
    every library a new build path, so it rebuilds."""
    for name in ("flash_attention.cu", "hopper.cuh"):
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.lib_path("flash_attention")
    (tmp_path / "hopper.cuh").write_text("// edited\n", encoding="utf-8")
    assert _build.lib_path("flash_attention") != before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc()


def test_launch_counter_is_thread_safe():
    import sys
    import threading
    counter = _build.LaunchCounter()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [counter.add() for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counter.count == 16 * 2000
    counter.reset()
    assert counter.count == 0
