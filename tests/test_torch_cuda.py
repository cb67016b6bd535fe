"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the BOTS workloads launching them end to end.

Every test here needs a card and is marked ``cuda``; whether a card is
present is decided inside the fixture, so every worker collects the same
tests and they skip without one.  This file imports neither JAX nor the
reference package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.bots import mandelbrot as tbm
from repro_torch.bots import sparselu as tbl
from repro_torch.kernels.block_lu import block_lu as k2
from repro_torch.kernels.block_lu.ops import bmod_op
from repro_torch.kernels.block_lu.ref import bmod_ref
from repro_torch.kernels.mandelbrot import mandelbrot as k1
from repro_torch.kernels.mandelbrot.ops import mandelbrot_rows
from repro_torch.kernels.mandelbrot.ref import mandelbrot_rows_ref

pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("M,N,K", [(128, 128, 128), (96, 96, 96), (200, 72, 136)])
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


def test_bots_verify_on_card(cuda_device):
    before = (k1.launches.count, k2.launches.count)
    assert tbm.verify("small", n_devices=4, device="cuda") == (0, 0.0)
    assert tbl.verify("large", n_devices=4, device="cuda") == 0.0
    assert k1.launches.count > before[0] and k2.launches.count > before[1]
