"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or ``repro``, the whole package imports
with JAX unavailable, and its entry points default to the card — raising
when there is none instead of picking the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def _modules():
    out = []
    for p in sorted(PKG.rglob("*.py")):
        parts = p.relative_to(PKG.parent).with_suffix("").parts
        out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return out


# subprocesses run single-threaded: six test workers share the CPU
_ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def fresh_import():
    """One fresh interpreter imports every module of the package with
    ``jax``, ``jaxlib`` and ``repro`` made unimportable and with building or
    loading a kernel turned into an error; the finished process."""
    code = ("import importlib, sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            "from repro_torch.kernels import _build\n"
            "def refuse(*args, **kwargs):\n"
            "    raise AssertionError('a kernel was built or loaded at import')\n"
            "_build.build = _build.library = refuse\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not _build._libs\n")
    env = {**os.environ, **_ONE_THREAD, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=str(ROOT),
                          capture_output=True, text=True, timeout=300)


def test_package_imports_without_jax(fresh_import):
    assert fresh_import.returncode == 0, fresh_import.stderr
    assert len(_modules()) >= 20


def test_kernel_modules_build_nothing_at_import(fresh_import):
    """Every module imports, the kernel launchers and the MoE model
    included, without building or loading a kernel: that waits for the
    first launch on the card."""
    modules = _modules()
    assert "repro_torch.kernels.grouped_matmul.grouped_matmul" in modules
    assert "repro_torch.models.moe" in modules
    for name in ("models.ssm", "models.mamba_lm", "models.hybrid",
                 "kernels.ssd_scan.ssd_scan", "kernels.ssd_scan.ops",
                 # the fabric
                 "core.compression", "core.topology", "core.transport",
                 "kernels.q8_wire.q8_wire", "kernels.q8_wire.ops",
                 "optim.adamw", "optim.schedule", "comm_modes"):
        assert f"repro_torch.{name}" in modules
    assert fresh_import.returncode == 0, fresh_import.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    """CUDA absent, whatever the machine has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_runtime_defaults_to_the_card(no_cuda):
    from repro_torch.core import ClusterRuntime, DevicePool, RuntimeConfig
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClusterRuntime(RuntimeConfig(n_virtual=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClusterRuntime(RuntimeConfig(n_virtual=2, comm_mode="direct"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DevicePool.virtual(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DevicePool.from_config(["node0 2"])
    rt = ClusterRuntime(RuntimeConfig(n_virtual=2), device="cpu")
    assert rt.device == torch.device("cpu")
    rt.shutdown()


def test_bots_default_to_the_card(no_cuda):
    from repro_torch.bots import mandelbrot, sparselu
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sparselu.verify("small")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mandelbrot.verify("small")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sparselu.run("small", device_counts=(1,))


def test_model_and_engine_default_to_the_card(no_cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    from repro_torch.serve import ServeConfig, ServeEngine
    model = Model(get_smoke_config("minitron-4b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init(torch.Generator().manual_seed(0))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.load_numpy({"w": params["final_norm"].float().numpy()})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(model, params, ServeConfig())
    assert ServeEngine(model, params, ServeConfig(), device="cpu").device.type == "cpu"
    for arch in ("mamba2-130m", "zamba2-2.7b"):          # the state families too
        model = Model(get_smoke_config(arch))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            model.init(torch.Generator().manual_seed(0))
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ServeEngine(model, params, ServeConfig())
        assert ServeEngine(model, params, ServeConfig(), device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_a_card():
    """Without a card the script exits non-zero and prints no result."""
    code = ("import runpy, sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['chip_smoke.py']\n"
            f"runpy.run_path({str(ROOT / 'chip_smoke.py')!r}, run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env={**os.environ, **_ONE_THREAD},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
