"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names; the plain references, the harness's and each
configuration's own, load nothing of the program."""
from __future__ import annotations

import subprocess
import sys

from conftest import BENCH, MOE_REFERENCE, ROOT, write_reference
from pb import imports


def _loaded(code: str) -> str:
    out = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(ROOT / 'src')!r}]\n{code}\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        capture_output=True, text=True, check=True, cwd=str(ROOT),
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    return out.stdout.strip().splitlines()[-1]


def test_names_are_compared_whole():
    assert imports.forbidden(["repro_torch", "repro_torch.serve", "reprox", "jaxtyping"]) == []
    assert imports.forbidden(["repro.core", "jax._src", "flax", "jaxlib.x"]) == \
        ["flax", "jax", "jaxlib", "repro"]
    assert imports.forbidden(["benchmarks.bots_fib"]) == ["benchmarks"]


def test_the_harness_and_the_program_load_no_jax():
    code = ("from pb import cell, check, control_run, loop, reference, spec, trace\n"
            "import repro_torch.serve, repro_torch.models\n"
            "from pb import imports; assert imports.forbidden() == [], imports.forbidden()")
    names = eval(_loaded(code))
    assert "repro_torch" in names and "torch" in names
    assert not set(names) & imports.FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = eval(_loaded("from pb import check, reference"))
    assert "repro_torch" not in names and not set(names) & imports.FORBIDDEN


def test_each_configurations_reference_loads_nothing_of_the_program(tmp_path):
    """Every ``references/*.py``, and a throwaway one, loaded by path as a
    run loads it."""
    paths = sorted((BENCH / "references").glob("*.py"))
    paths.append(write_reference(tmp_path / "tinybench", "tiny-moe", MOE_REFERENCE))
    for path in paths:
        names = eval(_loaded(
            "import importlib.util\n"
            f"s = importlib.util.spec_from_file_location('ref', {str(path)!r})\n"
            "m = importlib.util.module_from_spec(s); s.loader.exec_module(m)\n"
            "assert callable(m.logits)"))
        assert "repro_torch" not in names and not set(names) & imports.FORBIDDEN, path
        assert "repro_torch" not in path.read_text(), path


def test_no_harness_source_imports_jax_or_the_program_from_the_reference():
    for path in list((BENCH / "pb").glob("*.py")) + list((BENCH / "metrics").glob("*.py")) \
            + list((BENCH / "references").glob("*.py")) \
            + [BENCH / "run.py", BENCH / "sweep.py", BENCH / "control.py"]:
        text = path.read_text()
        for bad in ("import jax", "from jax", "import repro\n", "from repro ", "from repro.",
                    "import repro.", "import benchmarks", "from benchmarks"):
            assert bad not in text, (path, bad)
    ref = (BENCH / "pb" / "reference.py").read_text()
    assert "repro_torch" not in ref
