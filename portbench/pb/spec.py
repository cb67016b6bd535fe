"""The benchmark's own files, found by name.

``BENCHMARK.json`` at the checkout's root names every cell, configuration
and metric; each of them is a file under ``portbench/``:

* ``configs/<name>.json``: a model configuration as it is run (the port's
  ``ModelConfig`` fields, a sub-config such as ``moe`` or ``ssm`` as a
  nested object of its field's name, holding that dataclass's fields only),
  its weight initialisation and its published source;
* ``references/<name>.py``: the configuration's plain reference, a function
  ``logits(params, conf, tokens, rows, prec)`` in plain PyTorch that may use
  :mod:`pb.reference`'s helpers; without the file, :func:`pb.reference.logits`,
  the dense family's;
* ``traffic/<name>.json``: a traffic mix, the parameters of the one
  generator in :mod:`pb.traffic`;
* ``metrics/<name>.py``: the reader of one metric, a function
  ``read(ctx)`` that returns a number or None;
* ``limits/<cell>.json``: the limits of the cell's correctness check.

A new cell, configuration, traffic mix or metric is a new file and a new
entry in ``BENCHMARK.json``; no file here needs an edit.  A configuration of
another family (moe, ssm, hybrid, vlm, encdec) brings ``configs/<name>.json``
with its nested objects, ``references/<name>.py``, ``limits/<cell>.json``,
its traffic and the readers of its metrics (with their counts in a new
module under ``pb/`` where :mod:`pb.costs` covers only the dense family).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import typing
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


CACHE_VARS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TORCHINDUCTOR_CACHE_DIR": "inductor", "CUDA_CACHE_PATH": "cuda"}


def set_cache_env(root: Path = ROOT) -> None:
    """Point every compiler cache a run could fill at a fixed directory
    inside the checkout (``build/portbench-cache``), before torch loads.
    The program's own kernels build into ``build/kernels`` there."""
    for var, sub in CACHE_VARS.items():
        os.environ[var] = str(root / "build" / "portbench-cache" / sub)


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    workloads: Optional[List[str]]
    moves: Optional[str] = None

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int
    config_file: Path
    traffic_file: Path
    limits_file: Path
    reference_file: Path
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _metrics(entries: List[Dict[str, Any]]) -> List[Metric]:
    return [Metric(name=e["name"], unit=e["unit"], workloads=e.get("workloads"),
                   moves=e.get("moves")) for e in entries]


def resolve_cell(bench: Dict[str, Any], name: str, root: Path = ROOT,
                 bench_dir: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``bench`` with the files it runs from.  The
    configuration's file is the one ``BENCHMARK.json`` names; traffic,
    limits, the configuration's reference and metric readers are found by
    name under ``bench_dir``."""
    bench_dir = BENCH_DIR if bench_dir is None else bench_dir
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return Cell(
        name=name, config=w["config"], traffic=w["traffic"], chips=int(w["chips"]),
        config_file=root / configs[w["config"]]["file"],
        traffic_file=bench_dir / "traffic" / f"{w['traffic']}.json",
        limits_file=bench_dir / "limits" / f"{name}.json",
        reference_file=bench_dir / "references" / f"{w['config']}.py",
        end_to_end=[m for m in _metrics(bench["end_to_end"]) if m.applies_to(name)],
        per_layer=[m for m in _metrics(bench["per_layer"]) if m.applies_to(name)])


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _load(path: Path, module: str):
    """The module at ``path``, loaded by path: a name may hold dots."""
    spec = importlib.util.spec_from_file_location(module, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Optional[Path] = None) -> Callable[[Any], Any]:
    """``read`` of ``metrics/<name>.py``."""
    path = (BENCH_DIR if bench_dir is None else bench_dir) / "metrics" / f"{name}.py"
    return _load(path, f"portbench_metric_{name}").read


def reference_logits(cell: Cell) -> Callable[..., Any]:
    """``logits`` of the cell's ``references/<config>.py``, or
    :func:`pb.reference.logits` where the configuration has no such file."""
    if cell.reference_file.is_file():
        return _load(cell.reference_file, f"portbench_reference_{cell.config}").logits
    from . import reference
    return reference.logits


def _sub_config(hint: Any) -> Optional[type]:
    """The dataclass a field's type names (``Optional[MoEConfig]``), if any."""
    for t in (hint, *typing.get_args(hint)):
        if dataclasses.is_dataclass(t):
            return t
    return None


def _build(cls: type, conf: Dict[str, Any], nested: bool = False):
    """``cls`` from the keys of ``conf`` that name its fields; a field whose
    type is a dataclass is built from the object of its name, recursively.
    A nested object holds fields only: a key that names none is refused."""
    hints = typing.get_type_hints(cls)
    names = [f.name for f in dataclasses.fields(cls)]
    unknown = sorted(set(conf) - set(names))
    if nested and unknown:
        raise ValueError(f"{cls.__name__} has no field {unknown}")
    kw = {}
    for name in names:
        if name in conf:
            v, sub = conf[name], _sub_config(hints[name])
            kw[name] = _build(sub, v, True) if sub is not None and isinstance(v, dict) else v
    return cls(**kw)


def model_config(conf: Dict[str, Any]):
    """The port's ``ModelConfig`` from a configuration file: its fields are
    the file's keys of those names, a sub-config's from the nested object of
    its name; every other top-level key is documentation."""
    from repro_torch.models.config import ModelConfig
    return _build(ModelConfig, conf)
