"""Shared pieces of the benchmark's CPU tests: the harness's own modules
and the program on the path, tiny configurations and traffic, and
:func:`write_bench`, a throwaway benchmark built in a temporary directory
from files alone."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_DENSE = {
    "name": "tiny-dense", "family": "dense", "n_layers": 2, "d_model": 64, "n_heads": 4,
    "n_kv": 2, "d_head": None, "d_ff": 128, "vocab": 128, "act": "relu2",
    "tie_embeddings": False, "rope_theta": 10000.0, "rms_eps": 1e-6,
    "param_dtype": "float32", "compute_dtype": "float32", "use_kernels": True,
    "attn_block_q": 32, "attn_block_kv": 32,
    "init": [["embed.table", "normal", 0.125], ["*norm*", "const", 0.0],
             ["*", "normal", 0.25]]}
TINY_CHAT = {
    "arrival": "poisson", "rate_rps": 40.0,
    "prompt": {"dist": "lognormal", "median": 8, "sigma": 0.8, "min": 3, "max": 24},
    "output": {"dist": "lognormal", "median": 4, "sigma": 0.8, "min": 2, "max": 8},
    "engine": {"slots": 4, "max_len": 64}}
TINY_LIMITS = {"sample_tokens": 12,
               "logit_gap": {"limit": 1e-3, "set_from": "tiny CPU cells: float32 both sides"}}


def write_bench(root: Path, cells, metrics_from: Path = BENCH / "metrics") -> Path:
    """A checkout-like ``root`` holding BENCHMARK.json and a benchmark
    folder ``tinybench`` with the given cells [(name, config dict, traffic
    dict)]; the metric readers are copied from ``metrics_from``.  Returns
    the benchmark folder."""
    bench_dir = root / "tinybench"
    for sub in ("configs", "traffic", "limits"):
        (bench_dir / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(metrics_from, bench_dir / "metrics", dirs_exist_ok=True)
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs, workloads = [], []
    for name, conf, traffic in cells:
        cname, tname = conf["name"], f"{name}-traffic"
        (bench_dir / "configs" / f"{cname}.json").write_text(json.dumps(conf))
        (bench_dir / "traffic" / f"{tname}.json").write_text(json.dumps(traffic))
        (bench_dir / "limits" / f"{name}.json").write_text(json.dumps(TINY_LIMITS))
        if cname not in {c["name"] for c in configs}:
            configs.append({"name": cname, "source": "tiny", "reduced": [], "why": "test",
                            "file": f"tinybench/configs/{cname}.json"})
        workloads.append({"name": name, "config": cname, "traffic": tname, "chips": 1,
                          "why": "test"})
    names = [w["name"] for w in workloads]

    def keep(metrics):
        out = []
        for m in metrics:
            m = dict(m)
            if "workloads" in m:
                m["workloads"] = names
            out.append(m)
        return out

    bench = {"command": ["python3", "tinybench/run.py"], "paths": ["tinybench"],
             "run_seconds": 1, "configs": configs, "workloads": workloads,
             "end_to_end": keep(real["end_to_end"]), "per_layer": keep(real["per_layer"])}
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench_dir
