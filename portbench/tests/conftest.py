"""Shared pieces of the benchmark's CPU tests: the harness's own modules
and the program on the path, tiny configurations and traffic, a plain
reference of the tiny MoE configuration, and :func:`write_bench`, a
throwaway benchmark built in a temporary directory from files alone."""
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
# capacity_factor = n_experts / top_k: an expert's capacity is every token,
# so no assignment drops and the plain reference needs no capacity rule
TINY_MOE = {
    **TINY_DENSE, "name": "tiny-moe", "family": "moe", "act": "swiglu", "use_kernels": False,
    "moe": {"n_experts": 4, "top_k": 2, "d_ff_expert": 32, "capacity_factor": 2.0,
            "router_dtype": "float32", "n_shared_experts": 1}}
# the plain reference of TINY_MOE, as a configuration's references/<name>.py:
# the port's equations in float32, one sequence at a time
MOE_REFERENCE = '''"""Plain float32 forward of a MoE decoder: GQA attention, softmax top-k
routing with renormalised weights, SwiGLU experts and the shared expert."""
import torch
import torch.nn.functional as F

from pb import reference as R

SHARED_EXPERT = True


def _layer(stacked, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in stacked.items()}


def swiglu(h, w_gate, w_in, w_out, prec):
    return prec.mm(F.silu(prec.mm(h, w_gate)) * prec.mm(h, w_in), w_out)


def moe(p, h, m, prec):
    probs = torch.softmax(h @ p["router"].float(), -1)          # the router in float32
    w, idx = torch.topk(probs, m["top_k"], dim=-1)
    w = w / w.sum(-1, keepdim=True)
    experts = torch.stack([swiglu(h, p["w_gate"][e], p["w_in"][e], p["w_out"][e], prec)
                           for e in range(m["n_experts"])])      # [E, L, d]
    rows = torch.arange(h.shape[0], device=h.device)
    y = sum(w[:, j, None] * experts[idx[:, j], rows] for j in range(m["top_k"]))
    if SHARED_EXPERT and m.get("n_shared_experts", 0):
        y = y + swiglu(h, p["shared_gate"], p["shared_in"], p["shared_out"], prec)
    return y


def logits(params, conf, tokens, rows, prec=R.FP32):
    eps = conf["rms_eps"]
    x = params["embed"]["table"][tokens].float() * R.embed_scale(conf)
    for i in range(conf["n_layers"]):
        lp = _layer(params["layers"], i)
        x = x + R.attention(lp["attn"], R.rms_norm(x, lp["norm1"], eps), conf, prec)
        x = x + moe(lp["moe"], R.rms_norm(x, lp["norm2"], eps), conf["moe"], prec)
    x = R.rms_norm(x[rows], params["final_norm"], eps)
    return prec.mm(x, params.get("unembed", params["embed"])["table"].T)
'''
TINY_CHAT = {
    "arrival": "poisson", "rate_rps": 40.0,
    "prompt": {"dist": "lognormal", "median": 8, "sigma": 0.8, "min": 3, "max": 24},
    "output": {"dist": "lognormal", "median": 4, "sigma": 0.8, "min": 2, "max": 8},
    "engine": {"slots": 4, "max_len": 64}}
TINY_LIMITS = {"sample_tokens": 12,
               "logit_gap": {"limit": 1e-3, "set_from": "tiny CPU cells: float32 both sides"}}


def write_reference(bench_dir: Path, config: str, source: str) -> Path:
    """``references/<config>.py`` of a throwaway benchmark folder."""
    path = bench_dir / "references" / f"{config}.py"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(source)
    return path


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
