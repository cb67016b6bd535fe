"""Time the sparselu wavefront on the card, host funnel against peer fabric.

    PYTHONPATH=src python -m repro_torch.bots.fabric_timing --pairs 8

K=16, B=128 (1,496 tasks, 1,240 bmods) on 4 virtual devices, each run on a
fresh runtime: ``host-mediated`` (every edge fetched to the host and
re-sent) and ``direct`` (``comm_mode="direct"``, ``wavefront(peer=True)``:
every edge a SEND/RECV between two virtual devices).  One warm-up run of
each, then ``--pairs`` pairs in turns (H D D H H D D H ...), wall seconds by
the host clock around work that ends in a synchronize.  Prints one JSON
line per run, then one summary line: each fabric's median and quartiles,
the share of pairs the peer run won, and the card's name and power limit
(``nvidia-smi``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

K, B, DEVICES = 16, 128, 4


def run_once(fabric: str, mat: torch.Tensor) -> dict:
    from repro_torch.bots import sparselu as bl
    from repro_torch.core import ClusterRuntime, RuntimeConfig
    rt = ClusterRuntime(RuntimeConfig(n_virtual=DEVICES, comm_mode=fabric),
                        table=bl._make_table(K), device="cuda")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bl.wavefront(rt, mat, peer=fabric == "direct")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = rt.cost.summary()
    finally:
        rt.shutdown()
    return {"fabric": fabric, "wall_s": wall,
            **{k: s[k] for k in ("bytes_to", "bytes_from", "bytes_peer")}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fabric_timing needs a CUDA card")
    from repro_torch.bots import sparselu as bl
    mat = bl._matrix(K, B)
    for fabric in ("host-mediated", "direct"):          # warm-up, not kept
        run_once(fabric, mat)
    walls = {"host-mediated": [], "direct": []}
    for i in range(args.pairs):
        order = ("host-mediated", "direct") if i % 2 == 0 else ("direct", "host-mediated")
        for fabric in order:
            row = run_once(fabric, mat)
            walls[fabric].append(row["wall_s"])
            print(json.dumps({"pair": i, **row}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    summary = {f: {"median_s": float(np.median(w)),
                   "quartiles_s": [float(q) for q in np.percentile(w, [25, 75])]}
               for f, w in walls.items()}
    wins = sum(d < h for h, d in zip(walls["host-mediated"], walls["direct"]))
    print(json.dumps({"K": K, "B": B, "devices": DEVICES, "pairs": args.pairs,
                      **summary, "peer_won_share": wins / args.pairs,
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
