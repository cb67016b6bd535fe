"""Hierarchical vs flat collectives on a rack/spine topology.

The port's counterpart of ``benchmarks/topo_collectives.py``: the same three
sections, on the workloads of :mod:`.comm_modes` (the same seeded inputs,
runtime calls and byte columns), with the reference's asserts.

* ``collectives`` — flat ring vs hierarchical vs hierarchical + int8-wire
  all-reduce per topology shape (:func:`.comm_modes.collectives`).
  Asserted: the hierarchical sum equals the serial left-associated sum bit
  for bit, the flat ring's within rtol 1e-5, the int8 wire's within the
  block-int8 bound; the hierarchical path crosses the spine with at most
  60% of the flat ring's bytes, exactly ``2 (R - 1)`` vectors; the mean
  agrees bit for bit between the flat and hierarchical dispatches.
* ``sparselu`` — the §5.6 wavefront under round-robin, HEFT priced blind
  (flat peer link) and HEFT priced per pair through the topology
  (:func:`run_sparselu`).  Asserted: bit-identical results, and aware HEFT
  puts no more bytes on the spine than round-robin.
* ``dp_ring`` — ``data_parallel_step(comm_mode="direct")`` with flat and
  hierarchical dispatch (:func:`.comm_modes.dp_ring`).  Asserted:
  bit-identical parameters, fewer cross-rack bytes hierarchically.

    python -m repro_torch.topo_collectives --smoke --device cpu --json PATH

``--json`` writes ``BENCH_topo.json``'s layout (``gate_topology`` and
``inter_bw_ratio`` beside the sections).  Each section takes ``device``
(the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Sequence, Tuple

import torch

from . import comm_modes as cm
from ._device import DeviceLike
from .core import ClusterRuntime, HeftPlacement, RuntimeConfig, Topology
from .core.costmodel import PAPER_ETHERNET


def check_collectives(rows: List[Dict], got: Dict[Any, Any]) -> None:
    """The reference's asserts on :func:`.comm_modes.collectives`' output."""
    for (racks, per), out in got.items():
        vals = out["values"]
        serial = vals[0]
        for v in vals[1:]:
            serial = serial + v
        # the hierarchical leader chain IS the serial association — bitwise;
        # the flat ring's rotated association only agrees to float tolerance
        assert torch.equal(out["hier"].cpu(), serial), (racks, per)
        assert torch.allclose(out["flat-ring"].cpu(), serial, rtol=1e-5, atol=1e-6)
        err = float((out["hier+int8"].cpu() - serial).abs().max())
        assert err <= float(serial.abs().max()) / 64, (err,)   # block-int8 bound
        x = {r["mode"]: r["bytes_cross_rack"] for r in rows
             if (r["racks"], r["per_rack"]) == (racks, per)}
        n_elem = next(r["elems"] for r in rows if (r["racks"], r["per_rack"]) == (racks, per))
        # >= 40% fewer cross-rack bytes: 2(R-1) spine crossings, not 2(D-1)
        assert x["hier"] <= 0.6 * x["flat-ring"], (racks, per, x)
        assert x["hier"] == 2 * (racks - 1) * n_elem * 4, (racks, per, x)
        want = sum(vals) / len(vals)
        for m in out["mean:hier"] + out["mean:flat"]:
            assert torch.equal(m.cpu(), want), (racks, per)


def run_collectives(shapes=((2, 4), (4, 2), (2, 2), (3, 3)), n_elem: int = 4096,
                    ratio: float = 0.1, *, device: DeviceLike = "cuda") -> List[Dict]:
    rows, got = cm.collectives(shapes, n_elem, ratio, device=device)
    check_collectives(rows, got)
    return rows


def run_sparselu(K: int = 4, B: int = 32, shapes: Sequence = ((2, 2), (2, 4)),
                 ratio: float = 0.1, *, device: DeviceLike = "cuda"
                 ) -> Tuple[List[Dict], Dict[Any, Dict[str, Dict]]]:
    """The sparselu wavefront, every edge peer-routed, under round-robin,
    HEFT priced blind (flat peer link) and HEFT priced per pair through the
    topology (HEFT frozen at 5 µs, the comm-bound operating point), all
    accounted against the same two-tier topology: the rows and, per shape,
    each placement's results.  Asserts bit-identical results and that
    topology-aware HEFT puts no more bytes on the spine than round-robin."""
    from .bots import sparselu as bl
    rows: List[Dict] = []
    got: Dict[Any, Dict[str, Dict]] = {}
    for racks, per in shapes:
        topo = Topology.two_tier(racks, per, inter_bw_ratio=ratio)
        D = topo.n_devices
        mat = bl._matrix(K, B)
        menu = (("round-robin", "round-robin", None),
                ("heft-blind", HeftPlacement(default_task_s=5e-6,
                                             use_observed=False), None),
                ("heft-aware", HeftPlacement(default_task_s=5e-6,
                                             use_observed=False), topo))
        vals: Dict[str, Dict] = {}
        cross: Dict[str, float] = {}
        for name, policy, cfg_topo in menu:
            rt = ClusterRuntime(RuntimeConfig(n_virtual=D, link=PAPER_ETHERNET,
                                              topology=cfg_topo),
                                table=bl._make_table(K), device=device)
            try:
                res = rt.wavefront_offload(bl._build_dag(mat, K, B), nowait=True,
                                           peer=True, policy=policy)
                rt.cost.topology = topo          # blind runs: account anyway
                s = rt.cost.summary()
            finally:
                rt.shutdown()
            vals[name] = {k: v.cpu() for k, v in res.items()}
            cross[name] = s["bytes_peer_cross_rack"]
            rows.append({"section": "sparselu", "policy": name,
                         "racks": racks, "per_rack": per, "devices": D,
                         "comm_s": s["comm_s"] + s["peer_s"],
                         "bytes_peer": s["bytes_peer"],
                         "bytes_cross_rack": s["bytes_peer_cross_rack"]})
        for name in ("heft-blind", "heft-aware"):    # placement never moves bits
            assert vals[name].keys() == vals["round-robin"].keys(), name
            for k, v in vals["round-robin"].items():
                assert torch.equal(v, vals[name][k]), (name, k)
        assert cross["heft-aware"] <= cross["round-robin"], cross
        got[(racks, per)] = vals
    return rows, got


def run_dp_ring(d_model: int = 64, n_batch: int = 8, racks: int = 2, per: int = 4,
                steps: int = 4, sync_every: int = 2, ratio: float = 0.1, *,
                device: DeviceLike = "cuda") -> List[Dict]:
    rows, got = cm.dp_ring(d_model, n_batch, racks, per, steps, sync_every, ratio,
                           device=device)
    # the serial association survives the whole training loop: parameters
    # after hierarchical syncs are BITWISE those of the flat dispatch
    for leaf in ("w", "b"):
        assert torch.equal(got["flat"][leaf].cpu(), got["hier"][leaf].cpu()), leaf
    assert rows[1]["bytes_cross_rack"] < rows[0]["bytes_cross_rack"], rows
    return rows


def render(rows: List[Dict], title: str, cols: List[str]) -> str:
    out = [f"## {title}", " ".join(f"{c:>16}" for c in cols)]
    for r in rows:
        out.append(" ".join(
            f"{r[c]:>16.6g}" if isinstance(r[c], float) else f"{r[c]:>16}"
            for c in cols))
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true",
                    help="small sizes: same code paths and the same asserts")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="dump every section's rows to PATH (BENCH_topo.json's layout)")
    ap.add_argument("--inter-bw-ratio", type=float, default=0.1, metavar="R",
                    help="spine bandwidth as a fraction of the intra-rack link")
    ap.add_argument("--device", default="cuda",
                    help="where the virtual devices live (default: cuda)")
    ap.add_argument("--launches", metavar="PATH", default=None,
                    help="write this run's kernel launch counts to PATH")
    args = ap.parse_args(argv)
    r, dev = args.inter_bw_ratio, args.device
    if args.smoke:
        sections = {
            "collectives": run_collectives(shapes=((2, 4), (2, 2)), n_elem=1024,
                                           ratio=r, device=dev),
            "sparselu": run_sparselu(K=3, B=16, shapes=((2, 2),), ratio=r,
                                     device=dev)[0],
            "dp_ring": run_dp_ring(d_model=32, n_batch=4, steps=2, ratio=r,
                                   device=dev),
        }
    else:
        sections = {"collectives": run_collectives(ratio=r, device=dev),
                    "sparselu": run_sparselu(ratio=r, device=dev)[0],
                    "dp_ring": run_dp_ring(ratio=r, device=dev)}
    print(render(sections["collectives"],
                 "allreduce: flat ring vs hierarchical (cross-rack bytes)",
                 ["mode", "racks", "per_rack", "bytes_peer", "bytes_cross_rack",
                  "peer_s"]))
    print(render(sections["sparselu"],
                 "sparselu wavefront: round-robin vs HEFT blind/topology-aware",
                 ["policy", "racks", "per_rack", "bytes_peer", "bytes_cross_rack",
                  "comm_s"]))
    print(render(sections["dp_ring"],
                 "data_parallel_step(direct): flat vs hierarchical dispatch",
                 ["dispatch", "racks", "per_rack", "bytes_peer", "bytes_cross_rack",
                  "comm_s"]))
    x = {c["mode"]: c["bytes_cross_rack"] for c in sections["collectives"]
         if (c["racks"], c["per_rack"]) == (2, 4)}
    print(f"  → hierarchical allreduce crosses the spine with "
          f"{100 * (1 - x['hier'] / x['flat-ring']):.1f}% fewer bytes than the flat "
          f"ring (gate: >=40%) — bit-identical to the serial association")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"benchmark": "topo_collectives", "smoke": bool(args.smoke),
                       "inter_bw_ratio": r,
                       "gate_topology": Topology.two_tier(
                           2, 4, inter_bw_ratio=r).describe(),
                       "sections": sections}, f, indent=2, sort_keys=True)
        print(f"wrote {args.json}")
    from .kernels import write_launch_report
    write_launch_report(args.launches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
