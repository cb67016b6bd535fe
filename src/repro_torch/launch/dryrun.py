"""The dry run on one card: every (architecture × shape) cell's bytes and bound.

The port's counterpart of ``repro/launch/dryrun.py``.  The reference lowers
and compiles each cell's step for a TPU mesh and reads XLA's memory and cost
analyses.  On one H100 the dry run keeps its meaning without a compiler: for
every cell of ``SHAPES`` it builds the model's parameters on the ``meta``
device (shapes and dtypes, no storage), counts what the step needs resident
— parameters, AdamW's moments for train (the reference's ``_opt_for``
rule: bf16 moments above 100 B parameters), the step's inputs and, for
decode, the cache — and prices the step against the card's roofs with
``launch.hlo_analysis.analyze_step`` at the reference's count
(``cost="reference"``: each record's FLOPs and bytes are the reference dry
run's).  Nothing is allocated on any device.

    python -m repro_torch.launch.dryrun --all                  # the card
    python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k \\
        --device cpu

writes one JSON per cell to ``build/dryrun/<arch>__<shape>__h100.json``
(``--out``) in the reference's record layout: ``arch``, ``shape``, ``mesh``
("h100"), ``chips`` (1), ``kind``, the ``Roofline.to_dict()`` fields and
``memory_analysis`` with ``argument_bytes``, ``output_bytes`` and
``alias_bytes``.  ``temp_bytes`` is null: no compiler reports the step's
activations here.  ``fits_one_card`` says whether the argument bytes fit
one 80 GB card.  Skipped cells follow ``shape_cells``.  The reference's
XLA lowering, ``CFG_OVERRIDES``, ``--rules`` and ``--mesh multi`` belong to
its TPU meshes and have no counterpart.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict

import torch

from .._device import DeviceLike, resolve_device
from ..configs.registry import ARCHS, SHAPES, get_config, input_specs, shape_cells
from ..core import _tree
from ..models.config import param_count
from ..models.model import Model
from ..optim import AdamW, AdamWConfig
from .hlo_analysis import analyze_step

#: One H100's memory, as the fit test reads it (the card is sold as 80 GB).
CARD_BYTES = 80e9
MESH = "h100"


def _opt_for(cfg) -> AdamW:
    """fp32 moments by default; bf16 for the ≥100B cells (the reference's
    rule)."""
    total, _ = param_count(cfg)
    dtype = "bfloat16" if total > 100e9 else "float32"
    return AdamW(AdamWConfig(state_dtype=dtype))


def _nbytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in _tree.leaves(tree)
               if isinstance(t, torch.Tensor))


def _on_meta(tree: Any) -> bool:
    return all(t.device.type == "meta" for t in _tree.leaves(tree)
               if isinstance(t, torch.Tensor) and t.dim() > 0)


def lower_cell(arch: str, shape_name: str, *,
               device: DeviceLike = "cuda") -> Dict[str, Any]:
    """One cell's record; every tensor it makes lives on ``meta``.  ``device``
    is the card the bound is read for (its name goes into the record)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    spec = SHAPES[shape_name]
    model = Model(cfg)
    total, active = param_count(cfg)

    t0 = time.time()
    params = model.init_abstract()
    args = {"params": params, "inputs": input_specs(cfg, spec)}
    out_bytes = alias_bytes = 0
    B, S = spec.batch, spec.seq
    logits_bytes = B * cfg.vocab * 4                 # last-position logits, f32
    if spec.kind == "train":
        args["opt_state"] = _opt_for(cfg).init(params)
        # the updated parameters and moments take the old ones' place
        alias_bytes = _nbytes(params) + _nbytes(args["opt_state"])
        out_bytes = alias_bytes
    else:
        memory = None
        if cfg.is_encdec:
            memory = torch.empty(B, S // 2, cfg.d_model, device="meta",
                                 dtype=getattr(torch, cfg.compute_dtype))
        cache = model.make_cache(params, B, S, memory)
        if spec.kind == "decode":
            args["cache"] = cache                    # updated in place
            alias_bytes = _nbytes(cache)
        out_bytes = logits_bytes + _nbytes(cache)
    if not _on_meta(args):
        raise AssertionError(f"{arch} × {shape_name}: a tensor left the meta device")
    arg_bytes = _nbytes(args)
    t_build = time.time() - t0

    opt_bytes = 2 if total > 100e9 else 4
    rf = analyze_step(cfg, spec.kind, S, B, arch=arch, shape=shape_name,
                      opt_bytes=opt_bytes, cost="reference",
                      bytes_per_device=float(arg_bytes + out_bytes - alias_bytes))
    mem = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
           "temp_bytes": None, "alias_bytes": alias_bytes,
           "params_bytes": _nbytes(params),
           "opt_state_bytes": _nbytes(args.get("opt_state")),
           "input_bytes": _nbytes(args["inputs"]),
           "cache_bytes": _nbytes(args.get("cache"))}
    return {
        **rf.to_dict(),
        "kind": spec.kind,
        "params_total": total, "params_active": active,
        "memory_analysis": mem,
        "build_s": t_build,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "fits_one_card": arg_bytes <= CARD_BYTES,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS) + [None])
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES) + [None])
    ap.add_argument("--all", action="store_true", help="full assignment matrix")
    ap.add_argument("--out", default=os.path.join("build", "dryrun"))
    ap.add_argument("--device", default="cuda",
                    help="the card whose bound is read (default: cuda)")
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if args.all or args.arch is None else [args.arch]
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape_name, status, reason in shape_cells(arch):
            if args.shape and shape_name != args.shape:
                continue
            if status == "skip":
                print(f"[skip] {arch} × {shape_name}: {reason}", flush=True)
                continue
            fn = os.path.join(args.out, f"{arch}__{shape_name}__{MESH}.json")
            try:
                rec = lower_cell(arch, shape_name, device=args.device)
            except Exception as e:                  # recorded, and exit 1
                failures.append((arch, shape_name, repr(e)))
                print(f"[fail] {arch} × {shape_name}: {e!r}", flush=True)
                continue
            with open(fn, "w") as f:
                json.dump(rec, f, indent=1)
            ma = rec["memory_analysis"]
            print(f"[cell] {arch} × {shape_name}: flops={rec['hlo_flops']:.3e} "
                  f"bytes={rec['hlo_bytes']:.3e} bottleneck={rec['bottleneck']} "
                  f"t_bound={max(rec['t_compute_s'], rec['t_memory_s']):.4g}s "
                  f"args={ma['argument_bytes'] / 1e9:.2f}GB "
                  f"fits_one_card={rec['fits_one_card']}", flush=True)
    if failures:
        print("\nFAILURES:", flush=True)
        for f in failures:
            print(" ", f, flush=True)
        return 1
    print("\ndry-run complete.", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
