"""Architecture registry: ``--arch <id>`` lookup, shape cells, smoke batches.

The port's copy of the reference's registry.  The 40-cell assignment matrix
is ARCHS × SHAPES; :func:`shape_cells` marks the documented skips
(``long_500k`` for non-sub-quadratic archs).  The reference's
``input_specs`` (abstract ``jax.ShapeDtypeStruct`` stand-ins for its dry-run
driver) has no counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

from ..models import ModelConfig
from . import (gemma3_4b, gemma_7b, internvl2_2b, kimi_k2_1t_a32b,
               mamba2_130m, minitron_4b, moonshot_v1_16b_a3b, qwen2_72b,
               seamless_m4t_large_v2, zamba2_2_7b)

_MODULES = [zamba2_2_7b, seamless_m4t_large_v2, gemma_7b, qwen2_72b,
            minitron_4b, gemma3_4b, internvl2_2b, moonshot_v1_16b_a3b,
            kimi_k2_1t_a32b, mamba2_130m]

ARCHS: Dict[str, Any] = {m.ARCH_ID: m for m in _MODULES}


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch].config()


def get_smoke_config(arch: str) -> ModelConfig:
    return ARCHS[arch].smoke()


def shape_cells(arch: str) -> List[Tuple[str, str, str]]:
    """[(shape_name, 'run'|'skip', reason)] for the 4 assigned shapes."""
    cfg = get_config(arch)
    out = []
    for name, spec in SHAPES.items():
        if name == "long_500k" and not cfg.sub_quadratic:
            out.append((name, "skip",
                        "full quadratic attention; sub-quadratic required "
                        "(DESIGN.md §Arch-applicability)"))
        else:
            out.append((name, "run", ""))
    return out


def smoke_batch(cfg: ModelConfig, generator: torch.Generator,
                batch: int = 2, seq: int = 32) -> Dict[str, torch.Tensor]:
    """A real (allocated) tiny batch for a *smoke* config, drawn from
    ``generator`` on the generator's device."""
    dev = generator.device
    dtype = getattr(torch, cfg.compute_dtype)
    d: Dict[str, torch.Tensor] = {}
    if cfg.is_encdec:
        d["enc_embeds"] = torch.randn(batch, seq // 2, cfg.d_model,
                                      generator=generator, device=dev).to(dtype)
        text = seq // 2
    elif cfg.family == "vlm":
        d["embeds"] = torch.randn(batch, cfg.frontend_seq, cfg.d_model,
                                  generator=generator, device=dev).to(dtype)
        text = seq
    else:
        text = seq
    d["tokens"] = torch.randint(0, cfg.vocab, (batch, text), generator=generator,
                                device=dev, dtype=torch.int32)
    d["labels"] = torch.randint(0, cfg.vocab, (batch, text), generator=generator,
                                device=dev, dtype=torch.int32)
    return d
