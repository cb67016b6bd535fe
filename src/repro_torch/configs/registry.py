"""Architecture registry: ``--arch <id>`` lookup, shape cells, input specs.

The port's copy of the reference's registry.  The 40-cell assignment matrix
is ARCHS × SHAPES; :func:`shape_cells` marks the documented skips
(``long_500k`` for non-sub-quadratic archs), so the dry run
(``launch.dryrun``), the tests and the docs enumerate the same cells.
:func:`input_specs` gives each cell's inputs as ``meta``-device tensors
(shapes and dtypes, no storage), where the reference gives
``jax.ShapeDtypeStruct`` stand-ins.
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


# ---------------------------------------------------------------------------
# input specs (meta-device stand-ins: no allocation; the dry run's contract)
# ---------------------------------------------------------------------------
_META = torch.device("meta")


def _i32(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device=_META)


def _emb(cfg: ModelConfig, *shape) -> torch.Tensor:
    return torch.empty(shape, dtype=getattr(torch, cfg.compute_dtype), device=_META)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Batch-dict ``meta`` tensors for one (arch × shape) cell.

    train/prefill return the full batch dict; decode returns
    {token, pos} — the cache is derived by the dry run from
    ``Model.make_cache`` over the abstract parameters.
    """
    B, S = shape.batch, shape.seq
    if shape.kind in ("train", "prefill"):
        if cfg.is_encdec:
            half = S // 2
            d = {"enc_embeds": _emb(cfg, B, half, cfg.d_model),
                 "tokens": _i32(B, half)}
            if shape.kind == "train":
                d["labels"] = _i32(B, half)
            return d
        if cfg.family == "vlm":
            text = S - cfg.frontend_seq
            d = {"embeds": _emb(cfg, B, cfg.frontend_seq, cfg.d_model),
                 "tokens": _i32(B, text)}
            if shape.kind == "train":
                d["labels"] = _i32(B, text)
            return d
        d = {"tokens": _i32(B, S)}
        if shape.kind == "train":
            d["labels"] = _i32(B, S)
        return d
    if shape.kind == "decode":
        return {"token": _i32(B, 1), "pos": _i32()}
    raise ValueError(shape.kind)


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
