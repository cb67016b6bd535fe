"""Unified model facade (the port of ``repro/models/model.py``).

``Model(cfg)`` exposes init / forward / prefill / decode_step / make_cache
with the reference's batch-dict convention, so the server never branches on
family.  It is an ``nn.Module`` that holds the parameter tree it made
(:meth:`init`) or loaded from the reference (:meth:`load_numpy`) as
``model.params``; like the reference's, its passes take the tree explicitly.

Batch dict keys (all optional per family):
  tokens      [B, S_text] int32       decoder token ids
  embeds      [B, S_front, D]         frontend-stub embeddings (vlm)
  enc_embeds  [B, S_enc, D]           encoder frontend embeddings (audio encdec)

The attention families (dense, vlm, encdec/audio) and the moe family (its
expert GEMMs on the grouped-matmul kernel K6 under ``use_kernels``) are
ported.  The SSM and hybrid families (Mamba2 with its SSD-scan kernel K5)
raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from .._device import DeviceLike, resolve_device
from ..interop import params_from_numpy
from . import transformer
from .config import ModelConfig

SSM_TODO = ("the {} family (Mamba2 SSD blocks and the ssd-scan kernel K5) is "
            "not ported yet: ROADMAP.md item 13c, the SSM/hybrid serve path")


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig) -> None:
        super().__init__()
        if cfg.family in ("ssm", "hybrid"):
            raise NotImplementedError(SSM_TODO.format(cfg.family))
        self.cfg = cfg
        self.params: Optional[Dict[str, Any]] = None

    # -- parameters -----------------------------------------------------------
    def init(self, generator: torch.Generator, device: DeviceLike = "cuda") -> Any:
        """Random parameters from ``generator``, on ``device`` (the card
        unless the caller asks for the CPU; raises without one)."""
        dev = resolve_device(device)
        params = transformer.decoder_init(generator, self.cfg)
        if generator.device != dev:
            params = _to_device(params, dev)
        self.params = params
        return params

    def load_numpy(self, tree: Any, device: DeviceLike = "cuda") -> Any:
        """The reference's parameters, as a tree of numpy arrays, on ``device``."""
        self.params = params_from_numpy(tree, device)
        return self.params

    # -- passes ---------------------------------------------------------------
    def forward(self, params: Any, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return transformer.forward(params, self.cfg, tokens=batch.get("tokens"),
                                   embeds=batch.get("embeds"),
                                   enc_embeds=batch.get("enc_embeds"))

    def prefill(self, params: Any, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None, *,
                pad_width: Optional[torch.Tensor] = None):
        """``pad_width`` [B] int32: per-sequence left-pad widths, masked out
        of every attention with rope positions shifted, so a left-padded
        prompt is bit-exact with its unpadded reference."""
        return transformer.prefill(params, self.cfg, tokens=batch.get("tokens"),
                                   embeds=batch.get("embeds"),
                                   enc_embeds=batch.get("enc_embeds"),
                                   cache_len=cache_len, pad_width=pad_width)

    def decode_step(self, params: Any, token: torch.Tensor, cache, pos, *,
                    pad_width: Optional[torch.Tensor] = None, pad_offset: int = 0):
        """``pos`` an int (wave batching) or [B] (continuous batching); the
        cache is updated in place and returned."""
        return transformer.decode_step(params, self.cfg, token, cache, pos,
                                       pad_width=pad_width, pad_offset=pad_offset)

    def make_cache(self, params: Any, batch_size: int, max_len: int,
                   memory: Optional[torch.Tensor] = None):
        return transformer.make_cache(params, self.cfg, batch_size, max_len, memory)
