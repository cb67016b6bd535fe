"""Unified model facade (the port of ``repro/models/model.py``).

``Model(cfg)`` exposes init / loss / forward / prefill / decode_step /
make_cache with the reference's batch-dict convention, so the trainer and
the server never branch on family.  It is an ``nn.Module`` that holds the parameter tree it made
(:meth:`init`) or loaded from the reference (:meth:`load_numpy`) as
``model.params``; like the reference's, its passes take the tree explicitly.

Batch dict keys (all optional per family):
  tokens      [B, S_text] int32       decoder token ids
  labels      [B, S_text] int32       next-token targets (training)
  mask        [B, S_text] f32         loss mask (optional)
  embeds      [B, S_front, D]         frontend-stub embeddings (vlm)
  enc_embeds  [B, S_enc, D]           encoder frontend embeddings (audio encdec)

Every family is ported: the attention families (dense, vlm, encdec/audio),
the moe family (its expert GEMMs on the grouped-matmul kernel K6 under
``use_kernels``), and the ssm (mamba2) and hybrid (zamba2) families, whose
Mamba2 prefill runs the SSD-scan kernel K5 under ``use_kernels``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from .._device import DeviceLike, resolve_device
from ..interop import params_from_numpy
from . import hybrid, mamba_lm, transformer
from .config import ModelConfig, param_count
from .layers import cross_entropy_loss


_INITS = {"hybrid": hybrid.hybrid_init, "ssm": mamba_lm.mamba_lm_init}


class _MetaGenerator:
    """Stands in for a generator in :meth:`Model.init_abstract`: the
    initialisers make every leaf on its ``device``, ``meta``, and
    ``layers.normal_init`` draws nothing there."""

    device = torch.device("meta")


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.params: Optional[Dict[str, Any]] = None

    # -- parameters -----------------------------------------------------------
    def init(self, generator: torch.Generator, device: DeviceLike = "cuda") -> Any:
        """Random parameters from ``generator``, on ``device`` (the card
        unless the caller asks for the CPU; raises without one)."""
        dev = resolve_device(device)
        init = _INITS.get(self.cfg.family, transformer.decoder_init)
        params = init(generator, self.cfg)
        if generator.device != dev:
            params = _to_device(params, dev)
        self.params = params
        return params

    def init_abstract(self) -> Any:
        """The parameter tree of :meth:`init` on the ``meta`` device: shapes
        and dtypes, no storage (the template a checkpoint restores into)."""
        init = _INITS.get(self.cfg.family, transformer.decoder_init)
        return init(_MetaGenerator(), self.cfg)

    def load_numpy(self, tree: Any, device: DeviceLike = "cuda") -> Any:
        """The reference's parameters, as a tree of numpy arrays, on ``device``."""
        self.params = params_from_numpy(tree, device)
        return self.params

    # -- training -------------------------------------------------------------
    def loss(self, params: Any, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, {"ce", "moe_aux"}): next-token CE in fp32, plus 0.01 x the
        MoE aux loss for the attention families.  Take gradients on the
        plain route (``use_kernels=False``): the kernel wrappers refuse a
        gradient."""
        cfg = self.cfg
        if cfg.family in ("hybrid", "ssm"):
            logits, aux = self.forward(params, batch)
            ce = cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
            return ce, {"ce": ce, "moe_aux": aux}
        return transformer.loss_fn(params, cfg, batch)

    # -- passes ---------------------------------------------------------------
    def forward(self, params: Any, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        if cfg.family == "hybrid":
            return hybrid.hybrid_forward(params, cfg, batch["tokens"])
        if cfg.family == "ssm":
            return mamba_lm.mamba_lm_forward(params, cfg, batch["tokens"])
        return transformer.forward(params, self.cfg, tokens=batch.get("tokens"),
                                   embeds=batch.get("embeds"),
                                   enc_embeds=batch.get("enc_embeds"))

    def prefill(self, params: Any, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None, *,
                pad_width: Optional[torch.Tensor] = None,
                moe_counts: Optional[torch.Tensor] = None):
        """``pad_width`` [B] int32: per-sequence left-pad widths, masked out
        of every attention with rope positions shifted, so a left-padded
        prompt is bit-exact with its unpadded reference.  SSM/hybrid state
        scans cannot skip pad steps, so those families reject ``pad_width``
        (serve them unpadded, as the continuous batcher does).
        ``moe_counts`` [MoE layers, E] int32 on the device (the moe family):
        each MoE layer's tokens per expert are written to its row."""
        cfg = self.cfg
        if cfg.family in ("hybrid", "ssm"):
            if pad_width is not None:
                raise ValueError(
                    f"{cfg.family} prefill cannot mask left-pads (state scans "
                    "consume every step); prefill unpadded instead")
            fn = (hybrid.hybrid_prefill if cfg.family == "hybrid"
                  else mamba_lm.mamba_lm_prefill)
            return fn(params, cfg, batch["tokens"], cache_len)
        return transformer.prefill(params, self.cfg, tokens=batch.get("tokens"),
                                   embeds=batch.get("embeds"),
                                   enc_embeds=batch.get("enc_embeds"),
                                   cache_len=cache_len, pad_width=pad_width,
                                   moe_counts=moe_counts)

    def decode_step(self, params: Any, token: torch.Tensor, cache, pos, *,
                    pad_width: Optional[torch.Tensor] = None, pad_offset: int = 0,
                    moe_counts: Optional[torch.Tensor] = None,
                    live: Optional[torch.Tensor] = None):
        """``pos`` an int, or a device tensor, 0-dim or [B] (per-row fills),
        which the step never reads on the host, so that it can be captured
        as a CUDA graph (the three forms give the same bits); the cache is
        updated in place and returned.  ``pad_width`` and
        ``pad_offset`` continue a pad-masked prefill (attention families
        only; the ssm and hybrid families ignore them, as the reference's
        do).  ``moe_counts`` as :meth:`prefill`'s; ``live`` [B] bool on the
        device, the rows a dropless MoE routes (the others, a serving
        batch's free slots, get no routed output)."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            return hybrid.hybrid_decode_step(params, cfg, token, cache, pos)
        if cfg.family == "ssm":
            return mamba_lm.mamba_lm_decode_step(params, cfg, token, cache, pos)
        return transformer.decode_step(params, self.cfg, token, cache, pos,
                                       pad_width=pad_width, pad_offset=pad_offset,
                                       moe_counts=moe_counts, live=live)

    def make_cache(self, params: Any, batch_size: int, max_len: int,
                   memory: Optional[torch.Tensor] = None):
        """A zero decode cache on the parameters' device."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            return hybrid.hybrid_make_cache(params, cfg, batch_size, max_len)
        if cfg.family == "ssm":
            return mamba_lm.mamba_lm_make_cache(params, cfg, batch_size)
        return transformer.make_cache(params, cfg, batch_size, max_len, memory)

    def cache_batch_axes(self) -> Any:
        """The batch axis of each leaf of the decode cache, as a tree of
        ints in the cache's structure (the hybrid's conv and SSM states are
        [G, k, B, ...]; every other leaf has its batch on axis 1)."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            return dict(hybrid.CACHE_BATCH_AXES)
        if cfg.family == "ssm":
            return dict(mamba_lm.CACHE_BATCH_AXES)
        return transformer.cache_batch_axes(cfg)

    # -- accounting -----------------------------------------------------------
    def n_params(self) -> Tuple[int, int]:
        """(total, active) parameter counts of the config."""
        return param_count(self.cfg)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
