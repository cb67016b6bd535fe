"""Train and serve steps (the port of ``repro/train/steps.py``).

``make_train_step`` is the reference's step in eager PyTorch: gradients from
``torch.autograd.grad`` over the parameter tree's leaves, with optional
gradient accumulation over microbatches, then the optimizer's update.  The
reference's sharding rules, policies and shardings (its pjit path over a TPU
mesh) have no counterpart on one card.

The step takes gradients on the model's plain route: the hand-written
kernels have no backward, as the reference's have none, and their wrappers
raise when asked for one (``kernels.refuse_grad``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from ..core import _tree
from ..core.compression import true_div
from ..models.model import Model


def _loss_and_grads_once(model: Model, params: Any, batch: Dict[str, torch.Tensor]
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    flat, tdef = _tree.flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss, metrics = model.loss(_tree.unflatten(tdef, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            _tree.unflatten(tdef, grads))


def loss_and_grads(model: Model, params: Any, batch: Dict[str, torch.Tensor],
                   microbatches: int = 1
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss, metrics, grads) of ``model.loss`` at ``params``.

    Every leaf is made a fresh autograd leaf, so the caller's tensors are
    never marked, and a leaf the loss does not reach gets a zero gradient,
    as ``jax.grad`` gives.  With ``microbatches = m > 1`` the batch is split
    into m along axis 0 and ``loss / m`` and ``grads / m`` are summed in fp32
    from zeros, in microbatch order (the reference's ``lax.scan``); the
    metrics are the last microbatch's.
    """
    if microbatches == 1:
        return _loss_and_grads_once(model, params, batch)
    m = microbatches
    micro = [{k: v.reshape(m, v.shape[0] // m, *v.shape[1:])[i]
              for k, v in batch.items()} for i in range(m)]
    flat, tdef = _tree.flatten(params)
    loss = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in flat]
    for mb in micro:
        mb_loss, metrics, grads = _loss_and_grads_once(model, params, mb)
        loss = loss + true_div(mb_loss, m)
        acc = [a + true_div(g, m) for a, g in zip(acc, _tree.leaves(grads))]
    return loss, metrics, _tree.unflatten(tdef, acc)


def make_train_step(model: Model, optimizer: Any, *, microbatches: int = 1
                    ) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), metrics ``{"loss", "ce", "moe_aux", "grad_norm", "lr"}``: the
    gradients of :func:`loss_and_grads` (over ``microbatches``), then the
    optimizer's update."""

    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(model, params, batch, microbatches)
        with torch.no_grad():
            new_params, new_state, opt_metrics = optimizer.update(grads, opt_state,
                                                                  params)
        return new_params, new_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def lm_grads_kernel(model: Model) -> Callable:
    """A kernel-table entry ``(params, batch) -> {"grads": tree}``: the
    gradient of ``model.loss`` at the device's resident parameters, for the
    runtime's data-parallel fabric (``ClusterRuntime.data_parallel_grads``).
    It runs on a device's worker thread, on the device's stream."""

    def lm_grads(params, batch):
        return {"grads": loss_and_grads(model, params, batch)[2]}

    return lm_grads


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------
def make_serve_prefill(model: Model) -> Callable:
    def prefill_step(params, batch):
        logits, cache, pos = model.prefill(params, batch)
        return logits, cache, pos
    return prefill_step


def make_serve_step(model: Model) -> Callable:
    def serve_step(params, token, cache, pos):
        logits, new_cache = model.decode_step(params, token, cache, pos)
        return logits, new_cache
    return serve_step
