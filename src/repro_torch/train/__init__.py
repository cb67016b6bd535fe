"""Train and serve step builders of the port (``repro.train``'s
counterparts on one card: the pjit sharding rules have none)."""
from .steps import (lm_grads_kernel, loss_and_grads, make_serve_prefill,
                    make_serve_step, make_train_step)

__all__ = ["lm_grads_kernel", "loss_and_grads", "make_serve_prefill",
           "make_serve_step", "make_train_step"]
