"""The trainer entry point on one card (the port of ``repro/launch/train.py``).

Config-driven training with the deterministic prefetching pipeline, async
checkpoints with preemption handling (SIGTERM or SIGINT: finish the step,
checkpoint, exit 0), restore-and-resume, gradient accumulation and the
cosine-warmup LR schedule.  The reference's ``--mesh`` and ``--rules`` (its
pjit sharding over a TPU mesh) have no counterpart on one card; ``--device``
picks the card (the default) or the CPU.

On the CPU, at the smoke preset:

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --preset smoke --device cpu --steps 20

On the card, mamba2-130m at its full config:

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --preset full --steps 30 --global-batch 8 --seq 256 --ckpt-dir DIR

A resumed run (``--resume``) continues bit for bit where the checkpoint was
taken: the batches are step-seeded and the optimizer's step count comes back
with the moments.  ``--metrics PATH`` appends one JSON line per logged step
(the loss as an exact float, the step's seconds), for a caller that compares
runs.
"""
from __future__ import annotations

import argparse
import json
import signal
import sys
import time

import torch

from .._device import resolve_device
from ..checkpoint import CheckpointConfig, CheckpointManager
from ..configs.registry import get_config, get_smoke_config
from ..data import DataConfig, Prefetcher, SyntheticLM
from ..models.model import Model
from ..optim import AdamW, AdamWConfig
from ..optim.schedule import cosine_warmup
from ..train.steps import make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--state-dtype", default="float32")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--metrics", default=None,
                    help="append one JSON line per logged step to this file")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (get_config(args.arch) if args.preset == "full"
           else get_smoke_config(args.arch))
    if cfg.is_encdec or cfg.family == "vlm":
        frontend_seq = max(cfg.frontend_seq, args.seq // 2) \
            if cfg.family == "vlm" else args.seq // 2
    else:
        frontend_seq = 0
    model = Model(cfg)
    opt = AdamW(AdamWConfig(lr=cosine_warmup(args.lr, args.warmup, args.steps),
                            state_dtype=args.state_dtype))

    ckpt = None
    start_step = 0
    if args.ckpt_dir:
        ckpt = CheckpointManager(CheckpointConfig(
            directory=args.ckpt_dir, keep=args.keep, save_every=args.save_every))
    if ckpt and args.resume and ckpt.latest_step() is not None:
        abstract = model.init_abstract()
        state, start_step, extra = ckpt.restore(
            {"params": abstract, "opt": opt.init(abstract)}, device=dev)
        params, opt_state = state["params"], state["opt"]
        # the step count lives on the host, as AdamW.init makes it, so that
        # the LR and bias corrections are the uninterrupted run's
        opt_state["count"] = opt_state["count"].cpu()
        print(f"[train] resumed from step {start_step} "
              f"(loss was {extra.get('loss')})", flush=True)
    else:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = model.init(gen, device=dev)
        opt_state = opt.init(params)

    step_fn = make_train_step(model, opt, microbatches=args.microbatches)
    data_cfg = DataConfig(
        vocab=cfg.vocab, seq=args.seq, global_batch=args.global_batch,
        seed=args.seed, frontend_seq=frontend_seq,
        d_model=cfg.d_model if frontend_seq else 0, encdec=cfg.is_encdec)
    pipe = Prefetcher(SyntheticLM(data_cfg), start_step, depth=2, device=dev,
                      max_steps=args.steps - start_step)

    # preemption: the first SIGTERM/SIGINT finishes the current step,
    # checkpoints and exits 0; a restart with --resume continues bit-exactly
    preempted = {"flag": False}

    def _handler(signum, frame):
        print(f"[train] signal {signum}: checkpoint-and-exit after this step",
              flush=True)
        preempted["flag"] = True

    old_term = signal.signal(signal.SIGTERM, _handler)
    old_int = signal.signal(signal.SIGINT, _handler)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    last_loss = float("nan")
    step = start_step
    sync()
    t0, logged = time.perf_counter(), step
    try:
        for batch in pipe:
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            step += 1
            log_now = step % args.log_every == 0 or step == args.steps
            if log_now:
                sync()           # the interval's work is done on the card
                dt = (time.perf_counter() - t0) / (step - logged)
                last_loss = float(metrics["loss"])
                toks = args.global_batch * args.seq
                print(f"[train] step {step:6d} loss {last_loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"{dt:.2f}s/step {toks / dt:,.0f} tok/s", flush=True)
                if args.metrics:
                    with open(args.metrics, "a") as f:
                        f.write(json.dumps({
                            "step": step, "loss": last_loss,
                            "ce": float(metrics["ce"]),
                            "grad_norm": float(metrics["grad_norm"]),
                            "lr": float(metrics["lr"]), "s_per_step": dt,
                            "steps_timed": step - logged}) + "\n")
            if ckpt and (ckpt.should_save(step) or preempted["flag"]
                         or step == args.steps):
                ckpt.save(step, {"params": params, "opt": opt_state},
                          extra={"loss": last_loss}, blocking=False)
            if preempted["flag"]:
                break
            if log_now:
                # the next interval starts after the log and the checkpoint's
                # copy to the host: it times training steps only
                sync()
                t0, logged = time.perf_counter(), step
    finally:
        pipe.close()
        if ckpt:
            ckpt.wait()
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)

    print(f"[train] done at step {step} (loss {last_loss:.4f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
