"""Deterministic, host-sharded synthetic data pipeline with prefetch.

The port of ``repro/data/pipeline.py``, with its own copy of the generator:

* **Step-seeded determinism** — batch ``i`` is a pure function of
  ``(seed, i)``, independent of how many batches were drawn before it, so a
  job restored from a step-``k`` checkpoint consumes exactly the batches it
  would have seen without the failure.  The numpy draws are the
  reference's, so both packages give the same batches bit for bit.
* **Host-sharded** — each process generates only its slice of the global
  batch (``process_index/process_count``, 0 and 1 unless given: the port is
  one process).
* **Prefetch** — a daemon thread keeps ``depth`` batches ahead on the host,
  in pinned memory when the target is the card; the consumer copies each
  batch to the device with ``non_blocking=True`` on its own current stream,
  so the copy is ordered before the step that reads it.  There is no CPU
  fallback: the card unless the caller asks for the CPU.

The synthetic stream is a random walk over the vocabulary (token ``t+1``
correlates with token ``t``), so a run shows a real loss drop rather than
memorizing noise.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq: int
    global_batch: int
    seed: int = 0
    # modality-stub dims (vlm/audio archs): frontend embeddings per example
    frontend_seq: int = 0
    d_model: int = 0
    encdec: bool = False


class SyntheticLM:
    """Deterministic synthetic LM batches, host-sharded.

    ``batch(i)`` returns the host-local slice of global batch ``i`` as numpy
    arrays: ``{"tokens": [b, S], "labels": [b, S]}`` int32 (+ ``embeds`` or
    ``enc_embeds`` float32 stubs per ``DataConfig``), where ``b =
    global_batch / process_count``.
    """

    def __init__(self, cfg: DataConfig, process_index: int = 0,
                 process_count: int = 1) -> None:
        self.cfg = cfg
        self.pidx = process_index
        self.pcount = process_count
        if cfg.global_batch % self.pcount:
            raise ValueError(
                f"global_batch {cfg.global_batch} not divisible by "
                f"process_count {self.pcount}")
        self.local_batch = cfg.global_batch // self.pcount

    def _tokens(self, step: int) -> np.ndarray:
        cfg = self.cfg
        # per-(step, example) seeds; examples are globally indexed so each
        # host generates a disjoint, reproducible slice
        ex0 = self.pidx * self.local_batch
        rows = []
        for e in range(ex0, ex0 + self.local_batch):
            rng = np.random.default_rng((cfg.seed, step, e))
            # correlated walk over the vocab: learnable bigram structure
            steps = rng.integers(-3, 4, size=cfg.seq + 1)
            walk = np.cumsum(steps) + rng.integers(0, cfg.vocab)
            rows.append(np.mod(walk, cfg.vocab))
        return np.stack(rows).astype(np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        toks = self._tokens(step)
        out: Dict[str, np.ndarray] = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.frontend_seq and cfg.d_model:
            rng = np.random.default_rng((cfg.seed, step, 999_983, self.pidx))
            emb = rng.standard_normal(
                (self.local_batch, cfg.frontend_seq, cfg.d_model), dtype=np.float32)
            out["enc_embeds" if cfg.encdec else "embeds"] = emb
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1


class Prefetcher:
    """Background-thread prefetch, ``depth`` deep, and device placement."""

    _DONE = object()

    def __init__(self, source: SyntheticLM, start_step: int = 0, *,
                 depth: int = 2, device: DeviceLike = "cuda",
                 max_steps: Optional[int] = None) -> None:
        self.source = source
        self.device = resolve_device(device)
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, args=(start_step, max_steps), daemon=True)
        self._thread.start()

    def _stage(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The producer's half: host tensors, pinned when bound for the card."""
        out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        if self.device.type == "cuda":
            out = {k: v.pin_memory() for k, v in out.items()}
        return out

    def _place(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The consumer's half: the copy on the consumer's current stream."""
        if self.device.type == "cpu":
            return batch
        return {k: v.to(self.device, non_blocking=True) for k, v in batch.items()}

    def _put(self, item: Any) -> bool:
        """Bounded put that yields to a concurrent ``close()``: re-checks the
        stop flag on every queue-full timeout instead of blocking forever on
        a consumer that has already walked away."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, start_step: int, max_steps: Optional[int]) -> None:
        step = start_step
        while not self._stop.is_set():
            if max_steps is not None and step >= start_step + max_steps:
                self._put(self._DONE)
                return
            if self._put(self._stage(self.source.batch(step))):
                step += 1

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        item = self._q.get()
        if item is self._DONE:
            raise StopIteration
        return self._place(item)

    def close(self, timeout: float = 2.0) -> None:
        """Stop the producer and join it within ``timeout`` seconds.

        The producer may be blocked on a full queue, so close interleaves
        draining with short joins until the deadline.  A producer still
        alive past the deadline is a leak (it would pin its step's batch
        for the process lifetime), so that raises instead of returning
        silently.
        """
        self._stop.set()
        deadline = time.monotonic() + timeout
        while True:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.1)
            if not self._thread.is_alive():
                return
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"Prefetcher producer thread failed to stop within "
                    f"{timeout}s of close(); it is leaked")


def make_pipeline(cfg: DataConfig, *, start_step: int = 0,
                  device: DeviceLike = "cuda", depth: int = 2,
                  max_steps: Optional[int] = None) -> Prefetcher:
    return Prefetcher(SyntheticLM(cfg), start_step, depth=depth, device=device,
                      max_steps=max_steps)
