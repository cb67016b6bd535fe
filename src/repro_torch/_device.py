"""Device resolution under the port's rule: the card unless asked otherwise;
the CUDA streams that graph captures borrow; and the worker threads, each
with a stream of its own, that the port's virtual devices borrow."""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, List, Optional, Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and absent.

    There is no automatic CPU fallback: a caller that wants the CPU (the
    tests) passes ``device="cpu"``.  A bare ``"cuda"`` becomes the current
    card's index so that every virtual device of a pool names the same card.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


# Streams handed back, by card, for the next borrower.  PyTorch keeps a
# cuBLAS workspace for every stream a matmul or solve ran on until the
# process ends, so a fresh stream for each virtual device of each runtime
# (and each graph capture) would grow the card's allocated memory with
# every one made.
_free_streams: Dict[torch.device, List["torch.cuda.Stream"]] = {}
_free_streams_lock = threading.Lock()


def take_stream(device: torch.device) -> "torch.cuda.Stream":
    """A stream on ``device`` (a CUDA device) that no one else holds."""
    with _free_streams_lock:
        free = _free_streams.get(device)
        if free:
            return free.pop()
    return torch.cuda.Stream(device=device)


def give_stream(device: torch.device, stream: "torch.cuda.Stream") -> None:
    """Hand ``stream`` back once the work on it is done; the caller stops
    using it."""
    stream.synchronize()
    with _free_streams_lock:
        _free_streams.setdefault(device, []).append(stream)


class WorkerJob:
    """One job handed to a :class:`CardWorker`: ``join`` and ``is_alive``
    as a ``threading.Thread`` has them, for the job, not the thread."""

    def __init__(self) -> None:
        self._done = threading.Event()

    def join(self, timeout: Optional[float] = None) -> None:
        self._done.wait(timeout)

    def is_alive(self) -> bool:
        return not self._done.is_set()


class CardWorker:
    """A daemon thread on one card that keeps one stream for its whole life.

    PyTorch gives each thread a cuBLAS handle of its own and keeps a 32 MiB
    workspace for every (handle, stream) pair a matmul ran on until the
    process ends.  A virtual device borrows a worker, thread and stream
    together (:func:`take_worker`), and the worker goes back on its card's
    free list when the device's job ends, so the next runtime's devices run
    on the same pairs and the card's memory does not grow runtime by
    runtime."""

    _made = 0

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        self._jobs: "queue.SimpleQueue" = queue.SimpleQueue()
        CardWorker._made += 1
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name=f"omp-card-worker{CardWorker._made}")
        self.thread.start()

    def _loop(self) -> None:
        while True:
            fn, job = self._jobs.get()
            ok = False
            try:
                fn()
                ok = True
            finally:
                # an idle worker must not hold the job's closure: it would
                # keep the finished pool, and every tensor on its devices
                fn = None
                # back on the free list before the joiner wakes, so that a
                # runtime made right after this one's shutdown finds it; a
                # job that raised ends the thread, which is not handed back
                if ok:
                    with _free_workers_lock:
                        _free_workers.setdefault(self.device, []).append(self)
                job._done.set()

    def run(self, fn: Callable[[], None]) -> WorkerJob:
        """Run ``fn`` on this worker's thread; the caller stops using the
        worker once the returned job has ended."""
        job = WorkerJob()
        self._jobs.put((fn, job))
        return job


_free_workers: Dict[torch.device, List[CardWorker]] = {}
_free_workers_lock = threading.Lock()


def take_worker(device: torch.device) -> CardWorker:
    """An idle worker on ``device`` (a CUDA device), or a new one."""
    with _free_workers_lock:
        free = _free_workers.get(device)
        if free:
            return free.pop()
    return CardWorker(device)
