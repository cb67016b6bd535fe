"""Device resolution under the port's rule: the card unless asked otherwise;
and the CUDA streams the port's virtual devices and graph captures borrow."""
from __future__ import annotations

import threading
from typing import Dict, List, Union

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
