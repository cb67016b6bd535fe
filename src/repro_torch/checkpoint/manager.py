"""Checkpoints of tensor trees (port of ``repro.checkpoint.manager``).

The on-disk format is the reference's, so a checkpoint written by either
package restores in the other:

* **Layout** — ``<dir>/step_<k:08d>/proc_0.npz`` holds every leaf's bytes,
  ``manifest.json`` its global shape and dtype name (numpy's spelling:
  ``"float32"``, ``"bfloat16"``, ...), the step and the caller's ``extra``.
  A leaf is stored under ``"<path>|<start:stop,...>"`` (``"<path>|:"`` for a
  0-d leaf) as raw ``uint8`` bytes; its path is its dict keys and sequence
  indices joined by ``/``.  The port is one process, so ``proc_0`` is the
  only shard file and each leaf one whole shard; a restore still assembles
  the shards of every ``proc_*`` file it finds.
* **Atomicity** — a step is written under ``step_<k>.tmp`` and committed by
  ``os.replace``; :func:`latest_step` ignores ``.tmp``.
* **Async** — :meth:`CheckpointManager.save` copies the tree to the host
  before it returns and writes it on a thread with ``blocking=False``.
* **Retention** — the manager keeps the ``keep`` newest steps, deleting older
  ones only after a save succeeded.

numpy has no bfloat16, so dtypes go between manifest names and torch dtypes
through a table of this module's own, and a leaf's bytes are reinterpreted
in torch.  ``restore_pytree(..., device=...)`` places every leaf on one
device, the card unless the caller asks for the CPU; the reference's
``shardings`` (restoring onto another JAX mesh) have no counterpart.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core import _tree

#: manifest dtype names (``str(np.dtype(...))``, with ``ml_dtypes``' names
#: for the types numpy lacks) -> torch dtypes
DTYPES: Dict[str, torch.dtype] = {
    name: getattr(torch, name) for name in (
        "float64", "float32", "float16", "bfloat16", "int64", "int32", "int16",
        "int8", "uint8", "uint16", "uint32", "uint64", "bool", "complex64",
        "complex128", "float8_e4m3fn", "float8_e5m2")
    if hasattr(torch, name)}
_NAMES = {dt: name for name, dt in DTYPES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """The manifest's name of a torch dtype."""
    try:
        return _NAMES[dtype]
    except KeyError:
        raise TypeError(f"no checkpoint dtype name for {dtype}") from None


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a manifest dtype name."""
    try:
        return DTYPES[name]
    except KeyError:
        raise TypeError(f"unknown checkpoint dtype {name!r}") from None


def _path_key(path: Tuple[Any, ...]) -> str:
    return "/".join(str(p) for p in path)


def _as_tensor(leaf: Any) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))


def _idx_str(shape: Tuple[int, ...]) -> str:
    """The key suffix of a whole leaf: ``0:d`` per dim, ``:`` for 0-d."""
    return ",".join(f"0:{d}" for d in shape) if shape else ":"


def _parse_idx(s: str, shape: Tuple[int, ...]) -> Tuple[slice, ...]:
    if s in (":", ""):
        return tuple(slice(0, d) for d in shape)
    out = []
    for part in s.split(","):
        a, b = part.split(":")
        out.append(slice(int(a), int(b)))
    return tuple(out)


def _to_bytes(t: torch.Tensor) -> np.ndarray:
    """A tensor's raw bytes, on the host, as a flat uint8 array (a 0-d
    tensor is flattened before the view: it cannot change element size)."""
    return t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy()


def _from_bytes(raw: np.ndarray, dtype: torch.dtype,
                shape: Tuple[int, ...]) -> torch.Tensor:
    if raw.size == 0:
        return torch.empty(shape, dtype=dtype)
    return torch.from_numpy(np.array(raw, dtype=np.uint8)).view(dtype).reshape(shape)


# ---------------------------------------------------------------------------
# save / restore of one tree
# ---------------------------------------------------------------------------
def save_pytree(directory: str, step: int, tree: Any, *,
                extra: Optional[Dict[str, Any]] = None) -> str:
    """Write one checkpoint step of ``tree`` (tensors, numpy arrays or
    scalars in dicts, lists and tuples); blocking.  Returns its directory.
    Leaves on the card are copied to the host first."""
    flat, _ = _tree.flatten_with_path(tree)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest: Dict[str, Any] = {"step": step, "leaves": {}, "extra": extra or {}}
    arrays: Dict[str, np.ndarray] = {}
    for path, leaf in flat:
        key = _path_key(path)
        t = _as_tensor(leaf)
        shape = tuple(t.shape)
        manifest["leaves"][key] = {"shape": list(shape), "dtype": dtype_name(t.dtype)}
        arrays[f"{key}|{_idx_str(shape)}"] = _to_bytes(t)
    np.savez(os.path.join(tmp, "proc_0.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def checkpoint_steps(directory: str) -> List[int]:
    """The committed steps under ``directory``, oldest first (``.tmp`` and
    other names skipped)."""
    if not os.path.isdir(directory):
        return []
    out: List[int] = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                out.append(int(d[5:]))
            except ValueError:
                pass
    return sorted(out)


def prune_steps(directory: str, keep: Optional[int]) -> None:
    """Delete all but the ``keep`` newest steps (None or 0 keeps them all)."""
    for s in checkpoint_steps(directory)[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    """The newest committed step under ``directory``, or None."""
    steps = checkpoint_steps(directory)
    return steps[-1] if steps else None


def read_manifest(directory: str, step: int) -> Dict[str, Any]:
    with open(os.path.join(directory, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def restore_pytree(directory: str, *, step: Optional[int] = None,
                   template: Any = None, device: DeviceLike = "cuda"
                   ) -> Tuple[Any, int, Dict[str, Any]]:
    """``(tree, step, extra)`` of step ``step`` (default: the newest).

    ``template`` (a tree of tensors or :class:`~..core.mediary.TensorSpec`\\ s)
    gives the structure; each leaf is filled from the manifest by its path,
    so the restore does not depend on leaf order, cast to the template
    leaf's dtype, and placed on ``device`` (the card unless the caller asks
    for the CPU).  A path the checkpoint lacks raises ``KeyError``.
    """
    dev = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    manifest = read_manifest(directory, step)
    assembled: Dict[str, torch.Tensor] = {}
    for fn in sorted(os.listdir(d)):
        if not fn.startswith("proc_"):
            continue
        with np.load(os.path.join(d, fn)) as z:
            for k in z.files:
                key, idx_s = k.rsplit("|", 1)
                meta = manifest["leaves"][key]
                shape = tuple(meta["shape"])
                idx = _parse_idx(idx_s, shape)
                shard_shape = tuple(sl.stop - sl.start for sl in idx)
                data = _from_bytes(z[k], torch_dtype(meta["dtype"]), shard_shape)
                if shard_shape == shape:
                    assembled[key] = data
                else:
                    if key not in assembled:
                        assembled[key] = torch.zeros(shape, dtype=data.dtype)
                    assembled[key][idx] = data
    if template is None:
        raise ValueError("restore_pytree requires a template tree")
    flat, treedef = _tree.flatten_with_path(template)
    leaves = []
    for path, leaf in flat:
        key = _path_key(path)
        if key not in assembled:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = assembled[key]
        want = getattr(leaf, "dtype", t.dtype)
        leaves.append(t.to(device=dev, dtype=want))
    return _tree.unflatten(treedef, leaves), step, manifest["extra"]


# ---------------------------------------------------------------------------
# the manager: retention and async writes
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class CheckpointConfig:
    directory: str
    keep: int = 3
    save_every: int = 100


class CheckpointManager:
    def __init__(self, cfg: CheckpointConfig) -> None:
        self.cfg = cfg
        os.makedirs(cfg.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.cfg.save_every == 0

    def save(self, step: int, tree: Any, *, extra: Optional[Dict] = None,
             blocking: bool = True) -> None:
        """Copy ``tree`` to the host now; write it now or on a thread.

        The copy is taken even for host tensors: the caller may change them
        in place while the write is in flight."""
        self.wait()
        flat, treedef = _tree.flatten(tree)
        host_tree = _tree.unflatten(
            treedef, [_as_tensor(l).detach().to("cpu", copy=True) for l in flat])

        def work():
            try:
                save_pytree(self.cfg.directory, step, host_tree, extra=extra)
                prune_steps(self.cfg.directory, self.cfg.keep)
            except BaseException as e:    # re-raised by wait()
                self._error = e

        if blocking:
            work()
            self._raise_pending()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def restore(self, template: Any, device: DeviceLike = "cuda",
                step: Optional[int] = None):
        return restore_pytree(self.cfg.directory, step=step, template=template,
                              device=device)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.cfg.directory)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def _raise_pending(self) -> None:
        if self._error is not None:
            e, self._error = self._error, None
            raise e

