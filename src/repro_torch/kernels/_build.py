"""Build, load and count the port's hand-written CUDA kernels.

Every ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers) and
is compiled by its own ``nvcc`` call for Hopper (``sm_90a``) into
``build/kernels/lib<name>-<digest>.so`` at the repository root, then loaded
with ``ctypes``.  The digest covers the source, the shared headers
(``csrc/*.cuh``, such as ``hopper.cuh``'s TMA / mbarrier / wgmma helpers) and
the flags, so an edited source or header rebuilds.  :func:`build` starts one
``nvcc`` per source, all at once, and waits for them; :func:`library` builds
on first use, so a bare run of ``chip_smoke.py`` builds everything itself.
A missing ``nvcc`` or a failed build raises — there is no fallback.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error
(a refused launch never runs, and a later synchronize would not report it).

Every wrapper counts its launches in a :class:`LaunchCounter`.  A CUDA graph
replays kernels without calling the wrappers, so whoever captures one takes
the counters' change over the capture (:func:`launch_counts`,
:func:`counts_since`), takes it back out (the capture ran nothing) and adds
it again at each replay (:func:`add_counts`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
import weakref
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("mandelbrot", "block_lu", "flash_attention", "flash_decode",
           "grouped_matmul", "ssd_scan", "busy_loop", "q8_wire")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_libs_lock = threading.Lock()
_counters: "weakref.WeakSet[LaunchCounter]" = weakref.WeakSet()


class LaunchCounter:
    """How many times a wrapper launched its kernel (thread-safe: the
    virtual devices' worker threads launch concurrently)."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()
        _counters.add(self)

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._n += n

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        return self._n


def launch_counts() -> Dict[LaunchCounter, int]:
    """Every counter's count now."""
    return {c: c.count for c in list(_counters)}


def counts_since(before: Dict[LaunchCounter, int]) -> Dict[LaunchCounter, int]:
    """Each counter's change since ``before`` (:func:`launch_counts`), where
    it changed."""
    delta = {c: c.count - before.get(c, 0) for c in list(_counters)}
    return {c: n for c, n in delta.items() if n}


def add_counts(delta: Dict[LaunchCounter, int], sign: int = 1) -> None:
    """Add ``delta`` (``sign`` = -1: take it out) to the counters."""
    for c, n in delta.items():
        c.add(sign * n)


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None, *, force: bool = False,
          ptxas_verbose: bool = False) -> Dict[str, Dict[str, object]]:
    """Compile ``names`` (default: all sources) in parallel, one nvcc each.

    Up-to-date libraries are skipped unless ``force``.  Returns, per source
    built, its own nvcc's wall seconds and the compiler's log (with
    ``ptxas_verbose``, ``-Xptxas -v``'s registers, shared memory and spills
    per kernel).
    """
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    done: Dict[str, tuple] = {}

    def run(name: str, cmd: list, t0: float) -> None:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        done[name] = (proc.returncode, proc.stdout, time.perf_counter() - t0)

    threads, outs = [], {}
    for name in names:
        out = lib_path(name)
        if out.exists() and not force:
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        outs[name] = (tmp, out)
        cmd = [compiler, *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        threads.append(threading.Thread(target=run, args=(name, cmd, time.perf_counter())))
        threads[-1].start()
    for t in threads:
        t.join()
    report: Dict[str, Dict[str, object]] = {}
    failed = []
    for name, (tmp, out) in outs.items():
        code, log, seconds = done[name]
        if code != 0:
            failed.append(f"{name}.cu (exit {code}):\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def sass(path: Path) -> str:
    """``cuobjdump -sass`` of a built library."""
    tool = Path(nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout


def sass_count(name: str, opcode: str = "HGMMA") -> int:
    """How many ``opcode`` instructions the built ``lib<name>`` holds
    (``cuobjdump -sass``; HGMMA is wgmma on the tensor cores)."""
    return sum(opcode in line for line in sass(lib_path(name)).splitlines())


_SASS_FUNCTION = re.compile(r"Function\s*:\s*(\S+)")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_SASS_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_SASS_BRANCH = re.compile(r"\bBRA\s+(?:`\((\.L_x_\d+)\)|0x([0-9a-f]+))")


def sass_loops(text: str, function: str) -> list:
    """The loops of the first function in ``text`` (``cuobjdump -sass``
    output) whose mangled name contains ``function``: one dict per backward
    branch (a branch to itself excepted), in address order, with the number of instructions from the
    branch's target to the branch itself (``"instructions"``) and that
    range's count per opcode (``FMUL``, ``FADD``, ``FSETP``, ...; modifiers
    dropped)."""
    body, labels, pending, inside = [], {}, [], False
    for line in text.splitlines():
        m = _SASS_FUNCTION.search(line)
        if m:
            if inside:
                break
            inside = function in m.group(1)
            continue
        if not inside:
            continue
        m = _SASS_LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _SASS_INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for label in pending:
                labels[label] = addr
            pending = []
            body.append((addr, m.group(2)))
    loops = []
    for addr, ins in body:
        m = _SASS_BRANCH.search(ins)
        if not m:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        # a branch to itself is the padding after a function's last EXIT
        if target is None or target >= addr:
            continue
        ops = [re.sub(r"^@!?U?P\w+\s+", "", i).split()[0].split(".")[0]
               for a, i in body if target <= a <= addr]
        loop = {"start": target, "end": addr, "instructions": len(ops)}
        for op in sorted(set(ops)):
            loop[op] = ops.count(op)
        loops.append(loop)
    return loops


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _libs_lock:
        lib = _libs.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


# codes the tensor-core entry points return beyond cudaError_t's (csrc/hopper.cuh)
_TENSOR_MAP_ERRORS = {9001: "the driver's cuTensorMapEncodeTiled was not found",
                      9002: "cuTensorMapEncodeTiled refused a tensor map"}


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        reason = _TENSOR_MAP_ERRORS.get(code, f"CUDA error {code}")
        raise RuntimeError(f"{what}: {reason} at launch")
