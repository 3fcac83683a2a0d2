"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Every source under ``repro_torch/csrc`` is one shared library with a plain
C interface (no PyTorch headers, so each compiles in seconds).  Libraries
are built at first use into ``build/repro_torch/`` at the repository root,
named by a hash of their sources and flags, so an edited kernel is rebuilt
and a stale library is never loaded.  :func:`build` starts one nvcc per
source, all together, and waits for them; a failed compile raises with
nvcc's output.  Nothing here falls back to anything: no nvcc, no kernel.

The target is ``sm_90a`` (Hopper with its architecture-specific features).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Mapping, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("masked_gossip", "sparse_gossip", "scatter_rows")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on
    PATH, else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and the default "
        "CUDA install location); the port's kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library of source ``name`` lives once built."""
    h = hashlib.sha256()
    for part in (f"{name}.cu",) + HEADERS:
        h.update((CSRC / part).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source whose library is missing, in parallel.

    Returns nvcc's output per compiled source (register and shared-memory
    use from ``-Xptxas -v``); sources already built map to ``""``.
    """
    names = tuple(names)
    unknown = set(names) - set(SOURCES)
    if unknown:
        raise ValueError(f"unknown kernel sources {sorted(unknown)}; "
                         f"have {SOURCES}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs = {name: "" for name in names}
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str,
         prototypes: Mapping[str, Sequence[type]]) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed.

    ``prototypes`` maps each exported launch function to its ctypes
    argument types; every launch function returns the CUDA status as int.
    """
    lib = _LOADED.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        for fn, argtypes in prototypes.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def check_status(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a launch function reported a CUDA error."""
    if status != 0:
        msg = lib.repro_cuda_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {status} "
                           f"({msg})")


# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_operands(what: str, floats: Mapping[str, torch.Tensor],
                   ints: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> torch.device:
    """Validate a kernel launch's operands; return their common device.

    Every operand must be a contiguous CUDA tensor on one device; the float
    operands share one dtype the kernels take (float32 or bfloat16), the
    index operands are int32.  Anything else raises -- a wrapper never
    hands a tensor it cannot launch on to a plain version instead.
    """
    ints = ints or {}
    tensors = {**floats, **ints}
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel needs every operand on one "
                         f"CUDA device, got " + ", ".join(
                             f"{k}={t.device}" for k, t in tensors.items()))
    dtypes = {t.dtype for t in floats.values()}
    if len(dtypes) != 1 or next(iter(dtypes)) not in DTYPE_CODES:
        raise TypeError(f"{what}: float operands must share one dtype of "
                        f"{sorted(map(str, DTYPE_CODES))}, got " + ", ".join(
                            f"{k}={t.dtype}" for k, t in floats.items()))
    for k, t in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: {k} must be int32, got {t.dtype}")
    for k, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{what}: {k} must be contiguous")
    return next(iter(devices))


def stream_handle(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream
