"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled for
``sm_90a`` into ``build/torch_kernels/lib<name>.so`` of the checkout, at first
use (or when any file under ``csrc/`` is newer than the library: the sources
share headers, ``csrc/*.cuh``). Nothing here runs at import time: this module
imports on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def kernel_names() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return path


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """Whether ``lib<name>.so`` is missing or older than the newest file under
    ``csrc/`` (its own source or any header it may include)."""
    lib = library_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir() if p.is_file())
    return lib.stat().st_mtime < newest


def build(names: Optional[List[str]] = None) -> Dict[str, dict]:
    """Compile the given sources (default: all) that are missing or stale, one
    ``nvcc`` process per source, all started together. Returns, per source
    built, its wall seconds and ``nvcc``'s ``-Xptxas -v`` report. Raises with
    the compiler output if any build fails."""
    names = kernel_names() if names is None else names
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, time.perf_counter())
    report, failed = {}, []
    for n, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {n}.cu (rc={proc.returncode}):\n{log}")
            continue
        os.replace(tmp, library_path(n))
        report[n] = {"seconds": time.perf_counter() - t0, "nvcc": log.strip()}
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]


@functools.lru_cache(maxsize=None)
def bind(name: str, symbol: str, argtypes: Tuple) -> Callable[..., int]:
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, typed; it returns a
    ``cudaError_t`` code. Pointers and the stream are ``ctypes.c_void_p``."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def on_card(x: torch.Tensor, kernel: str) -> bool:
    """Whether a wrapper launches its kernel for ``x``: True for a CUDA tensor,
    False for a CPU one (the wrapper computes its plain version); raises for
    any other device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel} takes CPU or CUDA tensors, got {x.device}")
    return x.device.type == "cuda"


@functools.lru_cache(maxsize=None)
def _check_capability(index: int) -> None:
    cap = torch.cuda.get_device_capability(index)
    if cap != (9, 0):
        raise RuntimeError("the port's kernels are built for sm_90a (Hopper); "
                           f"device {index} has capability {cap}")


def launch(spec: Tuple[str, str, Tuple], device: torch.device, *args) -> None:
    """Call the entry point ``spec = (source, symbol, argtypes)`` as
    ``fn(*args, stream)`` on the current stream of ``device``, which must be a
    Hopper card, building the source first if needed; raise if the launch
    reports a CUDA error."""
    _check_capability(device.index if device.index is not None
                      else torch.cuda.current_device())
    kernel = spec[0]
    fn = bind(*spec)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
