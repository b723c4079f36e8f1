"""Build the host C++ libraries under ``native/`` with ``g++`` and load them
with ctypes: ``native/<source>.cpp`` → ``build/native/lib<source>.so`` of the
checkout, at first use or when the source is newer than the library. Nothing
is written under ``native/``, and a failed build raises with the compiler's
output: there is no fallback. Nothing here runs at import time."""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

NATIVE_SRC = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
# ``native/bleu.cpp`` names ``size_t`` without including <cstddef>, which
# libstdc++ 12's <unordered_map> no longer pulls in (the JAX package's build
# of it fails there and falls back to Python); the forced include builds the
# source as it is
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-include", "cstddef"]

_loaded: Dict[str, ctypes.CDLL] = {}


def library_path(source: str) -> Path:
    return BUILD_DIR / f"lib{source}.so"


def build(source: str) -> Path:
    """Compile ``native/<source>.cpp`` if its library is missing or stale;
    returns the library's path."""
    src, lib = NATIVE_SRC / f"{source}.cpp", library_path(source)
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return lib
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"no C++ compiler (g++, c++) on PATH to build {src}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{source}.so.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed for {src} (rc={proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``native/<source>.cpp``, built first if needed."""
    if source not in _loaded:
        _loaded[source] = ctypes.CDLL(str(build(source)))
    return _loaded[source]
