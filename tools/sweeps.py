"""What the sweep tools share: build this tree's CUDA sources with extra nvcc
defines, time each library in a process of its own, and read the card.

A sweep tool (``tools/sweep_*.py``) builds its variants with
``build_variants``, then hands ``time_each`` a map {name: library directory}:
this tree's ``build/torch_kernels``, its variants' directories and any
directory built elsewhere with the same C interface (for example a parent
commit's ``build/torch_kernels``). ``time_each`` runs the tool again as
``<tool> --time NAME DIR [args]`` for each, where the tool calls
``use_libraries(DIR)`` and times what it times. ``card_line`` gives the card's
name and power limit as ``nvidia-smi`` prints them; ``cuobjdump`` runs the CUDA
toolkit's ``cuobjdump`` on a library.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, Sequence, Tuple

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from streamspeech_tpu_torch.kernels import build  # noqa: E402


def build_variants(out_root: Path, variants: Dict[str, Tuple[Sequence[str], Sequence[str]]],
                   base: Sequence[str] = ()) -> Dict[str, Path]:
    """{name: its library directory}. A variant ``name: (sources, defines)``
    builds each of ``sources`` (``csrc/<source>.cu``) with the nvcc ``defines``
    into ``out_root/name/``; all nvcc runs start together. This tree's own
    build of the ``base`` sources (built first where stale) is copied beside
    each variant's libraries, so that a variant's timing finds the libraries it
    does not rebuild."""
    if base:
        build.build(list(base))
    dirs, procs = {}, []
    for name, (sources, defines) in variants.items():
        dirs[name] = out = out_root / name
        out.mkdir(parents=True, exist_ok=True)
        for src in base:
            if src not in sources:
                (out / f"lib{src}.so").write_bytes(build.library_path(src).read_bytes())
        for src in sources:
            procs.append((name, src, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, *defines, "-I", str(build.CSRC), "-o",
                 str(out / f"lib{src}.so"), str(build.CSRC / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, src, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} ({src}.cu):\n{log}")
    if failed:
        raise SystemExit("\n".join(failed))
    return dirs


def use_libraries(lib_dir: Path) -> None:
    """Make the port's loader take the libraries in ``lib_dir`` as they are:
    none there is rebuilt from this tree's sources, however old. A source with
    no library there is built into it."""
    build.BUILD_DIR = lib_dir
    for lib in sorted(lib_dir.glob("lib*.so")):
        build._loaded[lib.stem[len("lib"):]] = ctypes.CDLL(str(lib))


def time_each(tool: str, libs: Dict[str, Path], args: Sequence[str] = (), twice: bool = False,
              timeout: float = 900) -> bool:
    """Run ``tool --time NAME DIR *args`` for each library, each in a process of
    its own; with ``twice``, in the order A B .. B A, so that a drift of the
    card over the call weighs on both alike. A run that fails or outlasts
    ``timeout`` seconds is reported as a JSON line and the others still run.
    Returns whether every run ended well."""
    order = list(libs.items())
    ok = True
    for name, lib_dir in order + (order[::-1] if twice else []):
        try:
            subprocess.run([sys.executable, tool, "--time", name, str(lib_dir), *args],
                           check=True, timeout=timeout)
        except (subprocess.TimeoutExpired, subprocess.CalledProcessError) as err:
            print(json.dumps({"library": name, "failed": str(err)}), flush=True)
            ok = False
    return ok


def card_line() -> str:
    """The card's name and power limit: ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader``."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


def cuobjdump(*args) -> str:
    tool = Path(build._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), *args], capture_output=True, text=True, check=True,
                          timeout=300).stdout
