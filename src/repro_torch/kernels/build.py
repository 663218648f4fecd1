"""Build hand-written CUDA kernels with nvcc and load them with ctypes.

Each library is compiled on first use from the sources under
`src/repro_torch/csrc/` into `build/kernels/` at the repository root, under
a name keyed by a hash of the sources, every header under `csrc/` and the
compiler flags, so an edited source or header is rebuilt and an unchanged
one is loaded as it is. The sources expose plain C entry points; nothing
here includes PyTorch's headers.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def library_path(name: str, sources: Sequence[str], csrc: Path = CSRC,
                 extra_flags: Sequence[str] = ()) -> Path:
    """Where the build of `sources` (file names under csrc/) lives: a name
    keyed by a hash of the sources, every `*.cuh` under csrc/ (included or
    not) and the compiler flags, the library's own `extra_flags` among
    them."""
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *extra_flags)).encode())
    for p in [csrc / s for s in sources] + sorted(csrc.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def load_library(name: str, sources: Sequence[str],
                 extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Compile `sources` (file names under csrc/) into one shared library,
    with `extra_flags` after the common nvcc flags, unless a build of the
    same sources, headers and flags exists, and load it."""
    paths = [CSRC / s for s in sources]
    lib_path = library_path(name, sources, extra_flags=extra_flags)
    key = str(lib_path)
    if key in _loaded:
        return _loaded[key]
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), *map(str, paths)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {name} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    _loaded[key] = lib
    return lib
