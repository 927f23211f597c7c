"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled for ``sm_90a``
into ``build/kernels/lib<name>-<hash>.so`` at the root of the checkout (listed in
``.gitignore``) at first use; the hash of the source names the library, so an
edited source is rebuilt. Nothing is built or loaded when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}  # name -> loaded library
_LOAD_LOCK = threading.Lock()  # one build and load per source, whichever thread asks


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                           "with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _compile(name: str) -> Tuple[float, str]:
    """Compile ``csrc/<name>.cu``; returns (seconds, compiler output)."""
    out = library_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return time.perf_counter() - t0, proc.stdout + proc.stderr


def build() -> Dict[str, Tuple[float, str]]:
    """Compile every source not built yet, one ``nvcc`` each, all started together.
    Returns ``{name: (seconds, compiler output)}`` for the builds run."""
    todo = [p.stem for p in sorted(CSRC.glob("*.cu")) if not library_path(p.stem).exists()]
    with ThreadPoolExecutor(max(1, len(todo))) as pool:
        return dict(zip(todo, pool.map(_compile, todo)))


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it first if needed."""
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not library_path(name).exists():
                _compile(name)
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return lib
