"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``.  Libraries land in the
checkout's ``build/`` directory under a name that carries a hash of the
source, of the shared headers (``csrc/*.cuh``) and of the flags, so an
edited source or header is rebuilt and a stale library is never loaded.  :func:`build_all` starts one ``nvcc`` per source at once.

Nothing here runs at import time; this module also holds the launch
counters, one plain integer per kernel, which each wrapper increments
(:func:`count_launch`) where it launches its kernel and nowhere else.  Both
the first-use build and load and the counters are safe for threads: serving
replicas launch kernels from several host threads at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("fake_quant", "lut_dense", "lut_dense_bwd", "lut_serve")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel launches since the last reset_launches(), by kernel name
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}

_LOADED: Dict[str, ctypes.CDLL] = {}
# held across a library's first build and load, so threads that need it at
# once build it once and load it once
_LOAD_LOCK = threading.Lock()
# held across each read-modify-write of LAUNCHES
_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(name: str, n: int = 1) -> None:
    """Add ``n`` launches of kernel ``name`` to its counter, atomically."""
    with _COUNT_LOCK:
        LAUNCHES[name] += n


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels are built on the machine with "
                           "the card")
    return nvcc


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library, all ``nvcc`` processes in parallel.

    Returns the wall seconds each compile took (0.0 for one already built).
    Raises ``RuntimeError`` with the compiler's output if any build fails.
    """
    names = tuple(names) if names is not None else SOURCES
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    times = {n: 0.0 for n in names}
    if not todo:
        return times
    nvcc = _nvcc()
    procs = {}
    t0 = time.monotonic()
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        times[name] = time.monotonic() - t0
        if rc != 0:
            failed.append(f"{name} (rc {rc}):\n"
                          f"{(BUILD_DIR / f'{name}.log').read_text()}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return times


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``) of the last build of ``name``."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.

    ``bind`` (the wrapper's signature setup) runs once, on the first load,
    under the same lock, before any thread is handed the library.
    """
    lib = _LOADED.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LOADED.get(name)
            if lib is None:
                build_all([name])
                lib = ctypes.CDLL(str(library_path(name)))
                bind(lib)
                _LOADED[name] = lib
    return lib
