"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C entry point and compiles on its own into
``geomesa_tpu_torch/_build/lib<name>.so`` for ``sm_90a`` (Hopper). Nothing is
compiled when a module is imported: the first launch builds what it needs,
and :func:`build` compiles a set of sources in parallel (one ``nvcc`` each,
all started together). A source that fails to build raises; there is no
fallback. The libraries link the CUDA runtime statically and launch on the
stream PyTorch passes in, so they share PyTorch's context and stream order.

Several processes may share one build directory (pytest-xdist workers, a
smoke run beside a test run): the staleness check, the compile and the load
run under an ``fcntl`` lock on ``_build/.lock``, and nvcc writes to a
temporary file that is renamed onto the library, so no process ever loads a
half-written one.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("pip", "density_grouped", "join")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: per source: {"seconds": wall time of its nvcc, "log": nvcc's output
#: (the ``-Xptxas -v`` register / shared-memory report)}
build_log: Dict[str, dict] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    cands = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _so(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    so = _so(name)
    return not so.exists() or so.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime


@contextlib.contextmanager
def _locked():
    """Hold the build directory against other threads and processes."""
    BUILD_DIR.mkdir(exist_ok=True)
    with _lock, open(BUILD_DIR / ".lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield  # closing the file releases the lock


def _compile(names) -> None:
    cc = nvcc()
    t0 = time.perf_counter()
    tmp = {n: BUILD_DIR / f".lib{n}.{os.getpid()}.so" for n in names}
    procs = {
        n: subprocess.Popen(
            [cc, *NVCC_FLAGS, "-o", str(tmp[n]), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for n in names
    }
    failed = []
    for n, p in procs.items():
        out, _ = p.communicate()
        build_log[n] = {"seconds": time.perf_counter() - t0, "log": out}
        if p.returncode == 0:
            os.replace(tmp[n], _so(n))
        else:
            tmp[n].unlink(missing_ok=True)
            failed.append(f"{n}.cu (nvcc exit {p.returncode}):\n{out}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile those of ``names`` whose library is missing or older than its
    source, in parallel; raise if any fails. Returns the :data:`build_log`
    entries of the sources compiled by this call."""
    with _locked():
        todo = [n for n in names if _stale(n)]
        if todo:
            _compile(todo)
    return {n: build_log[n] for n in todo}


def load(name: str, bind) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use if it
    is missing or older than its source. ``bind(lib)`` sets the entry
    points' ctypes signatures once, at load."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _locked():
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                _compile([name])
            lib = ctypes.CDLL(str(_so(name)))
            bind(lib)
            _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by an entry point."""
    if rc != 0:
        raise RuntimeError(f"{what} failed to launch (cudaError_t {rc})")


def stream_handle(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
