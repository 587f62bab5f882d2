"""Build the CUDA sources in ``repro_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (pointers and the stream
as ``void*``, sizes as ``int``; every entry returns ``cudaGetLastError()``).
At first use it is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``repro_torch/_build/``, named by the hash of its source so a
changed source is rebuilt, and loaded with :mod:`ctypes`. A failed build
raises with the compiler's output. Nothing is built when a module is
imported: the CPU tests import every module and there is no ``nvcc`` there.
Building and loading hold one lock, so threads that first call a kernel at
once build it once and load one library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}
_LOCK = threading.RLock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME  # the toolkit torch found

    if CUDA_HOME and (pathlib.Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")
    raise KernelBuildError("nvcc not found on PATH or in the CUDA toolkit")


def library_path(name: str) -> pathlib.Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> tuple[pathlib.Path, pathlib.Path, subprocess.Popen] | None:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return tmp, log, proc


def _finish(name: str, job) -> None:
    tmp, log, proc = job
    output, _ = proc.communicate()
    log.write_text(output)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed on csrc/{name}.cu:\n{output}")
    os.replace(tmp, library_path(name))  # atomic: concurrent builds agree


def build(*names: str) -> None:
    """Compile the named sources that are not built yet, all nvcc at once."""
    with _LOCK:
        jobs = {n: _start(n) for n in names}
        try:
            for n, job in jobs.items():
                if job is not None:
                    _finish(n, job)
        finally:
            for job in jobs.values():
                if job is not None and job[2].poll() is None:
                    job[2].kill()
                    job[2].wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _LOADED[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch never runs).

    Each library exports ``<name>_error_string`` for the error's text.
    """
    if code != 0:
        describe = getattr(lib, f"{name}_error_string")
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({describe(code).decode()})")
