"""Build and load the CUDA kernels of ``csrc/`` (nvcc -> .so -> ctypes).

The shared library is compiled at first use from the sources in the
checkout, for ``sm_90a``, into ``build/kernels/`` at the repository root
(listed in ``.gitignore``): one ``nvcc -c`` per compile unit, all started
together, then one link.  Every source compiles once per operand type
(``-DFLASH_DTYPE`` / ``-DGEMM_DTYPE``: 0 float32, 1 bfloat16), so the
halves build in parallel.  Its file name carries a hash of the sources
and flags, so an edited source is rebuilt and a stale library is never
loaded.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["library", "build", "BUILD_DIR", "SOURCES", "HEADERS", "UNITS"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "flash_attention.cu", _CSRC / "matmul.cu",
           _CSRC / "grouped_matmul.cu")
#: (source, extra nvcc flags, object name): one ``nvcc -c`` each
UNITS = tuple(
    (src, (f"-D{'FLASH' if src is SOURCES[0] else 'GEMM'}_DTYPE={t}",),
     f"{src.stem}_{name}")
    for src in SOURCES for t, name in ((0, "f32"), (1, "bf16")))
#: included by SOURCES: part of the build's hash
HEADERS = (_CSRC / "gemm_tile.cuh", _CSRC / "gemm_thin.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
#: ``-Xptxas -v`` reports each kernel's registers and spills
#: (:data:`last_build` keeps that output)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: (seconds, compiler output) of the build this process ran or None
last_build: tuple[float, str] | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the CUDA "
                           "kernels cannot be built on this host")
    return found


def _target() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr([(str(u[0].name), u[1]) for u in UNITS]).encode())
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"


def _run(cmd: list[str]) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    return res.stdout + res.stderr


def build() -> Path:
    """Compile the kernels unless this exact build exists; return the
    library's path.  The sources compile in parallel (one ``nvcc`` each)
    into a temporary directory and link into a temporary file that is
    then renamed, so a concurrent or interrupted build never leaves a
    torn library."""
    global last_build
    target = _target()
    if target.is_file():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{name}.o" for _, _, name in UNITS]
        with ThreadPoolExecutor(len(UNITS)) as pool:
            logs = list(pool.map(
                _run, [[nvcc, *NVCC_FLAGS, *flags, "-c", "-o", str(o),
                        str(src)]
                       for (src, flags, _), o in zip(UNITS, objs)]))
        lib = Path(tmp) / target.name
        logs.append(_run([nvcc, "-shared", "-o", str(lib),
                          *map(str, objs)]))
        os.replace(lib, target)
    last_build = (time.perf_counter() - t0, "".join(logs))
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use, with every entry
    point's argument and result types declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.flash_attention_forward.argtypes = [
                p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i,
                p, p, i, i, i, p]
            lib.flash_attention_forward.restype = i
            lib.flash_attention_error_string.argtypes = [i]
            lib.flash_attention_error_string.restype = ctypes.c_char_p
            ll = ctypes.c_longlong
            lib.matmul_forward.argtypes = [
                p, p, p, i, i, i, ll, ll, ll, ll, i, i, i, i, i, i, i, i, p]
            lib.matmul_forward.restype = i
            lib.matmul_error_string.argtypes = [i]
            lib.matmul_error_string.restype = ctypes.c_char_p
            lib.grouped_matmul_forward.argtypes = [
                p, p, p, i, i, i, i, ll, ll, ll, ll, ll, ll, i, i, i, i, i,
                i, i, p, i, i, p]
            lib.grouped_matmul_forward.restype = i
            lib.grouped_matmul_error_string.argtypes = [i]
            lib.grouped_matmul_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
