"""Build and load the CUDA kernels from the sources in ``csrc/``.

The kernels have a plain C interface (``extern "C"`` launchers), so they
are compiled by ``nvcc`` alone into a shared library and loaded with
``ctypes``: no PyTorch headers, which keeps a build to seconds.  The build
happens at first use, into ``_build/`` beside this file (listed in
``.gitignore``), under a name keyed by a hash of the sources and the
command, so an edit rebuilds.  A failed build raises; there is no
fallback.

The command targets Hopper only (``sm_90a``) and leaves out
``--use_fast_math``: b2's divisions and the limiter selections stay IEEE.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
SOURCES = ("fct_ale.cu",)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # print each kernel's registers, shared memory and spills into the log
    "-Xptxas", "-v",
)

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
ARGTYPES = {
    "fct_bounds": [_P] * 8 + [_I] * 5 + [_P],
    "fct_limit": [_P] * 14 + [_I] * 4 + [_D, _D, _I, _P],
    "fct_update_fused": [_P] * 21 + [_I] * 4 + [_D, _I, _I, _P],
}


def nvcc() -> str:
    """The nvcc to run: ``$CUDA_HOME/bin/nvcc``, else the one on PATH,
    else the CUDA toolkit's default install prefix."""
    home = os.environ.get("CUDA_HOME")
    if home:
        return str(pathlib.Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def nvcc_command(output: pathlib.Path) -> list[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(output),
            *(str(CSRC / s) for s in SOURCES)]


def _source_key() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for s in SOURCES:
        h.update(s.encode())
        h.update((CSRC / s).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"libfct_ale_{_source_key()}.so"


def build() -> tuple[pathlib.Path, float]:
    """Compile the kernels if the keyed library is missing.

    Returns (library path, seconds spent compiling; 0.0 when it was
    already built).  The compiler's output goes to ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = nvcc_command(tmp)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out, seconds


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with every
    launcher's ``argtypes`` and ``restype`` set."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in ARGTYPES.items():
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, name + suffix)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib
