"""Build and load the CUDA kernels from the sources in ``csrc/``.

The kernels have a plain C interface (``extern "C"`` launchers), so each
source is compiled by ``nvcc`` alone into a shared library of its own and
loaded with ``ctypes``: no PyTorch headers, which keeps a build to seconds.
The sources are compiled in parallel, one ``nvcc`` process each, all
started together.  The build happens at first use, into ``_build/`` beside
this file (listed in ``.gitignore``), under a name keyed by a hash of the
source and the command, so an edit rebuilds that source.  A failed build
raises; there is no fallback.

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
import types

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"

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
    "fct_update_fused": [_P] * 23 + [_I] * 5 + [_D, _I, _I, _P],
    "fct_b3h": [_P] * 7 + [_I] * 4 + [_P],
    "fct_b3h_fixup": [_P] * 8 + [_I] * 5 + [_P],
    "fct_update": [_P] * 16 + [_I] * 4 + [_D, _I, _I, _P],
    "stress2rhs": [_P] * 7 + [_I] * 4 + [_P],
}

# each source and the launchers it defines (each as ``_f32`` and ``_f64``)
SOURCES = {
    "fct_ale.cu": ("fct_bounds", "fct_limit", "fct_update_fused", "fct_b3h",
                   "fct_b3h_fixup", "fct_update"),
    "stress2rhs.cu": ("stress2rhs",),
}


def nvcc() -> str:
    """The nvcc to run: ``$CUDA_HOME/bin/nvcc``, else the one on PATH,
    else the CUDA toolkit's default install prefix."""
    home = os.environ.get("CUDA_HOME")
    if home:
        return str(pathlib.Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def nvcc_command(source: str, output: pathlib.Path) -> list[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(output), str(CSRC / source)]


def _source_key(source: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(source.encode())
    h.update((CSRC / source).read_bytes())
    return h.hexdigest()[:16]


def library_path(source: str) -> pathlib.Path:
    stem = pathlib.Path(source).stem
    return BUILD_DIR / f"lib{stem}_{_source_key(source)}.so"


def build() -> tuple[list[pathlib.Path], float]:
    """Compile every source whose keyed library is missing, all in parallel.

    Returns (library paths in ``SOURCES`` order, wall seconds spent
    compiling; 0.0 when all were already built).  Each compiler's output
    goes to ``<library>.log``."""
    paths = [library_path(s) for s in SOURCES]
    todo = [(s, p) for s, p in zip(SOURCES, paths) if not p.exists()]
    if not todo:
        return paths, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for source, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = nvcc_command(source, tmp)
        procs.append((out, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for out, tmp, cmd, proc in procs:
        stdout, stderr = proc.communicate()
        out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + stdout
                                           + stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{stderr[-4000:]}")
        else:
            # atomic: a concurrent loader sees all or nothing
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths, time.perf_counter() - t0


@functools.cache
def library() -> types.SimpleNamespace:
    """Every launcher of the kernel libraries (built on first call), as
    attributes ``<name>_f32`` / ``<name>_f64`` with ``argtypes`` and
    ``restype`` set."""
    paths, _ = build()
    fns = {}
    for names, path in zip(SOURCES.values(), paths):
        lib = ctypes.CDLL(str(path))
        for name in names:
            for suffix in ("_f32", "_f64"):
                fn = getattr(lib, name + suffix)
                fn.argtypes = ARGTYPES[name]
                fn.restype = ctypes.c_int
                fns[name + suffix] = fn
    return types.SimpleNamespace(**fns)
