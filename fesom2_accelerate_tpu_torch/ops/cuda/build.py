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
``-Xptxas -v`` writes each kernel instance's registers, stack and spills
into the log; :func:`ptxas_report` reads them back.

Usage on a machine with nvcc (builds, then prints one line per kernel
instance)::

    python -m fesom2_accelerate_tpu_torch.ops.cuda.build
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
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
# every launcher ends in (threads per block, device, stream); the occupancy
# query in (threads per block, device)
ARGTYPES = {
    "fct_bounds": [_P] * 8 + [_I] * 6 + [_P],
    "fct_limit": [_P] * 14 + [_I] * 4 + [_D, _D, _I, _I, _P],
    "fct_limit_fused": [_P] * 17 + [_I] * 5 + [_D, _D, _I, _I, _P],
    "fct_update_fused": [_P] * 24 + [_I] * 5 + [_D, _I, _I, _I, _P],
    "fct_b3h": [_P] * 7 + [_I] * 5 + [_P],
    "fct_b3h_fixup": [_P] * 8 + [_I] * 6 + [_P],
    "fct_update": [_P] * 16 + [_I] * 4 + [_D, _I, _I, _I, _P],
    "fct_a2": [_P] * 6 + [_I] * 3 + [_D, _I, _I, _P],
    "fct_occupancy": [_I] * 6 + [_P, _I, _I],
    "stress2rhs": [_P] * 7 + [_I] * 5 + [_P],
}

# each source and the launchers it defines (each as ``_f32`` and ``_f64``)
SOURCES = {
    "fct_ale.cu": ("fct_bounds", "fct_limit", "fct_limit_fused",
                   "fct_update_fused", "fct_b3h", "fct_b3h_fixup",
                   "fct_update", "fct_a2", "fct_occupancy"),
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


def load(path: pathlib.Path, names) -> dict:
    """The launchers ``names`` of the library at ``path``, each as
    ``<name>_f32`` and ``<name>_f64``, with ``argtypes`` and ``restype``
    set."""
    lib = ctypes.CDLL(str(path))
    fns = {}
    for name in names:
        for suffix in ("_f32", "_f64"):
            fn = getattr(lib, name + suffix)
            fn.argtypes = ARGTYPES[name]
            fn.restype = ctypes.c_int
            fns[name + suffix] = fn
    return fns


@functools.cache
def library() -> types.SimpleNamespace:
    """Every launcher of the kernel libraries (built on first call), as
    attributes ``<name>_f32`` / ``<name>_f64``."""
    paths, _ = build()
    fns = {}
    for names, path in zip(SOURCES.values(), paths):
        fns.update(load(path, names))
    return types.SimpleNamespace(**fns)


# the kernels of the sources (``<name>_kernel``), longest first so that a
# name is not taken for its prefix
KERNELS = ("limit_fused", "limit", "update_fused", "update", "b3h_fixup",
           "b3h", "bounds", "a2", "stress2rhs")

# an entry line of ``ptxas -v``: the mangled kernel name, with its template
# arguments (dtype, then the int parameters: incidence slots where the
# kernel has them, block size last)
_ENTRY = re.compile(r"Compiling entry function '\w*?(" + "|".join(KERNELS)
                    + r")_kernelI([fd])((?:Li\d+E)+)")


def ptxas_report(log: str) -> list[dict]:
    """One dict per kernel instance in an nvcc log: ``kernel``, ``dtype``
    (float or double), ``params`` (the int template arguments, block size
    last), ``registers``, ``stack``, ``spill_stores`` and ``spill_loads``
    (bytes)."""
    out, cur = [], None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = dict(kernel=m.group(1) + "_kernel",
                       dtype="float" if m.group(2) == "f" else "double",
                       params=tuple(int(v) for v in
                                    re.findall(r"Li(\d+)E", m.group(3))))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            out.append(cur)
            cur = None
    return out


def main() -> None:
    paths, seconds = build()
    print(f"built {', '.join(p.name for p in paths)} in {seconds:.2f} s")
    for path in paths:
        for r in ptxas_report(path.with_suffix(".log").read_text()):
            print(f"{r['kernel']}<{r['dtype']},"
                  f"{','.join(map(str, r['params']))}>: {r['registers']} "
                  f"registers, stack {r.get('stack')}, spill stores "
                  f"{r.get('spill_stores')}, spill loads "
                  f"{r.get('spill_loads')}")


if __name__ == "__main__":
    main()
