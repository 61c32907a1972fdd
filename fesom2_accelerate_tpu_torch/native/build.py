"""Build the port's native code with g++: the host-embedding C ABI and
its demo host, and the mesh core and CPU golden reference.

``fesom2_torch_host.cpp`` (the ``f2t_*_`` surface, embedding CPython) is
built into a shared library linked against libpython, and
``host_embed_demo.cpp`` (a C host that owns its arrays and calls that
surface only) into a program linked against the library.
``fesom2_torch_core.cpp`` (the mesh core and the golden reference, a plain
C ABI that ``mesh/native.py`` binds with ctypes) is built into a library
of its own, at its first use (:func:`build_core`).  Every output goes into
``_build/`` beside this file (listed in ``.gitignore``), under a name
keyed by a hash of its sources and the commands, so an edit rebuilds it.
Each output is written under a per-process temporary name and moved into
place with ``os.replace``, as ``ops/cuda/build.py`` does, so concurrent
builders see all of a file or none.  A failed build raises.

Python's include and link flags come from ``sysconfig`` (``INCLUDEPY``,
``LIBDIR``, ``LDLIBRARY``) where it names a shared libpython, else from
``python3-config --embed``.  The library records ``LIBDIR`` as its
run path, the demo its own directory.

Usage (builds the shim and the demo, then prints the two paths)::

    python -m fesom2_accelerate_tpu_torch.native.build
"""

from __future__ import annotations

import functools
import hashlib
import os
import pathlib
import shlex
import shutil
import subprocess
import sys
import sysconfig

HERE = pathlib.Path(__file__).resolve().parent
BUILD_DIR = HERE / "_build"
SHIM = HERE / "fesom2_torch_host.cpp"
DEMO = HERE / "host_embed_demo.cpp"
CORE = HERE / "fesom2_torch_core.cpp"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall")


def compiler() -> str | None:
    return shutil.which(os.environ.get("CXX", "g++"))


@functools.cache
def python_flags() -> tuple[tuple, tuple] | None:
    """(compile flags, link flags) of the embedded Python, or None when
    there is no Python.h or no libpython to link."""
    inc = sysconfig.get_config_var("INCLUDEPY")
    libdir = sysconfig.get_config_var("LIBDIR")
    lib = sysconfig.get_config_var("LDLIBRARY") or ""
    if inc and libdir and lib.endswith(".so") and \
            (pathlib.Path(libdir) / lib).exists() and \
            (pathlib.Path(inc) / "Python.h").exists():
        name = lib[len("lib"):-len(".so")]
        return (f"-I{inc}",), (f"-L{libdir}", f"-l{name}",
                               f"-Wl,-rpath,{libdir}")
    config = shutil.which(f"python{sys.version_info.major}."
                          f"{sys.version_info.minor}-config") or \
        shutil.which("python3-config")
    if config is None:
        return None
    try:
        cflags = subprocess.run([config, "--includes"], capture_output=True,
                                text=True, check=True).stdout
        ldflags = subprocess.run([config, "--ldflags", "--embed"],
                                 capture_output=True, text=True,
                                 check=True).stdout
    except subprocess.CalledProcessError:
        return None
    return tuple(shlex.split(cflags)), tuple(shlex.split(ldflags))


def available() -> bool:
    """Whether this host can build the shim: a C++ compiler and an
    embeddable Python."""
    return compiler() is not None and python_flags() is not None


def _key(*sources: pathlib.Path, flags: str = "") -> str:
    h = hashlib.sha256()
    h.update(" ".join((compiler() or "",) + CXXFLAGS).encode())
    h.update(flags.encode())
    for src in sources:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def paths() -> tuple[pathlib.Path, pathlib.Path]:
    """(the shim's library, the demo program) of the current sources."""
    key = _key(SHIM, DEMO, flags=repr(python_flags()))
    return (BUILD_DIR / f"libfesom2_torch_host_{key}.so",
            BUILD_DIR / f"host_embed_demo_{key}")


def core_path() -> pathlib.Path:
    """The core's library of the current source and compiler."""
    return BUILD_DIR / f"libfesom2_torch_core_{_key(CORE)}.so"


def _compile(cmd_for, out: pathlib.Path) -> None:
    """Runs ``cmd_for(temporary output)`` and moves the output into
    ``out``; raises with the compiler's message on failure."""
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = cmd_for(tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)


def build() -> tuple[pathlib.Path, pathlib.Path]:
    """Builds what is missing -> (library, demo)."""
    cxx = compiler()
    flags = python_flags()
    if cxx is None or flags is None:
        raise RuntimeError("building the host shim needs g++ and an "
                           "embeddable Python (Python.h and libpython)")
    lib, demo = paths()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cflags, ldflags = flags
    if not lib.exists():
        _compile(lambda tmp: [cxx, *CXXFLAGS, *cflags, "-shared",
                              f"-Wl,-soname,{lib.name}", "-o", str(tmp),
                              str(SHIM), *ldflags], lib)
    if not demo.exists():
        _compile(lambda tmp: [cxx, *CXXFLAGS, "-o", str(tmp), str(DEMO),
                              str(lib), "-Wl,-rpath,$ORIGIN"], demo)
    return lib, demo


def build_core() -> pathlib.Path:
    """Builds the mesh core and golden reference if it is missing ->
    its library.  Raises where there is no compiler, and with the
    compiler's message where the build fails."""
    cxx = compiler()
    if cxx is None:
        raise RuntimeError(f"building the native core needs a C++ compiler: "
                           f"{os.environ.get('CXX', 'g++')} not found")
    lib = core_path()
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _compile(lambda tmp: [cxx, *CXXFLAGS, "-shared", "-o", str(tmp),
                              str(CORE)], lib)
    return lib


if __name__ == "__main__":
    for path in build():
        print(path)
