"""Drives the C demo host (``host_embed_demo.cpp``) on a case: its input
files, its run with the embedded interpreter pointed at this package, and
its outputs.

The demo reads ``<dir>/meta.txt`` (``n_elems nl n_nodes dt_milli vlimit
iter_yn backend``) and raw little-endian arrays (``elem_nodes``,
``nlev_elem``, ``node_xy`` and the eight f64 fields), runs one step
through the ``f2t_*_`` ABI and writes ``out_*.bin``.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sysconfig

import numpy as np

# each f64 field of a step and the name of its file
FIELD_FILES = (("ttf", "ttf"), ("fct_LO", "fct_LO"),
               ("fct_adf_v", "adf_v"), ("fct_adf_h", "adf_h"),
               ("hnode", "hnode"), ("hnode_new", "hnode_new"),
               ("del_ttf_advvert", "del_v"), ("del_ttf_advhoriz", "del_h"))
# the fields a step writes back, and their output files
OUT_FILES = {"fct_adf_v": "out_adf_v", "fct_adf_h": "out_adf_h",
             "fct_LO": "out_fct_LO", "del_ttf_advvert": "out_del_v",
             "del_ttf_advhoriz": "out_del_h"}
ROOT = pathlib.Path(__file__).resolve().parents[2]


def write_inputs(d, mesh, fields: dict, dt_milli: int, vlimit: int,
                 iter_yn: bool, backend: int) -> None:
    d = pathlib.Path(d)
    d.mkdir(parents=True, exist_ok=True)
    (d / "meta.txt").write_text(
        f"{mesh.n_elems} {mesh.nl} {mesh.n_nodes} {dt_milli} {vlimit} "
        f"{int(iter_yn)} {backend}\n")
    mesh.elem_nodes.astype(np.int32).tofile(d / "elem_nodes.bin")
    mesh.nlev_elem.astype(np.int32).tofile(d / "nlev_elem.bin")
    mesh.node_xy.astype(np.float64).tofile(d / "node_xy.bin")
    for k, name in FIELD_FILES:
        np.asarray(fields[k], np.float64).tofile(d / f"{name}.bin")


def environment() -> dict:
    """The demo's environment: the embedded interpreter is the build
    Python, so it is given this checkout and this Python's site-packages
    on ``PYTHONPATH``."""
    env = dict(os.environ)
    paths = [str(ROOT), sysconfig.get_paths()["purelib"],
             sysconfig.get_paths()["platlib"]]
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(
        paths + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                 if p]))
    return env


def run(demo, d, timeout: float = 600.0,
        env: dict | None = None) -> subprocess.CompletedProcess:
    """Runs the demo on the case in ``d``, with the variables of ``env``
    added to :func:`environment` (``{"FESOM2_TORCH_DEVICE": "cpu"}`` runs
    backend 0 on the CPU); its exit code names the ABI call that failed (0
    when none did)."""
    return subprocess.run([str(demo), str(d)], capture_output=True,
                          text=True, env={**environment(), **(env or {})},
                          timeout=timeout)


def outputs(d, mesh, iter_yn: bool) -> dict:
    """The fields the step wrote back, as f64 arrays of their shapes."""
    d = pathlib.Path(d)
    L, N, Ed = mesh.n_layers, mesh.n_nodes, mesh.n_edges
    keys = ["fct_adf_v", "fct_adf_h"] + (
        ["fct_LO"] if iter_yn else ["del_ttf_advvert", "del_ttf_advhoriz"])
    shapes = {"fct_adf_v": (L + 1, N), "fct_adf_h": (L, Ed)}
    return {k: np.fromfile(d / f"{OUT_FILES[k]}.bin").reshape(
        shapes.get(k, (L, N))) for k in keys}
