"""Checkpoint / resume of solver state (numpy copy of the JAX package's
``runtime/checkpoint.py``).

A state dict, with the mesh fingerprint and the config for safety, is
written as ``state.npz`` beside a ``meta.json`` with the JAX module's keys
(``step``, ``mesh``, ``vlimit``, ``iter_yn``, ``dt``, ``dtype``,
``format``), so an npz checkpoint loads in either package.  The JAX
module writes Orbax when it is importable; the port writes npz only and
raises on a checkpoint whose meta says "orbax" (the GPU machine has no
Orbax, and the port never imports it).  The port imports no JAX, so it
keeps its own copy of this code; ``mesh_fingerprint`` gives the same
digits as the JAX function on the same mesh.
"""

from __future__ import annotations

import hashlib
import json
import pathlib

import numpy as np
import torch

from fesom2_accelerate_tpu_torch.config import FctAleConfig
from fesom2_accelerate_tpu_torch.mesh.topology import Mesh


def mesh_fingerprint(mesh: Mesh) -> str:
    h = hashlib.sha256()
    for arr in (mesh.elem_nodes, mesh.nlev_elem, mesh.edges):
        h.update(np.ascontiguousarray(arr).tobytes())
    h.update(str(mesh.nl).encode())
    return h.hexdigest()[:16]


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path, state: dict, mesh: Mesh, cfg: FctAleConfig,
                    step: int = 0) -> None:
    """Writes ``state`` (tensors on any device, or numpy arrays) and its
    meta into the directory ``path``."""
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    meta = dict(
        step=step,
        mesh=mesh_fingerprint(mesh),
        vlimit=cfg.vlimit,
        iter_yn=cfg.iter_yn,
        dt=cfg.dt,
        dtype=str(np.dtype(cfg.np_dtype)),
        format="npz",
    )
    (path / "meta.json").write_text(json.dumps(meta))
    np.savez(path / "state.npz", **{k: _numpy(v) for k, v in state.items()})


def load_checkpoint(path, mesh: Mesh, cfg: FctAleConfig):
    """Returns (state dict of numpy arrays, step).  Raises on mesh or config
    mismatch — resuming onto a different mesh is a corruption hazard."""
    path = pathlib.Path(path)
    meta = json.loads((path / "meta.json").read_text())
    if meta["mesh"] != mesh_fingerprint(mesh):
        raise ValueError(
            f"checkpoint mesh {meta['mesh']} != current "
            f"{mesh_fingerprint(mesh)}"
        )
    if meta["vlimit"] != cfg.vlimit or meta["iter_yn"] != cfg.iter_yn:
        raise ValueError(f"checkpoint config mismatch: {meta}")
    fmt = meta.get("format", "npz")
    if fmt != "npz":
        raise RuntimeError(
            f"checkpoint {path} was written in {fmt!r} format (the JAX "
            f"package's Orbax); the port reads npz only: save it from the "
            f"JAX package with use_orbax=False")
    with np.load(path / "state.npz") as z:
        state = {k: z[k] for k in z.files}
    return state, int(meta["step"])
