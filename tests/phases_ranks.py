"""Ranks of a partitioned FCT-ALE run through the host ABI's phases, each a
process of its own over gloo: the helper of
``tests/test_torch_host_embed_phases.py`` (CPU) and
``tests/test_torch_host_embed_card.py`` (the card).

A rank joins the group, takes its stripe of the planar mesh
(``portbench.ranks``, owned nodes first), sets the library up on it
(``host_embed.setup_part``) and steps one tracer's seeded fields through
``pre_comm``, the exchange of the factors' halo columns and ``post_comm``,
then again with the exchange skipped.  Rank 0 gathers every rank's owned
columns and edges of the fields a step writes, after each step asked for,
and saves them as whole-mesh arrays.  It imports neither JAX nor the JAX
package, so the card's tests can use it.

Usage (one process a rank; :func:`launch` starts them)::

    python tests/phases_ranks.py --rank 0 --world 2 --init file:///tmp/r \\
        --out /tmp/out.npz --mesh 12,9,8 --backend 0 --steps 1,3
"""

from __future__ import annotations

import argparse
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the fields a non-iterative step writes into the host's buffers
WRITTEN = ("fct_adf_v", "fct_adf_h", "del_ttf_advvert", "del_ttf_advhoriz")
DT_MILLI = 500
SEED = 2 ** 31 + 7


def case(mesh: tuple) -> tuple:
    """(raw mesh arrays, the reference's mesh, one tracer's seeded f64
    fields as numpy) of the planar mesh ``(nx, ny, nl)``."""
    from portbench import inputs
    from portbench.reference.mesh import build_mesh

    nx, ny, nl = mesh
    raw = inputs.planar_mesh(nx, ny, nl)
    ref = build_mesh(raw[0], raw[1], nl, raw[2])
    made = inputs.fields(ref, SEED, 1, "cpu")[0]
    fields = {k: (v[0] if k in inputs.TRACER_FIELDS else v).numpy()
              for k, v in made.items()}
    return raw, ref, fields


def key(exchanged: bool, steps: int, field: str) -> str:
    return f"{'exchanged' if exchanged else 'skipped'}_{steps}_{field}"


def run_rank(rank: int, world: int, init: str, out: str, mesh: tuple,
             backend: int, steps: list, device: str) -> None:
    import numpy as np
    import torch.distributed as dist

    from fesom2_accelerate_tpu_torch import host_embed
    from fesom2_accelerate_tpu_torch.native import demo
    from fesom2_accelerate_tpu_torch.parallel import distributed
    from portbench import ranks

    distributed.init_distributed(init, world, rank)
    distributed.bind_device(device=device)
    (elem_nodes, nlev_elem, node_xy), ref, fields = case(mesh)
    parts = ranks.stripes(elem_nodes, nlev_elem, node_xy, ref.edges,
                          ranks.even_counts(ref.n_nodes, world))
    p = parts[rank]
    saved = {}
    for exchanged in (True, False):
        assert host_embed.setup_part(
            len(p.elem_nodes), mesh[2], p.elem_nodes.ctypes.data,
            p.nlev_elem.ctypes.data, len(p.nodes), p.n_owned,
            p.node_xy.ctypes.data, DT_MILLI, 1, 0, backend) == 0
        bufs = {k: np.ascontiguousarray(
            v[:, p.edges] * p.edge_sign if k == "fct_adf_h"
            else v[:, p.nodes]) for k, v in fields.items()}
        factors = [np.zeros((ref.n_layers, len(p.nodes))) for _ in range(2)]
        addrs = [bufs[k].ctypes.data for k, _ in demo.FIELD_FILES] + [
            a.ctypes.data for a in factors]
        try:
            for s in range(1, max(steps) + 1):
                assert host_embed.pre_comm(*addrs) == 0
                if exchanged:
                    ranks.exchange(p, factors)
                assert host_embed.post_comm(*addrs) == 0
                if s in steps:
                    own = p.owned_edges
                    mine = {k: bufs[k][:, own] * p.edge_sign[own]
                            if k == "fct_adf_h" else bufs[k][:, :p.n_owned]
                            for k in WRITTEN}
                    every = [None] * world if rank == 0 else None
                    dist.gather_object((rank, mine), every, dst=0)
                    for k in WRITTEN if rank == 0 else ():
                        whole = np.zeros(fields[k].shape)
                        for r, got in every:
                            q = parts[r]
                            cols = (q.edges[q.owned_edges]
                                    if k == "fct_adf_h"
                                    else q.nodes[:q.n_owned])
                            whole[:, cols] = got[k]
                        saved[key(exchanged, s, k)] = whole
        finally:
            host_embed.reset()
    if rank == 0:
        np.savez(out, **saved)
    dist.barrier()
    dist.destroy_process_group()


def launch(world: int, out, mesh: tuple, backend: int, steps: list,
           device: str, timeout: float) -> tuple:
    """Runs ``world`` ranks -> (status, each rank's output).  The status
    is 0 when every rank exited 0; on the first rank that fails, or once
    ``timeout`` seconds have passed, every rank still running is killed,
    and the status is that rank's exit code, or 124."""
    rdv = tempfile.mkdtemp()
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    if device == "cpu":
        env["FESOM2_TORCH_DEVICE"] = "cpu"
    logs, procs = [], []
    for r in range(world):
        logs.append(tempfile.TemporaryFile(mode="w+"))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--rank", str(r), "--world",
             str(world), "--init", f"file://{rdv}/rdv", "--out", str(out),
             "--mesh", ",".join(map(str, mesh)), "--backend", str(backend),
             "--steps", ",".join(map(str, steps)), "--device", device],
            stdout=logs[-1], stderr=subprocess.STDOUT, env=env,
            cwd=str(ROOT)))
    deadline = time.monotonic() + timeout
    status = 0
    try:
        while any(p.poll() is None for p in procs):
            bad = [p.returncode for p in procs if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                status = bad[0] if bad else 124
                break
            time.sleep(0.1)
        else:
            status = next((p.returncode for p in procs if p.returncode), 0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    out_logs = []
    for log in logs:
        log.seek(0)
        out_logs.append(log.read())
        log.close()
    return status, out_logs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--mesh", required=True)
    ap.add_argument("--backend", type=int, required=True)
    ap.add_argument("--steps", required=True)
    ap.add_argument("--device", default="cpu")
    a = ap.parse_args(argv)
    if a.device == "cpu":
        import torch

        torch.set_num_threads(1)
    run_rank(a.rank, a.world, a.init, a.out,
             tuple(int(x) for x in a.mesh.split(",")), a.backend,
             [int(x) for x in a.steps.split(",")], a.device)


if __name__ == "__main__":
    main()
