"""The benchmark's own tests (``python -m pytest portbench/tests``).

They run on the CPU at toy sizes, where the program's kernel wrappers run
their plain versions; the runs at the cells' own sizes are the
benchmark's, on the card."""

import functools
import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(scope="session")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def on_cpu(monkeypatch):
    """Lets the drivers run on the CPU: the solvers get the CUDA step
    functions, whose wrappers run their plain versions on CPU tensors;
    the EVP loop runs without CUDA graphs; the ABI's backend 1 builds such
    a CPU solver."""
    from fesom2_accelerate_tpu_torch import host_embed
    from fesom2_accelerate_tpu_torch.model import FctAleSolver
    from fesom2_accelerate_tpu_torch.ops.cuda.step import (
        fct_ale_step_cuda,
        fct_ale_step_cuda_batched,
    )
    from fesom2_accelerate_tpu_torch.parallel import ShardedFctAleSolver
    from fesom2_accelerate_tpu_torch.runtime import graphs

    from portbench.drivers import evp, fct_resident

    def solver(mesh, cfg, backend=None, device="cpu"):
        sv = FctAleSolver(mesh, cfg, device="cpu")
        sv._step_fn = functools.partial(fct_ale_step_cuda, fuse_k12=False,
                                        fuse_k34=True)
        sv._tracer_step_fn = functools.partial(
            fct_ale_step_cuda_batched, fuse_k12=False, fuse_k34=True)
        return sv

    def sharded(mesh, cfg, devices, tracers):
        sh = ShardedFctAleSolver(mesh, cfg, devices=devices, tracers=1)
        sh.set_step(True, False, tracers)
        return sh

    class LoopGraphs:
        def __init__(self, device):
            pass

        def run(self, step, state, n):
            return graphs.loop(step, state, n)

    monkeypatch.setattr(fct_resident, "FctAleSolver",
                        lambda mesh, cfg, device: solver(mesh, cfg))
    monkeypatch.setattr(fct_resident, "ShardedFctAleSolver", sharded)
    monkeypatch.setattr(evp, "StepGraphs", LoopGraphs)
    monkeypatch.setattr(host_embed, "_solver",
                        lambda mesh, cfg, backend: solver(mesh, cfg))
