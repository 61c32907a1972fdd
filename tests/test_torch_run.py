"""PyTorch port: the solvers' ``run`` (``runtime/graphs.py``).

On the "cuda" backend ``run`` replays CUDA graphs; the card is needed for
that, so ``chip_smoke.py`` holds it bit for bit against the loop of
steps.  Here, on the CPU:

* ``run`` and ``run_tracers`` of a CPU solver (the CUDA step functions
  given to it as well) and the sharded ``run`` never touch
  ``torch.cuda.CUDAGraph``: the loop of steps;
* the block schedule covers every step exactly once, and graphs pay
  where the host, not the card, sets the pace of a step;
* ``run`` leaves the caller's tensors as they were, and ``run(state, 0)``
  returns the state's values;
* the launch-count bookkeeping of a capture and its replays;
* the sharded ``run`` on the torch backend equals the JAX sharded ``run``
  (``lax.scan``) in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fesom2_accelerate_tpu.config import FctAleConfig as JaxFctAleConfig
from fesom2_accelerate_tpu.mesh import generate_planar_mesh as jax_planar_mesh
from fesom2_accelerate_tpu.parallel import (
    ShardedFctAleSolver as JaxShardedFctAleSolver,
)
from fesom2_accelerate_tpu_torch import (
    FctAleConfig,
    FctAleSolver,
    ShardedFctAleSolver,
)
from fesom2_accelerate_tpu_torch.mesh import (
    generate_planar_mesh,
    random_fields,
)
from fesom2_accelerate_tpu_torch.ops.cuda import kernels
from fesom2_accelerate_tpu_torch.ops.cuda.step import (
    BATCH_SHARED,
    fct_ale_step_cuda,
    fct_ale_step_cuda_batched,
)
from fesom2_accelerate_tpu_torch.runtime import graphs

from conftest import masked_allclose

K = graphs.BLOCK_STEPS


class _NoGraph:
    def __init__(self, *args, **kwargs):
        raise AssertionError("a CPU run touched torch.cuda.CUDAGraph")


@pytest.fixture
def no_graphs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _NoGraph)
    monkeypatch.setattr(torch.cuda, "graph", _NoGraph)


@pytest.fixture(scope="module")
def small():
    mesh = generate_planar_mesh(preset="small")
    return mesh, random_fields(mesh, seed=5)


def _cpu_solver_with_cuda_steps(mesh, cfg):
    """A CPU solver given the CUDA backend's step functions (every kernel
    wrapper runs its plain version on CPU tensors)."""
    solver = FctAleSolver(mesh, cfg, device="cpu")
    solver._step_fn = fct_ale_step_cuda
    solver._tracer_step_fn = fct_ale_step_cuda_batched
    return solver


def test_cpu_runs_never_touch_cuda_graphs(no_graphs, small):
    mesh, fields = small
    cfg = FctAleConfig(dt=0.5, dtype=torch.float32)
    solver = FctAleSolver(mesh, cfg, device="cpu")
    assert solver.backend == "torch" and solver._graphs is None
    state = solver.init_state(fields)
    out = solver.run(state, 3)
    ref = graphs.loop(solver.step, state, 3)
    assert out.keys() == state.keys()
    for k, v in ref.items():
        assert torch.equal(out[k], v), k

    cuda = _cpu_solver_with_cuda_steps(mesh, cfg)
    batched = {k: v if k in BATCH_SHARED else np.stack([v, 2.0 * v])
               for k, v in fields.items()}
    tb = cuda.init_state_tracers(batched)
    out = cuda.run_tracers(tb, 2)
    for k, v in graphs.loop(cuda.step_tracers, tb, 2).items():
        assert torch.equal(out[k], v), k
    assert cuda.run(cuda.init_state(fields), 2).keys() == state.keys()

    sh = ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 4)
    assert sh._graphs is None
    st = sh.init_state(fields)
    out = sh.run(st, 2)
    for k, v in graphs.loop(sh.step, st, 2).items():
        for p in range(4):
            assert torch.equal(out[k][p], v[p]), (k, p)
    assert sum(kernels.launch_counts().values()) == 0


@pytest.mark.parametrize("n", [0, 1, K - 1, K, K + 1, 3 * K + 2])
def test_blocks_cover_every_step_once(n):
    got = graphs.blocks(n)
    assert sum(got) == n
    assert all(1 <= b <= K for b in got)
    # full blocks first, one remainder block last
    assert all(b == K for b in got[:-1])
    assert len(got) == -(-n // K)
    # a replay: blocks of the first n - 1 steps, the last step eager
    if n:
        assert sum(graphs.blocks(n - 1)) + 1 == n
    with pytest.raises(ValueError, match="n_steps"):
        graphs.blocks(-1)


@pytest.mark.parametrize("sharded", [False, True])
def test_run_leaves_the_state_and_zero_steps(small, sharded):
    mesh, fields = small
    cfg = FctAleConfig(dt=0.5, iter_yn=True, dtype=torch.float64)
    if sharded:
        solver = ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 2)
        flat = lambda s: {(k, p): t for k, v in s.items()
                          for p, t in enumerate(v)}
    else:
        solver = FctAleSolver(mesh, cfg, device="cpu")
        flat = dict
    state = solver.init_state(fields)
    before = {k: v.clone() for k, v in flat(state).items()}
    out = solver.run(state, 3)
    for k, v in flat(state).items():
        assert torch.equal(v, before[k]), k
    assert not all(torch.equal(flat(out)[k], v) for k, v in before.items())
    zero = solver.run(state, 0)
    assert zero.keys() == state.keys()
    for k, v in flat(zero).items():
        assert torch.equal(v, before[k]), k


def test_capture_and_replay_counts():
    kernels.reset_launch_counts()
    kernels.bounds.launches = 5
    with kernels.capturing() as calls:
        # in a capture the wrappers count calls that launch nothing
        kernels.bounds.launches += 2
        kernels.update_fused.launches += 1
    assert calls["bounds"] == 2 and calls["update_fused"] == 1
    assert calls["limit"] == 0
    assert kernels.launch_counts()["bounds"] == 5
    assert kernels.launch_counts()["update_fused"] == 0
    for _ in range(3):
        kernels.count_replay(calls)
    counts = kernels.launch_counts()
    assert counts["bounds"] == 5 + 3 * 2 and counts["update_fused"] == 3
    assert sum(counts.values()) == 5 + 3 * 3
    # a capture that raises leaves the counts as they were too
    with pytest.raises(RuntimeError):
        with kernels.capturing():
            kernels.limit.launches += 4
            raise RuntimeError("capture failed")
    assert kernels.launch_counts() == counts
    kernels.reset_launch_counts()


@pytest.mark.parametrize("dry, want", [
    (6, True),    # the card ran dry at every step: the host sets the pace
    (5, False),   # the card set the pace; some enqueues ran long
    (3, False),
    (1, False),
    (0, False),
])
def test_graphs_pay_where_the_host_sets_the_pace(dry, want):
    assert graphs.WATCHED_STEPS == 6
    assert graphs.pays(dry, graphs.WATCHED_STEPS) is want
    # a signature's first run decides within its first block
    assert graphs.WARM_STEPS + graphs.WATCHED_STEPS < graphs.BLOCK_STEPS


def test_step_graphs_need_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA device"):
        graphs.StepGraphs("cpu")


@pytest.mark.parametrize("iter_yn", [False, True])
def test_sharded_run_matches_jax_scan_f64(small, iter_yn):
    mesh, fields = small
    steps = 3
    cfg = FctAleConfig(dt=0.7, iter_yn=iter_yn, dtype=torch.float64)
    sh = ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 4)
    got = sh.gather_state(sh.run(sh.init_state(fields), steps))

    jcfg = JaxFctAleConfig(dt=0.7, iter_yn=iter_yn, dtype=jnp.float64)
    jsh = JaxShardedFctAleSolver(jax_planar_mesh(preset="small"), jcfg,
                                 devices=jax.devices()[:4])
    ref = jsh.gather_state(jsh.run(jsh.init_state(fields), steps))
    assert got.keys() == ref.keys() == set(fields)
    for k, v in ref.items():
        masked_allclose(got[k], v, msg=f"jax scan[{k}]")
