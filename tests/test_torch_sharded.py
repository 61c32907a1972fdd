"""PyTorch port: the domain-decomposed FCT-ALE step on P parts in one
process, against the JAX package's ShardedFctAleSolver and the
single-device step.

* ``ShardedFctAleSolver(backend="torch")`` in float64 against the JAX
  solver's XLA path and the single-device step, at 1e-12, for iter_yn x
  exchange form, the multi-hop mesh and vlimit 2/3 (the cases of
  tests/test_sharded.py);
* the CUDA backend's phase functions on CPU tensors, where each kernel
  wrapper runs its plain version: split mode (K1, K2, K3 -> exchange ->
  K3fix, K4) against the JAX solver's Pallas path in interpret mode, f32,
  relerr < 2e-6, on the packed ``small`` mesh and on the RCM cylinder whose
  parts take the one-hot kernels; fused mode (exchange -> K34) against the
  single-device step, as tests/test_sharded.py holds the JAX fused mode;
* 5-step runs of every form that compare ``fct_adf_h`` as well;
* the fixup's invariants, the exchange forms, and the solver's rules.

JAX runs on the 8 virtual CPU devices of tests/conftest.py; Pallas
kernels through ``kernels.set_interpret(True)`` (not
``force_tpu_interpret_mode``, which deadlocks under shard_map,
tests/test_sharded.py:176-180)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fesom2_accelerate_tpu.config import FctAleConfig as JaxFctAleConfig
from fesom2_accelerate_tpu.mesh import generate_planar_mesh as jax_planar_mesh
from fesom2_accelerate_tpu.mesh.generate import (
    generate_cylinder_mesh as jax_cylinder_mesh,
)
from fesom2_accelerate_tpu.model.fct_ale import FctAleSolver as JaxFctAleSolver
from fesom2_accelerate_tpu.ops.pallas import kernels as pallas_kernels
from fesom2_accelerate_tpu.parallel import (
    ShardedFctAleSolver as JaxShardedFctAleSolver,
)
from fesom2_accelerate_tpu_torch import (
    FctAleConfig,
    FctAleSolver,
    ShardedFctAleSolver,
)
from fesom2_accelerate_tpu_torch.mesh import (
    generate_cylinder_mesh,
    generate_planar_mesh,
    random_fields,
)
from fesom2_accelerate_tpu_torch.ops.cuda import build, kernels
from fesom2_accelerate_tpu_torch.parallel import partition as part_mod
from fesom2_accelerate_tpu_torch.parallel.step_sharded import (
    fix_edge_ids,
    sharded_fct_ale_step_cuda,
)

from conftest import masked_allclose

F32_RELERR = 2e-6  # tests/test_sharded.py:212


def _relerr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


@pytest.fixture(scope="module")
def small():
    mesh = generate_planar_mesh(preset="small")
    return mesh, jax_planar_mesh(preset="small"), random_fields(mesh, seed=3)


def _node_keys(iter_yn):
    keys = ["fct_plus", "fct_minus", "fct_ttf_max", "fct_ttf_min",
            "fct_adf_v"]
    return keys + (["fct_LO"] if iter_yn
                   else ["del_ttf_advvert", "del_ttf_advhoriz"])


def _cuda_phases(sh, state, fused, n_steps=1):
    """n_steps of the CUDA backend's step on the parts of the torch solver
    ``sh`` (CPU tensors: every wrapper runs its plain version)."""
    fix = None if fused else [torch.from_numpy(fix_edge_ids(sh.pm, p))
                              for p in range(sh.n_parts)]
    for _ in range(n_steps):
        parts = [{k: v[p] for k, v in state.items()}
                 for p in range(sh.n_parts)]
        outs = sharded_fct_ale_step_cuda(sh.mds, sh.cfg, sh.halo_fill,
                                         parts, fix)
        new = {k: [o[k] for o in outs] for k in outs[0]}
        state = new if n_steps == 1 else {k: new[k] for k in state}
    return state


@pytest.mark.parametrize("exchange", ["ppermute", "allgather"])
@pytest.mark.parametrize("iter_yn", [False, True])
def test_sharded_torch_matches_jax_and_single(small, iter_yn, exchange):
    mesh, jmesh, fields = small
    cfg = FctAleConfig(dt=0.7, iter_yn=iter_yn, dtype=torch.float64)
    single = FctAleSolver(mesh, cfg, device="cpu")
    ref = single.step(single.init_state(fields))

    sh = ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 8,
                             exchange=exchange)
    assert sh.n_parts == 8 and sh.exchange_mode == exchange
    out = sh.step(sh.init_state(fields))

    jcfg = JaxFctAleConfig(dt=0.7, iter_yn=iter_yn, dtype=jnp.float64)
    jsh = JaxShardedFctAleSolver(jmesh, jcfg, exchange=exchange)
    jout = jsh.step(jsh.init_state(fields))
    for k in _node_keys(iter_yn):
        got = sh.gather_node(out[k])
        masked_allclose(got, ref[k].numpy(), msg=f"single[{k}]")
        masked_allclose(got, jsh.gather_node(jout[k]), msg=f"jax[{k}]")
    got = sh.gather_state({"fct_adf_h": out["fct_adf_h"]})["fct_adf_h"]
    masked_allclose(got, ref["fct_adf_h"].numpy(), msg="single[fct_adf_h]")
    masked_allclose(got, part_mod.gather_edge_field(
        sh.pm, np.asarray(jout["fct_adf_h"])), msg="jax[fct_adf_h]")


@pytest.mark.parametrize("form", ["torch", "split", "fused"])
def test_sharded_multihop_matches_single_and_jax(form):
    """Radius >= 2 (block size below the mesh bandwidth): the packed
    multi-hop exchange, every form, against the single-device step and the
    JAX sharded step (f64, 1e-12)."""
    mesh = generate_planar_mesh(nx=4, ny=7, nl=5)
    fields = random_fields(mesh, seed=2)
    cfg = FctAleConfig(dt=0.7, dtype=torch.float64)
    single = FctAleSolver(mesh, cfg, device="cpu")
    ref = single.step(single.init_state(fields))

    sh = ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 8,
                             exchange="ppermute")
    assert sh.pm.neighbor_radius >= 2
    state = sh.init_state(fields)
    out = (sh.step(state) if form == "torch"
           else _cuda_phases(sh, state, fused=(form == "fused")))
    jsh = JaxShardedFctAleSolver(jax_planar_mesh(nx=4, ny=7, nl=5),
                                 JaxFctAleConfig(dt=0.7, dtype=jnp.float64),
                                 exchange="ppermute")
    jout = jsh.step(jsh.init_state(fields))
    for k in _node_keys(False):
        got = sh.gather_node(out[k])
        masked_allclose(got, ref[k].numpy(), msg=f"single[{k}]")
        masked_allclose(got, jsh.gather_node(jout[k]), msg=f"jax[{k}]")
    masked_allclose(sh.gather_state(out)["fct_adf_h"],
                    ref["fct_adf_h"].numpy(), msg="fct_adf_h")


@pytest.mark.parametrize("vlimit", [2, 3])
def test_sharded_vlimit23_matches_single(small, vlimit):
    mesh, _, fields = small
    cfg = FctAleConfig(dt=0.7, vlimit=vlimit, dtype=torch.float64)
    single = FctAleSolver(mesh, cfg, device="cpu")
    ref = single.step(single.init_state(fields))
    sh = ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 8)
    state = sh.init_state(fields)
    for out in (sh.step(state), _cuda_phases(sh, state, fused=False)):
        for k in _node_keys(False):
            masked_allclose(sh.gather_node(out[k]), ref[k].numpy(),
                            msg=f"vlimit{vlimit}[{k}]")


def _jax_pallas_step(jmesh, jcfg, fields32, **kw):
    pallas_kernels.set_interpret(True)
    try:
        jsh = JaxShardedFctAleSolver(jmesh, jcfg, backend="pallas", **kw)
        return jsh, jsh.gather_state(jsh.step(jsh.init_state(fields32)))
    finally:
        pallas_kernels.set_interpret(False)


@pytest.mark.parametrize("iter_yn", [False, True])
def test_split_phases_match_jax_pallas_packed(small, iter_yn):
    """Split mode's plain versions against the JAX split chain on the packed
    layout (b3h_packed, b3h_packed_fixup, update_packed: Pallas rows
    11-13), 8 parts, f32."""
    mesh, jmesh, fields = small
    fields32 = {k: v.astype(np.float32) for k, v in fields.items()}
    cfg = FctAleConfig(dt=0.7, iter_yn=iter_yn, flux_eps=1e-7,
                       dtype=torch.float32)
    jcfg = JaxFctAleConfig(dt=0.7, iter_yn=iter_yn, flux_eps=1e-7,
                           dtype=jnp.float32)
    jsh, jout = _jax_pallas_step(jmesh, jcfg, fields32)
    assert jsh.ps.pack_K > 0 and jsh.ps.n_fix_tiles > 0
    assert not jsh.ps.fuse_k34

    sh = ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 8)
    out = sh.gather_state(_cuda_phases(sh, sh.init_state(fields32), False))
    L = mesh.n_layers
    for k in _node_keys(iter_yn):
        rows = L + 1 if k == "fct_adf_v" else L
        err = _relerr(out[k], jout[k][:rows])
        assert err < F32_RELERR, f"{k}: relerr {err:.2e}"
    for k in ["fct_adf_h"] + (["fct_adf_h_limited"] if iter_yn else []):
        err = _relerr(out[k], jout[k])
        assert err < F32_RELERR, f"{k}: relerr {err:.2e}"


def test_split_phases_match_jax_pallas_one_hot():
    """The RCM cylinder at 4 parts: the JAX parts take the one-hot split
    chain (b3h_pallas, b3h_fixup_pallas, update_pallas: Pallas rows 5-7)."""
    mesh = generate_cylinder_mesh(48, 16, 8)[0]
    jmesh = jax_cylinder_mesh(48, 16, 8)[0]
    fields32 = {k: v.astype(np.float32)
                for k, v in random_fields(mesh, seed=6).items()}
    cfg = FctAleConfig(dt=0.6, flux_eps=1e-7, dtype=torch.float32)
    jcfg = JaxFctAleConfig(dt=0.6, flux_eps=1e-7, dtype=jnp.float32)
    with pytest.warns(RuntimeWarning, match="degraded"):
        jsh, jout = _jax_pallas_step(jmesh, jcfg, fields32,
                                     devices=jax.devices()[:4])
    assert jsh.ps.pack_K == 0 and jsh.ps.n_fix_tiles > 0

    sh = ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 4)
    out = sh.gather_state(_cuda_phases(sh, sh.init_state(fields32), False))
    L = mesh.n_layers
    for k in _node_keys(False) + ["fct_adf_h"]:
        rows = L + 1 if k == "fct_adf_v" else L
        err = _relerr(out[k], jout[k][:rows])
        assert err < F32_RELERR, f"{k}: relerr {err:.2e}"


@pytest.mark.parametrize("iter_yn", [False, True])
def test_fused_phases_match_single(small, iter_yn):
    """Fused mode (exchange, then K34's plain version) against the
    single-device JAX XLA step, f32."""
    mesh, jmesh, fields = small
    fields32 = {k: v.astype(np.float32) for k, v in fields.items()}
    jcfg = JaxFctAleConfig(dt=0.7, iter_yn=iter_yn, flux_eps=1e-7,
                           dtype=jnp.float32)
    jsingle = JaxFctAleSolver(jmesh, jcfg)
    ref = jsingle.step(jsingle.init_state(fields32))
    cfg = FctAleConfig(dt=0.7, iter_yn=iter_yn, flux_eps=1e-7,
                       dtype=torch.float32)
    sh = ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 8)
    out = sh.gather_state(_cuda_phases(sh, sh.init_state(fields32), True))
    for k in _node_keys(iter_yn) + ["fct_adf_h"]:
        err = _relerr(out[k], np.asarray(ref[k]))
        assert err < F32_RELERR, f"{k}: relerr {err:.2e}"


@pytest.fixture(scope="module")
def five_steps_ref(small):
    """5 iterative f64 steps of the single-device port and of the JAX
    sharded XLA solver (8 parts)."""
    mesh, jmesh, fields = small
    cfg = FctAleConfig(dt=0.3, iter_yn=True, dtype=torch.float64)
    single = FctAleSolver(mesh, cfg, device="cpu")
    ref = single.run(single.init_state(fields), 5)
    jsh = JaxShardedFctAleSolver(
        jmesh, JaxFctAleConfig(dt=0.3, iter_yn=True, dtype=jnp.float64))
    jref = jsh.gather_state(jsh.run(jsh.init_state(fields), 5))
    return cfg, {k: v.numpy() for k, v in ref.items()}, jref


@pytest.mark.parametrize("form", ["torch", "split", "fused"])
def test_five_steps_match_single_and_jax(small, five_steps_ref, form):
    """5 iterative steps (fct_LO exchanged after each stage c, residual
    fluxes carried): every carried field, ``fct_adf_h`` included, against
    the single-device run and the JAX sharded run."""
    mesh, _, fields = small
    cfg, ref, jref = five_steps_ref
    sh = ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 8)
    state = sh.init_state(fields)
    out = (sh.run(state, 5) if form == "torch"
           else _cuda_phases(sh, state, fused=(form == "fused"), n_steps=5))
    assert out.keys() == state.keys()
    got = sh.gather_state(out)
    for k in ("fct_LO", "fct_adf_v", "fct_adf_h"):
        masked_allclose(got[k], ref[k], rtol=1e-10, atol=1e-11,
                        msg=f"single[{k}]")
        masked_allclose(got[k], jref[k], rtol=1e-10, atol=1e-11,
                        msg=f"jax[{k}]")


def test_fixup_completes_split_limiting_and_ignores_duplicates(small):
    """On every part: K3 on the pre-exchange factors, then K3fix on the fix
    list with the exchanged ones, equals K3 on the exchanged factors at
    every real edge (edges off the list have both endpoints owned, whose
    factors the exchange leaves alone); a duplicated, reordered id list
    gives the same bits."""
    mesh, _, fields = small
    cfg = FctAleConfig(dt=0.7, iter_yn=True, dtype=torch.float64)
    sh = ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 8)
    state = sh.init_state(fields)
    pres = []
    for p, md in enumerate(sh.mds):
        s = {k: v[p] for k, v in state.items()}
        tmax, tmin = kernels.bounds(md, s["fct_LO"], s["ttf"], 1)
        pres.append(kernels.limit(md, s["fct_adf_v"], tmax, tmin,
                                  s["fct_adf_h"], cfg.dt, cfg.flux_eps,
                                  True)[:2])
    before = [(pl.clone(), mn.clone()) for pl, mn in pres]
    sh.halo_fill([pm[0] for pm in pres])
    sh.halo_fill([pm[1] for pm in pres])
    for p, md in enumerate(sh.mds):
        ah = state["fct_adf_h"][p]
        ids = torch.from_numpy(fix_edge_ids(sh.pm, p))
        dup = torch.cat([ids.flip(0), ids, ids[::3]])
        split = kernels.b3h(md, *before[p], ah, True)
        once = kernels.b3h_fixup(md, *pres[p], ah, split[0].clone(),
                                 split[1].clone(), ids, True)
        twice = kernels.b3h_fixup(md, *pres[p], ah, split[0].clone(),
                                  split[1].clone(), dup, True)
        full = kernels.b3h(md, *pres[p], ah, True)
        n_real = int(np.sum(sh.pm.local_edges_global[p] >= 0))
        for a, b, c in zip(once, twice, full):
            assert torch.equal(a, b)
            assert torch.equal(a[:, :n_real], c[:, :n_real])
        changed = ~torch.eq(split[0], full[0]).all(dim=0)
        assert bool(changed.any()), f"part {p}: the exchange changed nothing"
        assert set(torch.nonzero(changed).flatten().tolist()) <= \
            set(ids.tolist())


@pytest.mark.parametrize("exchange", ["ppermute", "allgather"])
def test_halo_fill_sets_every_halo_column_from_its_owner(exchange):
    """Both exchange forms fill each halo column that holds a node with
    the owner's value and leave every owned column as it was."""
    mesh = generate_planar_mesh(nx=4, ny=7, nl=5)
    sh = ShardedFctAleSolver(mesh, FctAleConfig(dtype=torch.float64),
                             devices=["cpu"] * 8, exchange=exchange)
    pm = sh.pm
    field = np.random.default_rng(1).standard_normal((3, mesh.n_nodes))
    loc = part_mod.scatter_node_field(pm, field)
    xs = []
    for p in range(pm.n_parts):
        x = torch.from_numpy(loc[p].copy())
        x[:, :pm.H] = -7.0
        x[:, pm.H + pm.B:] = -7.0
        xs.append(x)
    sh.halo_fill(xs)
    for p, x in enumerate(xs):
        gids = pm.local_nodes_global[p]
        present = gids >= 0
        np.testing.assert_array_equal(x.numpy()[:, present],
                                      field[:, gids[present]])


def test_one_part_is_the_single_device_step(small):
    mesh, _, fields = small
    cfg = FctAleConfig(dt=0.7, dtype=torch.float64)
    sh = ShardedFctAleSolver(mesh, cfg, devices=["cpu"])
    assert sh.exchange_mode == "allgather"
    single = FctAleSolver(mesh, cfg, device="cpu")
    ref = single.step(single.init_state(fields))
    got = sh.gather_state(sh.step(sh.init_state(fields)))
    for k in ref:
        masked_allclose(got[k], ref[k].numpy(), msg=k)


def test_cuda_phases_on_cpu_launch_nothing(small):
    mesh, _, fields = small
    sh = ShardedFctAleSolver(mesh, FctAleConfig(dtype=torch.float64),
                             devices=["cpu"] * 4)
    kernels.reset_launch_counts()
    for fused in (False, True):
        _cuda_phases(sh, sh.init_state(fields), fused)
    assert not any(kernels.launch_counts().values())
    assert build.library.cache_info().currsize == 0, \
        "the CPU path must not build or load the CUDA library"


def test_solver_rules(small):
    mesh, _, fields = small
    cfg = FctAleConfig()
    with pytest.raises(ValueError, match="CUDA devices"):
        ShardedFctAleSolver(mesh, cfg, backend="cuda", devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="backend"):
        ShardedFctAleSolver(mesh, cfg, backend="xla", devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="cuda-only"):
        ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 2, fused=True)
    with pytest.raises(ValueError, match="exchange"):
        ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 2, exchange="nccl")
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 2, tracers=2)
    sh = ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 2)
    assert sh.exchange_mode == "ppermute" and sh.fix_ids is None
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        sh.save_checkpoint("x", {})
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        sh.load_checkpoint("x")
    with pytest.raises(ValueError, match="fct_adf_h"):
        sh.init_state({"fct_adf_h": fields["ttf"]})
    state = sh.init_state(fields)
    assert all(len(v) == 2 and v[0].dtype == torch.float32
               for v in state.values())
