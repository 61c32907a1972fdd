"""PyTorch port: the domain-decomposed FCT-ALE step on P parts in one
process, against the JAX package's ShardedFctAleSolver and the
single-device step.

* ``ShardedFctAleSolver(backend="torch")`` in float64 against the JAX
  solver's XLA path and the single-device step, at 1e-12, for iter_yn x
  exchange form, the multi-hop mesh and vlimit 2/3 (the cases of
  tests/test_sharded.py);
* the CUDA backend's phase functions on CPU tensors, where each kernel
  wrapper runs its plain version: split mode (K1, K2, K3 -> exchange ->
  K4-fix, which does K3fix's work in K4's launch) against the JAX solver's Pallas path in interpret mode, f32,
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
from fesom2_accelerate_tpu_torch.parallel import step_sharded
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
    owned = None if fused else (sh.pm.H, sh.pm.H + sh.pm.B)
    for _ in range(n_steps):
        parts = [{k: v[p] for k, v in state.items()}
                 for p in range(sh.n_parts)]
        outs = sharded_fct_ale_step_cuda(sh.mds, sh.cfg, sh.halo_fill,
                                         parts, owned)
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
    with pytest.raises(ValueError, match="cuda-only"):
        ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 2, tracers=2)
    with pytest.raises(ValueError, match="tracers"):
        ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 2, tracers=0)
    sh = ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 2)
    assert sh.exchange_mode == "ppermute" and sh.owned is None
    with pytest.raises(FileNotFoundError):
        sh.load_checkpoint("no-such-checkpoint")
    with pytest.raises(ValueError, match="fct_adf_h"):
        sh.init_state({"fct_adf_h": fields["ttf"]})
    state = sh.init_state(fields)
    assert all(len(v) == 2 and v[0].dtype == torch.float32
               for v in state.values())


# --------------------------------------------------------------------------
# the exchange's schedule: the JAX sharded step's (parallel/step_sharded.py:
# 176-186, ops/pallas/step.py:822-871, certified by tests/test_overlap.py)
# --------------------------------------------------------------------------


class _LoggedFill:
    """A halo fill that logs its phases into ``log`` (with the shapes it
    was given) and counts the index ops the fill it wraps runs."""

    def __init__(self, fill, log):
        self.fill, self.log, self.ops = fill, log, 0

    def _counted(self, fn, arg):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            out = fn(arg)
        self.ops += sum(e.count for e in prof.key_averages()
                        if e.key in ("aten::index_select",
                                     "aten::index_copy_"))
        return out

    def start(self, xs):
        self.log.append(("start", [tuple(x.shape) for x in xs]))
        return self._counted(self.fill.start, xs)

    def finish(self, pending):
        self.log.append(("finish",))
        return self._counted(self.fill.finish, pending)

    def __call__(self, xs):
        self.log.append(("fill", [tuple(x.shape) for x in xs]))
        return self._counted(self.fill, xs)


def _logged_solver(mesh, cfg, mode, log, tracers=1):
    """A 4-part CPU solver whose step is ``mode`` ("torch": the plain
    stages; "split", "fused": the CUDA step functions, every wrapper's
    plain version) and whose halo fill logs into ``log``."""
    sh = ShardedFctAleSolver(mesh, cfg, devices=["cpu"] * 4)
    sh.halo_fill = _LoggedFill(sh.halo_fill, log)
    sh.set_step(mode != "torch", mode == "fused", tracers)
    return sh


def _pair_halo(pair, sh):
    """The halo columns of a part's [2, ...] factor pair."""
    return torch.cat([pair[..., :sh.pm.H], pair[..., sh.pm.H + sh.pm.B:]],
                     dim=-1).clone()


@pytest.mark.parametrize("mode", ["split", "fused", "torch"])
def test_exchange_in_flight_while_k3_sweeps(small, mode, monkeypatch):
    """The order of a step's calls, as the JAX step's: split K1/K2 of
    every part -> start -> K3 of every part -> finish -> K4-fix, K3
    reading the pre-exchange factors (no halo column written before every
    K3 is enqueued); fused start -> finish -> K34; plain start ->
    inter_comm (b3 vertical) -> finish -> post_comm."""
    mesh, _, fields = small
    log = []
    sh = _logged_solver(mesh, FctAleConfig(dt=0.7, dtype=torch.float64),
                        mode, log)
    before = {}

    def logged(name, fn, part_of=lambda *a: None):
        def call(*args, **kw):
            p = part_of(*args)
            log.append((name, p))
            return fn(*args, **kw)
        return call

    part = {id(md): p for p, md in enumerate(sh.mds)}
    real_pre, real_k3 = step_sharded.cstep.pre_exchange, \
        step_sharded.cstep.limit_edges

    def pre(md, cfg, s, **kw):
        out = real_pre(md, cfg, s, **kw)
        log.append(("K1/K2", part[id(md)]))
        before[part[id(md)]] = _pair_halo(
            kernels.factor_pair(out["fct_plus"], out["fct_minus"]), sh)
        return out

    def k3(md, cfg, s, p, **kw):
        pair = kernels.factor_pair(p["fct_plus"], p["fct_minus"])
        assert torch.equal(_pair_halo(pair, sh), before[part[id(md)]]), \
            "a halo column was written before K3"
        log.append(("K3", part[id(md)]))
        return real_k3(md, cfg, s, p, **kw)

    by_part = lambda md, *a: part.get(id(md))  # noqa: E731
    monkeypatch.setattr(step_sharded.cstep, "pre_exchange", pre)
    monkeypatch.setattr(step_sharded.cstep, "limit_edges", k3)
    for name, attr in (("K4-fix", "post_exchange_split"),
                       ("K34", "post_exchange_fused")):
        monkeypatch.setattr(step_sharded.cstep, attr, logged(
            name, getattr(step_sharded.cstep, attr), by_part))
    for name in ("pre_comm", "inter_comm", "post_comm"):
        monkeypatch.setattr(step_sharded.single, name, logged(
            name, getattr(step_sharded.single, name), by_part))
    out = sh.step(sh.init_state(fields))

    parts = range(sh.n_parts)
    L, n_local = mesh.n_layers, sh.pm.n_local
    start = ("start", [(2, L, n_local)] * sh.n_parts)
    want = {
        "split": [("K1/K2", p) for p in parts] + [start]
        + [("K3", p) for p in parts] + [("finish",)]
        + [("K4-fix", p) for p in parts],
        "fused": [("K1/K2", p) for p in parts] + [start, ("finish",)]
        + [("K34", p) for p in parts],
        "torch": [("pre_comm", p) for p in parts] + [start]
        + [("inter_comm", p) for p in parts] + [("finish",)]
        + [("post_comm", p) for p in parts],
    }[mode]
    assert log == want
    # the step's fct_plus and fct_minus are the exchanged pair's halves
    for p in parts:
        halo = _pair_halo(torch.stack([out["fct_plus"][p],
                                       out["fct_minus"][p]]), sh)
        if mode != "torch":
            assert not torch.equal(halo, before[p]), \
                f"part {p}: the exchange wrote no halo column"
    ref = FctAleSolver(mesh, sh.cfg, device="cpu")
    ref = ref.step(ref.init_state(fields))
    for k in ("fct_plus", "fct_minus", "del_ttf_advhoriz"):
        masked_allclose(sh.gather_node(out[k]), ref[k].numpy(), msg=k)


@pytest.mark.parametrize("iter_yn", [False, True])
@pytest.mark.parametrize("mode", ["torch", "split", "fused"])
def test_one_exchange_of_both_factors_a_step(small, mode, iter_yn):
    """One exchange of the [2, ...] factor pair a step (2 index ops a slab,
    half of a fill a factor), plus one of fct_LO when iterative; the
    outputs equal the single-device step's and the JAX XLA sharded step's
    (f64, 1e-12)."""
    mesh, jmesh, fields = small
    cfg = FctAleConfig(dt=0.7, iter_yn=iter_yn, dtype=torch.float64)
    log = []
    sh = _logged_solver(mesh, cfg, mode, log)
    out = sh.step(sh.init_state(fields))
    L, n_local = mesh.n_layers, sh.pm.n_local
    want = [("start", [(2, L, n_local)] * 4), ("finish",)]
    if iter_yn:
        want.append(("fill", [(L, n_local)] * 4))
    assert log == want
    slabs = len(step_sharded.exchange_pairs(sh.pm))
    assert sh.halo_fill.ops == 2 * slabs * (1 + iter_yn)

    single = FctAleSolver(mesh, cfg, device="cpu")
    ref = single.step(single.init_state(fields))
    jsh = JaxShardedFctAleSolver(
        jmesh, JaxFctAleConfig(dt=0.7, iter_yn=iter_yn, dtype=jnp.float64),
        devices=jax.devices()[:4])
    jout = jsh.step(jsh.init_state(fields))
    for k in _node_keys(iter_yn):
        got = sh.gather_node(out[k])
        masked_allclose(got, ref[k].numpy(), msg=f"single[{k}]")
        masked_allclose(got, jsh.gather_node(jout[k]), msg=f"jax[{k}]")
    got = sh.gather_state({"fct_adf_h": out["fct_adf_h"]})["fct_adf_h"]
    masked_allclose(got, ref["fct_adf_h"].numpy(), msg="single[fct_adf_h]")
    masked_allclose(got, part_mod.gather_edge_field(
        sh.pm, np.asarray(jout["fct_adf_h"])), msg="jax[fct_adf_h]")


@pytest.mark.parametrize("mode", ["split", "fused"])
def test_one_exchange_of_both_factors_at_any_tb(small, mode):
    """At Tb = 2 tracers the pair is [2, Tb, L, cols], in one exchange of
    as many index ops as at Tb = 1, and each tracer's outputs are the bits
    of a Tb = 1 step on it."""
    mesh, _, fields = small
    cfg = FctAleConfig(dt=0.7, dtype=torch.float64)
    per = [random_fields(mesh, seed=3 + t) for t in range(2)]
    batched = {k: per[0][k] if k in ("hnode", "hnode_new")
               else np.stack([f[k] for f in per]) for k in per[0]}
    for f in per:
        f.update(hnode=per[0]["hnode"], hnode_new=per[0]["hnode_new"])
    log = []
    sh = _logged_solver(mesh, cfg, mode, log, tracers=2)
    out = sh.step(sh.init_state(batched))
    L, n_local = mesh.n_layers, sh.pm.n_local
    assert log == [("start", [(2, 2, L, n_local)] * 4), ("finish",)]
    ops = sh.halo_fill.ops
    assert ops == 2 * len(step_sharded.exchange_pairs(sh.pm))
    one = _logged_solver(mesh, cfg, mode, [])
    for t in range(2):
        one.halo_fill.ops = 0
        ref = one.step(one.init_state(per[t]))
        assert one.halo_fill.ops == ops
        for k, v in ref.items():
            for p in range(4):
                got = out[k][p] if k in ("hnode", "hnode_new") \
                    else out[k][p][t]
                assert torch.equal(got, v[p]), f"{k} part {p} tracer {t}"
