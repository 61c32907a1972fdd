"""The FCT-ALE step as CUDA kernels, whole or in the phases of a sharded step.

Counterpart of ``fesom2_accelerate_tpu/ops/pallas/step.py``
(``fct_ale_step_pallas_padded`` and ``_assemble_step_out``).  The kernels
take natural shapes ([L, N] node fields, [L+1, N] interface fields, [L, Ed]
edge fields), so there is no padding, packing or tiling step around them:
the Pallas planners (``plan.py``, ``packed.py``) are TPU layout machinery.
On CPU tensors each kernel wrapper runs its plain PyTorch version.

A sharded step fills the halo columns of ``fct_plus``/``fct_minus`` between
K2 and the b3 horizontal limiting, both in one exchange of the pair
(``kernels.factor_pair``, the JAX sharded step's ``jnp.stack([plus,
minus])``).  The
phases around that exchange:

* :func:`pre_exchange`: K1 bounds, K2 limit (the limiter factors), or
  K12 (both in one kernel);
* :func:`limit_edges`: split mode's K3, every edge limited on the
  pre-exchange factors (edges with no halo endpoint are then final); it
  reads no halo column's exchanged value, so the exchange is in flight
  while it runs;
* :func:`post_exchange_fused`: K34, from the exchanged factors;
* :func:`post_exchange_split`: K4-fix, one launch (``kernels.update_fixup``,
  K4 in its FIX form): the edges that touch a halo node limited again from
  the exchanged factors, in place into K3's outputs, and stage c.  K3fix
  then K4 (``kernels.b3h_fixup``, ``kernels.update``) computes the same
  bits in two launches; the step no longer runs them.

A step over P parts in one process enqueues every part's pre-exchange
phase, starts the one exchange, enqueues every part's K3 (split mode),
then finishes the exchange, so the exchange is not called from inside a
part's step (``parallel/step_sharded.py``).  The iterative mode's
``fct_LO`` halo refresh after stage c is done there as well.  One part
whose exchange its host makes (a FESOM2 rank through ``host_embed``'s
``pre_comm`` / ``post_comm``) runs :func:`pre_exchange`,
:func:`limit_edges` and :func:`post_exchange_split` as
``FctAleSolver.pre_comm`` / ``inter_comm`` / ``post_comm``.
:func:`fct_ale_step_cuda` is the single-device step, in one of the four
forms the JAX package selects with ``build_pallas_data(fuse_k12=,
fuse_k34=)``: K1 -> K2 or K12, then K34 or K3 -> K4.  On one device there
is no halo, so K3 needs no fixup.  The default is K1 -> K2 -> K34.
Every phase takes ``threads``, the kernels' block size.

Every phase also takes a batched state, the layout of the JAX package's
``fct_ale_step_pallas_batched``: each per-tracer field with a leading
tracer axis ([Tb, L, N], [Tb, L+1, N], [Tb, L, Ed]) and ``hnode``,
``hnode_new`` (``BATCH_SHARED``) shared [L, N].  The kernels take the
tracer axis in one launch each, so a batched step launches what a
single-tracer step does, whatever Tb is; :func:`fct_ale_step_cuda_batched`
is that step.  K12 has no tracer axis, so it takes one tracer only.
"""

from __future__ import annotations

from fesom2_accelerate_tpu_torch.config import FctAleConfig
from fesom2_accelerate_tpu_torch.ops.cuda import kernels
from fesom2_accelerate_tpu_torch.ops.cuda.kernels import DEFAULT_THREADS
from fesom2_accelerate_tpu_torch.ops.meshdata import MeshData

# the fields of a batched state that every tracer shares ([L, N], no axis)
BATCH_SHARED = frozenset({"hnode", "hnode_new"})


def pre_exchange(md: MeshData, cfg: FctAleConfig, state: dict, *,
                 fuse_k12: bool = False,
                 threads: int = DEFAULT_THREADS) -> dict:
    """K1, K2 (or K12 when ``fuse_k12``) -> the bounds, the limiter factors
    and the limited vertical fluxes (``adf_v_res`` is None unless
    ``iter_yn``).  ``fct_plus`` and ``fct_minus`` are the two halves of
    one [2, ...] allocation (the kernels' own on the card; stacked once
    from the plain versions' on the CPU), so that
    ``kernels.factor_pair(pre["fct_plus"], pre["fct_minus"])`` is both as
    one tensor without a copy, and one halo fill of it exchanges both."""
    if fuse_k12:
        tmax, tmin, plus, minus, adf_v_lim, adf_v_res = kernels.limit_fused(
            md, state["fct_LO"], state["ttf"], state["fct_adf_v"],
            state["fct_adf_h"], cfg.vlimit, cfg.dt, cfg.flux_eps,
            cfg.iter_yn, threads=threads)
    else:
        tmax, tmin = kernels.bounds(md, state["fct_LO"], state["ttf"],
                                    cfg.vlimit, threads=threads)
        plus, minus, adf_v_lim, adf_v_res = kernels.limit(
            md, state["fct_adf_v"], tmax, tmin, state["fct_adf_h"], cfg.dt,
            cfg.flux_eps, cfg.iter_yn, threads=threads)
    plus, minus = kernels.factor_pair(plus, minus)
    return dict(fct_ttf_max=tmax, fct_ttf_min=tmin, fct_plus=plus,
                fct_minus=minus, adf_v_lim=adf_v_lim, adf_v_res=adf_v_res)


def limit_edges(md: MeshData, cfg: FctAleConfig, state: dict, pre: dict,
                *, threads: int = DEFAULT_THREADS) -> tuple:
    """K3 on the factors of ``pre`` -> (limited fct_adf_h, residual)."""
    return kernels.b3h(md, pre["fct_plus"], pre["fct_minus"],
                       state["fct_adf_h"], cfg.iter_yn, threads=threads)


def post_exchange_fused(md: MeshData, cfg: FctAleConfig, state: dict,
                        pre: dict, *,
                        threads: int = DEFAULT_THREADS) -> dict:
    """K34 on the factors of ``pre`` -> the step's output dict."""
    o1, o2, adf_h_lim, adf_h_res = kernels.update_fused(
        md, pre["fct_plus"], pre["fct_minus"], pre["adf_v_lim"],
        state["fct_adf_h"], state["ttf"], state["hnode"],
        state["hnode_new"], state["fct_LO"], state["del_ttf_advvert"],
        state["del_ttf_advhoriz"], cfg.dt, cfg.iter_yn, threads=threads)
    return _assemble(cfg, state, pre, o1, o2, adf_h_lim, adf_h_res)


def post_exchange_split(md: MeshData, cfg: FctAleConfig, state: dict,
                        pre: dict, edges: tuple, owned: tuple, *,
                        threads: int = DEFAULT_THREADS) -> dict:
    """K4-fix -> the step's output dict: the edges of the part with an
    endpoint outside its owned columns ``owned = (lo, hi)`` limited again
    with the (exchanged) factors of ``pre``, in place into ``edges`` (K3's
    output), and stage c, in one launch."""
    o1, o2, adf_h_lim, adf_h_res = kernels.update_fixup(
        md, pre["fct_plus"], pre["fct_minus"], state["fct_adf_h"], *edges,
        owned, pre["adf_v_lim"], state["ttf"], state["hnode"],
        state["hnode_new"], state["fct_LO"], state["del_ttf_advvert"],
        state["del_ttf_advhoriz"], cfg.dt, cfg.iter_yn, threads=threads)
    return _assemble(cfg, state, pre, o1, o2, adf_h_lim, adf_h_res)


def _update(md: MeshData, cfg: FctAleConfig, state: dict, pre: dict,
            edges: tuple, threads: int) -> dict:
    """K4 on the limited fluxes of ``pre`` and ``edges`` -> the step's
    output dict."""
    adf_h_lim, adf_h_res = edges
    o1, o2 = kernels.update(
        md, pre["adf_v_lim"], adf_h_lim, state["ttf"], state["hnode"],
        state["hnode_new"], state["fct_LO"], state["del_ttf_advvert"],
        state["del_ttf_advhoriz"], cfg.dt, cfg.iter_yn, threads=threads)
    return _assemble(cfg, state, pre, o1, o2, adf_h_lim, adf_h_res)


def _assemble(cfg: FctAleConfig, state: dict, pre: dict, o1, o2, adf_h_lim,
              adf_h_res) -> dict:
    """The output dict of every form of the step: the keys of
    ``model.fct_ale.fct_ale_step`` for both ``iter_yn`` values."""
    out = dict(state)
    out.update(fct_ttf_max=pre["fct_ttf_max"], fct_ttf_min=pre["fct_ttf_min"],
               fct_plus=pre["fct_plus"], fct_minus=pre["fct_minus"])
    if cfg.iter_yn:
        out.update(
            fct_LO=o1,
            fct_adf_v=pre["adf_v_res"],
            fct_adf_h=adf_h_res,
            fct_adf_v_limited=pre["adf_v_lim"],
            fct_adf_h_limited=adf_h_lim,
        )
    else:
        out.update(
            fct_adf_v=pre["adf_v_lim"],
            fct_adf_h=adf_h_lim,
            del_ttf_advvert=o1,
            del_ttf_advhoriz=o2,
        )
    return out


def fct_ale_step_cuda(md: MeshData, cfg: FctAleConfig, state: dict, *,
                      fuse_k12: bool = False, fuse_k34: bool = True,
                      threads: int = DEFAULT_THREADS) -> dict:
    """Same contract as ``model.fct_ale.fct_ale_step``: the output dict has
    the same keys, for both ``iter_yn`` values.  Launches per step: K12 ->
    K34 2, K1 -> K2 -> K34 and K12 -> K3 -> K4 3, K1 -> K2 -> K3 -> K4 4."""
    pre = pre_exchange(md, cfg, state, fuse_k12=fuse_k12, threads=threads)
    if fuse_k34:
        return post_exchange_fused(md, cfg, state, pre, threads=threads)
    edges = limit_edges(md, cfg, state, pre, threads=threads)
    return _update(md, cfg, state, pre, edges, threads)


def fct_ale_step_cuda_batched(md: MeshData, cfg: FctAleConfig, state: dict,
                              *, fuse_k12: bool = False,
                              fuse_k34: bool = True,
                              threads: int = DEFAULT_THREADS) -> dict:
    """The multi-tracer step, counterpart of the JAX package's
    ``fct_ale_step_pallas_batched``: ``state`` holds each per-tracer field
    [Tb, ...] and ``hnode``/``hnode_new`` shared [L, N]; the output has the
    keys of :func:`fct_ale_step_cuda`, each per-tracer one [Tb, ...].  Tb
    independent single-tracer steps, in the launches of one (K1 -> K2 ->
    K34, or K3 -> K4 when not ``fuse_k34``).  ``fuse_k12`` raises: the
    batched step runs K1 -> K2, as the JAX package's does."""
    if fuse_k12:
        raise ValueError("fuse_k12: H-K12 has no tracer axis; a batched "
                         "step runs K1 -> K2")
    if state["ttf"].dim() != 3:
        raise ValueError(f"a batched state holds ttf as [Tb, L, N], got "
                         f"shape {tuple(state['ttf'].shape)}")
    return fct_ale_step_cuda(md, cfg, state, fuse_k34=fuse_k34,
                             threads=threads)
