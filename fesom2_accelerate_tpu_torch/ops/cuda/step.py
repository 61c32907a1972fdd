"""The FCT-ALE step as CUDA kernels, whole or in the phases of a sharded step.

Counterpart of ``fesom2_accelerate_tpu/ops/pallas/step.py``
(``fct_ale_step_pallas_padded`` and ``_assemble_step_out``).  The kernels
take natural shapes ([L, N] node fields, [L+1, N] interface fields, [L, Ed]
edge fields), so there is no padding, packing or tiling step around them:
the Pallas planners (``plan.py``, ``packed.py``) are TPU layout machinery.
On CPU tensors each kernel wrapper runs its plain PyTorch version.

A sharded step fills the halo columns of ``fct_plus``/``fct_minus`` between
K2 and the b3 horizontal limiting.  The phases around that exchange:

* :func:`pre_exchange`: K1 bounds, K2 limit (the limiter factors);
* :func:`limit_edges`: split mode's K3, every edge limited on the
  pre-exchange factors (edges with no halo endpoint are then final);
* :func:`post_exchange_fused`: K34, from the exchanged factors;
* :func:`post_exchange_split`: K3fix on the edges that touch a halo node,
  from the exchanged factors, then K4.

A step over P parts in one process enqueues every part's pre-exchange
phase before the one exchange, so the exchange is not called from inside a
part's step (``parallel/step_sharded.py``).  The iterative mode's
``fct_LO`` halo refresh after stage c is done there as well.
:func:`fct_ale_step_cuda` is the single-device step: K1 -> K2 -> K34.
"""

from __future__ import annotations

from fesom2_accelerate_tpu_torch.config import FctAleConfig
from fesom2_accelerate_tpu_torch.ops.cuda import kernels
from fesom2_accelerate_tpu_torch.ops.meshdata import MeshData


def pre_exchange(md: MeshData, cfg: FctAleConfig, state: dict) -> dict:
    """K1, K2 -> the bounds, the limiter factors and the limited vertical
    fluxes (``adf_v_res`` is None unless ``iter_yn``)."""
    tmax, tmin = kernels.bounds(md, state["fct_LO"], state["ttf"],
                                cfg.vlimit)
    plus, minus, adf_v_lim, adf_v_res = kernels.limit(
        md, state["fct_adf_v"], tmax, tmin, state["fct_adf_h"], cfg.dt,
        cfg.flux_eps, cfg.iter_yn)
    return dict(fct_ttf_max=tmax, fct_ttf_min=tmin, fct_plus=plus,
                fct_minus=minus, adf_v_lim=adf_v_lim, adf_v_res=adf_v_res)


def limit_edges(md: MeshData, cfg: FctAleConfig, state: dict,
                pre: dict) -> tuple:
    """K3 on the factors of ``pre`` -> (limited fct_adf_h, residual)."""
    return kernels.b3h(md, pre["fct_plus"], pre["fct_minus"],
                       state["fct_adf_h"], cfg.iter_yn)


def post_exchange_fused(md: MeshData, cfg: FctAleConfig, state: dict,
                        pre: dict) -> dict:
    """K34 on the factors of ``pre`` -> the step's output dict."""
    o1, o2, adf_h_lim, adf_h_res = kernels.update_fused(
        md, pre["fct_plus"], pre["fct_minus"], pre["adf_v_lim"],
        state["fct_adf_h"], state["ttf"], state["hnode"],
        state["hnode_new"], state["fct_LO"], state["del_ttf_advvert"],
        state["del_ttf_advhoriz"], cfg.dt, cfg.iter_yn)
    return _assemble(cfg, state, pre, o1, o2, adf_h_lim, adf_h_res)


def post_exchange_split(md: MeshData, cfg: FctAleConfig, state: dict,
                        pre: dict, edges: tuple, fix_ids) -> dict:
    """K3fix on the edges ``fix_ids`` with the (exchanged) factors of
    ``pre``, in place into ``edges`` (K3's output), then K4 -> the step's
    output dict."""
    adf_h_lim, adf_h_res = kernels.b3h_fixup(
        md, pre["fct_plus"], pre["fct_minus"], state["fct_adf_h"], *edges,
        fix_ids, cfg.iter_yn)
    o1, o2 = kernels.update(
        md, pre["adf_v_lim"], adf_h_lim, state["ttf"], state["hnode"],
        state["hnode_new"], state["fct_LO"], state["del_ttf_advvert"],
        state["del_ttf_advhoriz"], cfg.dt, cfg.iter_yn)
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


def fct_ale_step_cuda(md: MeshData, cfg: FctAleConfig, state: dict) -> dict:
    """Same contract as ``model.fct_ale.fct_ale_step``: the output dict has
    the same keys, for both ``iter_yn`` values."""
    return post_exchange_fused(md, cfg, state, pre_exchange(md, cfg, state))
