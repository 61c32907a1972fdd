"""The FCT-ALE step as three CUDA kernels: K1 bounds -> K2 limit -> K34.

Counterpart of the single-device part of
``fesom2_accelerate_tpu/ops/pallas/step.py`` (``fct_ale_step_pallas_padded``
with its DIA K1, packed K2 and fused K34).  The kernels take natural
shapes ([L, N] node fields, [L+1, N] interface fields, [L, Ed] edge
fields), so there is no padding, packing or tiling step around them: the
Pallas planners (``plan.py``, ``packed.py``) are TPU layout machinery.
On CPU tensors each kernel wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

from fesom2_accelerate_tpu_torch.config import FctAleConfig
from fesom2_accelerate_tpu_torch.ops.cuda import kernels
from fesom2_accelerate_tpu_torch.ops.meshdata import MeshData


def fct_ale_step_cuda(md: MeshData, cfg: FctAleConfig, state: dict) -> dict:
    """Same contract as ``model.fct_ale.fct_ale_step``: the output dict has
    the same keys, for both ``iter_yn`` values."""
    ttf, fct_LO = state["ttf"], state["fct_LO"]
    tmax, tmin = kernels.bounds(md, fct_LO, ttf, cfg.vlimit)
    plus, minus, adf_v_lim, adf_v_res = kernels.limit(
        md, state["fct_adf_v"], tmax, tmin, state["fct_adf_h"], cfg.dt,
        cfg.flux_eps, cfg.iter_yn)
    o1, o2, adf_h_lim, adf_h_res = kernels.update_fused(
        md, plus, minus, adf_v_lim, state["fct_adf_h"], ttf, state["hnode"],
        state["hnode_new"], fct_LO, state["del_ttf_advvert"],
        state["del_ttf_advhoriz"], cfg.dt, cfg.iter_yn)

    out = dict(state)
    out.update(fct_ttf_max=tmax, fct_ttf_min=tmin, fct_plus=plus,
               fct_minus=minus)
    if cfg.iter_yn:
        out.update(
            fct_LO=o1,
            fct_adf_v=adf_v_res,
            fct_adf_h=adf_h_res,
            fct_adf_v_limited=adf_v_lim,
            fct_adf_h_limited=adf_h_lim,
        )
    else:
        out.update(
            fct_adf_v=adf_v_lim,
            fct_adf_h=adf_h_lim,
            del_ttf_advvert=o1,
            del_ttf_advhoriz=o2,
        )
    return out
