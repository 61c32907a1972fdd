"""PyTorch port: the tuning harness (``utils/tuning.py``, ``utils/tune.py``),
the timing helpers (``runtime/tracing.py``), the byte models and kernel
bounds (``runtime/profiling.py``), and the element row H-A2 reads
(``MeshData.nlev_elem``).

The harness times only on a CUDA card, so here every ``tune_*``, every
timer and the command line must raise on the CPU, while the validating
half of each sweep (``check_*``) runs on CPU tensors, where each kernel
wrapper runs its plain version, and must find every configuration within
the JAX harness's tolerances (2e-5 per kernel, 1e-4 per step, 1e-5 for a2
and stress2rhs) against the float64 gate.  The copied byte models must
equal the JAX harness's exactly."""

import numpy as np
import pytest
import torch

from fesom2_accelerate_tpu.mesh import generate_planar_mesh as jax_planar_mesh
from fesom2_accelerate_tpu.utils import tuning as jax_tuning
from fesom2_accelerate_tpu_torch.mesh import generate_planar_mesh, random_fields
from fesom2_accelerate_tpu_torch.ops.cuda import kernels
from fesom2_accelerate_tpu_torch.ops.meshdata import build_mesh_data
from fesom2_accelerate_tpu_torch.parallel import partition_mesh
from fesom2_accelerate_tpu_torch.runtime import profiling, tracing
from fesom2_accelerate_tpu_torch.utils import tune, tuning


@pytest.fixture(scope="module")
def small():
    return generate_planar_mesh(preset="small")


@pytest.fixture(scope="module")
def fct_case(small):
    return tuning.fct_case(small, "cpu")


@pytest.mark.parametrize("preset", ["small", "core2"])
def test_byte_models_match_jax_tuning(preset):
    """kernel_bytes and a2_bytes equal the JAX harness's _kernel_bytes and
    tune_a2's formula (utils/tuning.py:308-309) on the same mesh, and the
    fused families are built from the same terms."""
    ours, ref = generate_planar_mesh(preset=preset), jax_planar_mesh(
        preset=preset)
    nod = int(np.sum(ref.nlev_nod - 1))
    edge = int(np.sum(ref.nlev_edge))
    for itemsize in (4, 8):
        got = profiling.kernel_bytes(ours, itemsize)
        want = jax_tuning._kernel_bytes(ref, itemsize)
        assert {k: got[k] for k in want} == want
        assert got["limit_fused"] == (want["bounds"] + want["limit"]
                                      - 2 * nod * itemsize)
        assert got["update_fused"] == want["update"] + 5 * edge * itemsize
    elem_active = int(np.sum(ref.nlev_elem - 1))
    assert profiling.a2_bytes(ours) == \
        (6 * elem_active + 2 * ref.n_layers * ref.n_elems) * 4


def _reach(n_nodes, ends, depth):
    """Node-levels a gather over ``ends`` reaches, up to ``depth`` each."""
    top = np.zeros(n_nodes, np.int64)
    np.maximum.at(top, np.ravel(ends), np.ravel(depth))
    return int(top.sum())


def test_kernel_io_counts_what_the_function_needs(small):
    """kernel_io counts each output once at its full size and each input
    once where the kernel's function needs it: H-K1 reads fct_LO and ttf
    on the active node-levels and the live slots of two incidence rows;
    H-A2 reads the bounds on the node-levels its active element-levels
    reach; H-K3fix reads only its (unique) edges; H-S2R reads the element
    rows of iced elements and rhs where the node has mass.  Counted here
    from the numpy mesh; the bound of every kernel is set by its bytes."""
    L, N, E = small.n_layers, small.n_nodes, small.n_elems
    nod = int(np.clip(small.nlev_nod - 1, 0, L).sum())
    assert nod < L * N, "the mesh has inactive node-levels"
    live = int(small.node_edges_num.sum())
    elem_reach = _reach(N, small.elem_nodes, np.repeat(
        np.clip(small.nlev_elem - 1, 0, None)[:, None], 3, axis=1))
    ids = torch.tensor([5, 0, 3, 3, 9, 1, 2, 8])
    u = np.unique(ids.numpy())
    fix_reach = _reach(N, small.edges[u], np.repeat(
        small.nlev_edge[u][:, None], 2, axis=1))
    for dtype in (torch.float32, torch.float64):
        md = build_mesh_data(small, dtype, "cpu")
        f = 4 if dtype == torch.float32 else 8
        nbytes, _ = profiling.kernel_io(md, "bounds")
        assert nbytes == 2 * nod * f + 2 * live * 4 + 2 * N * 4 + 2 * L * N * f
        nbytes, _ = profiling.kernel_io(md, "a2")
        assert nbytes == 2 * elem_reach * f + E * 16 + 2 * L * E * f
        fused = profiling.kernel_io(md, "limit_fused")[0]
        split = (profiling.kernel_io(md, "bounds")[0]
                 + profiling.kernel_io(md, "limit")[0])
        # K12 saves the bounds' re-read and the second copy of the rows
        assert fused == split - 2 * nod * f - 2 * N * 4 - live * 4
        nbytes, _ = profiling.kernel_io(md, "b3h_fixup", ids=ids)
        assert nbytes == (4 * len(ids) + 12 * len(u) + 2 * fix_reach * f
                          + 2 * L * len(u) * f)
        slab = torch.ones(kernels.SLAB_ROWS, E, dtype=dtype)
        slab[3, ::2] = 0.0  # the ea row: every other element ice-free
        iam = torch.ones(N, dtype=dtype)
        iam[::3] = 0.0
        nbytes, _ = profiling.kernel_io(md, "stress2rhs", slab=slab,
                                        inv_areamass=iam)
        iced, massed = E // 2, N - len(range(0, N, 3))
        assert nbytes == (E * f + 10 * iced * f
                          + 4 * int(small.node_elems_num.sum()) + 3 * N * f
                          + 2 * massed * f)
        s2r = dict(slab=slab, inv_areamass=iam)
        for name in ("bounds", "limit", "limit_fused", "update_fused",
                     "b3h", "update", "a2", "stress2rhs", "b3h_fixup"):
            for iter_yn in (False, True):
                nbytes, ops = profiling.kernel_io(md, name, iter_yn, ids=ids,
                                                  **s2r)
                ms, by = profiling.bound_ms(nbytes, ops, dtype)
                assert by == "bytes" and ms == nbytes / 3.35e12 * 1e3, name
    assert profiling.bound_ms(1, 10 ** 12)[1] == "operations"
    for name in ("no_such_kernel", "b3h_fixup", "stress2rhs"):
        with pytest.raises(ValueError):
            profiling.kernel_io(md, name)


def test_check_kernels_finds_every_configuration_ok(fct_case):
    for config in tuning.default_configs():
        errs, calls = tuning.check_kernels(fct_case, config["threads"])
        assert set(errs) == set(calls) == set(tuning.FAMILIES)
        for fam, err in errs.items():
            assert err < 2e-5, (config, fam, err)
        # the timed calls are the validated kernels on the same inputs
        assert torch.equal(calls["bounds"]()[0],
                           kernels.bounds_ref(fct_case.md,
                                              fct_case.state["fct_LO"],
                                              fct_case.state["ttf"], 1)[0])


@pytest.mark.parametrize("form", tuning.FORMS)
def test_check_step_finds_every_configuration_ok(fct_case, form):
    for threads in kernels.THREADS:
        assert tuning.check_step(fct_case, *form, threads) < 1e-4


def test_check_a2_and_stress2rhs_find_every_configuration_ok(small):
    a2 = tuning.a2_case(small, "cpu")
    s2r = tuning.s2r_case(small, "cpu")
    for threads in kernels.THREADS:
        assert tuning.check_a2(a2, threads) < 1e-5
        assert tuning.check_stress2rhs(s2r, threads) < 1e-5


@pytest.mark.parametrize("fn", [tuning.tune_kernels, tuning.tune_a2,
                                tuning.tune_step, tuning.tune_stress2rhs,
                                tuning.perf_kernels])
def test_tune_raises_on_cpu(small, fn):
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA device"):
        fn(small, device="cpu")
    assert sum(kernels.launch_counts().values()) == 0


def test_timers_raise_on_cpu(small, tmp_path):
    calls = []
    for timer in (tracing.device_time_ms, tracing.cuda_time_ms):
        with pytest.raises(ValueError, match="CUDA device"):
            timer(lambda: calls.append(1), 3, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        tracing.sleep_cycles_per_ms("cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        tracing.time_stages(small, random_fields(small, seed=0),
                            device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        with tracing.trace(tmp_path, device="cpu"):
            calls.append(1)
    assert calls == [], "nothing runs before the device is refused"


def test_tune_command_line_raises_on_cpu(tmp_path):
    with pytest.raises(ValueError, match="CUDA device"):
        tune.main(["--preset", "toy", "--families", "a2", "--device", "cpu",
                   "--outdir", str(tmp_path)])
    with pytest.raises(SystemExit):
        tune.main(["--families", "nonesuch", "--outdir", str(tmp_path)])
    assert list(tmp_path.iterdir()) == []


def test_tune_result_store_and_best(tmp_path):
    rs = [tuning.TuneResult({"threads": t}, ms, 1.0, 0.0, ok, "card, 1 W")
          for t, ms, ok in ((64, 0.3, True), (128, 0.1, False),
                            (256, 0.2, True))]
    assert tuning.best(rs).params == {"threads": 256}
    assert tuning.best(rs[1:2]) is None
    tuning.store(rs, tmp_path / "r.json")
    import json

    stored = json.loads((tmp_path / "r.json").read_text())
    assert [r["card"] for r in stored] == ["card, 1 W"] * 3
    assert tuning.default_configs() == [dict(threads=t)
                                        for t in (64, 128, 256, 512)]


@pytest.mark.parametrize("n_parts", [1, 4])
def test_mesh_data_nlev_elem(small, n_parts):
    """MeshData.nlev_elem (H-A2's mask row) is the mesh's nlev_elem, on the
    whole mesh and on each part, and its mask is stages.a2's elem_mask."""
    meshes = ([small] if n_parts == 1
              else partition_mesh(small, n_parts).local_meshes)
    for m in meshes:
        md = build_mesh_data(m, torch.float32, "cpu")
        assert md.nlev_elem.dtype == torch.int32
        assert torch.equal(md.nlev_elem, torch.from_numpy(
            np.asarray(m.nlev_elem, np.int32)))
        z = torch.arange(md.n_layers)[:, None]
        assert torch.equal(md.elem_mask, z < md.nlev_elem[None, :] - 1)
