"""PyTorch port: the bench and its measurement tools on the CPU.

``utils/bench.py`` (the counterpart of ``bench.py``), the bench's timer
(``runtime/tracing.py:time_run``), the measured roof
(``profiling.measure_stream_bandwidth``), the steps' least traffic
(``profiling.step_io``) and the scaling harness (``utils/scaling.py``, the
counterpart of ``bench_scaling.py``).  Every device measurement must raise
ValueError on the CPU, with nothing measured there; ``step_io`` must be the
sum of ``kernel_io`` over each form's launches; the modeled bytes must equal
the JAX package's; the line formatter must give the JAX bench's keys; and
the scaling harness's exactness gate must pass on the CPU (torch backend)
and fail when a part's result is perturbed."""

import json

import numpy as np
import pytest
import torch

from fesom2_accelerate_tpu.mesh import generate_planar_mesh as jax_planar_mesh
from fesom2_accelerate_tpu.runtime import profiling as jax_profiling
from fesom2_accelerate_tpu_torch import FctAleConfig, ShardedFctAleSolver
from fesom2_accelerate_tpu_torch.mesh import generate_planar_mesh
from fesom2_accelerate_tpu_torch.ops.meshdata import build_mesh_data
from fesom2_accelerate_tpu_torch.parallel import step_sharded
from fesom2_accelerate_tpu_torch.runtime import profiling, tracing
from fesom2_accelerate_tpu_torch.utils import accuracy, bench, scaling

# the JAX bench's line (bench.py) and the cells of the port's bench
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
METRICS = (
    "fct_ale_step_core2_f32_cuda",
    "fct_ale_step_core2_f32_cuda_iter",
    "fct_ale_step_cyl512_f32_cuda",
    "fct_ale_sharded_core2_f32_cuda_p4_split",
    "fct_ale_sharded_core2_f32_cuda_p4_fused",
    "fct_ale_step_core2_f32_cuda_T8",
    "fct_ale_sharded_core2_f32_cuda_p4_split_T8",
    "stress2rhs_core2_f32_cuda",
    "stress2rhs_cyl512_f32_cuda",
)


@pytest.fixture(scope="module")
def small():
    return generate_planar_mesh(preset="small")


def test_stream_bandwidth_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA device"):
        profiling.measure_stream_bandwidth(2 ** 20, 2, 1, device="cpu")


def test_time_run_refuses_the_cpu():
    calls = []
    with pytest.raises(ValueError, match="CUDA device"):
        tracing.time_run(lambda s, n: calls.append(n), {}, 20, device="cpu")
    assert calls == [], "time_run ran the run on the CPU"


@pytest.mark.parametrize("name", METRICS)
def test_bench_cells_refuse_the_cpu(name, monkeypatch):
    """Each cell raises before it builds anything when given the CPU."""
    built = []
    monkeypatch.setattr(bench, "setup", lambda *a: built.append(a))
    inputs = bench.Inputs()
    with pytest.raises(ValueError, match="CUDA device"):
        bench.run_cell(name, inputs, 20, 3e12, "card", device="cpu")
    assert built == [] and inputs.meshes == {}


def test_bench_setup_refuses_the_cpu():
    inputs = bench.Inputs()
    with pytest.raises(ValueError, match="CUDA device"):
        bench.setup(bench.CELLS[METRICS[0]], inputs, "cpu")
    assert inputs.meshes == {}, "setup built a mesh before refusing"


def test_bench_command_without_a_card(capsys, tmp_path):
    """No CUDA device: the command exits non-zero with a message, and
    writes and measures nothing."""
    out = tmp_path / "bench.json"
    assert bench.main(["--cell", "all", "--out", str(out)]) != 0
    assert "nothing measured" in capsys.readouterr().err
    assert not out.exists()


def test_accuracy_on_cuda_refuses_without_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        accuracy.main(["--device", "cuda", "--steps", "1"])


def test_bench_cells_are_the_table():
    assert tuple(bench.CELLS) == METRICS
    assert {c.tracers for c in bench.CELLS.values()} == {1, 8}


def _timing(step_ms=0.44, runs=(0.44, 0.45, 0.46)):
    return {"steps": 20, "step_ms": step_ms, "step_ms_runs": list(runs),
            "device_ms": 0.43, "host_ms": 0.47,
            "choice": {"run": "loop", "dry_steps": 1, "watched_steps": 6},
            "copy_in_ms": None}


@pytest.mark.parametrize("name", METRICS)
def test_bench_line_has_the_jax_keys(name):
    """The formatter gives bench.py's keys, the metric name, its unit, and
    values from the given timings: a tracer's share of the step at Tb = 8
    (bench.py --tracers divides), the modeled bytes against 3.35 TB/s,
    step_io against the measured roof."""
    cell = bench.CELLS[name]
    work, model, io, roof = 4_441_608, 800_000_000, 700_000_000, 3.0e12
    line = bench.bench_line(name, _timing(), work=work, model_bytes=model,
                            io_bytes=io, roof=roof, card="H100, 700 W",
                            tracers=cell.tracers)
    assert set(line) == JAX_KEYS
    assert line["metric"] == name
    json.dumps(line)
    s2r = cell.path == "stress2rhs"
    assert line["unit"] == ("nodes/s/chip" if s2r else "grid-points/s/chip")
    tracer_s = 0.44e-3 / cell.tracers
    assert line["value"] == pytest.approx(work / tracer_s)
    assert line["vs_baseline"] == pytest.approx(model / tracer_s / 3.35e12)
    d = line["detail"]
    assert d["step_ms"] == 0.44 and d["step_ms_runs"] == [0.44, 0.45, 0.46]
    assert d[("nodes" if s2r else "grid_points")] == work
    assert d["frac_measured_roof"] == pytest.approx(io / 0.44e-3 / roof)
    assert d["frac_datasheet"] == pytest.approx(io / 0.44e-3 / 3.35e12)
    assert d["measured_roof_GBps"] == pytest.approx(3000.0)
    for key in ("device_ms", "host_ms", "choice", "copy_in_ms", "card",
                "modeled_GB", "step_io_GB"):
        assert key in d
    assert ("tracers" in d) == (cell.tracers > 1)


def test_roof_check():
    bench.check_roof(3.35e12 * 1.05)
    with pytest.raises(AssertionError, match="measured roof"):
        bench.check_roof(3.35e12 * 1.06)


@pytest.mark.parametrize("tracers", [1, 8])
@pytest.mark.parametrize("iter_yn", [False, True])
@pytest.mark.parametrize("form", sorted(profiling.STEP_FORMS))
def test_step_io_sums_the_forms_kernels(small, form, tracers, iter_yn):
    """step_io is kernel_io summed over the kernels each form launches, on
    small, at Tb = 1 and 8 (K12 has no tracer axis and refuses 8)."""
    md = build_mesh_data(small, torch.float32, "cpu")
    cfg = FctAleConfig(iter_yn=iter_yn)
    want = {
        "K1->K2->K34": ("bounds", "limit", "update_fused"),
        "K12->K34": ("limit_fused", "update_fused"),
        "K1->K2->K3->K4": ("bounds", "limit", "b3h", "update"),
        "K12->K3->K4": ("limit_fused", "b3h", "update"),
        "K1->K2->K3->K4fix": ("bounds", "limit", "b3h", "update_fixup"),
    }[form]
    owned = (0, small.n_nodes)  # the whole mesh is one part's owned columns
    if tracers > 1 and "limit_fused" in want:
        with pytest.raises(ValueError, match="tracers"):
            profiling.step_io(md, cfg, form, tracers=tracers, owned=owned)
        return
    parts = [profiling.kernel_io(md, k, iter_yn, owned=owned,
                                 tracers=tracers) for k in want]
    got = profiling.step_io(md, cfg, form, tracers=tracers, owned=owned)
    assert got == (sum(b for b, _ in parts), sum(o for _, o in parts))
    assert got[0] > 0


@pytest.mark.parametrize("tracers", [1, 8])
def test_step_io_of_a_split_step_sums_its_parts(small, tracers):
    """A 4-part split step: step_io of each part with the owned columns,
    each the sum of K1, K2, K3 and K4-fix; K4-fix's bytes depend on the
    part's halo edges, so a part's sum differs from the whole mesh's."""
    cfg = FctAleConfig(dt=0.5, flux_eps=1e-7)
    sh = ShardedFctAleSolver(small, cfg, backend="torch",
                             devices=["cpu"] * 4)
    owned = (sh.pm.H, sh.pm.H + sh.pm.B)
    total = 0
    for md in sh.mds:
        want = sum(profiling.kernel_io(md, k, False, owned=owned,
                                       tracers=tracers)[0]
                   for k in ("bounds", "limit", "b3h", "update_fixup"))
        got = profiling.step_io(md, cfg, "K1->K2->K3->K4fix",
                                tracers=tracers, owned=owned)[0]
        assert got == want
        total += got
    whole = profiling.step_io(build_mesh_data(small, torch.float32, "cpu"),
                              cfg, "K1->K2->K3->K4", tracers=tracers)[0]
    assert total > whole  # halo columns are read on two parts
    with pytest.raises(ValueError, match="owned"):
        profiling.step_io(sh.mds[0], cfg, "K1->K2->K3->K4fix")
    with pytest.raises(ValueError, match="form"):
        profiling.step_io(sh.mds[0], cfg, "K1->K34")


@pytest.mark.parametrize("preset", ["small", "pi"])
def test_modeled_step_bytes_equal_the_jax_model(preset):
    ours, ref = generate_planar_mesh(preset=preset), jax_planar_mesh(
        preset=preset)
    for itemsize in (4, 8):
        for iter_yn in (False, True):
            assert profiling.fct_ale_step_bytes(ours, itemsize, iter_yn) == \
                jax_profiling.fct_ale_step_bytes(ref, itemsize, iter_yn)
    assert profiling.grid_points(ours) == jax_profiling.grid_points(ref)
    assert profiling.stress2rhs_bytes(ours) == \
        jax_profiling.stress2rhs_bytes(ref)


def _rows(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()]


def test_scaling_gate_passes_on_the_cpu(capsys):
    """--device cpu --backend torch --preset tiny at P = 1, 2, 4: exact
    against FctAleSolver, rows marked "cpu" with no times."""
    assert scaling.main(["--device", "cpu", "--backend", "torch",
                         "--preset", "tiny", "--parts", "1,2,4"]) == 0
    *rows, summary = _rows(capsys)
    assert [r["parts"] for r in rows] == [1, 2, 4]
    for r in rows:
        assert r["device"] == "cpu" and r["exact_vs_single"]
        assert r["relerr_vs_single"] < scaling.CHECK_RTOL
        assert "step_ms" not in r and "value" not in r
    assert summary["all_exact"] and summary["failures"] == []


def test_scaling_gate_fails_on_a_perturbed_part(capsys, monkeypatch):
    """A part whose fct_LO is off by 1e-3 makes the gate fail and the
    command return 1."""
    run = step_sharded.ShardedFctAleSolver.run

    def perturbed(self, state, n_steps):
        out = run(self, state, n_steps)
        if self.n_parts > 1:
            out["fct_LO"][1] = out["fct_LO"][1] + 1e-3
        return out

    monkeypatch.setattr(step_sharded.ShardedFctAleSolver, "run", perturbed)
    assert scaling.main(["--device", "cpu", "--backend", "torch",
                         "--preset", "tiny", "--parts", "1,2,4"]) == 1
    *rows, summary = _rows(capsys)
    assert [r["exact_vs_single"] for r in rows] == [True, False, False]
    assert len(summary["failures"]) == 2 and not summary["all_exact"]


def test_scaling_on_cuda_refuses_without_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        scaling.scaling(generate_planar_mesh(preset="toy"), "toy",
                        device="cuda")


def test_relerr_matches_the_jax_gate():
    a, b = np.array([1.0, 2.0, 5.0]), np.array([1.0, 2.5, 4.0])
    assert scaling.relerr(a, b) == pytest.approx(1.0 / 4.0)
    assert accuracy.relerr(a * 0.1, b * 0.1) == pytest.approx(0.1)
