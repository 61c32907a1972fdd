"""What the command and the reference load, each in a fresh interpreter,
by top-level module names compared whole (the program's name begins with
the JAX package's)."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

from portbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
JAX = {"jax", "jaxlib", "flax", "fesom2_accelerate_tpu"}
PORT = "fesom2_accelerate_tpu_torch"


def loaded(code: str, cwd=ROOT) -> set:
    """The top-level names in ``sys.modules`` after ``code`` runs in a
    fresh interpreter."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=cwd, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=str(cwd)))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_command_loads_no_jax():
    names = loaded(
        "import pathlib, portbench.run as r\n"
        "from portbench import harness\n"
        "import portbench.drivers.fct_resident, portbench.drivers.fct_abi\n"
        "import portbench.drivers.evp\n"
        "for p in (harness.HERE / 'metrics').glob('*.py'):\n"
        "    harness.load_module(p)\n")
    assert PORT in names
    assert not names & JAX


def test_the_reference_loads_nothing_of_the_program():
    names = loaded(
        "import portbench.reference.fct, portbench.reference.mesh\n"
        "import portbench.reference.stress2rhs, portbench.reference.compare\n"
        "import portbench.inputs, portbench.contract\n")
    assert not names & (JAX | {PORT})


def test_banned_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like_name", sys)
    assert "jax" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "jax", sys)
    monkeypatch.setitem(sys.modules, "fesom2_accelerate_tpu.mesh", sys)
    assert {"jax", "fesom2_accelerate_tpu"} <= set(harness.banned_modules())
    assert PORT not in harness.banned_modules()


def command(cwd, *extra):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "core2.fct-resident.T2", "--seed", "3", "--seconds", "1", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(cwd), CUDA_VISIBLE_DEVICES=""))


def test_no_card_no_result():
    out = command(ROOT)
    assert out.returncode == 2
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert "nothing measured" in out.stderr


def test_fails_where_only_the_benchmark_is(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = command(tmp_path)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
