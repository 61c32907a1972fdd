"""A new configuration, traffic mix and per-layer metric are new files
only: dropped into a copy of the benchmark, they are found by the names
``BENCHMARK.json`` gives them, and no file already there changes."""

import hashlib
import json
import shutil

import pytest

from portbench import harness, run
from portbench.tests.toy import TOY_MESH


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_found_by_name(on_cpu, monkeypatch, tmp_path):
    root = harness.ROOT
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    shutil.copytree(root / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(tmp_path)
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "core2.json").read_text())
    (pb / "configs" / "toy.json").write_text(json.dumps(
        dict(cfg, name="toy", mesh=TOY_MESH)))
    (pb / "traffic" / "fct-resident.T1.json").write_text(json.dumps(
        {"driver": "fct_resident", "tracers": 1,
         "limits": {"first_step_relerr": 1e-4, "last_step_relerr": 1e-4}}))
    (pb / "metrics" / "toy.steps.py").write_text(
        '"""The traced window\'s steps."""\n\n\n'
        "def read(rec):\n    return float(rec.traces[0]['steps'])\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "a toy",
                             "file": "portbench/configs/toy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy.fct-resident.T1",
                               "config": "toy", "traffic":
                               "fct-resident.T1", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("step_ms", "device.idle_pct"):
            m["workloads"].append("toy.fct-resident.T1")
    bench["per_layer"].append({"name": "toy.steps", "unit": "steps",
                               "better": "higher", "source":
                               "program_counter", "layer": "device",
                               "moves": "step_ms",
                               "workloads": ["toy.fct-resident.T1"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = digests(tmp_path)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {
        p.relative_to(tmp_path) for p in (pb / "configs" / "toy.json",
                                          pb / "traffic"
                                          / "fct-resident.T1.json",
                                          pb / "metrics" / "toy.steps.py")}

    c = harness.cell("toy.fct-resident.T1", root=tmp_path)
    assert c.config["name"] == "toy" and c.traffic["tracers"] == 1
    assert [m["name"] for m in c.end_to_end] == ["step_ms", "setup_s"]
    assert [m["name"] for m in c.per_layer] == ["device.idle_pct",
                                                 "toy.steps"]
    monkeypatch.setattr(harness, "HERE", pb)
    line = run.run_rank(c, 5, 0.3, True, "cpu")
    assert line["correct"] is True
    assert line["metrics"]["toy.steps"]["value"] >= 1


def test_an_unknown_cell_names_the_known_ones():
    with pytest.raises(KeyError, match="core2.evp120"):
        harness.cell("no-such-cell")
