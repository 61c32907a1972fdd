"""A run with the timed path broken underneath comes out not correct: for
each fault a cell can have, on the CPU at toy size, the harness's look for
a card skipped and the rest of a run driven as on the card.  And the
control, the reference in bfloat16 in the program's place, fails each
cell's checks where the program passes them."""

import pytest
import torch

from fesom2_accelerate_tpu_torch import host_embed
from fesom2_accelerate_tpu_torch.model import FctAleSolver, Stress2RhsSolver
from fesom2_accelerate_tpu_torch.parallel.step_sharded import HaloFill

from portbench.drivers import evp, fct_abi
from portbench.tests.toy import run_toy

RESIDENT = "core2.fct-resident.T2"
# the sharded path of configs/core2-4rank.json, 4 parts in one process
SHARDED = (RESIDENT, {"parts_per_rank": 4})
SETUP_CALLS = 5  # the resident driver's first call and warm-up


def after_setup(fault):
    """Wraps a solver method so that ``fault`` replaces it from the
    window's first call on."""
    def wrap(real):
        calls = [0]

        def method(self, state, n):
            calls[0] += 1
            out = real(self, state, n)
            return fault(state, out) if calls[0] > SETUP_CALLS else out
        return method
    return wrap


def altered(out: dict) -> dict:
    """One answer altered where it is produced: the largest limited
    horizontal flux of the step, 1% off."""
    out = dict(out)
    x = out["fct_adf_h"].clone()
    x.view(-1)[x.abs().argmax()] *= 1.01
    out["fct_adf_h"] = x
    return out


def half_batch(state: dict, out: dict) -> dict:
    """The second tracer of the batch left out: its fields as they were."""
    out = dict(out)
    for k, v in out.items():
        if v.dim() == 3 and v.shape[0] == 2 and k in state:
            out[k] = torch.stack([v[0], state[k][1]])
    return out


def previous():
    """A step that returns the previous step's output (its own from the
    window's first call)."""
    held = {}

    def fault(state, out):
        before = held.get("out", out)
        held["out"] = out
        return before
    return fault


@pytest.mark.parametrize("fault", [
    lambda state, out: dict(state),  # a step that returns its state
    previous(),
    half_batch,
    lambda state, out: altered(out),
], ids=["unchanged", "previous", "half_batch", "altered"])
def test_resident_faults(on_cpu, monkeypatch, fault):
    monkeypatch.setattr(FctAleSolver, "run_tracers",
                        after_setup(fault)(FctAleSolver.run_tracers))
    line = run_toy(RESIDENT)
    assert line["correct"] is False
    assert line["checks"]["first_step_relerr"]["value"] < \
        line["checks"]["first_step_relerr"]["limit"]
    assert line["checks"]["last_step_relerr"]["value"] > \
        line["checks"]["last_step_relerr"]["limit"]


def test_sharded_without_the_exchange(on_cpu, monkeypatch):
    monkeypatch.setattr(HaloFill, "finish", lambda self, pending: pending[0])
    line = run_toy(SHARDED[0], **SHARDED[1])
    assert line["correct"] is False
    for chk in line["checks"].values():
        assert chk["value"] > chk["limit"]


def test_sharded_answer_altered(on_cpu, monkeypatch):
    from fesom2_accelerate_tpu_torch.parallel import step_sharded

    real = step_sharded.sharded_fct_ale_step_cuda

    def broken(*a, **k):
        outs = real(*a, **k)
        outs[1] = altered(outs[1])
        return outs

    monkeypatch.setattr(step_sharded, "sharded_fct_ale_step_cuda", broken)
    line = run_toy(SHARDED[0], **SHARDED[1])
    assert line["correct"] is False


@pytest.mark.parametrize("fault", ["unchanged", "fewer_substeps",
                                   "altered"])
def test_evp_faults(on_cpu, monkeypatch, fault):
    if fault in ("unchanged", "fewer_substeps"):
        real = evp.StepGraphs

        class Broken(real):
            calls = 0

            def run(self, step, state, n):
                Broken.calls += 1
                if Broken.calls <= evp.WARM_CALLS:
                    return super().run(step, state, n)
                if fault == "unchanged":
                    return state
                return super().run(step, state, n - 1)

        monkeypatch.setattr(evp, "StepGraphs", Broken)
    else:
        real = Stress2RhsSolver.call_packed

        def call_packed(self, *a):
            u, v = real(self, *a)
            u = u.clone()
            u[u.abs().argmax()] *= 1.01
            return u, v

        monkeypatch.setattr(Stress2RhsSolver, "call_packed", call_packed)
    line = run_toy("core2.evp120")
    assert line["correct"] is False


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_abi_faults(on_cpu, monkeypatch, fault):
    real = host_embed.copy_out
    if fault == "unchanged":
        monkeypatch.setattr(host_embed, "copy_out", lambda out, host: None)
    elif fault == "half_batch":
        def step(self):
            host_embed.step(*self.addrs[0])
            self.steps += 1

        monkeypatch.setattr(fct_abi.Abi, "step", step)
    else:
        monkeypatch.setattr(host_embed, "copy_out",
                            lambda out, host: real(altered(out), host))
    line = run_toy("core2.fct-abi.T2")
    assert line["correct"] is False


@pytest.mark.parametrize("name,config", [
    (RESIDENT, {}), ("core2.evp120", {}), ("core2.fct-abi.T2", {}), SHARDED])
def test_the_control_fails_where_the_program_passes(on_cpu, name, config):
    sound = run_toy(name, **config)
    control = run_toy(name, control=True, **config)
    assert sound["correct"] is True and control["correct"] is False
    for k, chk in control["checks"].items():
        assert chk["value"] > 10 * sound["checks"][k]["value"]
