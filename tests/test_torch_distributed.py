"""PyTorch port: the sharded FCT-ALE step over two OS processes (gloo), the
counterpart of tests/test_multiprocess.py.

Every case runs 2 processes of ``utils.multiproc`` with 2 CPU parts each
(4 parts of the ``tiny`` mesh) and holds what both ranks gathered:

* bit for bit against the port's one-process
  ``ShardedFctAleSolver(devices=["cpu"] * 4)`` on the same case;
* against the JAX ``ShardedFctAleSolver`` on 4 of the virtual CPU devices
  of tests/conftest.py: XLA in float64 at 1e-12, Pallas in interpret mode
  (``kernels.set_interpret(True)``) in float32 at 2e-6, the tolerance of
  tests/test_multiprocess.py.

The cases: the torch backend in float64 (1 step; 3 iterative steps, with
each exchange form), the CUDA step functions on CPU tensors (each kernel
wrapper's plain version) split and fused in float32, and 2 tracers.  Then
a collective checkpoint (rank 0 writes) resumed in one process at 2
parts, the units of ``parallel/distributed.py`` and the exchange's list of
cross-process slabs, and a multi-process ``run`` that never touches
``torch.cuda.CUDAGraph``.  Every launch has its own timeout, which kills
both ranks."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fesom2_accelerate_tpu.config import FctAleConfig as JaxFctAleConfig
from fesom2_accelerate_tpu.mesh import generate_planar_mesh as jax_planar_mesh
from fesom2_accelerate_tpu.ops.pallas import kernels as pallas_kernels
from fesom2_accelerate_tpu.parallel import (
    ShardedFctAleSolver as JaxShardedFctAleSolver,
)
from fesom2_accelerate_tpu_torch import ShardedFctAleSolver
from fesom2_accelerate_tpu_torch.mesh import generate_planar_mesh
from fesom2_accelerate_tpu_torch.parallel import distributed
from fesom2_accelerate_tpu_torch.parallel import partition as part_mod
from fesom2_accelerate_tpu_torch.parallel import step_sharded
from fesom2_accelerate_tpu_torch.parallel.step_sharded import (
    ProcessHaloFill,
    Wire,
    exchange_pairs,
)
from fesom2_accelerate_tpu_torch.utils import multiproc

from conftest import masked_allclose

TIMEOUT = 120.0  # seconds a launch may take before both ranks are killed
F32_RELERR = 2e-6  # tests/test_multiprocess.py:95-105
PARTS = 4


def _launch(tmp_path, name, **case):
    """Runs one case on 2 processes -> (the state rank 0 gathered, each
    rank's JSON row); rank 1 gathered the same bits."""
    out = tmp_path / name
    status, logs = multiproc.launch(
        2, multiproc.worker_args(device="cpu", **case), f"file://{out}.rdv",
        TIMEOUT,
        out=out)
    assert status == 0, "\n".join(f"rank {r}:\n{log[-3000:]}"
                                  for r, log in enumerate(logs))
    with np.load(out / "rank0.npz") as z:
        got = {k: z[k] for k in z.files}
    rows = [json.loads((out / f"rank{r}.json").read_text())
            for r in range(2)]
    assert not (out / "rank1.npz").exists()
    for row in rows:
        assert row["digest"] == {k: multiproc.digest(v)
                                 for k, v in got.items()}
    return got, rows


def _one_process(mode, dtype, steps, iter_yn=False, exchange="auto",
                 tracers=1, preset="tiny"):
    sh = multiproc.build_solver(["cpu"] * PARTS, preset, dtype, mode,
                                iter_yn, exchange, tracers)
    state = sh.init_state(multiproc.case_fields(preset, tracers))
    return sh.gather_state(multiproc.take_steps(sh, state, steps))


def _jax(dtype, steps, iter_yn, exchange="auto", tracers=1):
    """The JAX sharded step on 4 virtual CPU devices: XLA in float64,
    Pallas (interpret mode) in float32."""
    f64 = dtype == "f64"
    jcfg = JaxFctAleConfig(dt=0.5, iter_yn=iter_yn,
                           dtype=jnp.float64 if f64 else jnp.float32,
                           **({} if f64 else {"flux_eps": 1e-7}))
    backend = "xla" if f64 else "pallas"
    pallas_kernels.set_interpret(not f64)
    try:
        jsh = JaxShardedFctAleSolver(
            jax_planar_mesh(preset="tiny"), jcfg, devices=jax.devices()[:4],
            backend=backend, exchange=exchange,
            **({"tracers": tracers} if tracers > 1 else {}))
        state = jsh.init_state(multiproc.case_fields("tiny", tracers))
        out = jsh.step(state) if steps == 1 else jsh.run(state, steps)
        return jsh.gather_state({k: v for k, v in out.items()
                                 if k in state or steps == 1})
    finally:
        pallas_kernels.set_interpret(False)


def _relerr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


CASES = {
    "torch_f64": dict(mode="torch", dtype="f64", steps=1),
    "torch_f64_iter3": dict(mode="torch", dtype="f64", steps=3,
                            iter_yn=True),
    "torch_f64_iter3_allgather": dict(mode="torch", dtype="f64", steps=3,
                                      iter_yn=True, exchange="allgather"),
    "split_f32": dict(mode="split", dtype="f32", steps=1),
    "fused_f32": dict(mode="fused", dtype="f32", steps=1),
    "split_f32_tracers2": dict(mode="split", dtype="f32", steps=1,
                               tracers=2),
}


@pytest.mark.parametrize("name", list(CASES))
def test_two_processes_match_one_process_and_jax(tmp_path, name):
    case = CASES[name]
    got, rows = _launch(tmp_path, name, **case)
    for r, row in enumerate(rows):
        # global_devices is process-contiguous: rank r holds parts 2r, 2r+1
        assert row["parts"] == [2 * r, 2 * r + 1] and row["n_parts"] == 4
        assert row["transport"] == "gloo"
        assert row["messages_per_step"] > 0 and row["bytes_per_step"] > 0
        assert row["launches_per_step"] == 0  # plain versions on the CPU
    ref = _one_process(**case)
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)

    tracers = case.get("tracers", 1)
    jout = _jax(case["dtype"], case["steps"], case.get("iter_yn", False),
                case.get("exchange", "auto"), tracers)
    keys = [k for k in ref if k in jout and "limited" not in k]
    assert {"fct_LO", "fct_adf_h", "ttf"} <= set(keys)
    for k in keys:
        a, b = ref[k], np.asarray(jout[k])[..., :ref[k].shape[-2], :]
        if case["dtype"] == "f64":
            masked_allclose(a, b, msg=f"jax[{k}]")
        else:
            assert _relerr(a, b) < F32_RELERR, k


def test_collective_checkpoint_resumes_in_one_process(tmp_path):
    """2 steps, a checkpoint that every rank gathers and rank 0 writes, 3
    more steps; the checkpoint resumed in one process at 2 parts for 3
    steps equals the 5 steps without a break."""
    ck = tmp_path / "ck"
    got, rows = _launch(tmp_path, "ckpt", mode="torch", dtype="f64",
                        steps=5, checkpoint=str(ck), checkpoint_at=2)
    assert [row["wrote_checkpoint"] for row in rows] == [True, False]
    assert (ck / "meta.json").exists() and (ck / "state.npz").exists()
    full = _one_process("torch", "f64", 5)
    for k, v in full.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)

    sh2 = ShardedFctAleSolver(multiproc.case_mesh("tiny"),
                              multiproc.case_config("f64", False),
                              devices=["cpu"] * 2)
    state, step = sh2.load_checkpoint(ck)
    assert step == 2
    resumed = sh2.gather_state(sh2.run(state, 3))
    for k, v in full.items():
        np.testing.assert_array_equal(resumed[k], v, err_msg=k)


def test_one_process_checkpoint_writes_at_any_rank(tmp_path, monkeypatch):
    """A one-process solver in a rank other than 0 (each rank running a
    solver of its own) still writes its checkpoint."""
    sh = ShardedFctAleSolver(multiproc.case_mesh("tiny"),
                             multiproc.case_config("f64", False),
                             devices=["cpu"] * 2)
    state = sh.init_state(multiproc.case_fields("tiny"))
    monkeypatch.setattr(distributed, "process_rank", lambda: 1)
    assert not sh.multiprocess
    assert sh.save_checkpoint(tmp_path / "ck", state, step=3)
    assert (tmp_path / "ck" / "meta.json").exists()
    _, step = sh.load_checkpoint(tmp_path / "ck")
    assert step == 3


def test_gather_owned_unpacks_ranks_of_unequal_parts(monkeypatch):
    """Rank 1 holds one part and rank 0 three: rank 1's stack is
    zero-padded to three, and the blocks come back in part order."""
    owners = [0, 0, 0, 1]
    blocks = [torch.full((2, 3), float(p + 1)) for p in range(4)]

    def all_gather(got, mine):
        assert mine.shape == (3, 2, 3)
        got[0].copy_(torch.stack(blocks[:3]))
        got[1].copy_(mine)

    monkeypatch.setattr(step_sharded.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(step_sharded.dist, "all_gather", all_gather)
    got, sent = step_sharded._gather_owned(
        blocks[3:], owners, Wire("gloo", [torch.device("cpu")]))
    assert len(got) == 4 and sent == 3 * 2 * 3 * 4
    for a, b in zip(got, blocks):
        assert torch.equal(a, b)


def test_worker_runs_on_the_card_unless_asked_for_the_cpu():
    args = multiproc._parser().parse_args(
        ["worker", "--rank", "0", "--world", "1", "--init-method", "x",
         "--out", "o"])
    assert args.device == "cuda"
    opts = multiproc.worker_args()
    assert opts[opts.index("--device") + 1] == "cuda"
    opts = multiproc.worker_args(device="cpu")
    assert opts[opts.index("--device") + 1] == "cpu"


def test_multiprocess_run_never_touches_cuda_graphs(tmp_path):
    """A 3-step run across processes (the CUDA step functions on CPU
    tensors) with ``torch.cuda.CUDAGraph`` and ``torch.cuda.graph`` made
    to raise in both ranks: the run is the host's loop."""
    out = tmp_path / "nograph"
    out.mkdir()
    code = ("import sys, torch\n"
            "def no(*a, **k):\n"
            "    raise AssertionError('CUDA graph touched')\n"
            "torch.cuda.CUDAGraph = no\n"
            "torch.cuda.graph = no\n"
            "from fesom2_accelerate_tpu_torch.utils import multiproc\n"
            "sys.exit(multiproc.worker(sys.argv[1:]))\n")
    env = dict(os.environ, PYTHONPATH=str(multiproc.ROOT),
               GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, "worker", "--rank", str(r), "--world",
         "2", "--init-method", f"file://{out}.rdv", "--out", str(out),
         *multiproc.worker_args(mode="split", steps=3, device="cpu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(2)]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ref = _one_process("split", "f32", 3)
    with np.load(out / "rank0.npz") as z:
        for k, v in ref.items():
            np.testing.assert_array_equal(z[k], v, err_msg=k)


def test_scaling_two_process_rows_on_the_cpu(capsys):
    """``utils.scaling --procs 1,2`` on the CPU: the 2-process rows pass
    the gate, equal the one-process runs in their bits and count what
    crossed between the processes."""
    from fesom2_accelerate_tpu_torch.utils import scaling

    assert scaling.main(["--device", "cpu", "--backend", "torch",
                         "--preset", "tiny", "--parts", "2,4", "--procs",
                         "1,2", "--steps", "2"]) == 0
    *rows, summary = [json.loads(x)
                      for x in capsys.readouterr().out.splitlines()]
    assert [(r["parts"], r["procs"]) for r in rows] == [
        (2, 1), (2, 2), (4, 1), (4, 2)]
    assert summary["all_exact"] and summary["procs"] == [1, 2]
    for r in rows[1::2]:
        assert r["bits_vs_1proc"] and r["exact_vs_single"]
        assert r["transport"] == "gloo" and r["cards"] == 1
        # iterative: one exchange of both limiter factors and one of
        # fct_LO a step, one message each a rank
        assert r["messages_per_step"] == 4 and r["bytes_per_step"] > 0
        assert "step_ms" not in r


def test_launch_kills_every_rank_on_failure_and_timeout(tmp_path):
    # a case that fails at once on both ranks (no such preset)
    status, logs = multiproc.launch(
        2, multiproc.worker_args(preset="nonesuch", device="cpu"),
        f"file://{tmp_path}/a.rdv", TIMEOUT, out=tmp_path / "a")
    assert status != 0 and any("nonesuch" in log for log in logs)
    # rank 1 of a world of 3 waits for a rank that never starts
    status, _ = multiproc.launch(2, ["--world", "3", "--device", "cpu"],
                                 f"file://{tmp_path}/b.rdv", 5.0,
                                 out=tmp_path / "b")
    assert status == 124


def test_global_devices_order(monkeypatch):
    assert distributed.global_devices(["cpu", "cpu"]) == [
        distributed.PartDevice(0, torch.device("cpu"))] * 2
    lists = [["cpu", "cpu"], ["cpu"], ["cpu", "cpu"]]

    def all_gather_object(out, obj):
        out[:] = lists

    monkeypatch.setattr(distributed, "is_multiprocess", lambda: True)
    monkeypatch.setattr(distributed.dist, "get_world_size", lambda: 3)
    monkeypatch.setattr(distributed.dist, "all_gather_object",
                        all_gather_object)
    got = distributed.global_devices(["cpu"])
    assert [d.rank for d in got] == [0, 0, 1, 2, 2]
    assert all(d.device == torch.device("cpu") for d in got)


def test_bind_device_and_nccl_refusal(monkeypatch):
    assert distributed.bind_device(device="cpu") == torch.device("cpu")
    assert distributed.process_rank() == 0
    assert not distributed.is_multiprocess()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.bind_device()
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        distributed.bind_device(device="tpu")
    # two ranks on a node without two cards: refused before NCCL starts
    with pytest.raises(RuntimeError, match="one rank on one card"):
        distributed.init_distributed("file:///nonexistent", 2, 0,
                                     backend="nccl")


@pytest.mark.parametrize("mesh_kw,parts,owners", [
    ({"preset": "tiny"}, 4, [0, 0, 1, 1]),
    ({"preset": "small"}, 8, [0, 0, 0, 0, 1, 1, 1, 1]),
    # radius 2: slabs of hop 2 cross between ranks as well
    ({"nx": 4, "ny": 7, "nl": 5}, 8, [0, 0, 1, 1, 2, 2, 3, 3]),
])
def test_both_sides_derive_the_same_cross_process_slabs(mesh_kw, parts,
                                                        owners):
    mesh = generate_planar_mesh(**mesh_kw)
    pm = part_mod.partition_mesh(mesh, parts)
    pairs = exchange_pairs(pm)
    again = exchange_pairs(part_mod.partition_mesh(mesh, parts))
    assert [(p, q, h) for p, q, h, _, _ in pairs] == \
        [(p, q, h) for p, q, h, _, _ in again]
    assert pairs == sorted(pairs, key=lambda t: (t[0], abs(t[2]), t[2]))
    wire = Wire("gloo", [torch.device("cpu")])
    ranks = sorted(set(owners))
    fills = {r: ProcessHaloFill(pm, "ppermute", owners, r,
                                ["cpu"] * owners.count(r), wire)
             for r in ranks}
    sends = {(tag, r, dst, len(c)) for r, f in fills.items()
             for tag, dst, _, c in f.sends}
    recvs = {(tag, src, r, len(c)) for r, f in fills.items()
             for tag, src, _, c in f.recvs}
    assert sends == recvs and sends
    tags = [t for t, *_ in sends]
    assert sorted(tags) == list(range(len(tags)))
    cross = [t for t in pairs if owners[t[0]] != owners[t[1]]]
    assert len(cross) == len(sends)
    if mesh_kw.get("nx") == 4:
        assert pm.neighbor_radius >= 2
        assert any(abs(h) == 2 for _, _, h, _, _ in cross)
    # what stays in a process is the one-process fill's slabs of its parts
    for r, f in fills.items():
        local = sum(len(s) for s in f.smaps)
        assert local == sum(1 for p, q, *_ in pairs
                            if owners[p] == owners[q] == r)


def _sent_a_step(preset, exchange, iter_yn, dtype):
    """(messages, bytes) each of 2 ranks (2 of the 4 parts each) sends a
    step, from the partition: one exchange of the [2, L, cols] factor pair
    and, iterative, one of fct_LO.  ppermute: one message a slab that
    leaves the rank; allgather: one to the other rank, its 2 owned blocks
    stacked."""
    mesh = generate_planar_mesh(preset=preset)
    pm = part_mod.partition_mesh(mesh, PARTS)
    owners = [0, 0, 1, 1]
    size = 4 if dtype == "f32" else 8
    fields = 2 + iter_yn
    out = []
    for r in range(2):
        if exchange == "allgather":
            out.append((1 + iter_yn,
                        2 * pm.B * mesh.n_layers * size * fields))
            continue
        cols = [len(c) for p, q, _, c, _ in exchange_pairs(pm)
                if owners[q] == r != owners[p]]
        out.append((len(cols) * (1 + iter_yn),
                    sum(cols) * mesh.n_layers * size * fields))
    return out


@pytest.mark.parametrize("mode,exchange,iter_yn,dtype", [
    ("split", "ppermute", False, "f32"),
    ("fused", "ppermute", True, "f32"),
    ("torch", "allgather", True, "f64"),
])
def test_two_processes_send_both_factors_in_one_exchange(
        tmp_path, mode, exchange, iter_yn, dtype):
    """Over 2 processes a rank sends one message a slab a step for both
    limiter factors (half of a message a factor), plus one for fct_LO when
    iterative, and the bytes of both; the state is bit for bit the
    one-process run's."""
    case = dict(mode=mode, dtype=dtype, steps=2, iter_yn=iter_yn,
                exchange=exchange)
    got, rows = _launch(tmp_path, f"{mode}_{exchange}", **case)
    assert [(r["messages_per_step"], r["bytes_per_step"]) for r in rows] \
        == _sent_a_step("tiny", exchange, iter_yn, dtype)
    ref = _one_process(**case)
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


class _FakeCuda:
    """What ``Wire`` touches of ``torch.cuda``, logging into ``log``: the
    compute stream raises if anything synchronizes it."""

    def __init__(self, log):
        self.log = log
        fake = self

        class Stream:
            def __init__(self, device=None, name="side"):
                self.name = name

            def wait_stream(self, other):
                fake.log.append(("wait", self.name, other.name))

            def synchronize(self):
                raise AssertionError(f"{self.name} stream synchronized")

        class Event:
            def record(self, stream):
                fake.log.append(("record", stream.name))

            def synchronize(self):
                fake.log.append(("event sync",))

        self.Stream, self.Event = Stream, Event
        self.compute = Stream(name="compute")

    def current_stream(self, device=None):
        return self.compute

    def stream(self, s):
        log = self.log

        class On:
            def __enter__(self):
                log.append(("on", s.name))

            def __exit__(self, *exc):
                log.append(("off", s.name))

        return On()


def test_staging_waits_on_its_events_never_on_the_stream(monkeypatch):
    """A staged wire makes what it sends on a side stream that waits for
    the compute stream (an event behind what was enqueued), records an
    event behind it, and ``ready`` synchronizes that event only: the
    compute stream goes on with K3."""
    log = []
    fake = _FakeCuda(log)
    for name in ("Stream", "Event", "current_stream", "stream"):
        monkeypatch.setattr(step_sharded.torch.cuda, name,
                            getattr(fake, name))
    wire = Wire("gloo", [torch.device("cuda", 0)])
    assert wire.staged
    x = torch.arange(6.0).reshape(2, 3)

    def make():
        log.append(("make",))
        return [x[:, :2]]

    (sent,), staged = wire.out(make, [x])
    assert torch.equal(sent, x[:, :2])
    assert log == [("wait", "side", "compute"), ("on", "side"), ("make",),
                   ("record", "side"), ("off", "side")]
    wire.ready(staged)
    assert log[-1] == ("event sync",) and len(staged) == 1
    assert Wire("gloo", [torch.device("cpu")]).out(make, [x])[1] == []
