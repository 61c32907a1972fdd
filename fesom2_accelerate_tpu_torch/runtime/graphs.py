"""A run of n steps replayed as CUDA graphs: the port's on-device ``run``.

The counterpart of ``jax.jit(lax.scan(...))`` in the JAX solvers' ``run``
(``fesom2_accelerate_tpu/model/fct_ale.py:197-218``,
``parallel/step_sharded.py:543-559``): the host enqueues a graph of many
steps once instead of every kernel and exchange op of every step.

:class:`StepGraphs` holds one graph pool (``torch.cuda.graph_pool_handle``)
for a solver and, for each step function and state signature (keys,
shapes, dtypes), a static copy of the carry and the graphs of the block
lengths its runs have needed.

``replay(step, state, n_steps)`` runs the steps as graphs:

* copies the state into the static carry: the caller's tensors are
  neither aliased nor written;
* replays the blocks of :func:`blocks` that cover the first n - 1 steps:
  ``BLOCK_STEPS`` steps chained through the pool, then one copy of the
  fields a step changes back into the static tensors, and a shorter block
  for the remainder.  Each block length is captured at its first use and
  cached, as the JAX solvers cache their scan per ``n_steps``;
* takes the last step eagerly from the static carry: the fields it writes
  are new tensors, the caller's (not pool memory that the next replay
  would overwrite), and the fields the steps leave as they were are the
  caller's own tensors, as in the loop of :func:`loop`.

``run(step, state, n_steps)`` replays where graphs pay and otherwise runs
:func:`loop`.  A graph saves the host's enqueue of each step and costs a
copy of the state a run and of the changed fields a block: it pays only
where the host, not the card, sets the pace of the loop.  So the first
run of a signature long enough takes its first ``WARM_STEPS`` steps
eagerly (they prime the step), then watches ``WATCHED_STEPS`` steps of
the loop: after the host has enqueued each, it asks (``Event.query``, no
synchronize) whether the card has finished the step before.  Where the
card sets the pace it is still busy with the queue; where the host does,
it has run dry.  Graphs pay when it ran dry at every one of them
(:func:`pays`): where the card sets the pace, an enqueue that runs long
now and then leaves it dry at some.  Where the allocator took memory
from the card during the watched steps (a ``cudaMalloc`` can wait for
the card), what they showed is the allocator's, and the choice waits for
a later run.  A choice holds for every later run of the signature
(``choices``).

The carry keeps the input's keys and drops the step's other outputs, as
the JAX scan does; ``n_steps == 0`` returns the state's tensors.  The
kernels are deterministic, so every run is bit-identical to :func:`loop`.

The first replay of a signature takes its first step eagerly, before any
capture: it primes what a capture may not do (``build.library()`` runs
nvcc at first use; ``MeshData.row_span`` and ``tile_edges`` read a tensor
on the host once per mesh data) and is a step of the run.

Launch counts: a capture calls the kernel wrappers but launches nothing,
and a replay launches without calling them.  So each capture records the
calls it made (``kernels.capturing``) and leaves the counts as they were,
and each replay adds them once (``kernels.count_replay``): the counts
are those of the loop.

Errors: a capture runs in the default global mode; one that fails raises,
and nothing falls back to the loop.  A kernel that faults in a replay
reports it at the next synchronize, as any asynchronous CUDA error does.
A graph captures one device: every tensor of the state must lie on the
:class:`StepGraphs`' device.

Spans (``runtime/tracing.py``, recorded only under a profiler):
``graphs.run`` a run, ``graphs.loop`` the host's loop, ``graphs.copy_in``
the copy into the static carry, ``graphs.replay`` each replay's enqueue,
``graphs.capture`` each capture.
"""

from __future__ import annotations

import torch

from fesom2_accelerate_tpu_torch.ops.cuda import kernels
from fesom2_accelerate_tpu_torch.runtime import tracing

# steps of one graph: the copy of the fields a step changes back into the
# static tensors after each block (144 MB on core2 f32, 0.12 ms by
# chip_smoke.py phase 8e) against 24 steps of 0.44 ms
BLOCK_STEPS = 24
# a signature's first run: eager steps before the watched ones, and the
# steps of the loop watched to choose between graphs and the loop
WARM_STEPS = 2
WATCHED_STEPS = 6


def blocks(n_steps: int) -> list:
    """The block lengths that cover ``n_steps`` steps in order: as many
    blocks of ``BLOCK_STEPS`` as fit, then the remainder."""
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    full, rest = divmod(n_steps, BLOCK_STEPS)
    return [BLOCK_STEPS] * full + ([rest] if rest else [])


def pays(dry: int, watched: int) -> bool:
    """Whether graphs pay for a step whose loop found the card run dry
    (done with the step before when the host had enqueued a step) at
    ``dry`` of ``watched`` steps."""
    return dry == watched


@tracing.spanned("graphs.loop")
def loop(step, state: dict, n_steps: int) -> dict:
    """``n_steps`` calls of ``step`` from the host; the carry keeps the
    input's keys."""
    for _ in range(n_steps):
        new = step(state)
        state = {k: new[k] for k in state}
    return state


class StepGraphs:
    """The CUDA graphs of one solver's runs on ``device``."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got "
                             f"{self.device}")
        self.pool = None
        self.stream = None
        # signature -> (watched steps at which the card ran dry, graphs pay)
        self.choices = {}
        # signature -> (static carry, the fields a step changes);
        # (signature, block length) -> (graph, the wrappers' calls)
        self._static = {}
        self._graphs = {}

    def _key(self, step, state: dict, n_steps: int) -> tuple:
        """The cache key of a run: the step's function (a bound method's
        function, so that the cache holds no reference to its solver) and
        the state's signature.  A :class:`StepGraphs` serves one solver."""
        if n_steps < 0:
            raise ValueError(f"n_steps must be >= 0, got {n_steps}")
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        for k, v in state.items():
            if v.device != self.device:
                raise ValueError(f"{k} is on {v.device}, the graphs on "
                                 f"{self.device}")
        return (getattr(step, "__func__", step),
                tuple((k, tuple(v.shape), v.dtype) for k, v in state.items()))

    @tracing.spanned("graphs.run")
    def run(self, step, state: dict, n_steps: int) -> dict:
        """``n_steps`` of ``step`` (a dict of tensors -> a dict with at
        least the same keys) from ``state``: graph replays where graphs
        pay for this signature, else the loop.  A run of fewer than 2
        steps cannot replay: it is the loop, with no cache key."""
        if n_steps < 2:
            if n_steps < 0:
                raise ValueError(f"n_steps must be >= 0, got {n_steps}")
            return loop(step, state, n_steps)
        key = self._key(step, state, n_steps)
        if key not in self.choices and n_steps > WARM_STEPS + WATCHED_STEPS:
            state = loop(step, state, WARM_STEPS)  # primes the step
            state = self._watched_steps(key, step, state)
            n_steps -= WARM_STEPS + WATCHED_STEPS
        if not self.choices.get(key, (0, False))[1]:
            return loop(step, state, n_steps)
        return self._replay(key, step, state, n_steps)

    def replay(self, step, state: dict, n_steps: int) -> dict:
        """``n_steps`` of ``step`` from ``state`` as graph replays,
        whether they pay or not."""
        key = self._key(step, state, n_steps)
        if key not in self._static and n_steps >= 2:
            state = loop(step, state, 1)  # primes the step
            n_steps -= 1
        return self._replay(key, step, state, n_steps)

    def _watched_steps(self, key, step, state: dict) -> dict:
        """``WATCHED_STEPS`` steps of the loop, each followed by an event
        -> their result; records (the steps at which the card had run dry,
        whether graphs pay) for ``key`` unless the allocator's reserve grew
        meanwhile."""
        dry = 0
        with torch.cuda.device(self.device):
            reserved = torch.cuda.memory_reserved()
            before = torch.cuda.Event()
            before.record()
            for _ in range(WATCHED_STEPS):
                state = loop(step, state, 1)
                dry += before.query()
                before = torch.cuda.Event()
                before.record()
            if torch.cuda.memory_reserved() == reserved:
                self.choices[key] = (dry, pays(dry, WATCHED_STEPS))
        return state

    def _replay(self, key, step, state: dict, n_steps: int) -> dict:
        if n_steps < 2:
            return loop(step, state, n_steps)
        with torch.cuda.device(self.device):
            if key not in self._static:
                if self.stream is None:
                    self.stream = torch.cuda.Stream(self.device)
                    self.pool = torch.cuda.graph_pool_handle()
                self._static[key] = (
                    {k: torch.empty_like(v) for k, v in state.items()}, [])
            static, changed = self._static[key]
            with tracing.span("graphs.copy_in"):
                for k, v in state.items():
                    static[k].copy_(v)
            for length in blocks(n_steps - 1):
                graph, calls = self._graph(key, step, length)
                with tracing.span("graphs.replay"):
                    graph.replay()
                kernels.count_replay(calls)
            # the fields the steps leave as they were: the caller's own
            last = {k: static[k] if k in changed else v
                    for k, v in state.items()}
            return loop(step, last, 1)

    def _graph(self, key, step, length: int) -> tuple:
        """(graph, the kernel wrappers' calls of one replay) of ``length``
        steps from and back into the static carry of ``key``, captured at
        first use."""
        if (key, length) not in self._graphs:
            static, changed = self._static[key]
            graph = torch.cuda.CUDAGraph()
            with tracing.span("graphs.capture"):
                with kernels.capturing() as calls:
                    with torch.cuda.graph(graph, pool=self.pool,
                                          stream=self.stream):
                        out = loop(step, dict(static), length)
                        for k, v in out.items():
                            if v is not static[k]:
                                static[k].copy_(v)
            changed[:] = [k for k, v in out.items() if v is not static[k]]
            self._graphs[key, length] = (graph, calls)
        return self._graphs[key, length]
