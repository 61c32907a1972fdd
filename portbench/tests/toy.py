"""Runs of a cell on the CPU at toy size, for the tests (the ``on_cpu``
fixture of ``conftest.py`` lets the drivers run there)."""

# the toy mesh every CPU run of a cell is cut to
TOY_MESH = {"kind": "planar", "nx": 12, "ny": 9, "nl": 8}


def toy_cell(name: str, **config):
    """Cell ``name`` of ``BENCHMARK.json`` on the toy mesh, ``config``
    keys replaced."""
    from portbench import harness

    c = harness.cell(name)
    c.config = dict(c.config, mesh=TOY_MESH, **config)
    return c


def run_toy(name: str, seconds: float = 0.3, traced: bool = False,
            seed: int = 2 ** 31 + 11, control: bool = False, **config):
    """One run of cell ``name`` on the CPU at toy size -> its result."""
    import io

    from portbench import run

    return run.run_rank(toy_cell(name, **config), seed, seconds, traced,
                        "cpu", out=io.StringIO(), control=control)
