"""The contract bytes on a mesh small enough to count by hand."""

import numpy as np

from portbench import contract
from portbench.reference.mesh import build_mesh

# two triangles of a unit square: element 0 with 3 interfaces, 1 with 4
SQUARE = build_mesh(np.array([[0, 1, 3], [0, 3, 2]]), np.array([3, 4]), 4,
                    np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0],
                              [1.0, 1.0]]))


def test_square_by_hand():
    # nodes 0, 2, 3 touch element 1 (3 layers), node 1 only element 0 (2)
    assert list(SQUARE.nlev_nod - 1) == [3, 2, 3, 3]
    # edges 0-1, 0-2, 0-3, 1-3, 2-3: layers 2, 3, 3, 2, 3
    assert SQUARE.edges.tolist() == [[0, 1], [0, 2], [0, 3], [1, 3], [2, 3]]
    assert list(SQUARE.nlev_edge) == [2, 3, 3, 2, 3]


def test_fct_step_bytes_by_hand():
    nod, edge = 11, 13  # active node-layers, edge-layers
    conn = 5 * 12 + 4 * 4  # endpoints and levels of 5 edges, 4 nodes
    # hnode, hnode_new, area; a tracer reads ttf, fct_LO, both fluxes and
    # both increments, and writes both fluxes and both increments
    two = conn + 4 * (3 * nod + 2 * ((5 * nod + edge) + (3 * nod + edge)))
    assert contract.fct_step_bytes(SQUARE, 2) == two == 1120
    # iterative: hnode_new, area; reads ttf, fct_LO, both fluxes; writes
    # fct_LO and both remainders
    one = conn + 4 * (2 * nod + (3 * nod + edge) + (2 * nod + edge))
    assert contract.fct_step_bytes(SQUARE, 1, iter_yn=True) == one == 488


def test_the_count_does_not_depend_on_the_form():
    # a function of the mesh, the tracers and the mode alone
    assert contract.fct_step_bytes(SQUARE, 4) == (
        2 * contract.fct_step_bytes(SQUARE, 2)
        - contract.fct_step_bytes(SQUARE, 0))
