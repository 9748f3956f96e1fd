"""P1/P2 basis tabulation: nodal property, partition of unity,
polynomial reproduction."""

import numpy as np
import pytest

from nupgcm.fem.quadrature import simplex_rule
from nupgcm.fem.reference import local_node_coords, tabulate


@pytest.mark.parametrize("tdim", [2, 3])
@pytest.mark.parametrize("order", [1, 2])
def test_nodal_basis(tdim, order):
    nodes = local_node_coords(tdim, order)
    phi, _ = tabulate(tdim, order, nodes)
    assert np.allclose(phi, np.eye(len(nodes)), atol=1e-13)


@pytest.mark.parametrize("tdim", [2, 3])
@pytest.mark.parametrize("order", [1, 2])
def test_partition_of_unity(tdim, order):
    qp, _ = simplex_rule(tdim, 4)
    phi, dphi = tabulate(tdim, order, qp)
    assert np.allclose(phi.sum(axis=1), 1.0, atol=1e-13)
    assert np.allclose(dphi.sum(axis=1), 0.0, atol=1e-13)


@pytest.mark.parametrize("tdim", [2, 3])
def test_p2_reproduces_quadratics(tdim):
    """P2 interpolation of a quadratic is exact, incl. gradients."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((tdim, tdim))
    A = A + A.T
    bvec = rng.standard_normal(tdim)

    def f(x):
        return np.einsum("...i,ij,...j->...", x, A, x) + x @ bvec + 1.7

    def grad_f(x):
        return 2.0 * x @ A + bvec

    nodes = local_node_coords(tdim, 2)
    fvals = f(nodes)
    qp, _ = simplex_rule(tdim, 3)
    phi, dphi = tabulate(tdim, 2, qp)
    assert np.allclose(phi @ fvals, f(qp), atol=1e-12)
    assert np.allclose(np.einsum("qit,i->qt", dphi, fvals), grad_f(qp), atol=1e-12)
