"""Monomial-exactness tests for the simplex quadrature rules."""

import math
from itertools import product

import numpy as np
import pytest

from nupgcm.fem.quadrature import simplex_rule


def exact_monomial_integral(alpha):
    """Integral of prod x_i^a_i over the unit simplex."""
    num = np.prod([math.factorial(a) for a in alpha])
    return num / math.factorial(sum(alpha) + len(alpha))


@pytest.mark.parametrize("tdim", [1, 2, 3])
@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5])
def test_monomial_exactness(tdim, degree):
    qp, qw = simplex_rule(tdim, degree)
    assert np.all(qw > 0), "rule must have positive weights"
    for alpha in product(range(degree + 1), repeat=tdim):
        if sum(alpha) > degree:
            continue
        approx = np.sum(qw * np.prod(qp ** np.array(alpha), axis=1))
        assert abs(approx - exact_monomial_integral(alpha)) < 1e-13


def test_points_inside_simplex():
    for tdim in (2, 3):
        qp, _ = simplex_rule(tdim, 4)
        assert np.all(qp >= 0)
        assert np.all(qp.sum(axis=1) <= 1 + 1e-14)
