"""Krylov solvers vs dense reference solutions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nupgcm.solvers.cg import cg
from nupgcm.solvers.gmres import gmres


@pytest.fixture(scope="module")
def spd_system():
    rng = np.random.default_rng(0)
    n = 120
    A = rng.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n)
    b = rng.standard_normal(n)
    return jnp.asarray(A), jnp.asarray(b), np.linalg.solve(A, b)


@pytest.fixture(scope="module")
def nonsym_system():
    rng = np.random.default_rng(1)
    n = 120
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal(n)
    return jnp.asarray(A), jnp.asarray(b), np.linalg.solve(A, b)


def test_cg(spd_system):
    A, b, xref = spd_system
    x, st = cg(lambda v: A @ v, b, jnp.zeros_like(b),
               M_diag_inv=1.0 / jnp.diag(A), atol=1e-12, rtol=1e-12)
    assert bool(st.converged)
    assert np.abs(np.asarray(x) - xref).max() < 1e-8


def test_cg_itmax_respected(spd_system):
    A, b, _ = spd_system
    _, st = cg(lambda v: A @ v, b, jnp.zeros_like(b), itmax=3, atol=0.0, rtol=1e-30)
    assert int(st.iterations) == 3


def test_gmres_left_precond(nonsym_system):
    A, b, xref = nonsym_system
    d = jnp.diag(A)
    x, st = gmres(lambda v: A @ v, b, jnp.zeros_like(b),
                  M=lambda r: r / d, m=20, atol=1e-12, rtol=1e-12)
    assert bool(st.converged)
    assert np.abs(np.asarray(x) - xref).max() < 1e-7


def test_fgmres_with_inner_cg(nonsym_system):
    A, b, xref = nonsym_system

    def M(r):
        # crude inner solve on the symmetric part
        S = 0.5 * (A + A.T)
        z, _ = cg(lambda v: S @ v, r, jnp.zeros_like(r), itmax=5, atol=0.0, rtol=1e-8)
        return z

    x, st = gmres(lambda v: A @ v, b, jnp.zeros_like(b), M=M, flexible=True,
                  m=20, atol=1e-11, rtol=1e-11)
    assert bool(st.converged)
    assert np.abs(np.asarray(x) - xref).max() < 1e-6


def test_gmres_restart_path(nonsym_system):
    """Small m forces restarts; must still converge."""
    A, b, xref = nonsym_system
    x, st = gmres(lambda v: A @ v, b, jnp.zeros_like(b), m=5, atol=1e-10, rtol=1e-10)
    assert bool(st.converged)
    assert int(st.iterations) > 5  # restarted at least once
    assert np.abs(np.asarray(x) - xref).max() < 1e-5


def test_gmres_singular_consistent():
    """GMRES on a singular but consistent system (pressure nullspace
    analog): converges to a solution."""
    rng = np.random.default_rng(2)
    n = 50
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    A[:, -1] = 0.0  # null direction e_n
    x_true = rng.standard_normal(n)
    x_true[-1] = 0.0
    b = jnp.asarray(A @ x_true)
    x, st = gmres(lambda v: jnp.asarray(A) @ v, b, jnp.zeros(n), m=25,
                  atol=1e-10, rtol=1e-10)
    assert float(jnp.linalg.norm(jnp.asarray(A) @ x - b)) < 1e-8
