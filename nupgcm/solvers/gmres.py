"""Restarted GMRES(m) and flexible FGMRES(m) (jit-compatible).

The reference's inversion solve is Krylov.jl GMRES with restart
memory 20 and a left preconditioner (reference src/inversion.jl:74-93,
src/iterative_solvers.jl:58).  This is a jit-native re-implementation:

  * fixed-size Krylov basis (m+1, n) arrays -> static shapes under jit;
  * classical Gram-Schmidt with one re-orthogonalization pass (CGS2)
    instead of modified GS -- two batched (m+1, n) matvecs per
    iteration that XLA runs as dense products, numerically as robust as MGS;
  * Givens rotations tracked incrementally for the residual norm;
  * ``flexible=True`` stores the preconditioned directions (FGMRES,
    right preconditioning) so inner-iterative preconditioners (e.g.
    the block Stokes preconditioner, reference src/preconditioners.jl)
    are supported.

Stopping: ||r_pre|| <= atol + rtol * ||r0_pre|| in the preconditioned
residual norm for left preconditioning (Krylov.jl semantics), true
residual norm for FGMRES.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .cg import SolveStats


def _givens(a, b):
    r = jnp.hypot(a, b)
    r_safe = jnp.where(r == 0, 1.0, r)
    c = jnp.where(r == 0, 1.0, a / r_safe)
    s = jnp.where(r == 0, 0.0, b / r_safe)
    return c, s, r


def gmres(op, b, x0, *, M=None, m=20, atol=1e-6, rtol=1e-6, itmax=0,
          flexible=False, psum_axis=None):
    """Solve op(x) = b with restarted (F)GMRES(m).

    op: callable x -> A x.
    M: preconditioner callable r -> M^{-1} r (left unless flexible).
    psum_axis: when running inside shard_map over a device mesh axis,
    vectors are shard-local; Gram-Schmidt projections and norms become
    local partials + psum (distributed FGMRES); the Hessenberg/Givens
    scalars stay replicated across shards.
    Returns (x, SolveStats).
    """
    n = b.shape[0]
    dt = b.dtype
    if itmax == 0:
        itmax = 2 * n
    if M is None:
        M = lambda r: r

    if psum_axis is None:
        _reduce = lambda x: x
    else:
        _reduce = lambda x: jax.lax.psum(x, psum_axis)
    _norm = lambda v: jnp.sqrt(_reduce(jnp.vdot(v, v)))

    def pre_resid(x):
        r = b - op(x)
        return M(r) if not flexible else r

    r0 = pre_resid(x0)
    beta0 = _norm(r0)
    tol = atol + rtol * beta0

    def cycle(x):
        """One restart cycle; returns (x_new, resid, inner_iters)."""
        r = pre_resid(x)
        beta = _norm(r)
        V = jnp.zeros((m + 1, n), dt).at[0].set(r / jnp.where(beta == 0, 1.0, beta))
        Z = jnp.zeros((m, n), dt) if flexible else None
        R = jnp.zeros((m, m), dt)  # upper-triangular factor, columns
        g = jnp.zeros(m + 1, dt).at[0].set(beta)
        cs = jnp.zeros(m, dt)
        sn = jnp.zeros(m, dt)

        def cond(st):
            V, Z, R, g, cs, sn, j, res = st
            return jnp.logical_and(j < m, res > tol)

        def body(st):
            V, Z, R, g, cs, sn, j, res = st
            vj = V[j]
            if flexible:
                zj = M(vj)
                Z = Z.at[j].set(zj)
                w = op(zj)
            else:
                w = M(op(vj))
            # CGS2: rows of V beyond j are zero, so full products are safe
            h1 = _reduce(V @ w)
            w = w - V.T @ h1
            h2 = _reduce(V @ w)
            w = w - V.T @ h2
            h = h1 + h2
            hnorm = _norm(w)
            h = h.at[j + 1].set(hnorm)
            V = V.at[j + 1].set(w / jnp.where(hnorm == 0, 1.0, hnorm))

            # apply existing rotations to the new column
            def rot(i, hcol):
                hi, hi1 = hcol[i], hcol[i + 1]
                hcol = hcol.at[i].set(cs[i] * hi + sn[i] * hi1)
                hcol = hcol.at[i + 1].set(-sn[i] * hi + cs[i] * hi1)
                return hcol

            h = jax.lax.fori_loop(0, j, rot, h)
            c, s, rr = _givens(h[j], h[j + 1])
            cs = cs.at[j].set(c)
            sn = sn.at[j].set(s)
            h = h.at[j].set(rr).at[j + 1].set(0.0)
            R = R.at[:, j].set(h[:m])
            g = g.at[j + 1].set(-s * g[j])
            g = g.at[j].set(c * g[j])
            res = jnp.abs(g[j + 1])
            return (V, Z, R, g, cs, sn, j + 1, res)

        st = (V, Z, R, g, cs, sn, jnp.array(0, jnp.int32), beta)
        V, Z, R, g, cs, sn, j, res = jax.lax.while_loop(cond, body, st)

        # back-substitution on the j x j leading block (pad: unit diag)
        idx = jnp.arange(m)
        used = idx < j
        Rm = jnp.where(
            jnp.logical_and(used[:, None], used[None, :]), R, 0.0
        ) + jnp.diag(jnp.where(used, 0.0, jnp.ones(m, dt)))
        y = jax.scipy.linalg.solve_triangular(Rm, jnp.where(used, g[:m], 0.0), lower=False)
        dx = (Z.T @ y) if flexible else (V[:m].T @ y)
        return x + dx, res, j

    def outer_cond(st):
        x, res, total = st
        return jnp.logical_and(res > tol, total < itmax)

    def outer_body(st):
        x, res, total = st
        x, res, j = cycle(x)
        return (x, res, total + j)

    x, res, total = jax.lax.while_loop(
        outer_cond, outer_body, (x0, beta0, jnp.array(0, jnp.int32))
    )
    return x, SolveStats(iterations=total, residual=res, converged=res <= tol)
