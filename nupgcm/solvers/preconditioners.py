"""Preconditioners for the PG inversion/evolution solves.

Reference strategy (src/inversion.jl:42-59, src/evolution.jl:143-159,
src/preconditioners.jl):
  * evolution CG: Jacobi diag(A)^-1 (GPU / rebuilding paths) or LU (CPU)
  * inversion GMRES: constant diagonal (1/h^dim) on GPU, LU on CPU,
    experimental block-diagonal Stokes preconditioner (Elman 2014).

On the device there is no sparse LU; instead we make the block-diagonal
Stokes preconditioner the first-class option -- velocity block solved
by a few inner Jacobi-CG iterations on the *symmetric* viscous
operator, pressure block by the scaled pressure mass matrix -- wrapped
in FGMRES.  This turns the reference's tens-of-thousands of
1/h^dim-preconditioned iterations (BASELINE.md) into O(100).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from .cg import cg


def chebyshev(op, dinv: jnp.ndarray, r: jnp.ndarray, k: int,
              lmin, lmax) -> jnp.ndarray:
    """k-step Chebyshev approximation of (D^-1 A)^-1 D^-1 r.

    The textbook SPD Chebyshev smoother (Saad, Iterative Methods,
    Alg. 12.1) on the Jacobi-scaled operator with eigenvalue bounds
    [lmin, lmax].  Unlike inner CG it performs NO dot products, so
    every iteration is pure matvec + axpy with no reduction
    latency on the critical path -- the preferred inner solver for the
    block-Stokes preconditioner.
    """
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    d = (1.0 / theta) * (dinv * r)
    z = d

    def body(i, carry):
        z, d, r, rho = carry
        r = r - op(d)
        rho1 = 1.0 / (2.0 * sigma1 - rho)
        d = rho1 * rho * d + (2.0 * rho1 / delta) * (dinv * r)
        z = z + d
        return (z, d, r, rho1)

    z, d, r, rho = jax.lax.fori_loop(0, k - 1, body, (z, d, r, rho))
    return z


def power_lmax(op, dinv: jnp.ndarray, n: int, iters: int = 30) -> jnp.ndarray:
    """Largest eigenvalue estimate of D^-1 A via power iteration
    (deterministic start), with a 10% safety margin."""
    v = jnp.cos(jnp.arange(n, dtype=dinv.dtype))  # decorrelated start

    def body(i, v):
        w = dinv * op(v)
        return w / jnp.linalg.norm(w)

    v = jax.lax.fori_loop(0, iters, body, v / jnp.linalg.norm(v))
    w = dinv * op(v)
    lam = jnp.vdot(v, w) / jnp.vdot(v, v)
    return 1.1 * lam


def jacobi(diag: jnp.ndarray):
    """Pointwise inverse-diagonal preconditioner."""
    inv = 1.0 / diag
    return lambda r: inv * r


def const_diag(scale: float):
    """Constant diagonal scaling (reference 1/h^dim preconditioner)."""

    def M(r):
        return r / scale

    return M


@dataclass
class CoarseCorrection:
    """P1-vertex two-grid correction for the velocity block.

    Given a smoothed iterate z for A z = r, restricts the residual to
    the vertex coarse space (exact P1 c P2 inclusion transpose), solves
    it with a precomputed dense coarse inverse (one dense matvec), and
    prolongs the correction back.  Flattens the h-dependence of the
    outer iteration count that pure Chebyshev smoothing suffers.
    """

    solve: callable  # rc (Nc,) -> zc (Nc,): dense-inverse matvec or
    #                   an iterative coarse solve (element-local P1 op)
    parents: jnp.ndarray  # (n_nodes, 2) int32 coarse vertex dofs
    weights: jnp.ndarray  # (n_nodes, 2) inclusion weights (1,0)/(.5,.5)
    coarse_free: jnp.ndarray  # (Nc,) mask
    free_u: jnp.ndarray  # (3*n_nodes,) fine mask
    n_vert: int

    def __call__(self, A, r: jnp.ndarray, z: jnp.ndarray) -> jnp.ndarray:
        rc = r - A(z)
        rf = rc.reshape(-1, 3)  # node-major (node, comp)
        contrib = self.weights[:, :, None] * rf[:, None, :]  # (n, 2, 3)
        rcoarse = jax.ops.segment_sum(
            contrib.reshape(-1, 3), self.parents.reshape(-1),
            num_segments=self.n_vert,
        ).reshape(-1) * self.coarse_free
        zc = self.solve(rcoarse) * self.coarse_free
        zc3 = zc.reshape(-1, 3)[self.parents]  # (n, 2, 3)
        corr = (self.weights[:, :, None] * zc3).sum(axis=1).reshape(-1)
        return z + corr * self.free_u


@dataclass
class SaddleCoarseCorrection:
    """P1-P1 coarse correction over the FULL (u, p) saddle residual.

    Captures the global geostrophic/baroclinic coupling that the
    block preconditioner's Mp/a2e2 Schur surrogate misses in the
    rotation-dominated (small-Ekman) regime: the coarse problem is the
    same rotating saddle system on the vertex space (BP-stabilized),
    solved by ``solve`` -- a dense precomputed inverse (small meshes,
    one dense matvec) or an inner block-preconditioned FGMRES on the
    element-local coarse operator (large meshes).  Velocity
    restriction/prolongation is the exact P1 c P2 inclusion; pressure
    (already P1) passes through unchanged.
    """

    solve: callable  # rc (4nv,) -> zc (4nv,)
    parents: jnp.ndarray  # (n_nodes, 2)
    weights: jnp.ndarray  # (n_nodes, 2)
    coarse_free_u: jnp.ndarray  # (3nv,)
    free_fine: jnp.ndarray  # (N,) full fine free mask
    n_vert: int
    nu_dofs: int  # fine velocity dof count

    def _restrict(self, r: jnp.ndarray) -> jnp.ndarray:
        ru = r[: self.nu_dofs].reshape(-1, 3)
        contrib = self.weights[:, :, None] * ru[:, None, :]
        rcu = jax.ops.segment_sum(
            contrib.reshape(-1, 3), self.parents.reshape(-1),
            num_segments=self.n_vert,
        ).reshape(-1) * self.coarse_free_u
        return jnp.concatenate([rcu, r[self.nu_dofs:]])

    def _prolong(self, zc: jnp.ndarray) -> jnp.ndarray:
        zcu = (zc[: 3 * self.n_vert] * self.coarse_free_u).reshape(-1, 3)
        z3 = zcu[self.parents]  # (n, 2, 3)
        zu = (self.weights[:, :, None] * z3).sum(axis=1).reshape(-1)
        return jnp.concatenate([zu, zc[3 * self.n_vert:]])

    def __call__(self, A, r: jnp.ndarray, z: jnp.ndarray) -> jnp.ndarray:
        rc = r - A(z)
        zc = self.solve(self._restrict(rc))
        return z + self._prolong(zc) * self.free_fine


@dataclass
class AggregateCoarseCorrection:
    """Second-level (aggregate) correction for the P1-P1 coarse saddle
    system.

    At production scale the vertex coarse system is itself large
    (4 n_vert ~ 144k at 0.87M fine dofs) and must be solved
    iteratively; the accuracy of THAT solve drives the outer FGMRES
    count (measured: 3 outer iterations with a dense coarse inverse at
    43k dofs vs 17 with the k-step inner solve at 0.87M).  This adds a
    third grid: vertices are clustered into contiguous aggregates
    (host BFS over the mesh connectivity at setup), the coarse saddle
    matrix is Galerkin-projected onto piecewise-constant aggregate
    basis functions, and the resulting O(10k) system is inverted dense
    once -- applied here as one dense matvec between restrict
    (segment-sum) and prolong (gather).  Used multiplicatively after
    the coarse-level block smoother, exactly like the fine-level
    ``SaddleCoarseCorrection``.
    """

    inv: jnp.ndarray      # (4*n_agg, 4*n_agg) dense inverse
    agg: jnp.ndarray      # (n_vert,) int32 vertex -> aggregate
    n_agg: int
    free_c: jnp.ndarray   # (4*n_vert,) coarse-level free mask

    def __call__(self, A, r: jnp.ndarray, z: jnp.ndarray) -> jnp.ndarray:
        na = self.n_agg
        nv = self.agg.shape[0]
        rc = r - A(z)
        ru = rc[: 3 * nv].reshape(nv, 3)
        # (na, 3).reshape(-1) lays dofs out as 3*aggregate + component,
        # matching the Galerkin matrix built in
        # models/model.py::_assemble_saddle_coarse_l2
        r2u = jax.ops.segment_sum(ru, self.agg, num_segments=na)
        r2p = jax.ops.segment_sum(rc[3 * nv:], self.agg, num_segments=na)
        r2 = jnp.concatenate([r2u.reshape(-1), r2p])
        z2 = self.inv @ r2
        zu = z2[: 3 * na].reshape(na, 3)[self.agg]
        zp = z2[3 * na:][self.agg]
        corr = jnp.concatenate([zu.reshape(-1), zp]) * self.free_c
        return z + corr


@dataclass
class BlockStokesPrecond:
    """Block-diagonal preconditioner for the (u, p) saddle system.

    M^{-1} = diag( (A_visc)^{-1}_approx , ((1/a2e2) M_p)^{-1}_approx )

    where A_visc is the Dirichlet-pinned symmetric viscous + |f|-mass
    block and M_p the pressure mass matrix.  Blocks are inverted
    approximately by fixed-iteration Chebyshev smoothing (reduction-
    free; ``method='cg'`` falls back to Jacobi-CG).  Because the
    operator count is FIXED either way, the preconditioner is a fixed
    linear operator under Chebyshev and standard GMRES would suffice;
    we still run it under FGMRES so both methods are interchangeable.
    """

    visc_op: callable  # SPD u-block smoothing operator (masked)
    visc_diag_inv: jnp.ndarray
    mp_op: callable  # pressure mass operator scaled by 1/a2e2
    mp_diag_inv: jnp.ndarray
    nu_dofs: int  # velocity dof count (static)
    inner_iters_u: int = 20
    inner_iters_p: int = 5
    method: str = "chebyshev"
    lmax_u: jnp.ndarray = None  # spectral bound of D^-1 A_visc
    lmax_p: jnp.ndarray = None
    cond_ratio: float = 30.0  # lmin = lmax / cond_ratio
    ublock_op: callable = None  # FULL u-block (viscous + Coriolis)
    up_coupling: callable = None  # p -> u pressure-gradient block (-B^T)
    coarse: object = None  # optional TwoGridU coarse correction
    saddle_coarse: object = None  # optional SaddleCoarseCorrection
    outer_op: callable = None  # full masked saddle operator (for
    #                            residuals of the saddle coarse step)

    def _solve_p(self, rp: jnp.ndarray) -> jnp.ndarray:
        if self.method == "cg":
            zp, _ = cg(self.mp_op, rp, jnp.zeros_like(rp),
                       M_diag_inv=self.mp_diag_inv,
                       atol=0.0, rtol=1e-8, itmax=self.inner_iters_p)
            return zp
        # pressure mass is well conditioned under Jacobi: tight ratio
        return chebyshev(self.mp_op, self.mp_diag_inv, rp,
                         self.inner_iters_p, self.lmax_p / 4.0, self.lmax_p)

    def __call__(self, r: jnp.ndarray) -> jnp.ndarray:
        z = self._block(r)
        if self.saddle_coarse is not None:
            # multiplicative two-level step over the whole saddle
            # system: block pre-smooth -> geostrophic coarse.  NO post
            # block smooth: the Chebyshev u-block amplifies modes below
            # its lmin bound, and in post position (after the coarse
            # has removed what it can) that amplification compounds
            # until the outer FGMRES stalls (measured: stall at 2e-5
            # with post, clean convergence without).
            z = self.saddle_coarse(self.outer_op, r, z)
        return z

    def _block(self, r: jnp.ndarray) -> jnp.ndarray:
        ru, rp = r[: self.nu_dofs], r[self.nu_dofs:]
        if self.up_coupling is not None:
            # block UPPER-triangular M = [[A_hat, up], [0, S_hat]]:
            # with exact blocks the preconditioned spectrum is {1}
            # (GMRES converges in 2 iterations vs 3 eigenvalue clusters
            # for block-diagonal).  S_hat = M_p / a2e2 is SPD because
            # the coupling is skew (pu = -up^T): S = B A^{-1} B^T > 0.
            zp = self._solve_p(rp)
            ru = ru - self.up_coupling(zp)
            zu = self._solve_u(ru)
            return jnp.concatenate([zu, zp])
        return jnp.concatenate([self._solve_u(ru), self._solve_p(rp)])

    def _solve_u(self, ru: jnp.ndarray) -> jnp.ndarray:
        if self.method == "inner_gmres":
            # small-Ekman regime: the skew Coriolis term dominates the
            # velocity block, so smooth the FULL (nonsymmetric) block
            # with inner GMRES instead of an SPD Chebyshev surrogate
            from .gmres import gmres as _gmres

            zu, _ = _gmres(
                self.ublock_op, ru, jnp.zeros_like(ru),
                M=lambda v: self.visc_diag_inv * v,
                m=self.inner_iters_u, atol=0.0, rtol=1e-8,
                itmax=self.inner_iters_u,
            )
        elif self.method == "chebyshev":
            zu = chebyshev(self.visc_op, self.visc_diag_inv, ru,
                           self.inner_iters_u, self.lmax_u / self.cond_ratio,
                           self.lmax_u)
        else:
            zu, _ = cg(
                self.visc_op, ru, jnp.zeros_like(ru),
                M_diag_inv=self.visc_diag_inv,
                atol=0.0, rtol=1e-8, itmax=self.inner_iters_u,
            )
        if self.coarse is not None:
            # V-cycle: pre-smooth (above), coarse solve, post-smooth
            zu = self.coarse(self.visc_op, ru, zu)
            r2 = ru - self.visc_op(zu)
            zu = zu + chebyshev(self.visc_op, self.visc_diag_inv, r2,
                                self.inner_iters_u,
                                self.lmax_u / self.cond_ratio, self.lmax_u)
        return zu
