"""Element-local (matrix-free) operator application.

The replacement for assembled-sparse SpMV in the Krylov hot loop.  An
assembled CSR/COO matvec costs one random gather plus one scatter per
*nonzero* (~1M each for the 3D inversion operator); the element-local
form

    y = sum_e  P_e^T ( A_e  (P_e x) )

costs one gather + one scatter per *element dof* (~30x fewer memory
transactions) and turns the arithmetic into a batched dense
(nc, nl, nl) x (nc, nl) contraction.  On the GPU the saddle-type
operators run all three stages in one kernel (ops/fused.py).

The element tensors are exactly the ones the assembly kernels already
produce (fem/assembly.py), so state-dependent rebuilds (eddy nu,
convection kappa_v) are a single einsum with no scatter at all.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
@dataclass
class ElementOperator:
    """y = scatter_rows( einsum(Ae, gather_cols(x)) ).

    Ae:       (nc, nl_r, nl_c) element matrices
    cd_rows:  (nc, nl_r) int32 global row dofs
    cd_cols:  (nc, nl_c) int32 global col dofs
    row_plan: VectorPlan for the row scatter (static)
    """

    Ae: jnp.ndarray
    cd_rows: jnp.ndarray
    cd_cols: jnp.ndarray
    row_plan: object  # VectorPlan (static aux data)

    def tree_flatten(self):
        return (self.Ae, self.cd_rows, self.cd_cols), self.row_plan

    @classmethod
    def tree_unflatten(cls, aux, children):
        Ae, cd_rows, cd_cols = children
        return cls(Ae=Ae, cd_rows=cd_rows, cd_cols=cd_cols, row_plan=aux)

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        x = jnp.asarray(x)
        xe = x[self.cd_cols]  # (nc, nl_c)
        ye = jnp.einsum("cij,cj->ci", self.Ae, xe)
        return self.row_plan.assemble(ye)

    def rmatvec(self, y: jnp.ndarray) -> jnp.ndarray:
        """Transpose apply (gather rows, scatter cols) -- requires a
        col plan; only valid for square operators with rows == cols."""
        ye = y[self.cd_rows]
        xe = jnp.einsum("cij,ci->cj", self.Ae, ye)
        return self.row_plan.assemble(xe)

    def diagonal(self) -> jnp.ndarray:
        """Valid when cd_rows == cd_cols (square element blocks)."""
        de = jnp.einsum("cii->ci", self.Ae)
        return self.row_plan.assemble(de)

    def with_elems(self, Ae: jnp.ndarray) -> "ElementOperator":
        return ElementOperator(Ae=Ae, cd_rows=self.cd_rows, cd_cols=self.cd_cols,
                               row_plan=self.row_plan)


@jax.tree_util.register_pytree_node_class
@dataclass
class SaddleOperator:
    """Element-local operator over the combined (u, p) vector with
    node-grouped velocity gathers.

    Velocity dofs are laid out node-major (dof = 3*node + comp), so
    gathering/scattering the velocity part as (n_nodes, 3) rows via
    scalar node ids uses 3x fewer indices than the flat path.

    cd_u: (nc, nlu) scalar velocity node ids
    cd_p: (nc, nlp) pressure dof ids (nlp may be 0)
    u_plan / p_plan: VectorPlans over cd_u (node ids) and cd_p
    n_u_nodes: velocity node count (static)

    The operator is stored as separate (uu, up, pu) blocks -- the
    zero pp block is never materialized, and avoiding the big
    concatenated (nc, NL, NL) tensor keeps the assembly graph simple
    (the fused concat form triggered pathological minutes-long XLA
    compiles at 58k cells) and saves ~20% memory.

    uu: (nc, 3*nlu, 3*nlu);  up: (nc, 3*nlu, nlp);  pu: (nc, nlp, 3*nlu)
    (up/pu may be None for velocity-only operators, e.g. the
    preconditioner's viscous block).  ``pp`` is an optional
    (nc, nlp, nlp) pressure-pressure block (zero for the plain saddle
    system; the Brezzi-Pitkaranta stabilization of the P1-P1 coarse
    system lives there).
    """

    uu: jnp.ndarray
    up: jnp.ndarray
    pu: jnp.ndarray
    cd_u: jnp.ndarray
    cd_p: jnp.ndarray
    u_plan: object
    p_plan: object
    n_u_nodes: int
    pp: jnp.ndarray = None

    def tree_flatten(self):
        return (self.uu, self.up, self.pu, self.cd_u, self.cd_p, self.pp), (
            self.u_plan, self.p_plan, self.n_u_nodes,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        uu, up, pu, cd_u, cd_p, pp = children
        return cls(uu=uu, up=up, pu=pu, cd_u=cd_u, cd_p=cd_p, pp=pp,
                   u_plan=aux[0], p_plan=aux[1], n_u_nodes=aux[2])

    @property
    def _nlu3(self):
        return 3 * self.cd_u.shape[1]

    def _gather_u(self, x):
        x = jnp.asarray(x)
        nu3 = 3 * self.n_u_nodes
        xu3 = x[:nu3].reshape(-1, 3)
        return xu3[self.cd_u].reshape(self.cd_u.shape[0], self._nlu3)

    def _gather_p(self, x):
        x = jnp.asarray(x)
        return x[3 * self.n_u_nodes:][self.cd_p]

    def _scatter_u(self, yu_e):
        return self.u_plan.assemble_rows(yu_e.reshape(-1, 3)).reshape(-1)

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        """On the GPU in float32 the fused kernel (ops/fused.py),
        elsewhere XLA's take path."""
        from .fused import fused_saddle_matvec, use_fused

        x = jnp.asarray(x)
        if not use_fused(jax.default_backend(), x.dtype):
            return self.take_matvec(x)
        return fused_saddle_matvec(
            self.uu, self.up, self.pu, self.pp, self.cd_u, self.cd_p, x,
            n_u=self.n_u_nodes, n_p=self.p_plan.ndof)

    def take_matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        """XLA take path: gather, batched einsum, sorted segment-sum."""
        xe_u = self._gather_u(x)
        yu_e = jnp.einsum("cij,cj->ci", self.uu, xe_u)
        if self.up is None:
            return self._scatter_u(yu_e)
        xe_p = self._gather_p(x)
        yu_e = yu_e + jnp.einsum("cij,cj->ci", self.up, xe_p)
        yp_e = jnp.einsum("cij,cj->ci", self.pu, xe_u)
        if self.pp is not None:
            yp_e = yp_e + jnp.einsum("cij,cj->ci", self.pp, xe_p)
        return jnp.concatenate([self._scatter_u(yu_e), self.p_plan.assemble(yp_e)])

    def diagonal(self) -> jnp.ndarray:
        du = self._scatter_u(jnp.einsum("cii->ci", self.uu))
        if self.up is None:
            return du
        if self.pp is not None:
            dp = self.p_plan.assemble(jnp.einsum("cii->ci", self.pp))
        else:
            dp = jnp.zeros(self.p_plan.ndof, du.dtype)
        return jnp.concatenate([du, dp])

    def up_matvec(self, p_vec: jnp.ndarray) -> jnp.ndarray:
        """Coupling block alone: velocity rows of [0, up; 0, 0] @ [0; p]
        (the pressure-gradient term).  Used by the block-triangular
        Stokes preconditioner."""
        xe_p = jnp.asarray(p_vec)[self.cd_p]
        yu_e = jnp.einsum("cij,cj->ci", self.up, xe_p)
        return self._scatter_u(yu_e)

    def with_elems(self, uu, up=None, pu=None) -> "SaddleOperator":
        return SaddleOperator(uu=uu, up=up if up is not None else self.up,
                              pu=pu if pu is not None else self.pu,
                              cd_u=self.cd_u, cd_p=self.cd_p,
                              u_plan=self.u_plan, p_plan=self.p_plan,
                              n_u_nodes=self.n_u_nodes)


# ----------------------------------------------------------------------
# Plain NumPy float64 references: per-cell dense products scattered
# with np.add.at, independent of the gather tables and sorted
# segment-sum plans above.  Tests and the on-device smoke check compare
# the operators with these.
# ----------------------------------------------------------------------
def element_matvec_reference(Ae, cd_rows, cd_cols, n_rows, x):
    """Reference of ``ElementOperator.matvec``."""
    Ae = np.asarray(Ae, np.float64)
    cd_rows = np.asarray(cd_rows)
    xe = np.asarray(x, np.float64)[np.asarray(cd_cols)]
    y = np.zeros(n_rows)
    np.add.at(y, cd_rows, np.einsum("cij,cj->ci", Ae, xe))
    return y


def saddle_matvec_reference(cd_u, cd_p, n_u_nodes, n_p, x, uu=None,
                            up=None, pu=None, pp=None):
    """Reference of ``SaddleOperator``: ``x`` is the combined
    (3*n_u_nodes + n_p) vector; blocks left as None are zero.  Returns
    the velocity rows alone when ``pu`` and ``pp`` are both None (as
    ``matvec`` of a velocity-only operator and ``up_matvec`` do), else
    the combined vector."""
    x = np.asarray(x, np.float64)
    cd_u, cd_p = np.asarray(cd_u), np.asarray(cd_p)
    nc = cd_u.shape[0]
    nu3 = 3 * n_u_nodes
    xe_u = x[:nu3].reshape(-1, 3)[cd_u].reshape(nc, -1)
    xe_p = x[nu3:][cd_p]
    f64 = lambda a: np.asarray(a, np.float64)
    yu_e = np.zeros((nc, 3 * cd_u.shape[1]))
    if uu is not None:
        yu_e += np.einsum("cij,cj->ci", f64(uu), xe_u)
    if up is not None:
        yu_e += np.einsum("cij,cj->ci", f64(up), xe_p)
    yu = np.zeros((n_u_nodes, 3))
    np.add.at(yu, cd_u, yu_e.reshape(nc, -1, 3))
    if pu is None and pp is None:
        return yu.reshape(-1)
    yp_e = np.zeros(cd_p.shape)
    if pu is not None:
        yp_e += np.einsum("cij,cj->ci", f64(pu), xe_u)
    if pp is not None:
        yp_e += np.einsum("cij,cj->ci", f64(pp), xe_p)
    yp = np.zeros(n_p)
    np.add.at(yp, cd_p, yp_e)
    return np.concatenate([yu.reshape(-1), yp])
