"""Device sparse-matrix containers and SpMV.

The Krylov hot loop of the reference runs on CUSPARSE CSR matvecs
(reference ext/nuPGCMCUDAExt.jl:27); here the equivalent is a sorted
COO (CSR-ordered) container whose SpMV is a gather + multiply +
row-segmented sum -- XLA lowers this to device gathers and a
segmented reduction.  The value vector is a plain jnp array, so
operators can be rebuilt on device (eddy viscosity, convection) by
swapping ``vals`` without touching the static index structure.

An ELL (padded fixed-width row) variant is provided for the
bandwidth-bound SpMV after RCM ordering.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
@dataclass
class COOMatrix:
    """Sorted-COO sparse matrix (row-major order)."""

    rows: jnp.ndarray  # (nnz,) int32, sorted
    cols: jnp.ndarray  # (nnz,) int32
    vals: jnp.ndarray  # (nnz,) float
    shape: tuple  # (n_rows, n_cols) -- static

    def tree_flatten(self):
        return (self.rows, self.cols, self.vals), self.shape

    @classmethod
    def tree_unflatten(cls, aux, children):
        rows, cols, vals = children
        return cls(rows=rows, cols=cols, vals=vals, shape=aux)

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        prod = self.vals * x[self.cols]
        return jax.ops.segment_sum(
            prod, self.rows, num_segments=self.shape[0], indices_are_sorted=True
        )

    def diagonal(self) -> jnp.ndarray:
        d = jnp.where(self.rows == self.cols, self.vals, 0.0)
        return jax.ops.segment_sum(
            d, self.rows, num_segments=self.shape[0], indices_are_sorted=True
        )

    def with_vals(self, vals: jnp.ndarray) -> "COOMatrix":
        return COOMatrix(rows=self.rows, cols=self.cols, vals=vals, shape=self.shape)

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (np.asarray(self.vals), (np.asarray(self.rows), np.asarray(self.cols))),
            shape=self.shape,
        )


def coo_from_plan(plan, vals: jnp.ndarray) -> COOMatrix:
    """Bind assembled nnz values to a MatrixPlan's static structure."""
    return COOMatrix(
        rows=jnp.asarray(plan.rows), cols=jnp.asarray(plan.cols),
        vals=vals, shape=(plan.n_rows, plan.n_cols),
    )


@jax.tree_util.register_pytree_node_class
@dataclass
class ELLMatrix:
    """Fixed-width padded rows: cols/vals (n_rows, width).

    Padding entries point at column 0 with value 0.  SpMV is a pure
    2D gather + row reduction -- no scatter.
    """

    cols: jnp.ndarray  # (n, w) int32
    vals: jnp.ndarray  # (n, w)
    shape: tuple

    def tree_flatten(self):
        return (self.cols, self.vals), self.shape

    @classmethod
    def tree_unflatten(cls, aux, children):
        cols, vals = children
        return cls(cols=cols, vals=vals, shape=aux)

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        return jnp.einsum("nw,nw->n", self.vals, x[self.cols])

    def diagonal(self) -> jnp.ndarray:
        n = self.shape[0]
        row = jnp.arange(n, dtype=self.cols.dtype)[:, None]
        return jnp.where(self.cols == row, self.vals, 0.0).sum(axis=1)


def ell_from_coo(rows: np.ndarray, cols: np.ndarray, nnz_slots_to_ell=None,
                 n_rows: int = None):
    """Host: build the static ELL layout for a sorted-COO structure.

    Returns (ell_cols (n, w) int32, slot_map (nnz,) int32) where
    ``vals_ell.ravel()[slot_map[k]] = coo_vals[k]`` fills the values.
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    n = n_rows if n_rows is not None else int(rows.max()) + 1
    counts = np.bincount(rows, minlength=n)
    w = int(counts.max())
    ell_cols = np.zeros((n, w), dtype=np.int32)
    slot_map = np.empty(len(rows), dtype=np.int64)
    # rows sorted: position within row = running index
    starts = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(len(rows)) - starts[rows]
    slot_map = rows.astype(np.int64) * w + pos
    ell_cols.reshape(-1)[slot_map] = cols
    return ell_cols, slot_map.astype(np.int32), w


class MaskedOperator:
    """Dirichlet-pinned linear operator over full dof vectors.

    op(x) = A x on free dofs, identity on constrained dofs.  This keeps
    static shapes (no free-dof compaction) while being mathematically
    the reference's free-dof system + lift (src/evolution.jl:256-260).
    """

    def __init__(self, mat, free_mask: jnp.ndarray):
        self.mat = mat
        self.free = free_mask  # float (0/1) or bool

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        x = jnp.asarray(x)
        f = jnp.asarray(self.free)
        y = self.mat.matvec(x * f)
        return jnp.where(f.astype(bool), y, x)

    def diagonal(self) -> jnp.ndarray:
        d = self.mat.diagonal()
        return jnp.where(self.free.astype(bool), d, 1.0)
