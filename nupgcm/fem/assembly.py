"""Element-batched FEM assembly: static plans (host) + jitted kernels.

Accelerator-first re-design of the reference's Gridap ``assemble_matrix`` /
``assemble_vector`` layer (reference src/inversion.jl:121-249,
src/evolution.jl:199-296).  Instead of lazy cell arrays and sparse CSC
insertion we use:

  * a **static sparsity plan** computed once on host: every element
    matrix entry (cell, i, j) maps to a slot in a sorted-COO nnz
    vector; assembly on device is one batched einsum producing the
    element tensors plus one sorted ``segment_sum`` scatter -- fully
    jittable, so operators that depend on the evolving state
    (convection kappa_v, eddy nu: reference src/model.jl:160-170,
    229-246) are rebuilt *on device inside the step* with zero host
    round-trips.
  * element tensors contracted with quadrature tables via einsum --
    XLA fuses these into batched contractions.

All kernels are dtype-polymorphic; tables are baked in as constants.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


# ----------------------------------------------------------------------
# static plans
# ----------------------------------------------------------------------

def _digest(*arrays) -> bytes:
    """Stable content digest so plans hash identically across
    processes -- they ride in jit pytree aux data, and id()-based
    hashing would defeat the persistent compilation cache."""
    import hashlib

    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.digest()


@dataclass(frozen=True)
class MatrixPlan:
    """Maps flattened element-matrix entries to sorted-COO slots."""

    n_rows: int
    n_cols: int
    nnz: int
    rows: np.ndarray  # (nnz,) int32, sorted (row-major)
    cols: np.ndarray  # (nnz,) int32
    gather_perm: np.ndarray  # (n_entries,) int32: sort order of entries
    slot_sorted: np.ndarray  # (n_entries,) int32: slot of each sorted entry

    def __hash__(self):
        if not hasattr(self, "_hash"):
            object.__setattr__(self, "_hash", hash(
                (self.n_rows, self.n_cols, self.nnz,
                 _digest(self.rows, self.cols, self.gather_perm,
                         self.slot_sorted))
            ))
        return self._hash

    def __eq__(self, other):
        return (
            isinstance(other, MatrixPlan)
            and (self.n_rows, self.n_cols, self.nnz)
            == (other.n_rows, other.n_cols, other.nnz)
            and hash(self) == hash(other)
        )

    def assemble(self, elem_vals: jnp.ndarray) -> jnp.ndarray:
        """Device: element tensors (nc, nl_r, nl_c) -> nnz values."""
        v = elem_vals.reshape(-1)[self.gather_perm]
        return jax.ops.segment_sum(
            v, jnp.asarray(self.slot_sorted), num_segments=self.nnz,
            indices_are_sorted=True,
        )


def build_matrix_plan(row_dofs: np.ndarray, col_dofs: np.ndarray,
                      n_rows: int, n_cols: int, pad_nnz_to: int = 1) -> MatrixPlan:
    """row_dofs (nc, nl_r), col_dofs (nc, nl_c): one entry per (c,i,j).

    ``pad_nnz_to``: pad the nnz count to a multiple (dummy trailing
    entries at (n_rows-1, n_cols-1) with permanently-zero values) so
    the value vector can be sharded evenly across devices.
    """
    nc, nlr = row_dofs.shape
    nlc = col_dofs.shape[1]
    r = np.repeat(row_dofs[:, :, None], nlc, axis=2).reshape(-1)
    c = np.repeat(col_dofs[:, None, :], nlr, axis=1).reshape(-1)
    key = r.astype(np.int64) * np.int64(n_cols) + c
    uniq, inv = np.unique(key, return_inverse=True)
    gather_perm = np.argsort(inv, kind="stable").astype(np.int32)
    slot_sorted = inv[gather_perm].astype(np.int32)
    rows = (uniq // n_cols).astype(np.int32)
    cols = (uniq % n_cols).astype(np.int32)
    pad = (-len(uniq)) % pad_nnz_to
    if pad:
        rows = np.concatenate([rows, np.full(pad, n_rows - 1, np.int32)])
        cols = np.concatenate([cols, np.full(pad, n_cols - 1, np.int32)])
    return MatrixPlan(
        n_rows=n_rows, n_cols=n_cols, nnz=len(uniq) + pad,
        rows=rows, cols=cols, gather_perm=gather_perm, slot_sorted=slot_sorted,
    )


@dataclass(frozen=True)
class VectorPlan:
    """Maps flattened element-vector entries to dof slots."""

    ndof: int
    gather_perm: np.ndarray  # (n_entries,) int32
    dof_sorted: np.ndarray  # (n_entries,) int32 (sorted)

    def __hash__(self):
        if not hasattr(self, "_hash"):
            object.__setattr__(self, "_hash", hash(
                (self.ndof, _digest(self.gather_perm, self.dof_sorted))
            ))
        return self._hash

    def __eq__(self, other):
        return (
            isinstance(other, VectorPlan)
            and self.ndof == other.ndof
            and hash(self) == hash(other)
        )

    def assemble(self, elem_vals: jnp.ndarray) -> jnp.ndarray:
        v = elem_vals.reshape(-1)[self.gather_perm]
        return jax.ops.segment_sum(
            v, jnp.asarray(self.dof_sorted), num_segments=self.ndof,
            indices_are_sorted=True,
        )

    def assemble_rows(self, row_vals: jnp.ndarray) -> jnp.ndarray:
        """Scatter (n_entries, k) rows -> (ndof, k): one index per row
        of k values (used for node-grouped 3-vector scatters)."""
        v = row_vals.reshape(-1, row_vals.shape[-1])[self.gather_perm]
        return jax.ops.segment_sum(
            v, jnp.asarray(self.dof_sorted), num_segments=self.ndof,
            indices_are_sorted=True,
        )


def build_vector_plan(dofs: np.ndarray, ndof: int) -> VectorPlan:
    flat = dofs.reshape(-1)
    gather_perm = np.argsort(flat, kind="stable").astype(np.int32)
    return VectorPlan(
        ndof=ndof, gather_perm=gather_perm,
        dof_sorted=flat[gather_perm].astype(np.int32),
    )


# ----------------------------------------------------------------------
# device-side gradient tables
# ----------------------------------------------------------------------

def physical_grads(invJT: jnp.ndarray, dphi: jnp.ndarray, embed: jnp.ndarray) -> jnp.ndarray:
    """Physical gradients embedded in 3D.

    invJT (nc, tdim, tdim), dphi (nq, nl, tdim) reference grads,
    embed (tdim, 3) plane->3D axis embedding.
    Returns G3 (nc, nq, nl, 3); the y-column is zero for 2D meshes.
    """
    gp = jnp.einsum("cpr,qir->cqip", invJT, dphi)  # plane components
    return jnp.einsum("cqip,pd->cqid", gp, embed)


# ----------------------------------------------------------------------
# element kernels (volume)
# ----------------------------------------------------------------------

def elem_mass(wq, phi_r, phi_c):
    """M_e[c,i,j] = sum_q w phi_r_i phi_c_j  (reference build_M,
    src/evolution.jl:209-212)."""
    return jnp.einsum("cq,qi,qj->cij", wq, phi_r, phi_c)


def elem_weighted_mass(wq, coeff_q, phi_r, phi_c):
    return jnp.einsum("cq,cq,qi,qj->cij", wq, coeff_q, phi_r, phi_c)


def elem_stiffness(wq, coeff_q, G3, axes):
    """K_e[c,i,j] = sum_q w k sum_{d in axes} dG_i dG_j.

    axes = (0, 1) gives the horizontal stiffness K_h, axes = (2,) the
    vertical K_v (reference src/evolution.jl:224-246).
    """
    Gs = G3[..., list(axes)]
    return jnp.einsum("cq,cq,cqid,cqjd->cij", wq, coeff_q, Gs, Gs)


def elem_rhs_diff(wq, coeff_q, G3, N2):
    """rhs_diff_e[c,i] = sum_q w (-N^2 k) dz(phi_i)
    (reference build_rhs_diff, src/evolution.jl:269-278)."""
    return -N2 * jnp.einsum("cq,cq,cqi->ci", wq, coeff_q, G3[..., 2])


def elem_inversion_blocks(wq, nu_q, f_q, phi_u, Gu3, phi_p, a2e2,
                          variable_nu: bool):
    """Saddle element blocks (uu, up, pu) -- see elem_inversion for the
    forms.  Blocks stay separate: the zero pp block is never built and
    no big concatenated tensor is materialized."""
    nc, nq = wq.shape
    nlu = phi_u.shape[1]
    nlp = phi_p.shape[1]
    dt = wq.dtype
    eye3 = jnp.eye(3, dtype=dt)

    lap = jnp.einsum("cq,cq,cqid,cqjd->cji", wq, nu_q, Gu3, Gu3)
    visc = a2e2 * jnp.einsum("cji,ba->cjbia", lap, eye3)
    if variable_nu:
        visc = visc + a2e2 * jnp.einsum("cq,cq,cqib,cqja->cjbia", wq, nu_q, Gu3, Gu3)
    mf = jnp.einsum("cq,cq,qj,qi->cji", wq, f_q, phi_u, phi_u)
    C = jnp.zeros((3, 3), dtype=dt).at[1, 0].set(1.0).at[0, 1].set(-1.0)
    uu = (visc + jnp.einsum("cji,ba->cjbia", mf, C)).reshape(nc, 3 * nlu, 3 * nlu)
    up = -jnp.einsum("cq,cqjb,qk->cjbk", wq, Gu3, phi_p).reshape(nc, 3 * nlu, nlp)
    pu = jnp.einsum("cq,qk,cqia->ckia", wq, phi_p, Gu3).reshape(nc, nlp, 3 * nlu)
    return uu, up, pu


def elem_inversion(wq, nu_q, f_q, phi_u, Gu3, phi_p, a2e2, variable_nu: bool):
    """Full inversion element matrix over the combined (u, p) space.

    Local combined index: velocity node i, component a -> 3*i + a;
    pressure node k -> 3*nlu + k.  Entry order elem[c, test, trial].

    Forms (reference bilinear_form, src/inversion.jl:172-192):
      constant nu:  a2e2 * nu * grad(u) : grad(v)
      variable nu:  2 a2e2 * nu * sym_grad(u) : sym_grad(v)
                    = a2e2 * nu * (delta_ab grad_i.grad_j + d_b phi_i d_a phi_j)
      - (div v) p + q (div u) + f (zhat x u).v
    """
    nc, nq = wq.shape
    nlu = phi_u.shape[1]
    nlp = phi_p.shape[1]
    dt = wq.dtype
    eye3 = jnp.eye(3, dtype=dt)

    lap = jnp.einsum("cq,cq,cqid,cqjd->cji", wq, nu_q, Gu3, Gu3)  # test j, trial i
    visc = a2e2 * jnp.einsum("cji,ba->cjbia", lap, eye3)
    if variable_nu:
        visc = visc + a2e2 * jnp.einsum("cq,cq,cqib,cqja->cjbia", wq, nu_q, Gu3, Gu3)

    # Coriolis: f (zhat x u).v = f (u_x v_y - u_y v_x)
    mf = jnp.einsum("cq,cq,qj,qi->cji", wq, f_q, phi_u, phi_u)
    C = jnp.zeros((3, 3), dtype=dt).at[1, 0].set(1.0).at[0, 1].set(-1.0)
    cor = jnp.einsum("cji,ba->cjbia", mf, C)

    uu = (visc + cor).reshape(nc, 3 * nlu, 3 * nlu)

    # pressure gradient: -(div v) p  -> test (j,b), trial k
    up = -jnp.einsum("cq,cqjb,qk->cjbk", wq, Gu3, phi_p).reshape(nc, 3 * nlu, nlp)
    # continuity: q (div u) -> test k, trial (i,a)
    pu = jnp.einsum("cq,qk,cqia->ckia", wq, phi_p, Gu3).reshape(nc, nlp, 3 * nlu)

    pp = jnp.zeros((nc, nlp, nlp), dtype=dt)
    top = jnp.concatenate([uu, up], axis=2)
    bot = jnp.concatenate([pu, pp], axis=2)
    return jnp.concatenate([top, bot], axis=1)


def elem_buoyancy_to_velocity(wq, phi_u, phi_b, inv_alpha):
    """B element tensor: (1/alpha) b (zhat . v)
    (reference build_B_inversion, src/inversion.jl:199-218).

    Returns (nc, 3*nlu, nlb) with only w-component rows nonzero.
    """
    nc = wq.shape[0]
    nlu = phi_u.shape[1]
    nlb = phi_b.shape[1]
    bw = inv_alpha * jnp.einsum("cq,qj,qk->cjk", wq, phi_u, phi_b)
    out = jnp.zeros((nc, nlu, 3, nlb), dtype=wq.dtype)
    out = out.at[:, :, 2, :].set(bw)
    return out.reshape(nc, 3 * nlu, nlb)


# ----------------------------------------------------------------------
# element kernels (surface)
# ----------------------------------------------------------------------

def elem_wind_rhs(wq_f, taux_q, tauy_q, phi_uf, alpha):
    """Wind-stress surface rhs: alpha (taux x + tauy y).v dGamma
    (reference build_b_inversion, src/inversion.jl:242).

    Returns (nf, nlu_f, 3): nonzero x/y components.
    """
    nf, _ = wq_f.shape
    nl = phi_uf.shape[1]
    rx = alpha * jnp.einsum("cq,cq,qi->ci", wq_f, taux_q, phi_uf)
    ry = alpha * jnp.einsum("cq,cq,qi->ci", wq_f, tauy_q, phi_uf)
    out = jnp.zeros((nf, nl, 3), dtype=wq_f.dtype)
    out = out.at[:, :, 0].set(rx)
    out = out.at[:, :, 1].set(ry)
    return out


def elem_flux_rhs(wq_f, flux_q, phi_bf, alpha):
    """Surface buoyancy-flux rhs: alpha F d dGamma
    (reference build_rhs_flux, src/evolution.jl:283-292)."""
    return alpha * jnp.einsum("cq,cq,qi->ci", wq_f, flux_q, phi_bf)


# ----------------------------------------------------------------------
# advection right-hand side (the per-step hot assembly)
# ----------------------------------------------------------------------

def elem_advection_bdf1(wq, phi_b, Gb3, phi_u, u_e, b_e, N2, dt):
    """BDF1 advection rhs: (b - dt (u.grad b + w N^2)) d
    (reference advection_lform, src/model.jl:292-295).

    u_e (nc, nlu, 3) and b_e (nc, nlb) are gathered element dofs.
    """
    u_q = jnp.einsum("qi,cia->cqa", phi_u, u_e)
    b_q = jnp.einsum("qi,ci->cq", phi_b, b_e)
    gb_q = jnp.einsum("cqid,ci->cqd", Gb3, b_e)
    adv = jnp.einsum("cqa,cqa->cq", u_q, gb_q) + u_q[..., 2] * N2
    integ = b_q - dt * adv
    return jnp.einsum("cq,qi,cq->ci", wq, phi_b, integ)


def elem_advection_bdf2(wq, phi_b, Gb3, phi_u, u_e, u_prev_e, b_e, b_prev_e, N2, dt):
    """BDF2 advection rhs:
    (4/3 b - 1/3 b_prev - 2/3 dt ((2u - u_prev).grad(2b - b_prev)
                                  + (2w - w_prev) N^2)) d
    (reference advection_lform, src/model.jl:297-300)."""
    ue = 2.0 * u_e - u_prev_e
    be = 2.0 * b_e - b_prev_e
    u_q = jnp.einsum("qi,cia->cqa", phi_u, ue)
    gb_q = jnp.einsum("cqid,ci->cqd", Gb3, be)
    adv = jnp.einsum("cqa,cqa->cq", u_q, gb_q) + u_q[..., 2] * N2
    b_q = jnp.einsum("qi,ci->cq", phi_b, b_e)
    bp_q = jnp.einsum("qi,ci->cq", phi_b, b_prev_e)
    integ = 4.0 / 3.0 * b_q - 1.0 / 3.0 * bp_q - 2.0 / 3.0 * dt * adv
    return jnp.einsum("cq,qi,cq->ci", wq, phi_b, integ)
