"""Multi-device sharding of the PG model (SPMD over a jax Mesh).

The reference is single-device only (SURVEY.md §2.3: one GPU, host
copies).  Here the scientific-computing analogs of DP/SP are first-
class:

  * **nnz / element sharding (this module)**: the Krylov hot loop's
    SpMV and the element-batched assemblies are sharded over a 1D
    device mesh along the nonzero / cell axes; state vectors stay
    replicated and XLA/GSPMD inserts the ``psum`` reductions after
    each segmented scatter.  Collectives run device to device; the host
    is never in the loop.  This is the "pick a mesh, annotate shardings, let XLA
    insert collectives" recipe.
  * **sharded-state domain decomposition (parallel/dd.py)**: the
    production path at scale -- partitioned state, owned/ghost dof
    blocks, ``ppermute`` halo exchange inside every matvec, psum'd
    Krylov reductions, replicated coarse correction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "dd"  # domain-decomposition axis


def make_device_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (AXIS,))


def shard_model(model, mesh: Mesh):
    """Reshard a PGModel's operator data over the device mesh.

    Operator nnz vectors and element-batched constants are sharded
    along their leading axis; state and small tables stay replicated.
    Returns the model (modified in place) -- its jitted functions are
    re-traced on next call with the new shardings, and GSPMD
    partitions the step accordingly.
    """
    repl = NamedSharding(mesh, P())
    sh0 = NamedSharding(mesh, P(AXIS))

    def put(x, sharding):
        return jax.device_put(x, sharding)

    # element-batched constants (leading axis = cells)
    for k in ("wq", "invJT", "f_q", "nu_q", "kh_q", "kv_q", "h_cells", "cd_u", "cd_b"):
        if k in model.const:
            model.const[k] = put(model.const[k], sh0)
    if "f_eddy_q" in model.const:
        model.const["f_eddy_q"] = put(model.const["f_eddy_q"], sh0)
    # replicated small tables + masks
    for k in ("embed", "phi_u", "dphi_u", "phi_p", "dphi_p", "phi_b", "dphi_b",
              "free_u", "udiri", "free_b", "bdiri", "free_inv", "xdiri_inv",
              "wq_surf", "phi_u_surf", "phi_b_surf", "taux_q", "tauy_q",
              "tg_parents", "tg_weights", "tg_coarse_free"):
        if k in model.const:
            model.const[k] = put(model.const[k], repl)

    # element operator tensors: shard along the cell axis
    for k in ("A_uu_e", "A_up_e", "A_pu_e", "B_e", "M_e", "Kh_e", "Kv_e",
              "visc_e", "Mp_e", "coarse_e"):
        if k in model.ops:
            model.ops[k] = put(model.ops[k], sh0)
    for k in ("s", "rhs_diff", "rhs_flux", "p_volw", "coarse_inv"):
        if k in model.ops:
            model.ops[k] = put(model.ops[k], repl)
    model.mesh_devices = mesh
    # re-create the jit wrappers so fresh traces capture the new
    # shardings (previously traced closures baked the old placements)
    model._build_functions()
    return model


def replicate_state(state, mesh: Mesh):
    repl = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, repl), state)
