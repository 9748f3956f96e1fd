"""Assembly correctness: integral identities and exactness checks of
the element kernels + sparsity plans against analytic values."""

import jax.numpy as jnp
import numpy as np
import pytest

from nupgcm.fem import assembly as asm
from nupgcm.fem.spaces import ScalarSpace
from nupgcm.mesh.generators import box_mesh, rect_mesh
from nupgcm.models.fedata import FEData, Spaces
from nupgcm.ops.sparse import coo_from_plan


@pytest.fixture(scope="module", params=[2, 3])
def fe(request):
    if request.param == 2:
        mesh = rect_mesh(4, 3, x0=0, x1=2, z0=-1, z1=0)
    else:
        mesh = box_mesh(3, 2, 2, lo=(0, 0, -1), hi=(2, 1, 0))
    spaces = Spaces(mesh, b_diri_tags=[], b_diri_vals=[])
    return FEData(mesh, spaces)


def _grads_b(fe):
    return asm.physical_grads(
        jnp.asarray(fe.geom.invJT), jnp.asarray(fe.tab_b.dphi), jnp.asarray(fe.embed)
    )


def volume(fe):
    return 2.0 if fe.mesh.tdim == 3 else 2.0  # both domains have |Omega| = 2


def test_mass_matrix_integrals(fe):
    wq = jnp.asarray(fe.geom.wq)
    phi = jnp.asarray(fe.tab_b.phi)
    M = coo_from_plan(fe.plan_b, fe.plan_b.assemble(asm.elem_mass(wq, phi, phi)))
    ones = jnp.ones(fe.spaces.n_b)
    # 1^T M 1 = |Omega|
    assert abs(float(ones @ M.matvec(ones)) - volume(fe)) < 1e-12
    # 1^T M f = integral of f for quadratic f (P2-exact)
    bs = fe.spaces.b_space
    x = bs.dof_coords
    f = x[:, 0] ** 2  # integral over x in [0,2] (times unit extent) = 8/3
    assert abs(float(ones @ M.matvec(jnp.asarray(f))) - 8.0 / 3.0) < 1e-12
    # symmetry
    S = M.to_scipy()
    assert abs(S - S.T).max() < 1e-13


def test_stiffness_anisotropy(fe):
    """Kh annihilates z-functions, Kv annihilates x-functions, and
    f^T K f = integral |grad_sel f|^2 exactly for P2 f."""
    wq = jnp.asarray(fe.geom.wq)
    ones_q = jnp.ones_like(wq)
    G3 = _grads_b(fe)
    Kh = coo_from_plan(fe.plan_b, fe.plan_b.assemble(asm.elem_stiffness(wq, ones_q, G3, (0, 1))))
    Kv = coo_from_plan(fe.plan_b, fe.plan_b.assemble(asm.elem_stiffness(wq, ones_q, G3, (2,))))
    x = fe.spaces.b_space.dof_coords
    fx = jnp.asarray(x[:, 0] + 0.5 * x[:, 0] ** 2)  # d/dx = 1 + x
    fz = jnp.asarray(x[:, 2])
    assert float(jnp.abs(Kv.matvec(fx)).max()) < 1e-12
    assert float(jnp.abs(Kh.matvec(fz)).max()) < 1e-12
    # energy: int (1+x)^2 over x in [0,2] = [ (1+x)^3/3 ] = (27-1)/3 = 26/3
    assert abs(float(fx @ Kh.matvec(fx)) - 26.0 / 3.0) < 1e-11
    assert abs(float(fz @ Kv.matvec(fz)) - volume(fe)) < 1e-12


def test_advection_rhs_identity(fe):
    """With u = (1,0,0) and b = x: u.grad b = 1, so the BDF1 advection
    rhs equals M(b - dt*1) exactly (P2/quadrature-exact)."""
    wq = jnp.asarray(fe.geom.wq)
    phi_b = jnp.asarray(fe.tab_b.phi)
    phi_u = jnp.asarray(fe.tab_u.phi)
    G3 = _grads_b(fe)
    us, bs = fe.spaces.u_space, fe.spaces.b_space
    u = np.zeros((us.ndof, 3))
    u[:, 0] = 1.0
    b = bs.dof_coords[:, 0]
    cd_u = jnp.asarray(fe.cd_u)
    cd_b = jnp.asarray(fe.cd_b)
    dt = 0.37
    elem = asm.elem_advection_bdf1(
        wq, phi_b, G3, phi_u, jnp.asarray(u)[cd_u], jnp.asarray(b)[cd_b], 0.0, dt
    )
    rhs = fe.vec_plan_b.assemble(elem)
    M = coo_from_plan(fe.plan_b, fe.plan_b.assemble(asm.elem_mass(wq, phi_b, phi_b)))
    expect = M.matvec(jnp.asarray(b) - dt)
    assert float(jnp.abs(rhs - expect).max()) < 1e-12


def test_bdf2_advection_reduces_to_bdf1(fe):
    """With u_prev=u, b_prev=b and matching dt factors, BDF2 kernel's
    advective part equals BDF1's (first-step behavior)."""
    wq = jnp.asarray(fe.geom.wq)
    phi_b = jnp.asarray(fe.tab_b.phi)
    phi_u = jnp.asarray(fe.tab_u.phi)
    G3 = _grads_b(fe)
    us, bs = fe.spaces.u_space, fe.spaces.b_space
    rng = np.random.default_rng(0)
    u = rng.standard_normal((us.ndof, 3))
    b = rng.standard_normal(bs.ndof)
    cd_u = jnp.asarray(fe.cd_u)
    cd_b = jnp.asarray(fe.cd_b)
    ue, be = jnp.asarray(u)[cd_u], jnp.asarray(b)[cd_b]
    dt = 0.1
    r1 = asm.elem_advection_bdf1(wq, phi_b, G3, phi_u, ue, be, 1.3, dt)
    # BDF2 with identical history and dt' chosen so 2/3 dt' = dt, plus
    # mass terms matching: 4/3 b - 1/3 b = b
    r2 = asm.elem_advection_bdf2(wq, phi_b, G3, phi_u, ue, ue, be, be, 1.3, 1.5 * dt)
    assert float(jnp.abs(r1 - r2).max()) < 1e-12


def test_inversion_block_structure(fe):
    """Assembled saddle matrix: continuity block is -transpose of the
    pressure-gradient block; viscous block symmetric; Coriolis block
    antisymmetric in components."""
    wq = jnp.asarray(fe.geom.wq)
    Gu3 = asm.physical_grads(
        jnp.asarray(fe.geom.invJT), jnp.asarray(fe.tab_u.dphi), jnp.asarray(fe.embed)
    )
    fq = jnp.ones_like(wq) * 0.7
    nuq = jnp.ones_like(wq)
    elem = asm.elem_inversion(
        wq, nuq, fq, jnp.asarray(fe.tab_u.phi), Gu3, jnp.asarray(fe.tab_p.phi),
        jnp.asarray(0.25), False,
    )
    A = coo_from_plan(fe.plan_inv, fe.plan_inv.assemble(elem)).to_scipy().toarray()
    n_u = fe.spaces.n_u
    Auu = A[:n_u, :n_u]
    Aup = A[:n_u, n_u:]
    Apu = A[n_u:, :n_u]
    App = A[n_u:, n_u:]
    assert np.abs(Apu + Aup.T).max() < 1e-12
    assert np.abs(App).max() == 0.0
    # symmetric + antisymmetric split of Auu: antisym part = Coriolis
    sym = 0.5 * (Auu + Auu.T)
    anti = 0.5 * (Auu - Auu.T)
    # Coriolis couples components 0<->1 with mass weight 0.7
    # viscous part symmetric: check residual antisymmetry only in 0/1 blocks
    assert np.abs(anti).max() > 0
    # energy of a rigid motion u=(1,1,1) through viscous part = 0
    # (constant fields have zero gradient)
    uconst = np.ones(n_u)
    assert np.abs(sym @ uconst).max() < 1e-11


def test_b_matrix(fe):
    """B maps b to vertical momentum: (1/alpha) b zhat.v; a constant
    b against constant test w-component gives |Omega|/alpha."""
    wq = jnp.asarray(fe.geom.wq)
    inv_alpha = jnp.asarray(2.0)
    elem = asm.elem_buoyancy_to_velocity(
        wq, jnp.asarray(fe.tab_u.phi), jnp.asarray(fe.tab_b.phi), inv_alpha
    )
    B = coo_from_plan(fe.plan_B, fe.plan_B.assemble(elem))
    ones_b = jnp.ones(fe.spaces.n_b)
    y = np.asarray(B.matvec(ones_b))
    yw = y[: fe.spaces.n_u].reshape(-1, 3)
    assert np.abs(y[fe.spaces.n_u:]).max() == 0.0  # no pressure rows
    # x,y test components get nothing
    assert np.abs(yw[:, :2]).max() < 1e-14
    # sum over w rows = integral of 2*1*1 = 2 |Omega|
    assert abs(yw[:, 2].sum() - 2.0 * volume(fe)) < 1e-12
