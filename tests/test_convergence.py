"""Spatial convergence of the inversion (manufactured solution).

Automates the reference's constructed-problem convergence study
(reference scratch/convergence.jl:101-157 ``constructed_problem_rhs``
/ ``compute_error``): inject an analytic strong-form forcing into the
rotating-Stokes saddle system and measure the H1 (energy-norm)
velocity error and L2 pressure error against the exact solution.
Expected orders for P2-P1 Taylor-Hood (reference
docs/src/model_formulation/numerical_approach.md:110-122): O(h^2) in
the energy norm.
"""

import numpy as np
import jax.numpy as jnp
import nupgcm as npg
from nupgcm.fem import assembly as asm

F0 = 1.0  # constant Coriolis
A2E2 = 1.0  # alpha^2 eps^2 with eps = alpha = 1


# bubble factor G(x) = x^2 (1-x)^2 and derivatives
def G(x):
    return x ** 2 * (1 - x) ** 2


def Gp(x):
    return 2 * x * (1 - x) * (1 - 2 * x)


def Gpp(x):
    return 2 * (1 - 6 * x + 6 * x ** 2)


def Gppp(x):
    return 12 * (2 * x - 1)


# exact solution on the unit square (x, z): streamfunction
# psi = G(x) G(z) => u = d_z psi, w = -d_x psi (div-free, zero on the
# whole boundary incl. gradients); v = G(x) G(z); p = cos(pi x) cos(pi z)
def exact(x, z):
    u = G(x) * Gp(z)
    v = G(x) * G(z)
    w = -Gp(x) * G(z)
    return u, v, w


def exact_grads(x, z):
    # rows: (du/dx, du/dz), (dv/dx, dv/dz), (dw/dx, dw/dz)
    return (
        (Gp(x) * Gp(z), G(x) * Gpp(z)),
        (Gp(x) * G(z), G(x) * Gp(z)),
        (-Gpp(x) * G(z), -Gp(x) * Gp(z)),
    )


def forcing(x, z):
    """Strong-form momentum residual of the exact solution:
    F = f zxu + grad p - a2e2 lap(u) (y-invariant 2D form)."""
    u, v, w = exact(x, z)
    dpx = -np.pi * np.sin(np.pi * x) * np.cos(np.pi * z)
    dpz = -np.pi * np.cos(np.pi * x) * np.sin(np.pi * z)
    lap_u = Gpp(x) * Gp(z) + G(x) * Gppp(z)
    lap_v = Gpp(x) * G(z) + G(x) * Gpp(z)
    lap_w = -(Gppp(x) * G(z) + Gp(x) * Gpp(z))
    F1 = -F0 * v + dpx - A2E2 * lap_u
    F2 = F0 * u - A2E2 * lap_v
    F3 = dpz - A2E2 * lap_w
    return F1, F2, F3


def solve_one(n):
    mesh = npg.generators.rect_mesh(n, n)
    params = npg.Parameters(eps=1.0, alpha=1.0, mu_rho=1.0, N2=0.0,
                            f=lambda x: F0 + 0 * x[0], H=lambda x: 1.0)
    forc = npg.Forcings(nu=1.0, kappa_h=1.0, kappa_v=1.0, tau_x=0.0,
                        tau_y=0.0, b_surface_bc=npg.SurfaceDirichletBC(0.0))
    spaces = npg.Spaces(mesh, u_diri_tags=["boundary"],
                        u_diri_masks=[(True, True, True)],
                        b_diri_tags=[], b_diri_vals=[])
    fe = npg.FEData(mesh, spaces)
    ts = npg.BDF2(t_start=0, t_stop=1, dt=1e-2)
    model = npg.PGModel(fe, params, forc, ts, inv_atol=1e-13, inv_rtol=1e-13)

    wq = np.asarray(fe.geom.wq)          # (nc, nq) zero on padded cells
    xq = np.asarray(fe.geom.xq)          # (nc, nq, 3)
    phi_u = np.asarray(fe.tab_u.phi)     # (nq, nn_u)
    x, z = xq[..., 0], xq[..., 2]

    # rhs_u[(c, 3i+a)] = sum_q wq phi_i(x_q) F_a(x_q)
    F = np.stack(forcing(x, z), axis=-1)                    # (nc, nq, 3)
    elem_u = np.einsum("cq,qi,cqa->cia", wq, phi_u, F)
    elem_u = elem_u.reshape(len(wq), -1)                    # (nc, 3*nn)
    rhs_u = fe.vec_plan_u3.assemble(jnp.asarray(elem_u, model.dtype))
    y_full = jnp.concatenate([rhs_u, jnp.zeros(spaces.n_p, model.dtype)])

    u, p, stats = model.solve_inversion(y_full)
    assert float(stats.residual) < 1e-8

    # H1 velocity error + L2 pressure error by quadrature
    u_e = np.asarray(u)[fe.cd_u]                            # (nc, nn, 3)
    uh_q = np.einsum("qi,cia->cqa", phi_u, u_e)
    Gu3 = np.asarray(asm.physical_grads(
        jnp.asarray(fe.geom.invJT, model.dtype),
        jnp.asarray(fe.tab_u.dphi, model.dtype),
        jnp.asarray(fe.embed, model.dtype)))                # (nc, nq, nn, 3)
    guh_q = np.einsum("cqid,cia->cqad", Gu3, u_e)
    u0 = np.stack(exact(x, z), axis=-1)
    g0 = exact_grads(x, z)
    gu0 = np.zeros_like(guh_q)
    for a in range(3):
        gu0[..., a, 0] = g0[a][0]
        gu0[..., a, 2] = g0[a][1]
    err2 = ((uh_q - u0) ** 2).sum(-1) + ((guh_q - gu0) ** 2).sum((-1, -2))
    u_h1 = float(np.sqrt((wq * err2).sum()))

    phi_p = np.asarray(fe.tab_p.phi)
    ph_q = np.einsum("qi,ci->cq", phi_p, np.asarray(p)[fe.cd_p])
    p0_q = np.cos(np.pi * x) * np.cos(np.pi * z)
    p_l2 = float(np.sqrt((wq * (ph_q - p0_q) ** 2).sum()))
    return u_h1, p_l2


def test_inversion_spatial_convergence_order():
    """Energy-norm (H1) velocity error order >= 1.9 over 3 refinements
    (reference docs/.../numerical_approach.md:110-118)."""
    errs = np.array([solve_one(n) for n in (4, 8, 16)])
    u_orders = np.log2(errs[:-1, 0] / errs[1:, 0])
    p_orders = np.log2(errs[:-1, 1] / errs[1:, 1])
    assert np.all(u_orders >= 1.9), (errs[:, 0], u_orders)
    # P1 pressure L2: O(h^2) as well
    assert np.all(p_orders >= 1.7), (errs[:, 1], p_orders)
