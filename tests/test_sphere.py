"""End-to-end PG run on the sphere mesh (BASELINE.json configs[4];
reference meshes/mesh_sphere.jl:1-17 generates the geometry but no
reference script ever runs it -- this exercises the full model loop on
the rotating-ball configuration with f = z, the spherical analog of
the beta-plane Coriolis projection)."""

import numpy as np
import pytest

import nupgcm as npg


@pytest.fixture(scope="module")
def sphere_model():
    mesh = npg.generators.sphere_mesh(4)
    params = npg.Parameters(
        eps=0.2, alpha=1.0, mu_rho=1.0, N2=1.0,
        f=lambda x: x[2],        # rotation-axis projection
        H=lambda x: 1.0,
    )
    forc = npg.Forcings(nu=1.0, kappa_h=1e-2, kappa_v=1e-2,
                        tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0))
    spaces = npg.Spaces(
        mesh,
        u_diri_tags=["boundary"], u_diri_vals=[(0, 0, 0)],
        u_diri_masks=[(True, True, True)],
        b_diri_tags=["surface"], b_diri_vals=[0.0],
    )
    fe = npg.FEData(mesh, spaces)
    ts = npg.BDF2(t_start=0, t_stop=1e9, dt=1e-3)
    return npg.PGModel(fe, params, forc, ts)


def test_sphere_mesh_geometry():
    mesh = npg.generators.sphere_mesh(4)
    r = np.linalg.norm(mesh.coords, axis=1)
    # all nodes inside the unit ball, boundary nodes on it
    assert r.max() <= 1.0 + 1e-12
    bnodes = np.unique(mesh.tagged["boundary"][2])
    assert np.allclose(r[bnodes], 1.0, atol=1e-12)
    # positive total volume ~ 4/3 pi (cube-to-ball map distorts cells
    # but keeps orientation)
    from nupgcm.mesh.quality import volumes

    vol = volumes(mesh.coords, mesh.cells).sum()
    assert abs(vol - 4.0 / 3.0 * np.pi) / (4.0 / 3.0 * np.pi) < 0.05


def test_sphere_run_stability(sphere_model):
    """10 BDF2 steps of a buoyant blob in the rotating ball: stable,
    max-principle-respecting b, converged solves."""
    m = sphere_model
    b0 = lambda x: 0.1 * np.exp(
        -((x[0] - 0.3) ** 2 + x[1] ** 2 + x[2] ** 2) / 0.1)
    st = m.set_b(m.rest_state(), b0)
    st = m.run(st, n_info=0, max_steps=10)
    u = np.asarray(st.u)
    b = np.asarray(st.b)
    assert np.isfinite(u).all() and np.isfinite(b).all()
    # diffusion + advection with b=0 boundary: max principle up to
    # small overshoot from the explicit advection term
    assert b.min() > -1e-3 and b.max() < 0.11
    assert 1e-4 < np.abs(u).max() < 1.0


def test_sphere_inversion_rotational_structure():
    """With f = z and an axisymmetric buoyancy, lowering the Ekman
    number strengthens the azimuthal (thermal-wind) flow relative to
    the meridional overturning -- the rotating-ball analog of
    geostrophic adjustment.  Checks the ratio is monotone in eps."""

    def az_ratio(eps):
        mesh = npg.generators.sphere_mesh(4)
        params = npg.Parameters(eps=eps, alpha=1.0, mu_rho=1.0, N2=1.0,
                                f=lambda x: x[2], H=lambda x: 1.0)
        forc = npg.Forcings(nu=1.0, kappa_h=1e-2, kappa_v=1e-2,
                            tau_x=0.0, tau_y=0.0,
                            b_surface_bc=npg.SurfaceDirichletBC(0.0))
        spaces = npg.Spaces(
            mesh, u_diri_tags=["boundary"], u_diri_vals=[(0, 0, 0)],
            u_diri_masks=[(True, True, True)],
            b_diri_tags=["surface"], b_diri_vals=[0.0])
        fe = npg.FEData(mesh, spaces)
        m = npg.PGModel(fe, params, forc,
                        npg.BDF2(t_start=0, t_stop=1e9, dt=1e-3))
        st = m.set_b(m.rest_state(),
                     lambda x: 0.1 * np.exp(-(x[0] ** 2 + x[1] ** 2) / 0.2))
        u, p, aux = m.invert_jit(m.ops, st)
        u = np.asarray(u)
        xy = np.asarray(m.fe.spaces.u_space.dof_coords)[:, :2]
        rho = np.linalg.norm(xy, axis=1)
        sel = rho > 0.3
        az = np.stack([-xy[:, 1], xy[:, 0]], axis=1) / np.maximum(
            rho, 1e-12)[:, None]
        u_az = (u[:, :2] * az).sum(axis=1)
        u_mer = np.linalg.norm(u[:, :2] - u_az[:, None] * az, axis=1)
        return float((u_az[sel] ** 2).sum() / (u_mer[sel] ** 2).sum())

    weak, strong = az_ratio(0.5), az_ratio(0.05)
    assert strong > 2.0 * weak
