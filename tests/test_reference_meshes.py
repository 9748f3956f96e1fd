"""Optional end-to-end runs on the reference's shipped gmsh meshes
(skipped when /root/reference is not mounted): exercises the .msh
reader + tag closure against real Gmsh output and reproduces the
bowl-mixing configuration on the exact reference discretization."""

import os

import numpy as np
import pytest

import nupgcm as npg

REF = "/root/reference/meshes"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference meshes not available"
)


def _mixing_model(mesh, nsteps=20):
    eps, alpha, mu = 2e-1, 0.5, 1e1
    params = npg.Parameters(
        eps=eps, alpha=alpha, mu_rho=mu, N2=1 / alpha,
        f=lambda x: 1.0 + 0.5 * x[1],
        H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2),
    )
    kap = lambda x: 1e-2 + np.exp(
        -(x[2] + alpha * (1 - x[0] ** 2 - x[1] ** 2)) / (0.1 * alpha)
    )
    forc = npg.Forcings(nu=1.0, kappa_h=kap, kappa_v=kap, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0))
    spaces = npg.Spaces(
        mesh,
        u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True), (False, False, True)],
        b_diri_tags=["coastline", "surface"], b_diri_vals=[0.0, 0.0],
    )
    fe = npg.FEData(mesh, spaces)
    dt = 1e-4 * mu / (alpha * eps) ** 2
    ts = npg.BDF2(t_start=0, t_stop=nsteps * dt, dt=dt)
    model = npg.PGModel(fe, params, forc, ts)
    return model


def test_reference_bowl2D_mixing():
    mesh = npg.read_msh(f"{REF}/bowl2D_1.000000e-01_5.000000e-01.msh")
    assert mesh.tdim == 2
    model = _mixing_model(mesh)
    st = model.run(model.rest_state(), n_info=0)
    u = np.asarray(st.u)
    b = np.asarray(st.b)
    assert np.isfinite(u).all() and np.isfinite(b).all()
    assert 1e-6 < np.abs(u).max() < 1e-1
    # mixing produces positive buoyancy perturbation at depth
    assert b.max() > 1e-4


def test_reference_bowl3D_mixing():
    mesh = npg.read_msh(f"{REF}/bowl3D_1.000000e-01_5.000000e-01.msh")
    assert mesh.tdim == 3
    model = _mixing_model(mesh, nsteps=10)
    st = model.run(model.rest_state(), n_info=0, steps_per_block=5)
    u = np.asarray(st.u)
    assert np.isfinite(u).all()
    assert 1e-6 < np.abs(u).max() < 1e-1


# ---------------------------------------------------------------------------
# bowl3D wind + surface-flux config (BASELINE "production" config #2):
# wind stress tau_x = -0.1 cos(pi y / 2) AND a SurfaceFluxBC together,
# merging the two reference suites (test/bowl_wind_tests.jl:9-45,
# test/bowl_surface_flux_tests.jl:9-43) into one forcing bundle.
# ---------------------------------------------------------------------------

def wind_flux_model(mesh, nsteps=50):
    eps, alpha, mu = np.sqrt(1e-1), 0.5, 1.0
    H = lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2)
    params = npg.Parameters(
        eps=eps, alpha=alpha, mu_rho=mu, N2=0.0,
        f=lambda x: 1.0 + 0.5 * x[1], H=H,
    )
    kap = lambda x: 1e-2 + np.exp(-(x[2] + H(x)) / (0.1 * alpha))
    forc = npg.Forcings(
        nu=1.0, kappa_h=kap, kappa_v=kap,
        tau_x=lambda x: -1e-1 * np.cos(np.pi * x[1] / 2), tau_y=0.0,
        b_surface_bc=npg.SurfaceFluxBC(lambda x: 1e-3 * np.sin(np.pi * x[0])),
    )
    spaces = npg.Spaces(
        mesh,
        u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True), (False, False, True)],
        b_diri_tags=[], b_diri_vals=[],
    )
    fe = npg.FEData(mesh, spaces)
    dt = 1e-1
    ts = npg.BDF2(t_start=0, t_stop=nsteps * dt, dt=dt)
    model = npg.PGModel(fe, params, forc, ts, inv_atol=1e-10, inv_rtol=1e-10,
                        evo_atol=1e-11, evo_rtol=1e-11)
    state = model.set_b(model.rest_state(), lambda x: x[2] / alpha)
    return model, state


from _helpers import integral_rel_l2


def test_bowl3D_wind_flux_golden(tmp_path):
    """50-step golden regression of the combined wind + surface-flux
    production config on the reference bowl3D mesh, plus
    checkpoint/resume equivalence mid-run (reference analogs:
    test/bowl_wind_tests.jl + test/bowl_surface_flux_tests.jl;
    BASELINE.md config #2).  Self-seeding golden fixture, the
    reference's own pattern (test/bowl_mixing_tests.jl:52-56)."""
    from nupgcm.io import checkpoint as ck

    mesh = npg.read_msh(f"{REF}/bowl3D_1.000000e-01_5.000000e-01.msh")
    model, state0 = wind_flux_model(mesh, nsteps=50)

    # straight-through 50 steps
    st50 = model.run(state0, n_info=0, max_steps=50)
    assert int(st50.step) == 50
    u, b = np.asarray(st50.u), np.asarray(st50.b)
    assert np.isfinite(u).all() and np.isfinite(b).all()
    assert 1e-6 < np.abs(u).max() < 1e2

    # checkpoint at 25, resume, must match straight-through
    st25 = model.run(state0, n_info=0, max_steps=25)
    path = str(tmp_path / "ckpt_25.npz")
    ck.save_state(model, st25, path)
    st_resumed = model.run(ck.load_state(model, path), n_info=0, max_steps=50)
    assert int(st_resumed.step) == 50
    err_u = np.abs(np.asarray(st_resumed.u) - u).max() / max(np.abs(u).max(), 1e-30)
    err_b = np.abs(np.asarray(st_resumed.b) - b).max() / max(np.abs(b).max(), 1e-30)
    assert err_u < 1e-10 and err_b < 1e-10, (err_u, err_b)

    # golden regression (generate-if-missing, like the reference);
    # fixture stored in mesh-canonical dof order so it survives
    # renumbering-strategy changes (matching test_model.py's pattern)
    golden = os.path.join(os.path.dirname(__file__), "data",
                          "bowl3d_wind_flux_50.npz")
    us, bs = model.fe.spaces.u_space, model.fe.spaces.b_space
    if not os.path.exists(golden):
        os.makedirs(os.path.dirname(golden), exist_ok=True)
        u_can = np.stack([us.to_original_order(u[:, c]) for c in range(3)],
                         axis=1)
        np.savez_compressed(golden, u=u_can, b=bs.to_original_order(b))
        pytest.skip("golden data generated; rerun to compare")
    ref = np.load(golden)
    ref_u = np.stack([us.from_original_order(ref["u"][:, c]) for c in range(3)],
                     axis=1)
    ref_b = bs.from_original_order(ref["b"])
    fe = model.fe
    eu = integral_rel_l2(fe, st50.u, ref_u, fe.cd_u, fe.tab_u.phi)
    eb = integral_rel_l2(fe, st50.b, ref_b, fe.cd_b, fe.tab_b.phi)
    assert eu < 1e-3 and eb < 1e-3, (eu, eb)
