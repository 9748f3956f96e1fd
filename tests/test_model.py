"""End-to-end model physics tests (analytic + regression), mirroring
the reference's test strategy (reference test/bowl_mixing_tests.jl)
with analytic acceptance criteria instead of golden JLD2 files."""

import jax.numpy as jnp
import numpy as np
import pytest

import nupgcm as npg


def integral_l2(fe, field_vals, cell_dofs, phi):
    """FE-integral L2 norm^2: sum_c int f_h^2 (the layout-invariant
    norm the reference tests use, test/bowl_mixing_tests.jl:101-103).

    ``cell_dofs`` must be the padded FEData tables (fe.cd_b / fe.cd_u)
    to match the padded quadrature weights.
    """
    wq = jnp.asarray(fe.geom.wq)
    fe_vals = jnp.asarray(field_vals)[jnp.asarray(cell_dofs)]
    fq = jnp.einsum("qi,ci->cq", jnp.asarray(phi), fe_vals)
    return float(jnp.einsum("cq,cq->", wq, fq ** 2))


def test_hydrostatic_exactness():
    """Constant b on a closed box: u = 0 to solver tolerance, p = z+C
    exactly representable in P1 -> recovered to solver tolerance."""
    mesh = npg.generators.rect_mesh(6, 6, x0=-1, x1=1, z0=-1, z1=0)
    params = npg.Parameters(eps=1.0, alpha=1.0, mu_rho=1.0, N2=0.0,
                            f=lambda x: 1.0 + 0 * x[0], H=lambda x: 1.0)
    forc = npg.Forcings(nu=1.0, kappa_h=1.0, kappa_v=1.0, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0))
    spaces = npg.Spaces(mesh, u_diri_tags=["boundary"],
                        u_diri_masks=[(True, True, True)],
                        b_diri_tags=[], b_diri_vals=[])
    fe = npg.FEData(mesh, spaces)
    ts = npg.BDF2(t_start=0, t_stop=1, dt=1e-2)
    model = npg.PGModel(fe, params, forc, ts, inv_atol=1e-10, inv_rtol=1e-12)
    st = model.set_b(model.rest_state(), lambda x: 1.0 + 0 * x[0])
    st = model.invert(st)
    assert float(jnp.abs(st.u).max()) < 1e-7
    zc = spaces.p_space.dof_coords[:, 2]
    assert np.abs(np.asarray(st.p) - (zc + 0.5)).max() < 1e-6


def test_diffusion_decay_bdf2():
    """b = sin(pi z) with Dirichlet top/bottom decays at rate
    (alpha eps)^2 / mu * pi^2 (exact 1D solution)."""
    mesh = npg.generators.rect_mesh(5, 10)
    eps, alpha, mu = 0.5, 1.0, 1.0
    params = npg.Parameters(eps=eps, alpha=alpha, mu_rho=mu, N2=0.0,
                            f=lambda x: 1.0 + 0 * x[0], H=lambda x: 1.0)
    forc = npg.Forcings(nu=1.0, kappa_h=0.0, kappa_v=1.0, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0))
    spaces = npg.Spaces(mesh, u_diri_tags=["boundary"],
                        u_diri_masks=[(True, True, True)],
                        b_diri_tags=["top", "bottom"], b_diri_vals=[0.0, 0.0])
    fe = npg.FEData(mesh, spaces)
    dt = 2e-3
    ts = npg.BDF2(t_start=0, t_stop=30 * dt, dt=dt)
    model = npg.PGModel(fe, params, forc, ts)
    st = model.set_b(model.rest_state(), lambda x: np.sin(np.pi * x[2]))
    st = model.run(st, n_info=0)
    lam = (alpha * eps) ** 2 / mu * np.pi ** 2
    zc = spaces.b_space.dof_coords[:, 2]
    exact = np.exp(-lam * float(st.t)) * np.sin(np.pi * zc)
    assert np.abs(np.asarray(st.b) - exact).max() < 2e-3


def test_bdf1_vs_bdf2_convergence():
    """BDF2 with the same dt must beat BDF1 against the exact decay."""
    mesh = npg.generators.rect_mesh(3, 8)
    params = npg.Parameters(eps=1.0, alpha=1.0, mu_rho=1.0, N2=0.0,
                            f=lambda x: 1.0 + 0 * x[0], H=lambda x: 1.0)
    forc = npg.Forcings(nu=1.0, kappa_h=0.0, kappa_v=1.0, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0))
    spaces = npg.Spaces(mesh, u_diri_tags=["boundary"],
                        u_diri_masks=[(True, True, True)],
                        b_diri_tags=["top", "bottom"], b_diri_vals=[0.0, 0.0])
    fe = npg.FEData(mesh, spaces)
    dt, nsteps = 2e-2, 12
    lam = np.pi ** 2
    zc = spaces.b_space.dof_coords[:, 2]

    errs = {}
    for TS in (npg.BDF1, npg.BDF2):
        ts = TS(t_start=0, t_stop=nsteps * dt, dt=dt)
        model = npg.PGModel(fe, params, forc, ts)
        st = model.set_b(model.rest_state(), lambda x: np.sin(np.pi * x[2]))
        st = model.run(st, n_info=0)
        exact = np.exp(-lam * float(st.t)) * np.sin(np.pi * zc)
        errs[TS.__name__] = np.abs(np.asarray(st.b) - exact).max()
    assert errs["BDF2"] < 0.5 * errs["BDF1"], errs


def test_adaptive_bdf2_variable_step():
    """Adaptive BDF2 (variable-step coefficients -- the reference's
    open TODO, src/timesteppers.jl:35): dt ramps up (clamped to r <= 2
    per step) while the solution still tracks the exact diffusion
    decay at second-order accuracy."""
    mesh = npg.generators.rect_mesh(5, 10)
    params = npg.Parameters(eps=1.0, alpha=1.0, mu_rho=1.0, N2=0.0,
                            f=lambda x: 1.0 + 0 * x[0], H=lambda x: 1.0)
    forc = npg.Forcings(nu=1.0, kappa_h=0.0, kappa_v=1.0, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0))
    spaces = npg.Spaces(mesh, u_diri_tags=["boundary"],
                        u_diri_masks=[(True, True, True)],
                        b_diri_tags=["top", "bottom"], b_diri_vals=[0.0, 0.0])
    fe = npg.FEData(mesh, spaces)
    # CFL cap ~ 2e-3 (u ~ 0 -> dt = CFL_factor h_min / u_min); start
    # 16x below it so the ramp exercises r = 2 steps
    h_min = fe.h_cells.min()
    cap = 2e-3
    ts = npg.BDF2(t_start=0, t_stop=1.0, dt=cap / 16,
                  adaptive=True, CFL_factor=cap * 0.01 / h_min)
    model = npg.PGModel(fe, params, forc, ts)
    st = model.set_b(model.rest_state(), lambda x: np.sin(np.pi * x[2]))
    st = model.run(st, n_info=0, max_steps=40)
    assert float(st.dt) == pytest.approx(cap, rel=1e-6)  # ramp completed
    lam = np.pi ** 2
    zc = spaces.b_space.dof_coords[:, 2]
    exact = np.exp(-lam * float(st.t)) * np.sin(np.pi * zc)
    assert np.abs(np.asarray(st.b) - exact).max() < 2e-3


@pytest.fixture(scope="module")
def bowl_model():
    """Reference bowl-mixing configuration on a coarse generated mesh
    (reference test/bowl_mixing_tests.jl:16-44)."""
    eps, alpha, mu = 2e-1, 0.5, 1e1
    params = npg.Parameters(
        eps=eps, alpha=alpha, mu_rho=mu, N2=1 / alpha,
        f=lambda x: 1.0 + 0.5 * x[1],
        H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2),
    )
    kap = lambda x: 1e-2 + np.exp(-(x[2] + alpha * (1 - x[0] ** 2 - x[1] ** 2)) / (0.1 * alpha))
    forc = npg.Forcings(nu=1.0, kappa_h=kap, kappa_v=kap, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0))
    mesh = npg.generators.bowl2D(0.1, alpha)
    spaces = npg.Spaces(
        mesh,
        u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True), (False, False, True)],
        b_diri_tags=["coastline", "surface"], b_diri_vals=[0.0, 0.0],
    )
    fe = npg.FEData(mesh, spaces)
    dt = 1e-4 * mu / (alpha * eps) ** 2
    ts = npg.BDF2(t_start=0, t_stop=50 * dt, dt=dt)
    model = npg.PGModel(fe, params, forc, ts)
    st = model.run(model.rest_state(), n_info=0)
    return model, st


def test_bowl_mixing_runs_stable(bowl_model):
    model, st = bowl_model
    u = np.asarray(st.u)
    b = np.asarray(st.b)
    assert np.isfinite(u).all() and np.isfinite(b).all()
    # mixing-driven circulation: nonzero but small flow
    assert 1e-5 < np.abs(u).max() < 1e-1
    # buoyancy perturbation from bottom-enhanced mixing is positive
    # near the bottom (mixing of the N^2 z background)
    assert b.max() > 1e-3
    # Dirichlet surface values preserved
    sb = model.fe.spaces.b_space.tagged_dofs(["surface"])
    assert np.abs(b[sb]).max() < 1e-14


def test_bowl_mixing_regression(bowl_model):
    """Self-golden regression in the layout-invariant FE-integral
    norm (the reference's acceptance metric, rel. L2 < 1e-3)."""
    import pathlib

    model, st = bowl_model
    fe = model.fe
    bs = fe.spaces.b_space
    us = fe.spaces.u_space
    datafile = pathlib.Path(__file__).parent / "data" / "bowl_mixing_2d.npz"
    # store in mesh-canonical dof order so the golden file is
    # invariant to the RCM/renumbering strategy
    b = np.asarray(st.b)
    u = np.asarray(st.u)
    b_can = bs.to_original_order(b)
    u_can = np.stack([us.to_original_order(u[:, c]) for c in range(3)], axis=1)
    if not datafile.exists():
        datafile.parent.mkdir(exist_ok=True)
        np.savez(datafile, b=b_can, u=u_can.reshape(-1), t=float(st.t))
        pytest.skip("golden data generated; rerun to compare")
    ref = np.load(datafile)
    ref_b = bs.from_original_order(ref["b"])
    num = integral_l2(fe, b - ref_b, fe.cd_b, fe.tab_b.phi)
    den = integral_l2(fe, ref_b, fe.cd_b, fe.tab_b.phi)
    # reference acceptance bar: rel. L2 < 1e-3 (solver-parameter
    # changes legitimately move iterates below this level)
    assert num / den < 1e-3
    uref_can = ref["u"].reshape(-1, 3)
    uref = np.stack(
        [us.from_original_order(uref_can[:, c]) for c in range(3)], axis=1
    )
    du = u - uref
    num = sum(integral_l2(fe, du[:, c], fe.cd_u, fe.tab_u.phi) for c in range(3))
    den = sum(integral_l2(fe, uref[:, c], fe.cd_u, fe.tab_u.phi) for c in range(3))
    assert num / den < 1e-3


def test_wind_driven():
    """Pure wind stress, N2=0: surface stress drives a flow; check a
    nonzero interior circulation develops and stays bounded."""
    eps, alpha, mu = 2e-1, 0.5, 1e1
    params = npg.Parameters(eps=eps, alpha=alpha, mu_rho=mu, N2=0.0,
                            f=lambda x: 1.0 + 0.5 * x[1],
                            H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2))
    forc = npg.Forcings(nu=1.0, kappa_h=1e-2, kappa_v=1e-2,
                        tau_x=lambda x: -0.1 * np.cos(np.pi / 2 * x[1]), tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0))
    mesh = npg.generators.bowl2D(0.15, alpha)
    spaces = npg.Spaces(
        mesh,
        u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True), (False, False, True)],
        b_diri_tags=[], b_diri_vals=[],
    )
    fe = npg.FEData(mesh, spaces)
    ts = npg.BDF1(t_start=0, t_stop=5e-2, dt=1e-2)
    model = npg.PGModel(fe, params, forc, ts)
    st = model.set_b(model.rest_state(), lambda x: x[2] / alpha)
    st = model.run(st, n_info=0)
    u = np.asarray(st.u)
    assert np.isfinite(u).all()
    assert np.abs(u[:, 0]).max() > 1e-4  # wind drives zonal flow


def test_surface_flux_bc():
    """SurfaceFluxBC injects buoyancy: with F > 0 the mean buoyancy
    must increase (no Dirichlet sink)."""
    eps, alpha, mu = 2e-1, 0.5, 1e1
    params = npg.Parameters(eps=eps, alpha=alpha, mu_rho=mu, N2=1 / alpha,
                            f=lambda x: 1.0 + 0 * x[1],
                            H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2))
    forc = npg.Forcings(nu=1.0, kappa_h=1e-2, kappa_v=1e-2, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npg.SurfaceFluxBC(lambda x: 1e-3 * np.sin(np.pi * x[0]) ** 2))
    mesh = npg.generators.bowl2D(0.15, alpha)
    spaces = npg.Spaces(
        mesh,
        u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True), (False, False, True)],
        b_diri_tags=[], b_diri_vals=[],
    )
    fe = npg.FEData(mesh, spaces)
    ts = npg.BDF2(t_start=0, t_stop=0.5, dt=0.05)
    model = npg.PGModel(fe, params, forc, ts)
    st0 = model.rest_state()
    st = model.run(st0, n_info=0)
    wq = jnp.asarray(fe.geom.wq)
    phi = jnp.asarray(fe.tab_b.phi)
    cd = jnp.asarray(fe.cd_b)

    def mean_b(bvals):
        fq = jnp.einsum("qi,ci->cq", phi, jnp.asarray(bvals)[cd])
        return float(jnp.einsum("cq,cq->", wq, fq))

    assert mean_b(st.b) > mean_b(st0.b) + 1e-6


def test_convection_parameterization():
    """Unstable stratification triggers convective kappa: the unstable
    profile must be mixed away faster than with base kappa alone."""
    mesh = npg.generators.rect_mesh(4, 8)
    params = npg.Parameters(eps=0.5, alpha=1.0, mu_rho=1.0, N2=0.0,
                            f=lambda x: 1.0 + 0 * x[0], H=lambda x: 1.0)
    conv = npg.ConvectionParameterization(kappa_c=10.0, N2_min=1e-3)
    base = dict(nu=1.0, kappa_h=0.0, kappa_v=1e-3, tau_x=0.0, tau_y=0.0,
                b_surface_bc=npg.SurfaceDirichletBC(0.0))
    spaces = npg.Spaces(mesh, u_diri_tags=["boundary"],
                        u_diri_masks=[(True, True, True)],
                        b_diri_tags=[], b_diri_vals=[])
    fe = npg.FEData(mesh, spaces)
    ts = npg.BDF1(t_start=0, t_stop=0.05, dt=0.01)
    unstable = lambda x: -0.5 * x[2]  # db/dz < 0

    results = {}
    for name, cp in (("off", None), ("on", conv)):
        forc = npg.Forcings(**base) if cp is None else npg.Forcings(**base, conv_param=cp)
        model = npg.PGModel(fe, params, forc, ts)
        st = model.set_b(model.rest_state(), unstable)
        st = model.run(st, n_info=0)
        # vertical buoyancy variance: convection flattens the profile
        b = np.asarray(st.b)
        results[name] = np.var(b)
    assert results["on"] < 0.5 * results["off"], results


def test_eddy_parameterization_rebuild():
    """Eddy viscosity path: inversion matrix is rebuilt at step 10 and
    the model keeps running stably."""
    mesh = npg.generators.bowl2D(0.2, 0.5)
    eddy = npg.EddyParameterization(f=lambda x: 1.0 + 0 * x[1], N2_min=1e-2)
    params = npg.Parameters(eps=2e-1, alpha=0.5, mu_rho=1e1, N2=2.0,
                            f=lambda x: 1.0 + 0 * x[1],
                            H=lambda x: 0.5 * (1 - x[0] ** 2 - x[1] ** 2))
    forc = npg.Forcings(nu=1.0, kappa_h=1e-2, kappa_v=1e-2, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0), eddy_param=eddy)
    spaces = npg.Spaces(
        mesh,
        u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True), (False, False, True)],
        b_diri_tags=["surface"], b_diri_vals=[0.0],
    )
    fe = npg.FEData(mesh, spaces)
    ts = npg.BDF2(t_start=0, t_stop=12 * 0.05, dt=0.05)
    model = npg.PGModel(fe, params, forc, ts)
    A0 = np.asarray(model.ops["A_uu_e"]).copy()
    st = model.set_b(model.rest_state(), lambda x: 0.1 * np.exp(2 * x[2]))
    st = model.run(st, n_info=0)
    A1 = np.asarray(model.ops["A_uu_e"])
    assert np.isfinite(np.asarray(st.u)).all()
    assert np.abs(A1 - A0).max() > 1e-10  # matrix actually rebuilt


def test_small_ekman_saddle_coarse():
    """Rotation-dominated inversion (small Ekman number): the block
    preconditioner's Mp Schur surrogate degrades as eps -> 0 (the
    reference's own open problem, scratch/inversion_log.md); the
    P1-P1 full-saddle coarse correction must keep the outer FGMRES
    converging in a handful of iterations and clearly beat the
    block-only preconditioner at the same iteration budget."""
    eps, alpha = 0.05, 0.5
    mesh = npg.generators.bowl3D(0.35, alpha, nz=4)
    params = npg.Parameters(eps=eps, alpha=alpha, mu_rho=1.0, N2=1 / alpha,
                            f=lambda x: 1.0 + 0.5 * x[1],
                            H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2))
    forc = npg.Forcings(nu=1.0, kappa_h=1.0, kappa_v=1.0, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0))
    spaces = npg.Spaces(
        mesh,
        u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True),
                      (False, False, True)],
        b_diri_tags=["coastline", "surface"], b_diri_vals=[0.0, 0.0])
    fe = npg.FEData(mesh, spaces)
    ts = npg.BDF2(t_start=0, t_stop=1, dt=1e-2)
    b_ic = lambda x: 0.1 * np.exp(
        (x[2] - alpha * (1 - x[0] ** 2 - x[1] ** 2)) / (0.2 * alpha))

    stats = {}
    for on in (True, False):
        model = npg.PGModel(fe, params, forc, ts, saddle_coarse=on,
                            inv_itmax=60)
        st = model.set_b(model.rest_state(), b_ic)
        _, _, aux = model.invert_jit(model.ops, st)
        stats[on] = (int(aux["inv_iters"]), float(aux["inv_res"]))

    it_on, res_on = stats[True]
    it_off, res_off = stats[False]
    assert res_on < 1e-5, stats  # converged in the hard regime
    assert it_on <= 25, stats  # O(1)-ish outer iterations
    # the coarse solve must be doing real work vs block-only
    assert it_on < it_off or res_on < 1e-2 * res_off, stats


def test_saddle_coarse_scales_past_dense():
    """The element-local iterative coarse path (meshes too big for the
    dense coarse inverse): outer FGMRES iterations stay bounded and
    near-flat through >=100k inversion DoFs with saddle_coarse active
    by default (the dense path caps at coarse_dense_max/4 vertices)."""
    eps, alpha = 0.5, 0.5
    params = npg.Parameters(eps=eps, alpha=alpha, mu_rho=1.0, N2=1 / alpha,
                            f=lambda x: 1.0 + 0.5 * x[1],
                            H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2))
    kap = lambda x: 1e-2 + np.exp(
        -(x[2] + alpha * (1 - x[0] ** 2 - x[1] ** 2)) / (0.1 * alpha))
    forc = npg.Forcings(nu=1.0, kappa_h=kap, kappa_v=kap, tau_x=0.0,
                        tau_y=0.0, b_surface_bc=npg.SurfaceDirichletBC(0.0))
    bic = lambda x: 0.1 * np.exp(
        -(x[2] + alpha * (1 - x[0] ** 2 - x[1] ** 2)) / 0.05)

    iters = {}
    for h, nz, kw in [(0.14, 5, dict(coarse_dense_max=0)),  # force iterative
                      (0.08, 9, {})]:  # naturally past the dense limit
        mesh = npg.generators.bowl3D(h, alpha, nz=nz)
        spaces = npg.Spaces(
            mesh, u_diri_tags=["bottom", "coastline", "surface"],
            u_diri_vals=[(0, 0, 0)] * 3,
            u_diri_masks=[(True, True, True), (True, True, True),
                          (False, False, True)],
            b_diri_tags=["coastline", "surface"], b_diri_vals=[0.0, 0.0])
        fe = npg.FEData(mesh, spaces)
        ts = npg.BDF2(t_start=0, t_stop=1, dt=1e-3)
        model = npg.PGModel(fe, params, forc, ts, inv_itmax=100, **kw)
        assert not model.saddle_coarse_dense or kw  # iterative path active
        st = model.set_b(model.rest_state(), bic)
        _, _, aux = model.invert_jit(model.ops, st)
        iters[fe.n_inv] = (int(aux["inv_iters"]), float(aux["inv_res"]))

    (n1, (it1, res1)), (n2, (it2, res2)) = sorted(iters.items())
    assert n2 >= 100_000, iters
    assert res1 < 1e-5 and res2 < 1e-5, iters
    assert it2 <= 35, iters  # bounded at 100k DoF
    assert it2 <= it1 + 15, iters  # near-flat growth over 5x DoFs


def test_precond_refresh_tracks_eddy_nu():
    """refresh_precond: after the eddy viscosity drifts from the
    build-time field, a host-side refresh restores solver health --
    same shapes (no retrace), converged residual, and no more
    iterations than the stale-preconditioner solve."""
    eps, alpha, mu = 2e-1, 0.5, 1e1
    mesh = npg.generators.bowl3D(0.35, alpha, nz=3)
    spaces = npg.Spaces(
        mesh, u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True),
                      (False, False, True)],
        b_diri_tags=["coastline", "surface"], b_diri_vals=[0.0, 0.0])
    fe = npg.FEData(mesh, spaces)
    params = npg.Parameters(eps=eps, alpha=alpha, mu_rho=mu, N2=1 / alpha,
                            f=lambda x: 1.0 + 0.5 * x[1],
                            H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2))
    kap = lambda x: 1e-2 + np.exp(
        -(x[2] + alpha * (1 - x[0] ** 2 - x[1] ** 2)) / (0.1 * alpha))
    forc = npg.Forcings(
        nu=1.0, kappa_h=kap, kappa_v=kap, tau_x=0.0, tau_y=0.0,
        b_surface_bc=npg.SurfaceDirichletBC(0.0),
        eddy_param=npg.EddyParameterization(
            f=lambda x: 1.0 + 0.5 * x[1], N2_min=float(np.sqrt(1e-3))))
    ts = npg.BDF2(t_start=0, t_stop=1e9, dt=1e-2)
    m = npg.PGModel(fe, params, forc, ts, inv_atol=1e-7, inv_rtol=1e-7)
    st = m.rest_state()
    # march past several in-jit eddy rebuilds so nu drifts from the
    # build-time field the preconditioner was assembled with
    ops, st, aux = m.multi_step_jit(m.ops, st, 30)
    it_stale = int(np.asarray(aux["inv_iters"])[-1])
    new_ops = m.refresh_precond(ops, st)
    for k in ops:
        assert np.shape(new_ops[k]) == np.shape(ops[k]), k  # no retrace
    assert np.abs(np.asarray(new_ops["visc_e"])
                  - np.asarray(ops["visc_e"])).max() > 0  # really updated
    m.ops = new_ops
    _, _, aux2 = m.multi_step_jit(m.ops, st, 1)
    it_fresh = int(np.asarray(aux2["inv_iters"])[-1])
    res = float(np.asarray(aux2["inv_res"])[-1])
    assert np.isfinite(res) and res < 1e-6
    assert it_fresh <= it_stale + 2, (it_fresh, it_stale)
    # no-op without an eddy parameterization
    forc2 = npg.Forcings(nu=1.0, kappa_h=kap, kappa_v=kap, tau_x=0.0,
                         tau_y=0.0, b_surface_bc=npg.SurfaceDirichletBC(0.0))
    m2 = npg.PGModel(fe, params, forc2, ts)
    assert m2.refresh_precond(m2.ops, m2.rest_state()) is m2.ops


def test_refresh_precond_twogrid_dense_coarse():
    """refresh_precond on the u-block two-grid path with a dense coarse
    inverse: the rebuild replaces coarse_inv and needs no coarse
    diagonal (it used to read the absent coarse_e and raise KeyError)."""
    alpha = 0.5
    mesh = npg.generators.bowl2D(0.2, alpha)
    spaces = npg.Spaces(
        mesh, u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True),
                      (False, False, True)],
        b_diri_tags=["coastline", "surface"], b_diri_vals=[0.0, 0.0])
    fe = npg.FEData(mesh, spaces)
    params = npg.Parameters(eps=2e-1, alpha=alpha, mu_rho=1e1, N2=1 / alpha,
                            f=lambda x: 1.0 + 0.5 * x[1],
                            H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2))
    forc = npg.Forcings(
        nu=1.0, kappa_h=1e-2, kappa_v=1e-2, tau_x=0.0, tau_y=0.0,
        b_surface_bc=npg.SurfaceDirichletBC(0.0),
        eddy_param=npg.EddyParameterization(
            f=lambda x: 1.0 + 0.5 * x[1], N2_min=1e-2))
    ts = npg.BDF2(t_start=0, t_stop=1e9, dt=1e-2)
    m = npg.PGModel(fe, params, forc, ts, saddle_coarse=False, twogrid=True)
    assert m.twogrid and m.coarse_dense
    st = m.set_b(m.rest_state(), lambda x: 0.1 * x[2])
    new_ops = m.refresh_precond(m.ops, st)
    assert "coarse_e" not in new_ops and "coarse_dinv" not in new_ops
    assert np.abs(np.asarray(new_ops["coarse_inv"])
                  - np.asarray(m.ops["coarse_inv"])).max() > 0
    m.ops = new_ops
    _, _, aux = m.multi_step_jit(m.ops, st, 1)
    assert np.isfinite(float(np.asarray(aux["inv_res"])[-1]))


def test_saddle_coarse_l2_aggregate_level():
    """Second (aggregate) coarse level on the iterative coarse path:
    same solution at tight tolerance, and at least as few outer FGMRES
    iterations as without it (at production scale it restores the
    dense-coarse iteration count: 17.6 -> 5.4 in-step at 0.87M)."""
    eps, alpha, mu = 2e-1, 0.5, 1e1
    mesh = npg.generators.bowl3D(0.25, alpha, nz=4)
    spaces = npg.Spaces(
        mesh, u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True),
                      (False, False, True)],
        b_diri_tags=["coastline", "surface"], b_diri_vals=[0.0, 0.0])
    fe = npg.FEData(mesh, spaces)
    params = npg.Parameters(eps=eps, alpha=alpha, mu_rho=mu, N2=1 / alpha,
                            f=lambda x: 1.0 + 0.5 * x[1],
                            H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2))
    kap = lambda x: 1e-2 + np.exp(
        -(x[2] + alpha * (1 - x[0] ** 2 - x[1] ** 2)) / (0.1 * alpha))
    forc = npg.Forcings(nu=1.0, kappa_h=kap, kappa_v=kap, tau_x=0.0,
                        tau_y=0.0, b_surface_bc=npg.SurfaceDirichletBC(0.0))
    ts = npg.BDF2(t_start=0, t_stop=1.0, dt=1e-3)
    bic = lambda x: 0.1 * np.exp(
        -(x[2] + 0.5 * (1 - x[0] ** 2 - x[1] ** 2)) / 0.05)

    kw = dict(coarse_dense_max=256,  # force the iterative coarse path
              saddle_coarse_inner=16,  # same budget in both configs
              inv_rtol=1e-10, inv_atol=1e-10)
    m_l2 = npg.PGModel(fe, params, forc, ts, saddle_coarse_l2=True, **kw)
    m_no = npg.PGModel(fe, params, forc, ts, saddle_coarse_l2=False, **kw)
    assert m_l2.saddle_coarse_l2 and "sc2_inv" in m_l2.ops
    assert 1 < m_l2._sc2_na < mesh.n_vertices
    st = m_l2.set_b(m_l2.rest_state(), bic)
    u1, _, a1 = m_l2.invert_jit(m_l2.ops, st)
    u2, _, a2 = m_no.invert_jit(m_no.ops, st)
    rel = float(np.linalg.norm(np.asarray(u1) - np.asarray(u2))
                / np.linalg.norm(np.asarray(u2)))
    assert rel < 1e-5, rel
    assert int(a1["inv_iters"]) <= int(a2["inv_iters"]), (
        int(a1["inv_iters"]), int(a2["inv_iters"]))


def test_args_table_mode_bitwise(bowl_model):
    """"args" table mode (static tables as device-array jit arguments,
    required at production scale where inlined constants overflow the
    serialized HLO) is bitwise-identical to the default inlined mode."""
    model, _ = bowl_model
    fe, params, forc, ts = model.fe, model.params, model.forcings, model.ts

    m1 = npg.PGModel(fe, params, forc, ts, table_mode="const")
    s1 = m1.run(m1.rest_state(), n_info=0, max_steps=6, steps_per_block=3)
    m2 = npg.PGModel(fe, params, forc, ts, table_mode="args")
    assert m2.table_mode == "args"
    s2 = m2.run(m2.rest_state(), n_info=0, max_steps=6, steps_per_block=3)
    assert np.abs(np.asarray(s1.u) - np.asarray(s2.u)).max() == 0.0
    assert np.abs(np.asarray(s1.b) - np.asarray(s2.b)).max() == 0.0

    i1 = m1.invert(m1.set_b(m1.rest_state(), lambda x: 0.05 * np.exp(2 * x[2])))
    i2 = m2.invert(m2.set_b(m2.rest_state(), lambda x: 0.05 * np.exp(2 * x[2])))
    assert np.abs(np.asarray(i1.u) - np.asarray(i2.u)).max() == 0.0
