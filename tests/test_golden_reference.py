"""Golden cross-validation against the reference implementation.

Reproduces all four reference regression suites on the reference's own
meshes and golden JLD2 states (reference test/bowl_mixing_tests.jl,
bowl_dirichlet_tests.jl, bowl_wind_tests.jl, bowl_surface_flux_tests.jl;
data at /root/reference/test/data/*.jld2):

  * 50 BDF2 steps from the reference initial condition;
  * acceptance = FE-integral relative L2 < 1e-3 for u and b (the
    reference's bar, test/bowl_mixing_tests.jl:101-103);
  * plus the assembled-inversion-matrix regression
    (test/bowl_mixing_tests.jl:51-64) at machine precision.

The reference->this-framework dof mapping is reconstructed in
nupgcm/io/gridap.py and validated by the matrix test.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

import nupgcm as npg
from nupgcm.io import gridap as gi

REF = "/root/reference"
DATA = os.path.join(REF, "test", "data")

pytestmark = pytest.mark.skipif(
    not os.path.isdir(DATA), reason="reference golden data not available"
)


def _mesh_path(dim):
    return os.path.join(REF, "meshes", f"bowl{dim}D_1.000000e-01_5.000000e-01.msh")


def _build(config, dtype=None):
    """Build (model, maps, state0) for a reference test configuration."""
    dim = config["dim"]
    mshf = _mesh_path(dim)
    mesh = npg.read_msh(mshf)
    alpha = 0.5
    H = lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2)
    params = npg.Parameters(
        eps=config["eps"], alpha=alpha, mu_rho=config["mu_rho"],
        N2=config["N2"],
        f=lambda x: config["f0"] + config["beta"] * x[1], H=H,
    )
    forc = npg.Forcings(
        nu=1.0, kappa_h=config["kappa"], kappa_v=config["kappa"],
        tau_x=config.get("tau_x", 0.0), tau_y=0.0,
        b_surface_bc=config["bc"],
    )
    b_diri_tags = config.get("b_diri_tags", ["coastline", "surface"])
    spaces = npg.Spaces(
        mesh,
        u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True),
                      (False, False, True)],
        b_diri_tags=b_diri_tags,
        b_diri_vals=[config.get("b_surface", 0.0)] * len(b_diri_tags),
    )
    fe = npg.FEData(mesh, spaces)
    dt = config["dt"]
    ts = npg.BDF2(t_start=0, t_stop=50 * dt, dt=dt)
    # the reference's golden states come from exact sparse direct
    # solves (src/iterative_solvers.jl:49-55 CPU fast path); tighten
    # the Krylov tolerances accordingly.  In f32 (the production
    # dtype) the tightest reachable tolerances are ~1e-7.
    if dtype is not None and dtype == jnp.float32:
        model = npg.PGModel(fe, params, forc, ts, dtype=dtype,
                            inv_atol=1e-7, inv_rtol=1e-7,
                            evo_atol=1e-8, evo_rtol=1e-8)
    else:
        model = npg.PGModel(fe, params, forc, ts,
                            inv_atol=1e-11, inv_rtol=1e-10,
                            evo_atol=1e-12, evo_rtol=1e-12)
    maps = gi.gridap_maps(mshf, spaces)
    state = model.rest_state()
    if config.get("b0") is not None:
        state = model.set_b(state, config["b0"])
    return model, maps, state


from _helpers import integral_rel_l2 as _rel_l2


def _run_and_compare(config, golden, dtype=None):
    model, maps, state = _build(config, dtype=dtype)
    # exactly 50 steps: the golden states' t = 50 accumulated dt
    state = model.run(state, n_info=0, max_steps=50)
    assert int(state.step) == 50
    ref = gi.state_from_reference(
        model, os.path.join(DATA, golden), maps
    )
    fe = model.fe
    err_u = _rel_l2(fe, state.u, ref.u, fe.cd_u, fe.tab_u.phi)
    err_b = _rel_l2(fe, state.b, ref.b, fe.cd_b, fe.tab_b.phi)
    print(f"{golden}: rel-L2 u={err_u:.3e} b={err_b:.3e}")
    assert err_u < 1e-3, f"u mismatch vs reference golden: {err_u:.3e}"
    assert err_b < 1e-3, f"b mismatch vs reference golden: {err_b:.3e}"


# ---------------------------------------------------------------------------
# configurations (mirroring the reference test scripts)
# ---------------------------------------------------------------------------

def _kappa_exp(alpha):
    return lambda x: 1e-2 + np.exp(
        -(x[2] + alpha * (1 - x[0] ** 2 - x[1] ** 2)) / (0.1 * alpha)
    )


MIXING = dict(
    eps=0.2, mu_rho=10.0, N2=2.0, f0=1.0, beta=0.5,
    kappa=_kappa_exp(0.5), bc=npg.SurfaceDirichletBC(0.0),
    dt=1e-4 * 10.0 / (0.5 * 0.2) ** 2, b0=None,
)

DIRI = dict(
    dim=3, eps=np.sqrt(1e-1), mu_rho=1.0, N2=0.0, f0=0.0, beta=0.5,
    kappa=1.0, bc=npg.SurfaceDirichletBC(lambda x: x[1]),
    b_surface=lambda x: x[1], dt=1e-1, b0=lambda x: x[1],
)

WIND = dict(
    dim=3, eps=np.sqrt(1e-1), mu_rho=1.0, N2=0.0, f0=0.0, beta=0.5,
    kappa=_kappa_exp(0.5), tau_x=lambda x: -1e-1 * np.cos(np.pi * x[1] / 2),
    bc=npg.SurfaceDirichletBC(0.0), dt=1e-1,
    b0=lambda x: x[2] / 0.5,
)

FLUX = dict(
    dim=3, eps=np.sqrt(1e-1), mu_rho=1.0, N2=0.0, f0=1.0, beta=0.0,
    kappa=1e-2, bc=npg.SurfaceFluxBC(lambda x: 1e-3 * np.sin(np.pi * x[0])),
    b_diri_tags=[], dt=1e-1, b0=lambda x: x[2] / 0.5,
)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_matrix_regression_2d():
    """Assembled inversion operator == reference golden matrix
    (machine precision), validating both the assembly kernels and the
    Gridap dof-numbering reconstruction."""
    model, maps, _ = _build(dict(MIXING, dim=2))
    A_ref = gi.read_jld2_csc(
        os.path.join(DATA, "A_bowl_mixing_2D.jld2"), "A_inversion"
    ).toarray()
    A_mine = gi.assemble_inversion_csr(model).toarray()
    nu3 = 3 * model.fe.spaces.u_space.ndof
    idx = np.concatenate([maps.u_free, nu3 + maps.p_free])
    A_sub = A_mine[np.ix_(idx, idx)]
    rel = np.abs(A_sub - A_ref).max() / np.abs(A_ref).max()
    assert rel < 1e-12, f"assembled matrix mismatch: rel={rel:.3e}"


def test_golden_mixing_2d():
    _run_and_compare(dict(MIXING, dim=2), "bowl_mixing_2D.jld2")


def test_golden_mixing_3d():
    _run_and_compare(dict(MIXING, dim=3), "bowl_mixing_3D.jld2")


def test_golden_mixing_2d_f32():
    """f32 (the production dtype) meets the reference's 1e-3
    integral-norm bar over the full 50-step golden run (SURVEY #7(g)).
    Measured: rel-L2 u=1.4e-4, b=1.9e-6 -- an order of magnitude of
    headroom vs the f64 result (u=2e-4-ish dominated by the time
    discretization, not the arithmetic precision)."""
    _run_and_compare(dict(MIXING, dim=2), "bowl_mixing_2D.jld2",
                     dtype=jnp.float32)


def test_golden_mixing_3d_f32():
    _run_and_compare(dict(MIXING, dim=3), "bowl_mixing_3D.jld2",
                     dtype=jnp.float32)


def test_golden_dirichlet():
    _run_and_compare(DIRI, "bowl_diri.jld2")


def test_golden_wind():
    _run_and_compare(WIND, "bowl_wind.jld2")


def test_golden_surface_flux():
    _run_and_compare(FLUX, "bowl_surface_flux.jld2")


def test_golden_dirichlet_f32():
    _run_and_compare(DIRI, "bowl_diri.jld2", dtype=jnp.float32)


def test_golden_wind_f32():
    _run_and_compare(WIND, "bowl_wind.jld2", dtype=jnp.float32)


def test_golden_surface_flux_f32():
    _run_and_compare(FLUX, "bowl_surface_flux.jld2", dtype=jnp.float32)
