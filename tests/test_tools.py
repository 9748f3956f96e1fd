"""1D column model, JLD2 checkpoint interop, and extra plotting."""

import numpy as np
import pytest

import nupgcm as npg
from nupgcm.io.jld2 import export_state, import_state, read_jld2
from nupgcm.tools.column import ColumnModel, fd_stencil


def test_fd_stencil_exactness():
    """Fornberg weights differentiate polynomials exactly."""
    x = np.array([0.0, 0.3, 1.0])
    s1 = fd_stencil(x, 0.3, 1)
    s2 = fd_stencil(x, 0.3, 2)
    # f = 2 + 3x + 4x^2 -> f' = 3 + 8x, f'' = 8
    f = 2 + 3 * x + 4 * x ** 2
    assert abs(s1 @ f - (3 + 8 * 0.3)) < 1e-12
    assert abs(s2 @ f - 8.0) < 1e-12


def test_column_flat_bottom_steady_state():
    """theta = 0: steady buoyancy satisfies dz(b) = -1 (b = -z) and the
    inversion gives no flow (rhs = b tan(theta) = 0)."""
    m = ColumnModel(nz=64, eps=0.3, theta=0.0, dt=0.5, kappa=1.0, nu=1.0)
    b = np.zeros(m.nz)
    for _ in range(2000):
        b = m.step_b(b)
    assert np.allclose(b, -m.z, atol=1e-6)
    u, v, w, Px = m.invert(b)
    assert np.max(np.abs(u)) < 1e-12
    assert np.max(np.abs(w)) < 1e-12


def test_column_slope_transport_constraint():
    """Sloped column: flow develops and the along-constraint transport
    integrates to ~0 (the zero-transport Px closure)."""
    m = ColumnModel(nz=96, eps=0.2, theta=0.1, phi=0.0, dt=0.1,
                    kappa=lambda z: 1e-1 + np.exp(-(z + 1) / 0.2))
    b, u, v, w, Px = m.run(t_stop=20.0)
    assert np.max(np.abs(u)) > 1e-8  # flow exists
    dz = np.diff(m.z)
    trans = np.sum((u[:-1] + u[1:]) / 2 * dz)
    assert abs(trans) < 1e-10 * max(np.max(np.abs(u)), 1.0)
    # boundary conditions hold
    assert abs(u[0]) < 1e-12 and abs(v[0]) < 1e-12
    # bottom insulating flux: 1 + Gamma dz(b) = 0
    bz0 = m.bz(b)[0]
    assert abs(1.0 + m.Gamma * bz0) < 1e-8


def test_column_no_px():
    m = ColumnModel(nz=48, eps=0.2, theta=0.05, no_Px=True, dt=0.1)
    b, u, v, w, Px = m.run(t_stop=2.0)
    assert Px == pytest.approx(0.0, abs=1e-14)


@pytest.fixture(scope="module")
def tiny_model():
    eps, alpha, mu = 2e-1, 0.5, 1e1
    params = npg.Parameters(eps=eps, alpha=alpha, mu_rho=mu, N2=1 / alpha,
                            f=1.0, H=lambda x: alpha * (1 - x[0] ** 2))
    forc = npg.Forcings(nu=1.0, kappa_h=1e-2, kappa_v=1e-2, tau_x=0.0,
                        tau_y=0.0, b_surface_bc=npg.SurfaceDirichletBC(0.0))
    mesh = npg.generators.bowl2D(0.2, alpha)
    spaces = npg.Spaces(
        mesh,
        u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True), (False, False, True)],
        b_diri_tags=["surface"], b_diri_vals=[0.0],
    )
    fe = npg.FEData(mesh, spaces)
    ts = npg.BDF2(t_start=0, t_stop=0.3, dt=0.1)
    model = npg.PGModel(fe, params, forc, ts)
    st = model.set_b(model.rest_state(), lambda x: 0.05 * np.exp(2 * x[2]))
    st = model.run(st, n_info=0, max_steps=2)
    return model, st


def test_jld2_roundtrip(tiny_model, tmp_path):
    """export_state -> import_state reproduces the state exactly."""
    model, st = tiny_model
    path = str(tmp_path / "state.jld2")
    export_state(model, st, path)
    st2 = import_state(model, path)
    assert np.allclose(np.asarray(st2.u), np.asarray(st.u), atol=1e-12)
    assert np.allclose(np.asarray(st2.p), np.asarray(st.p), atol=1e-12)
    assert np.allclose(np.asarray(st2.b), np.asarray(st.b), atol=1e-12)
    assert float(st2.t) == pytest.approx(float(st.t))


def test_read_reference_jld2():
    """h5py path reads the reference's own golden JLD2 checkpoints
    (reference test/data, written by JLD2.jl)."""
    import os

    path = "/root/reference/test/data/bowl_mixing_2D.jld2"
    if not os.path.exists(path):
        pytest.skip("reference data not present")
    d = read_jld2(path)
    assert {"u", "p", "b", "t"} <= set(d)
    assert d["u"].ndim == 1 and d["u"].dtype == np.float64
    assert float(np.asarray(d["t"])) == pytest.approx(5.0)


def test_plot_tri_mesh_and_wave(tiny_model, tmp_path):
    model, st = tiny_model
    from nupgcm.plotting import plot_slice_wave, plot_tri_mesh

    f1 = plot_tri_mesh(model, np.asarray(st.b), ofile=str(tmp_path / "tri.png"))
    sp = model.fe.spaces
    uc = np.asarray(st.u) * (1.0 + 0.5j)
    bc = np.asarray(st.b) * (1.0 + 0.5j)
    f2 = plot_slice_wave(model, uc, bc, N2=model.params.N2, k=2.0,
                         omega=0.1 + 0.05j, ofile=str(tmp_path / "wave.png"))
    import os

    assert os.path.getsize(f1) > 0 and os.path.getsize(f2) > 0
