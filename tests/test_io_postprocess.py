"""Checkpoint round-trip, VTU writing, point evaluation, and
streamfunction diagnostics."""

import numpy as np
import pytest

import nupgcm as npg
from nupgcm.io.checkpoint import load_state, save_state
from nupgcm.io.vtk import save_vtk, write_vtu
from nupgcm.postprocess import (
    Grid3,
    barotropic_streamfunction,
    overturning_streamfunction,
    sample_state,
    stratification,
)
from nupgcm.utils.pointeval import FieldEvaluator


@pytest.fixture(scope="module")
def small_model():
    eps, alpha, mu = 2e-1, 0.5, 1e1
    params = npg.Parameters(
        eps=eps, alpha=alpha, mu_rho=mu, N2=1 / alpha,
        f=lambda x: 1.0 + 0.5 * x[1],
        H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2),
    )
    forc = npg.Forcings(nu=1.0, kappa_h=1e-2, kappa_v=1e-2, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0))
    mesh = npg.generators.bowl3D(0.35, alpha, nz=2)
    spaces = npg.Spaces(
        mesh,
        u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True), (False, False, True)],
        b_diri_tags=["surface"], b_diri_vals=[0.0],
    )
    fe = npg.FEData(mesh, spaces)
    ts = npg.BDF2(t_start=0, t_stop=0.5, dt=0.1)
    model = npg.PGModel(fe, params, forc, ts, inv_itmax=200)
    st = model.set_b(model.rest_state(), lambda x: 0.05 * np.exp(2 * x[2]))
    st = model.run(st, n_info=0, max_steps=3)
    return model, st


def test_point_eval_exactness(small_model):
    """P2 point evaluation reproduces a quadratic exactly inside the
    domain and returns NaN outside (reference nan_eval parity)."""
    model, st = small_model
    mesh = model.fe.mesh
    bs = model.fe.spaces.b_space
    x = bs.dof_coords
    f = 1.0 + x[:, 0] + 2 * x[:, 2] + x[:, 0] * x[:, 2]
    ev = FieldEvaluator(mesh)
    pts = np.array([[0.0, 0.0, -0.2], [0.5, 0.1, -0.1], [2.0, 0.0, 0.0]])
    vals = ev.eval(bs, f, pts)
    exact = 1.0 + pts[:, 0] + 2 * pts[:, 2] + pts[:, 0] * pts[:, 2]
    assert np.allclose(vals[:2], exact[:2], atol=1e-10)
    assert np.isnan(vals[2])  # outside the unit-disk bowl


def test_checkpoint_roundtrip(small_model, tmp_path):
    model, st = small_model
    p = str(tmp_path / "state.npz")
    save_state(model, st, p)
    st2 = load_state(model, p)
    assert np.allclose(np.asarray(st.b), np.asarray(st2.b))
    assert np.allclose(np.asarray(st.u), np.asarray(st2.u))
    assert float(st2.t) == float(st.t)
    assert int(st2.step) == int(st.step)
    # resume: one more step from the restored state works
    _, st3, aux = model.step_jit(model.ops, st2)
    assert np.isfinite(float(aux["u_max"]))


def test_checkpoint_mismatch_raises(small_model, tmp_path):
    model, st = small_model
    p = str(tmp_path / "state.npz")
    save_state(model, st, p)
    # build a different-size model
    mesh = npg.generators.bowl3D(0.45, 0.5, nz=2)
    spaces = npg.Spaces(mesh, b_diri_tags=[], b_diri_vals=[])
    fe = npg.FEData(mesh, spaces)
    m2 = npg.PGModel(fe, model.params, model.forcings, model.ts)
    with pytest.raises(ValueError, match="does not match"):
        load_state(m2, p)


def test_vtu_writer(small_model, tmp_path):
    model, st = small_model
    p = str(tmp_path / "state.vtu")
    save_vtk(model, st, p)
    txt = open(p).read()
    assert "QUADRATIC" not in txt  # types are numeric
    assert 'Name="u"' in txt and 'Name="b"' in txt and 'Name="kappa_v"' in txt
    # parseable XML with consistent sizes
    import xml.etree.ElementTree as ET

    root = ET.parse(p).getroot()
    piece = root.find(".//Piece")
    n_pts = int(piece.get("NumberOfPoints"))
    mesh = model.fe.mesh
    assert n_pts == mesh.n_vertices + mesh.n_edges
    types = piece.find(".//DataArray[@Name='types']").text.split()
    assert set(types) == {"24"}  # quadratic tets


def test_streamfunctions(small_model):
    model, st = small_model
    grid = Grid3.from_mesh(model.fe.mesh, nx=24, ny=24, nz=12)
    Psi, U, _ = barotropic_streamfunction(model, st, grid)
    psi, v_int, b_bar, _ = overturning_streamfunction(model, st, grid)
    # masks: NaN outside the bowl footprint, finite inside
    assert np.isnan(Psi[0, 0])  # corner outside unit disk
    assert np.isfinite(Psi[12, 12])
    assert np.isfinite(psi).any()
    prof, z = stratification(model, st, grid)
    assert np.isfinite(prof[2:-2]).all()


def test_sample_state_background(small_model):
    """Full buoyancy includes the N^2 z background."""
    model, st = small_model
    grid = Grid3.from_mesh(model.fe.mesh, nx=8, ny=8, nz=8)
    s = sample_state(model, st, grid)
    inside = s["mask"] > 0
    assert (s["b"][inside] != s["b_pert"][inside]).any()


def test_find_H_and_cached_slice(small_model, tmp_path):
    """find_H bisection recovers the bowl depth (reference find_H,
    src/plotting.jl:38-52); the cached slice plot bundle reuses point
    locations across saves (reference cache pattern)."""
    from nupgcm.plotting import SliceCache, plot_slice, sim_plots
    from nupgcm.utils.pointeval import FieldEvaluator, find_H

    model, state = small_model
    ev = FieldEvaluator(model.fe.mesh)
    alpha = model.params.alpha
    # bowl: H(x, y) = alpha (1 - x^2 - y^2); the discrete boundary is
    # within one cell of the analytic one on this coarse mesh
    H = find_H(ev, 0.0, 0.0, tol=1e-10)
    assert abs(H - alpha) < 0.15
    H2 = find_H(ev, 0.7, 0.0, tol=1e-10)
    assert abs(H2 - alpha * (1 - 0.49)) < 0.15
    assert np.isnan(find_H(ev, 2.0, 0.0))  # outside the basin

    # cached slice reuse + slice-direction variants + quiver
    c1 = plot_slice(model, state, "b", ofile=str(tmp_path / "b1.png"), n=32)
    c2 = plot_slice(model, state, "w", ofile=str(tmp_path / "w1.png"),
                    cache=c1, quiver=True)
    assert c2 is c1  # same cache round-trips
    cz = plot_slice(model, state, "u", z=-0.1,
                    ofile=str(tmp_path / "uz.png"), n=24)
    assert cz.labels == ("x", "y")
    files = sim_plots(model, state, out_dir=str(tmp_path), index=3)
    import os

    assert all(os.path.exists(f) for f in files)
    assert isinstance(getattr(model, "_slice_cache", None), SliceCache)


def test_publication_plots_3d(small_model, tmp_path):
    """The publication plot products render on a 3D model (reference
    postprocess/psi2d.py, streamfunctions.py, slice.py roles)."""
    from nupgcm import plotting as P

    model, st = small_model
    g = Grid3.from_mesh(model.fe.mesh, nx=24, ny=24, nz=12)
    P.plot_psi2d(model, st, n=32, ofile=str(tmp_path / "psi2d.png"))
    P.plot_barotropic_streamfunction(model, st, grid=g,
                                     ofile=str(tmp_path / "baro.png"))
    P.plot_overturning_streamfunction(model, st, grid=g,
                                      ofile=str(tmp_path / "ovt.png"))
    P.plot_zonal_mean(model, st, "v", grid=g,
                      ofile=str(tmp_path / "zm.png"))
    P.circulation_plot(model, st, "z", -0.1, n=32,
                       ofile=str(tmp_path / "circ.png"))
    P.plot_stratification(model, st, grid=g,
                          ofile=str(tmp_path / "strat.png"))
    for f in ("psi2d", "baro", "ovt", "zm", "circ", "strat"):
        assert (tmp_path / f"{f}.png").stat().st_size > 0


def test_publication_plots_channel(tmp_path):
    """Channel2D plot products (reference postprocess/channel2D.py
    plot_psib/plot_uvwb/plot_fieldb/plot_psi_profile/
    plot_surface_b_flux)."""
    from nupgcm import plotting as P

    eps, alpha, mu = 2e-1, 0.5, 1e1
    params = npg.Parameters(eps=eps, alpha=alpha, mu_rho=mu, N2=1 / alpha,
                            f=1.0, H=alpha)
    forc = npg.Forcings(nu=1.0, kappa_h=1e-2, kappa_v=1e-2, tau_x=0.0,
                        tau_y=0.0, b_surface_bc=npg.SurfaceDirichletBC(0.0))
    mesh = npg.generators.channel2D(0.1, alpha)
    spaces = npg.Spaces(
        mesh,
        u_diri_tags=["bottom", "basin", "coastline"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True)] * 3,
        b_diri_tags=["surface"], b_diri_vals=[0.0],
    )
    fe = npg.FEData(mesh, spaces)
    ts = npg.BDF2(t_start=0, t_stop=0.5, dt=0.1)
    model = npg.PGModel(fe, params, forc, ts, inv_itmax=200)
    st = model.set_b(model.rest_state(), lambda x: 0.05 * np.exp(2 * x[2]))
    st = model.run(st, n_info=0, max_steps=2)

    P.plot_channel_psib(model, st, n=32, rescale_z=True,
                        ofile=str(tmp_path / "cpsi.png"))
    P.plot_channel_uvwb(model, st, rescale_z=True,
                        ofile=str(tmp_path / "cuvwb.png"))
    P.plot_channel_field(model, st, "v", rescale_z=True,
                         ofile=str(tmp_path / "cv.png"))
    P.plot_psi_profile(model, st, -0.75, n=48,
                       ofile=str(tmp_path / "cprof.png"))
    P.plot_surface_b_flux(model, st, n=48,
                          ofile=str(tmp_path / "cflux.png"))
    for f in ("cpsi", "cuvwb", "cv", "cprof", "cflux"):
        assert (tmp_path / f"{f}.png").stat().st_size > 0
