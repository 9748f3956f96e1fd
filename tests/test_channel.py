"""Channel configs: periodic re-entrant channel3D and the 2D
meridional channel section (reference channel.jl / mesh_channel2D.jl
geometries)."""

import math
from itertools import combinations

import numpy as np
import pytest

import nupgcm as npg
from nupgcm.mesh.generators import channel2D, channel3D


def test_channel2D_mesh():
    m = channel2D(0.05, 0.5)
    _, d = m.cell_jacobians()
    assert d.min() > 0
    # area: flat part (0.5 - L_curve) * H + bezier part
    # int_0^1 H t(2-t) L_curve dt = H L_curve * 2/3... accept 5%
    H, Lc = 0.5, 0.1875
    area_exact = H * (0.5 - Lc) + H * Lc * (2 / 3)
    assert abs((d / 2).sum() - area_exact) < 0.05 * area_exact
    assert set(m.tag_names()) >= {"surface", "bottom", "basin", "coastline"}
    assert m.plane_axes == [1, 2]  # y-z meridional plane
    bv, _ = m.tag_closure(["basin"])
    assert np.allclose(m.coords[bv, 1], -0.5)


def test_channel3D_mesh_periodic():
    m = channel3D(0.1)
    _, d = m.cell_jacobians()
    assert d.min() > 0
    # volume = Lx * int D0 (1 - s^2) dy = 1 * 0.5 * (2/3) * 0.5
    vol = (d / 6).sum()
    assert abs(vol - 0.5 * 0.5 * 2 / 3) < 0.05
    assert m.periodic_pairs is not None and len(m.periodic_pairs) > 0
    # pairs map x=Lx to x=0 with identical (y, z)
    s, mas = m.periodic_pairs[:, 0], m.periodic_pairs[:, 1]
    assert np.allclose(m.coords[s, 0], 1.0)
    assert np.allclose(m.coords[mas, 0], 0.0)
    assert np.allclose(m.coords[s, 1:], m.coords[mas, 1:], atol=1e-12)
    # conformity
    faces = {}
    for c in m.cells:
        for f in combinations(sorted(c.tolist()), 3):
            faces[f] = faces.get(f, 0) + 1
    assert max(faces.values()) <= 2


def test_periodic_dof_identification():
    m = channel3D(0.12)
    sp = npg.Spaces(m, b_diri_tags=[], b_diri_vals=[])
    bs = sp.b_space
    n_slave_v = len(m.periodic_pairs)
    n_slave_e = len(m.periodic_edge_pairs())
    assert (~bs.active).sum() == n_slave_v + n_slave_e
    # cell_dofs never reference inactive dofs
    inactive = np.where(~bs.active)[0]
    assert not np.isin(bs.cell_dofs, inactive).any()
    # resolve_periodic fills slaves with master values
    vals = np.arange(bs.ndof, dtype=float)
    r = bs.resolve_periodic(vals)
    assert (r[inactive] != vals[inactive]).all() or n_slave_v == 0
    assert np.array_equal(r[bs.active], vals[bs.active])


def test_channel_wind_driven_jet():
    """Zonal wind over the re-entrant channel spins up an along-channel
    jet that is periodic across the seam."""
    m3 = channel3D(0.1)
    params = npg.Parameters(eps=0.3, alpha=1.0, mu_rho=1.0, N2=1.0,
                            f=lambda x: 1.0 + 0 * x[1], H=lambda x: 0.5)
    forc = npg.Forcings(nu=1.0, kappa_h=1e-2, kappa_v=1e-2,
                        tau_x=-0.05, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0))
    spaces = npg.Spaces(m3, u_diri_tags=["bottom", "coastline"],
                        u_diri_vals=[(0, 0, 0)] * 2,
                        u_diri_masks=[(True, True, True)] * 2,
                        b_diri_tags=[], b_diri_vals=[])
    fe = npg.FEData(m3, spaces)
    ts = npg.BDF1(t_start=0, t_stop=0.5, dt=0.1)
    model = npg.PGModel(fe, params, forc, ts)
    st = model.run(model.rest_state(), n_info=0, max_steps=5)
    u = np.asarray(st.u)
    assert np.isfinite(u).all()
    # along-channel (zonal) jet dominates
    assert np.abs(u[:, 0]).max() > 5 * np.abs(u[:, 1]).max()
    # periodicity: same values either side of the seam
    from nupgcm.utils.pointeval import FieldEvaluator

    ev = FieldEvaluator(m3)
    pts0 = np.array([[0.001, 0.0, -0.2], [0.001, 0.1, -0.1]])
    pts1 = pts0.copy()
    pts1[:, 0] = 0.999
    u0 = ev.eval(spaces.u_space, u, pts0)
    u1 = ev.eval(spaces.u_space, u, pts1)
    assert np.abs(u0 - u1).max() < 5e-3 * np.abs(u0).max()
    # x-invariance of the solution (zonally symmetric forcing)
    pts_mid = pts0.copy()
    pts_mid[:, 0] = 0.5
    um = ev.eval(spaces.u_space, u, pts_mid)
    assert np.abs(u0 - um).max() < 0.05 * np.abs(u0).max()


def test_channel_basin_mesh():
    """Composite channel+basin geometry: conforming, positive cells,
    x-periodic channel seam, coastline only in the basin region."""
    from nupgcm.mesh.generators import channel_basin

    m = channel_basin(0.1, alpha=0.2)
    _, d = m.cell_jacobians()
    assert d.min() > 0
    faces = {}
    for c in m.cells:
        for f in combinations(sorted(c.tolist()), 3):
            faces[f] = faces.get(f, 0) + 1
    assert max(faces.values()) <= 2
    assert m.periodic_pairs is not None and len(m.periodic_pairs) > 0
    s, mas = m.periodic_pairs[:, 0], m.periodic_pairs[:, 1]
    assert np.allclose(m.coords[s, 0], 1.0)
    assert np.allclose(m.coords[mas, 0], 0.0)
    # periodic pairs only exist in the channel region (y <= -0.5)
    assert m.coords[s, 1].max() <= -0.5 + 1e-9
    # coastline nodes at the surface with zero depth
    cv, _ = m.tag_closure(["coastline"])
    assert np.allclose(m.coords[cv, 2], 0.0)
    # basin interior reaches the full depth H = 0.2
    assert abs(m.coords[:, 2].min() + 0.2) < 1e-9


def test_channel_basin_runs():
    """Wind-driven channel_basin spins up stably with the periodic
    seam active."""
    from nupgcm.mesh.generators import channel_basin

    m = channel_basin(0.12, alpha=0.2)
    params = npg.Parameters(eps=0.3, alpha=0.2, mu_rho=1.0, N2=1.0,
                            f=lambda x: 1.0 + 0.5 * x[1], H=lambda x: 0.2)
    forc = npg.Forcings(nu=1.0, kappa_h=1e-2, kappa_v=1e-2,
                        tau_x=lambda x: -0.05 * np.cos(np.pi * x[1]), tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0))
    spaces = npg.Spaces(m, u_diri_tags=["bottom", "coastline"],
                        u_diri_vals=[(0, 0, 0)] * 2,
                        u_diri_masks=[(True, True, True)] * 2,
                        b_diri_tags=[], b_diri_vals=[])
    fe = npg.FEData(m, spaces)
    ts = npg.BDF1(t_start=0, t_stop=0.3, dt=0.1)
    model = npg.PGModel(fe, params, forc, ts)
    st = model.set_b(model.rest_state(), lambda x: 0.5 * x[2])
    st = model.run(st, n_info=0, max_steps=3)
    assert np.isfinite(np.asarray(st.u)).all()
    assert np.abs(np.asarray(st.u)).max() > 1e-4


def _seam_unmatched_edges(m):
    """Slave-plane edges with no master under the periodic map (must be
    0 for a conforming seam)."""
    e = m.edges
    s2m = -np.ones(m.n_vertices, np.int64)
    s2m[m.periodic_pairs[:, 0]] = m.periodic_pairs[:, 1]
    both = (s2m[e[:, 0]] >= 0) & (s2m[e[:, 1]] >= 0)
    return int(both.sum()) - len(m.periodic_edge_pairs())


@pytest.mark.parametrize("gen_name", [
    "channel_basin", "channel_basin_flat", "channel_basin_no_flat",
    "channel_basin_no_flat_round_end"])
def test_channel_basin_family_conforming_seam(gen_name):
    """Every channel_basin variant builds a valid mesh whose periodic
    seam is EXACTLY conforming: all slave-plane edges have master
    edges, so no P2 dof falls back to weak coupling (the round-2 gap;
    reference meshes/channel_basin*.jl seam via gmsh setPeriodic)."""
    from nupgcm.mesh import generators

    m = getattr(generators, gen_name)(0.1, alpha=0.2)
    _, d = m.cell_jacobians()
    assert d.min() > 0
    faces = {}
    for c in m.cells:
        for f in combinations(sorted(c.tolist()), 3):
            faces[f] = faces.get(f, 0) + 1
    assert max(faces.values()) <= 2
    assert len(m.periodic_pairs) > 0
    assert _seam_unmatched_edges(m) == 0
    assert set(m.tag_names()) >= {"surface", "bottom", "coastline", "interior"}
    # full depth reached
    assert abs(m.coords[:, 2].min() + 0.2) < 1e-9


def test_channel_basin_flat_exact_volume():
    """Flat variant is a box of depth H: volume is exact."""
    from nupgcm.mesh.generators import channel_basin_flat

    m = channel_basin_flat(0.1, alpha=0.2)
    _, d = m.cell_jacobians()
    assert abs((d / 6).sum() - 0.2 * 1.0 * 2.0) < 1e-12
    # vertical walls are tagged bottom; coastline is the 1D surface rim
    assert 1 in m.tagged["coastline"]
    cv, _ = m.tag_closure(["coastline"])
    assert np.allclose(m.coords[cv, 2], 0.0)


def test_channel_basin_refinement_grading():
    """refinement_factor grades the sigma layers: min vertical spacing
    ~ h/r at bottom+surface, interior ~ h (the reference's
    Distance/Threshold near-boundary refinement,
    meshes/channel_basin.jl:131-147)."""
    from nupgcm.mesh.generators import channel_basin

    r = 4
    m = channel_basin(0.1, alpha=0.2, refinement_factor=r)
    _, d = m.cell_jacobians()
    assert d.min() > 0
    assert _seam_unmatched_edges(m) == 0
    # deepest column: spacing at the ends is ~1/r of the interior
    col = np.hypot(m.coords[:, 0] - 0.5, m.coords[:, 1] - 0.2) < 0.05
    z = np.unique(np.round(m.coords[col, 2], 10))
    dz = np.diff(np.sort(z))
    assert dz.min() < 1.5 * 0.05 / r
    assert dz.max() > 3 * dz.min()
    # graded near BOTH boundaries
    assert dz[0] < 1.5 * 0.05 / r and dz[-1] < 1.5 * 0.05 / r
