"""Mesh generators + gmsh reader: conformity, volumes, tags."""

import math
from itertools import combinations

import numpy as np
import pytest

from nupgcm.mesh.core import Mesh, unique_edges
from nupgcm.mesh.generators import bowl2D, bowl3D, box_mesh, rect_mesh
from nupgcm.mesh.gmsh_reader import read_msh


def face_conformity(mesh: Mesh):
    """Every interior facet shared by exactly 2 cells, boundary by 1."""
    nvert = mesh.tdim + 1
    faces = {}
    for c in mesh.cells:
        for f in combinations(sorted(c), nvert - 1):
            faces[f] = faces.get(f, 0) + 1
    counts = np.array(list(faces.values()))
    assert counts.max() <= 2
    return (counts == 1).sum()


def total_volume(mesh: Mesh) -> float:
    _, detJ = mesh.cell_jacobians()
    assert detJ.min() > 0, "all cells positively oriented"
    return detJ.sum() / math.factorial(mesh.tdim)


def test_rect_mesh():
    m = rect_mesh(5, 4)
    assert abs(total_volume(m) - 1.0) < 1e-14
    face_conformity(m)
    sv, _ = m.tag_closure(["top"])
    assert np.allclose(m.coords[sv, 2], 1.0)


def test_box_mesh():
    m = box_mesh(3, 3, 3)
    assert abs(total_volume(m) - 1.0) < 1e-13
    face_conformity(m)
    sv, se = m.tag_closure(["boundary"])
    # all 6 faces tagged: vertices on the boundary of the unit cube
    x = m.coords[sv]
    on_bnd = np.any((np.abs(x) < 1e-14) | (np.abs(x - 1) < 1e-14), axis=1)
    assert on_bnd.all()


def test_bowl2D():
    alpha = 0.5
    m = bowl2D(0.1, alpha)
    # area = int alpha (1 - x^2) dx = 4 alpha / 3
    assert abs(total_volume(m) - 4 * alpha / 3) < 0.02
    face_conformity(m)
    sv, _ = m.tag_closure(["surface"])
    assert np.allclose(m.coords[sv, 2], 0.0)
    cv, _ = m.tag_closure(["coastline"])
    assert len(cv) == 2
    assert np.allclose(np.abs(m.coords[cv, 0]), 1.0)


def test_bowl3D():
    alpha = 0.5
    m = bowl3D(0.15, alpha)
    # volume = alpha pi / 2
    assert abs(total_volume(m) - alpha * np.pi / 2) < 0.03
    face_conformity(m)
    sv, _ = m.tag_closure(["surface"])
    assert np.allclose(m.coords[sv, 2], 0.0)
    cv, _ = m.tag_closure(["coastline"])
    r = np.linalg.norm(m.coords[cv, :2], axis=1)
    assert np.allclose(r, 1.0)
    # coastline is closure of both surface and bottom boundaries
    bv, _ = m.tag_closure(["bottom"])
    assert set(cv) <= set(bv)


def test_unique_edges_roundtrip():
    m = box_mesh(2, 2, 2)
    edges, cell_edges = unique_edges(m.cells)
    # each cell's local edge k connects the LOCAL_EDGES vertex pair
    from nupgcm.fem.reference import LOCAL_EDGES

    led = np.array(LOCAL_EDGES[3])
    for ci in range(min(10, m.n_cells)):
        for k, (i, j) in enumerate(led):
            pair = sorted((m.cells[ci, i], m.cells[ci, j]))
            assert list(edges[cell_edges[ci, k]]) == pair


GMSH_SAMPLE = """$MeshFormat
4.1 0 8
$EndMeshFormat
$PhysicalNames
2
1 1 "boundary"
2 2 "interior"
$EndPhysicalNames
$Entities
0 1 1 0
1 0 0 0 1 1 0 1 1 1 0
1 0 0 0 1 1 0 1 2 1 1
$EndEntities
$Nodes
2 4 1 4
1 1 0 2
1
2
0 0 0
1 0 0
2 1 0 2
3
4
1 1 0
0 1 0
$EndNodes
$Elements
2 4 1 4
1 1 1 2
1 1 2
2 2 3
2 1 2 2
3 1 2 3
4 1 3 4
$EndElements
"""


def test_gmsh_reader(tmp_path):
    p = tmp_path / "sample.msh"
    p.write_text(GMSH_SAMPLE)
    m = read_msh(str(p))
    assert m.tdim == 2
    assert m.n_vertices == 4
    assert m.n_cells == 2
    assert "boundary" in m.tagged and "interior" in m.tagged
    v, e = m.tag_closure(["boundary"])
    assert set(v) == {0, 1, 2}


def test_msh_writer_roundtrip(tmp_path):
    """write_msh -> read_msh preserves vertices, cells (as sets), and
    physical-group closures for 2D and 3D generated meshes."""
    from nupgcm.mesh.writer import write_msh

    for name, mesh in [
        ("bowl3D", bowl3D(0.3, 0.5, nz=3)),
        ("bowl2D", bowl2D(0.2, 0.5)),
    ]:
        path = str(tmp_path / f"{name}.msh")
        write_msh(mesh, path)
        m2 = read_msh(path)
        assert m2.tdim == mesh.tdim
        assert m2.n_vertices == mesh.n_vertices
        assert m2.n_cells == mesh.n_cells
        assert np.allclose(m2.coords, mesh.coords)
        cells = lambda m: set(map(tuple, np.sort(m.cells, axis=1)))
        assert cells(m2) == cells(mesh)
        for t in mesh.tag_names():
            v1, _ = mesh.tag_closure([t])
            v2, _ = m2.tag_closure([t])
            assert set(v1) == set(v2), (name, t)


def test_quality_stats():
    """Inner-angle/volume statistics parity with the reference's
    quality tooling (meshes/mesh_quality.jl:16-115)."""
    from nupgcm.mesh.quality import inner_angles, volumes, stats, quality_report

    # equilateral triangle: all angles 60
    coords = np.array([[0, 0, 0], [1, 0, 0], [0.5, math.sqrt(3) / 2, 0]])
    th = inner_angles(coords[:, :2], np.array([[0, 1, 2]]))
    assert np.allclose(th, 60.0)
    assert th.shape == (3,)
    # regular tet: 12 angles, all 60
    c4 = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]], float)
    th4 = inner_angles(c4, np.array([[0, 1, 2, 3]]))
    assert th4.shape == (12,)
    assert np.allclose(th4, 60.0)
    # unit box volumes sum to 1
    m = box_mesh(2, 2, 2)
    v = volumes(m.coords, m.cells)
    assert abs(v.sum() - 1.0) < 1e-12
    s = stats(v)
    assert s["min"] <= s["median"] <= s["max"]
    rep = quality_report(m)
    assert rep["n_cells"] == m.n_cells
    assert "inner angles" in rep["text"]
    # 2D report path
    rep2 = quality_report(rect_mesh(3, 3))
    assert abs(np.sort(np.array([rep2["volumes"]["max"]]))[0] - 1 / 18) < 1e-12
