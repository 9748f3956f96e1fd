"""Native meshkit library vs NumPy/SciPy reference implementations."""

import numpy as np
import pytest

from nupgcm.mesh import native
from nupgcm.mesh.core import unique_edges as py_unique_edges
from nupgcm.mesh.generators import bowl3D


@pytest.fixture(scope="module")
def lib():
    lib = native.load()
    if lib is None:
        pytest.skip("native meshkit not buildable in this environment")
    return lib


@pytest.fixture(scope="module")
def mesh():
    return bowl3D(0.15, 0.5)


def test_unique_edges_matches_numpy(lib, mesh):
    e1, ce1 = py_unique_edges(mesh.cells)
    e2, ce2 = native.unique_edges(mesh.cells)
    assert np.array_equal(e1, e2)
    assert np.array_equal(ce1, ce2)


def test_rcm_valid_and_effective(lib, mesh):
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from nupgcm.fem.spaces import ScalarSpace

    s = ScalarSpace(mesh, 2)
    rows = np.repeat(s.cell_dofs, s.nloc, axis=1).ravel()
    cols = np.tile(s.cell_dofs, (1, s.nloc)).ravel()
    g = sp.csr_matrix((np.ones(len(rows), np.int8), (rows, cols)),
                      shape=(s.ndof, s.ndof))
    g.sum_duplicates()
    perm = native.rcm(g.indptr, g.indices)
    assert sorted(perm.tolist()) == list(range(s.ndof))

    def bandwidth(p):
        inv = np.empty_like(p)
        inv[p] = np.arange(len(p))
        coo = g.tocoo()
        return int(np.abs(inv[coo.row] - inv[coo.col]).max())

    bw_native = bandwidth(perm)
    bw_scipy = bandwidth(np.asarray(reverse_cuthill_mckee(g, symmetric_mode=True),
                                    dtype=np.int64))
    bw_none = bandwidth(np.arange(s.ndof, dtype=np.int64))
    assert bw_native < bw_none / 2
    assert bw_native <= 1.5 * bw_scipy


def test_partition_cells(lib, mesh):
    from nupgcm.fem.spaces import ScalarSpace

    s = ScalarSpace(mesh, 2)
    s.renumber(s.rcm_permutation())  # contiguity needs RCM order
    parts = native.partition_cells(s.cell_dofs, s.ndof, 4)
    counts = np.bincount(parts, minlength=4)
    assert counts.sum() == mesh.n_cells
    # RCM-ordered dofs give a reasonably balanced contiguous partition
    assert counts.min() > 0.25 * counts.max()


def test_msh_parse_matches_python(lib, tmp_path):
    from tests.test_mesh import GMSH_SAMPLE

    p = tmp_path / "sample.msh"
    p.write_text(GMSH_SAMPLE)
    out = native.parse_msh_fast(str(p))
    assert out is not None
    coords, node_ids, blocks = out
    assert coords.shape == (4, 3)
    tris = [b for b in blocks if b[0] == 2]
    assert sum(b[3].shape[0] for b in tris) == 2
