"""Element-local operators against the plain NumPy float64 references
(nupgcm/ops/element.py) that the on-device smoke check also uses:
random element tensors on a real mesh's dof tables and scatter plans."""

import numpy as np
import pytest

import nupgcm as npg
from nupgcm.ops.element import (ElementOperator, SaddleOperator,
                                element_matvec_reference,
                                saddle_matvec_reference)


@pytest.fixture(scope="module")
def fe():
    mesh = npg.generators.bowl3D(0.3, 0.5, nz=3)
    spaces = npg.Spaces(
        mesh, u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True),
                      (False, False, True)],
        b_diri_tags=["coastline", "surface"], b_diri_vals=[0.0, 0.0])
    return npg.FEData(mesh, spaces)


def _rand(rng, *shape):
    return rng.standard_normal(shape)


@pytest.mark.parametrize("case", ["saddle", "uu", "up", "scalar", "p1p1_pp"])
def test_operator_matches_numpy_reference(fe, case):
    rng = np.random.default_rng(1)
    nc = fe.cd_u.shape[0]
    nlu3, nlp = 3 * fe.cd_u.shape[1], fe.cd_p.shape[1]
    n_u, n_p = fe.spaces.u_space.ndof, fe.spaces.p_space.ndof
    cd_u = np.asarray(fe.cd_u, np.int32)
    cd_p = np.asarray(fe.cd_p, np.int32)
    if case == "scalar":
        Ae = _rand(rng, nc, *fe.cd_b.shape[1:] * 2)
        op = ElementOperator(Ae=Ae, cd_rows=np.asarray(fe.cd_b, np.int32),
                             cd_cols=np.asarray(fe.cd_b, np.int32),
                             row_plan=fe.vec_plan_b)
        x = rng.standard_normal(fe.spaces.n_b)
        got = op.matvec(x)
        ref = element_matvec_reference(Ae, fe.cd_b, fe.cd_b, fe.spaces.n_b, x)
    elif case == "p1p1_pp":
        # the P1-P1 coarse saddle: vertex space on both sides, with the
        # stabilizing pressure-pressure block
        nlv3 = 3 * nlp
        blocks = dict(uu=_rand(rng, nc, nlv3, nlv3), up=_rand(rng, nc, nlv3, nlp),
                      pu=_rand(rng, nc, nlp, nlv3), pp=_rand(rng, nc, nlp, nlp))
        op = SaddleOperator(cd_u=cd_p, cd_p=cd_p, u_plan=fe.vec_plan_p,
                            p_plan=fe.vec_plan_p, n_u_nodes=n_p, **blocks)
        x = rng.standard_normal(4 * n_p)
        got = op.matvec(x)
        ref = saddle_matvec_reference(cd_p, cd_p, n_p, n_p, x, **blocks)
    else:
        blocks = dict(uu=_rand(rng, nc, nlu3, nlu3), up=_rand(rng, nc, nlu3, nlp),
                      pu=_rand(rng, nc, nlp, nlu3))
        x = rng.standard_normal(fe.n_inv)
        if case == "uu":
            blocks["up"] = blocks["pu"] = None
        op = SaddleOperator(cd_u=cd_u, cd_p=cd_p, u_plan=fe.vec_plan_u_nodes,
                            p_plan=fe.vec_plan_p, n_u_nodes=n_u, **blocks)
        if case == "up":
            got = op.up_matvec(x[3 * n_u:])
            ref = saddle_matvec_reference(cd_u, cd_p, n_u, n_p, x,
                                          up=blocks["up"])
        else:
            got = op.matvec(x)
            ref = saddle_matvec_reference(cd_u, cd_p, n_u, n_p, x, **blocks)
    got = np.asarray(got)
    assert got.shape == ref.shape
    # float64 throughout; only the order of the scatter sums differs
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("case", ["saddle", "uu", "p1p1_pp"])
def test_fused_kernel_interpret_matches_numpy_reference(fe, case):
    """The fused Triton kernel (ops/fused.py) in interpret mode, one
    cell per program (the interpreter's atomic adds keep one update per
    repeated index, so only the GPU sums a repeated dof)."""
    from nupgcm.ops.fused import fused_saddle_matvec

    rng = np.random.default_rng(2)
    nc = fe.cd_u.shape[0]
    n_u, n_p = fe.spaces.u_space.ndof, fe.spaces.p_space.ndof
    nlp = fe.cd_p.shape[1]
    cd_p = np.asarray(fe.cd_p, np.int32)
    if case == "p1p1_pp":
        cd_u, nn, R = cd_p, n_p, 3 * nlp
    else:
        cd_u, nn, R = np.asarray(fe.cd_u, np.int32), n_u, 3 * fe.cd_u.shape[1]
    blocks = dict(uu=_rand(rng, nc, R, R), up=_rand(rng, nc, R, nlp),
                  pu=_rand(rng, nc, nlp, R), pp=None)
    if case == "uu":
        blocks.update(up=None, pu=None)
    if case == "p1p1_pp":
        blocks["pp"] = _rand(rng, nc, nlp, nlp)
    # padding cells repeat one dof throughout; their tensors are zero,
    # as the model's are
    pad = np.abs(np.asarray(fe.geom.wq)).sum(axis=1) == 0
    for v in blocks.values():
        if v is not None:
            v[pad] = 0.0
    x = rng.standard_normal(3 * nn + n_p)
    got = fused_saddle_matvec(blocks["uu"], blocks["up"], blocks["pu"],
                              blocks["pp"], cd_u, cd_p, x, n_u=nn, n_p=n_p,
                              BC=1, interpret=True)
    ref = saddle_matvec_reference(cd_u, cd_p, nn, n_p, x, **blocks)
    assert got.shape == ref.shape
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def test_fused_kernel_choice():
    """The fused kernel serves float32 on the GPU; everything else takes
    XLA's take path, which is what runs here."""
    import jax

    from nupgcm.ops.fused import use_fused

    assert use_fused("gpu", np.float32)
    assert not use_fused("gpu", np.float64)
    assert not use_fused("cpu", np.float32)
    assert not use_fused(jax.default_backend(), np.float32)
