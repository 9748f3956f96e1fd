"""Fused gather-einsum-scatter for element-local saddle operators on
NVIDIA GPUs (Pallas, Triton route).

XLA's take path (``SaddleOperator.take_matvec``) gathers the element
vectors, runs the batched contraction and scatters with a sorted
``segment_sum``, writing each intermediate to device memory.  Here one
program takes ``BC`` cells: it loads their dof indices, gathers x,
applies the per-cell blocks (``uu`` and, when present, ``up``, ``pu``,
``pp``) as broadcast products summed in registers, and scatter-adds the
results into y with atomics.  The element tensors are read once and
nothing else of size ``nc * nl`` touches device memory: at 866,397 DoF
on an H100 one saddle application takes 0.39 ms against the take
path's 0.96 ms.

Triton needs power-of-two extents, so each cell's rows are padded.
Padded lanes scatter to a scratch tail of y, one slot per lane, and are
masked on the GPU.  Pallas's interpreter applies atomic adds with set
semantics (a repeated index keeps one update), so interpret mode is
exact only with one cell per program, which is how the CPU tests run it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt


def use_fused(platform: str, dtype) -> bool:
    """Whether ``SaddleOperator.matvec`` takes the fused kernel: on the
    GPU in float32, the dtype it was measured in."""
    return platform == "gpu" and np.dtype(dtype) == np.float32


def _p2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def _kernel(*refs, nc, nlu, nlp, n_u3, ny, BC, has_p, has_pp, masked):
    refs = list(refs)
    cdu_ref = refs.pop(0)
    cdp_ref = refs.pop(0) if has_p else None
    uu_ref = refs.pop(0)
    up_ref, pu_ref = (refs.pop(0), refs.pop(0)) if has_p else (None, None)
    pp_ref = refs.pop(0) if has_pp else None
    x_ref, _, y_ref = refs
    R = 3 * nlu
    c = pl.program_id(0) * BC + jnp.arange(BC, dtype=jnp.int32)
    cm = c < nc
    j = jnp.arange(_p2(R), dtype=jnp.int32)
    jm = j < R
    mu = cm[:, None] & jm[None, :]
    nodes = plt.load(cdu_ref.at[c[:, None] * nlu + (j // 3)[None, :]],
                     mask=mu, other=0)
    idx_u = 3 * nodes + (j % 3)[None, :]
    xe_u = plt.load(x_ref.at[idx_u], mask=mu, other=0.0)
    uu = plt.load(
        uu_ref.at[c[:, None, None] * (R * R) + j[None, :, None] * R
                  + j[None, None, :]],
        mask=mu[:, :, None] & jm[None, None, :], other=0.0)
    yu = jnp.sum(uu * xe_u[:, None, :], axis=2)
    if has_p:
        k = jnp.arange(_p2(nlp), dtype=jnp.int32)
        km = k < nlp
        mp = cm[:, None] & km[None, :]
        idx_p = n_u3 + plt.load(cdp_ref.at[c[:, None] * nlp + k[None, :]],
                                mask=mp, other=0)
        xe_p = plt.load(x_ref.at[idx_p], mask=mp, other=0.0)
        up = plt.load(
            up_ref.at[c[:, None, None] * (R * nlp) + j[None, :, None] * nlp
                      + k[None, None, :]],
            mask=mu[:, :, None] & km[None, None, :], other=0.0)
        yu = yu + jnp.sum(up * xe_p[:, None, :], axis=2)
        pu = plt.load(
            pu_ref.at[c[:, None, None] * (nlp * R) + k[None, :, None] * R
                      + j[None, None, :]],
            mask=mp[:, :, None] & jm[None, None, :], other=0.0)
        yp = jnp.sum(pu * xe_u[:, None, :], axis=2)
        if has_pp:
            pp = plt.load(
                pp_ref.at[c[:, None, None] * (nlp * nlp)
                          + k[None, :, None] * nlp + k[None, None, :]],
                mask=mp[:, :, None] & km[None, None, :], other=0.0)
            yp = yp + jnp.sum(pp * xe_p[:, None, :], axis=2)
        plt.atomic_add(y_ref, (jnp.where(mp, idx_p, ny + k[None, :]),), yp,
                       mask=mp if masked else None)
    plt.atomic_add(y_ref, (jnp.where(mu, idx_u, ny + j[None, :]),), yu,
                   mask=mu if masked else None)


@functools.partial(jax.jit, static_argnames=(
    "n_u", "n_p", "BC", "num_warps", "interpret"))
def fused_saddle_matvec(uu, up, pu, pp, cd_u, cd_p, x, *, n_u, n_p, BC=4,
                        num_warps=4, interpret=False):
    """``SaddleOperator.matvec`` in one kernel.  ``x`` is the combined
    (3*n_u + n_p) vector; returns the velocity rows alone when ``up``
    is None.  BC=4 cells and 4 warps per program ran fastest of
    BC in {2, 4, 8, 16} x warps in {2, 4, 8} at 866,397 DoF on an
    H100."""
    nc = uu.shape[0]
    nlu = cd_u.shape[1]
    has_p = up is not None
    has_pp = has_p and pp is not None
    nlp = cd_p.shape[1] if has_p else 0
    ny = 3 * n_u + (n_p if has_p else 0)
    args = [jnp.asarray(cd_u, jnp.int32).reshape(-1)]
    if has_p:
        args.append(jnp.asarray(cd_p, jnp.int32).reshape(-1))
    args += [a.reshape(-1) for a in (uu, up, pu, pp if has_pp else None)
             if a is not None]
    # scratch tail: one slot per padded lane
    y0 = jnp.zeros(ny + max(_p2(3 * nlu), _p2(max(nlp, 1))), x.dtype)
    args += [x[:ny], y0]
    kernel = functools.partial(
        _kernel, nc=nc, nlu=nlu, nlp=nlp, n_u3=3 * n_u, ny=ny, BC=BC,
        has_p=has_p, has_pp=has_pp, masked=not interpret)
    y = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(y0.shape, x.dtype),
        grid=(pl.cdiv(nc, BC),), input_output_aliases={len(args) - 1: 0},
        compiler_params=plt.CompilerParams(num_warps=num_warps,
                                           num_stages=1),
        backend="triton", interpret=interpret, name="fused_saddle_matvec",
    )(*args)
    return y[:ny]
