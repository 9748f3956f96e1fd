"""The PG model driver: state, toolkits, jitted timestep, run loop.

Accelerator equivalent of the reference's ``Model`` / ``run!`` /
``evolve!`` / ``invert!`` stack (reference src/model.jl).  Key design
departures, all made so the whole step compiles to device code:

  * State is a pytree of full-length dof vectors (Dirichlet dofs are
    pinned by masks, never compacted) -- static shapes under jit.
  * One fused, jitted ``step`` performs: CFL dt update -> advection rhs
    assembly (element-batched einsum) -> evolution CG solve ->
    inversion (F)GMRES solve -> diagnostics.  No host round-trips in
    the hot loop; ``run`` can dispatch blocks of steps via lax.scan.
  * State-dependent operator rebuilds (convection kappa_v each step,
    eddy nu every 10 steps: reference src/model.jl:160-170, 229-246)
    are value-only updates of static sparsity structures, computed on
    device inside the step.
  * The buoyancy vector carries its Dirichlet values, so the
    B-matrix product already contains the reference's ``b_diri`` lift
    (reference src/inversion.jl:242-243 assembles it separately).
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..fem import assembly as asm
from ..fem.spaces import _eval_coeff
from ..ops.element import ElementOperator, SaddleOperator
from ..ops.sparse import COOMatrix, MaskedOperator, coo_from_plan
from ..solvers.cg import cg
from ..solvers.gmres import gmres
from ..solvers.preconditioners import BlockStokesPrecond
from .config import Forcings, Parameters, SurfaceDirichletBC, SurfaceFluxBC
from .fedata import FEData
from .timesteppers import BDF1, BDF2


class BlowUpError(RuntimeError):
    pass


def _aggregate_vertices(cd_p: np.ndarray, nv: int, max_agg: int):
    """Cluster mesh vertices into <= max_agg contiguous aggregates.

    Capped BFS over the vertex-vertex connectivity (from the P1 cell
    dof table), seeded in vertex order -- vertices carry the RCM
    permutation (fem/spaces.py), so consecutive seeds grow
    band-compact aggregates.  The cap is grown until the aggregate
    count fits; stragglers surrounded by full aggregates become small
    aggregates of their own (harmless).  Returns (agg (nv,) int64,
    n_agg)."""
    from scipy import sparse as _sp

    nl = cd_p.shape[1]
    ii = [cd_p[:, a] for a in range(nl) for b in range(nl) if a != b]
    jj = [cd_p[:, b] for a in range(nl) for b in range(nl) if a != b]
    adj = _sp.csr_matrix(
        (np.ones(nl * (nl - 1) * cd_p.shape[0], np.int8),
         (np.concatenate(ii), np.concatenate(jj))), shape=(nv, nv))
    indptr, indices = adj.indptr, adj.indices
    cap = max(2, -(-nv // max_agg))
    while True:
        agg = np.full(nv, -1, np.int64)
        na = 0
        for seed in range(nv):
            if agg[seed] >= 0:
                continue
            agg[seed] = na
            size = 1
            frontier = [seed]
            while frontier and size < cap:
                nxt = []
                for v in frontier:
                    for w in indices[indptr[v]:indptr[v + 1]]:
                        if agg[w] < 0:
                            agg[w] = na
                            size += 1
                            nxt.append(w)
                            if size >= cap:
                                break
                    if size >= cap:
                        break
                frontier = nxt
            na += 1
        if na <= max_agg:
            return agg, na
        cap = int(cap * 1.5) + 1


@jax.tree_util.register_pytree_node_class
@dataclass
class State:
    """Prognostic + diagnostic model state (full dof vectors)."""

    u: jnp.ndarray  # (ndof_u, 3)
    p: jnp.ndarray  # (n_p,)
    b: jnp.ndarray  # (n_b,) including Dirichlet dofs
    u_prev: jnp.ndarray
    b_prev: jnp.ndarray
    t: jnp.ndarray  # scalar
    dt: jnp.ndarray  # scalar
    step: jnp.ndarray  # int32 step counter

    def tree_flatten(self):
        return (
            (self.u, self.p, self.b, self.u_prev, self.b_prev, self.t, self.dt, self.step),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, c):
        return cls(*c)


def _quad_eval(fn_or_const, xq: np.ndarray, dtype) -> np.ndarray:
    """Evaluate a coefficient on physical quadrature points (host)."""
    if callable(fn_or_const):
        vals = np.asarray(_eval_coeff(fn_or_const, xq), dtype=np.float64)
        vals = np.broadcast_to(vals, xq.shape[:-1])
    else:
        vals = np.full(xq.shape[:-1], float(fn_or_const))
    return vals.astype(dtype)


class PGModel:
    """Planetary-geostrophic model on one JAX device mesh."""

    def __init__(
        self,
        fe: FEData,
        params: Parameters,
        forcings: Forcings,
        timestepper,
        dtype=None,
        inv_atol=1e-6,
        inv_rtol=1e-6,
        inv_itmax=0,
        inv_memory=20,
        evo_atol=1e-6,
        evo_rtol=1e-6,
        evo_itmax=0,
        preconditioner: str = "blockstokes",
        inner_iters_u: Optional[int] = None,
        inner_iters_p: int = 5,
        inner_method: Optional[str] = None,
        cond_ratio: float = 20.0,
        triangular: bool = True,
        twogrid: bool = True,
        saddle_coarse: Optional[bool] = None,
        coarse_dense_max: int = 12288,
        saddle_coarse_inner: Optional[int] = None,
        saddle_coarse_l2: Optional[bool] = None,
        assembly_chunk: int = 8192,
        matmul_precision: Optional[str] = "float32",
        table_mode: str = "auto",
    ):
        self.fe = fe
        self.params = params
        self.forcings = forcings
        self.ts = timestepper
        if dtype is None:
            dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        self.dtype = dtype
        # Matmul precision policy (utils/precision.py): at JAX's
        # default precision an f32 dot or einsum may run in TF32 on the
        # GPU's tensor cores (about three decimal digits).  The FE
        # element contractions and Krylov basis products need true f32
        # to hold the 1e-3 golden bar, so the default is "float32"
        # (HIGHEST), scoped to this model's traces and never
        # process-global.  Pass matmul_precision=None to keep the JAX
        # default.
        self.matmul_precision = matmul_precision
        # "const": static tables are closed over and inlined into the
        # executable (fine up to a few 100k DoF).  "args": the tables
        # ride as device-array jit arguments -- inlining O(100MB)
        # constants bloats the HLO and the compile.  "auto" switches
        # on size.
        if table_mode == "auto":
            table_mode = "args" if fe.n_inv > 300_000 else "const"
        self.table_mode = table_mode
        # Bounded default iteration budgets.  The solvers' own "2n"
        # cap lets an f32 solve that stagnates ~1 decade above tol at
        # production scale spin for a ~day-long single dispatch.
        # 25 restart cycles / 1000 CG steps is far beyond any
        # converging configuration.
        if inv_itmax == 0:
            inv_itmax = 25 * inv_memory
        if evo_itmax == 0:
            evo_itmax = 1000
        self.inv_opts = dict(atol=inv_atol, rtol=inv_rtol, itmax=inv_itmax, m=inv_memory)
        self.evo_opts = dict(atol=evo_atol, rtol=evo_rtol, itmax=evo_itmax)
        self.precond_kind = preconditioner
        self.cond_ratio = cond_ratio
        self.triangular = triangular
        self.twogrid = twogrid
        # below this size the coarse problem is solved by a precomputed
        # dense inverse (one dense matvec); above it by inner CG on the
        # element-local P1 operator
        self.coarse_dense_max = coarse_dense_max
        self.coarse_dense = 3 * fe.mesh.n_vertices <= coarse_dense_max
        # geostrophic (full-saddle P1-P1) coarse correction: the
        # small-Ekman fix and the strongest option overall (converges
        # in O(1) outer iterations).  Default ON at every size: small
        # meshes use a precomputed dense coarse inverse (one dense
        # matvec), large ones an inner block-preconditioned FGMRES on
        # the element-local P1-P1 coarse operator.  The u-block
        # two-grid then becomes redundant and is skipped.
        if saddle_coarse is None:
            saddle_coarse = True
        self.saddle_coarse = saddle_coarse
        self.saddle_coarse_dense = 4 * fe.mesh.n_vertices <= coarse_dense_max
        # second-level aggregate correction for the ITERATIVE coarse
        # path (production sizes): default on -- the near-exact coarse
        # solve it enables is what keeps the outer iteration count
        # h-flat past the dense-inverse size bound
        if saddle_coarse_l2 is None:
            saddle_coarse_l2 = True
        self.saddle_coarse_l2 = (saddle_coarse_l2 and self.saddle_coarse
                                 and not self.saddle_coarse_dense)
        self.saddle_coarse_delta = 1.0
        if self.saddle_coarse:
            self.twogrid = False
        if inner_method is None:
            # rotation-dominance at grid scale: Coriolis vs viscous
            # stiffness, f h^2 / (a2e2 nu).  Beyond ~10 the SPD
            # Chebyshev surrogate cannot damp the rotational fine
            # modes (measured: 37 vs 17 outer iterations at eps=0.05)
            # and the full-block inner GMRES smoother takes over.
            xq = fe.geom.xq[: min(len(fe.geom.xq), 4096)]
            f_med = float(np.median(np.abs(_quad_eval(params.f, xq, np.float64))))
            nu_med = float(np.median(np.abs(_quad_eval(forcings.nu, xq, np.float64))))
            rot = f_med * fe.h_median ** 2 / (params.a2e2 * max(nu_med, 1e-300))
            inner_method = (
                "inner_gmres" if (self.saddle_coarse and rot > 10.0) else "chebyshev"
            )
        self.inner_method = inner_method
        if saddle_coarse_inner is None:
            # the iterative coarse solve needs a deeper inner budget
            # in the rotation-dominated regime (measured: k=16 stalls
            # the outer at eps=0.05 while k=40 converges h-flat).
            # With the aggregate second level the cycle is strong
            # enough to apply DIRECTLY (k=0, no inner Krylov): at 0.87M
            # DoF a sweep of k=16/8/4/2/0 ran fastest at k=0 with the
            # outer iteration count unchanged; the rotation-dominated
            # regime keeps a moderate budget.
            if self.saddle_coarse_l2:
                saddle_coarse_inner = (
                    8 if self.inner_method == "inner_gmres" else 0)
            else:
                saddle_coarse_inner = (
                    40 if self.inner_method == "inner_gmres" else 16)
        self.saddle_coarse_inner = saddle_coarse_inner
        if inner_iters_u is None:
            # smoothing need only damp high frequencies next to a
            # coarse solve: 2 (saddle V-cycle) / 4 (u-block two-grid)
            # pre+post Chebyshev gave the fewest outer iterations;
            # the inner-GMRES smoother needs a slightly deeper Krylov
            # space to capture the rotational coupling (6 measured
            # optimal at eps=0.05)
            if self.inner_method == "inner_gmres":
                inner_iters_u = 6
            else:
                inner_iters_u = (2 if self.saddle_coarse
                                 else 4 if self.twogrid else 10)
        self.inner_iters = (inner_iters_u, inner_iters_p)
        self.assembly_chunk = assembly_chunk

        import os as _os
        import time as _time

        _dbg = _os.environ.get("NUPGCM_DEBUG_TIMING")
        # build-time device compute (chunked assembly, spectral bounds,
        # dense coarse inverses) runs under the scoped precision; the
        # step/invert functions defined here are individually wrapped
        # so later traces see the same policy
        from ..utils.precision import precision_ctx

        with precision_ctx(self.matmul_precision):
            _t0 = _time.time()
            self._build_constants()
            if _dbg:
                print(f"[build] constants {_time.time() - _t0:.1f}s", flush=True)
            _t0 = _time.time()
            self._build_operators()
            if _dbg:
                print(f"[build] operators {_time.time() - _t0:.1f}s", flush=True)
            _t0 = _time.time()
            self._build_functions()
            if _dbg:
                print(f"[build] functions {_time.time() - _t0:.1f}s", flush=True)

    # ------------------------------------------------------------------
    # static device constants
    # ------------------------------------------------------------------
    def _build_constants(self):
        """Static tables the jitted kernels close over.

        These stay NumPy arrays: a jit that closes over a device array
        copies it back to the host while lowering, whereas host
        constants are inlined into the executable and uploaded once
        ("const" table mode; "args" mode passes them as arguments).
        """
        fe, dt = self.fe, self.dtype
        sp = fe.spaces
        c = {}
        c["wq"] = np.asarray(fe.geom.wq, dt)
        c["invJT"] = np.asarray(fe.geom.invJT, dt)
        c["embed"] = np.asarray(fe.embed, dt)
        c["phi_u"] = np.asarray(fe.tab_u.phi, dt)
        c["dphi_u"] = np.asarray(fe.tab_u.dphi, dt)
        c["phi_p"] = np.asarray(fe.tab_p.phi, dt)
        c["dphi_p"] = np.asarray(fe.tab_p.dphi, dt)
        c["phi_b"] = np.asarray(fe.tab_b.phi, dt)
        c["dphi_b"] = np.asarray(fe.tab_b.dphi, dt)
        c["cd_u"] = np.asarray(fe.cd_u, np.int32)
        c["cd_b"] = np.asarray(fe.cd_b, np.int32)
        c["h_cells"] = np.asarray(fe.h_cells, dt)

        # coefficients at volume quadrature points (host eval, static)
        xq = fe.geom.xq
        fr, pr = self.forcings, self.params
        c["f_q"] = _quad_eval(pr.f, xq, dt)
        c["nu_q"] = _quad_eval(fr.nu, xq, dt)
        c["kh_q"] = _quad_eval(fr.kappa_h, xq, dt)
        c["kv_q"] = _quad_eval(fr.kappa_v, xq, dt)
        self.variable_nu = callable(fr.nu) or fr.eddy_param.is_on

        # eddy parameterization f at quad points
        if fr.eddy_param.is_on:
            c["f_eddy_q"] = _quad_eval(fr.eddy_param.f, xq, dt)

        # surface group
        surf = fe.surface
        c["wq_surf"] = np.asarray(surf.geom.wq, dt)
        c["phi_u_surf"] = np.asarray(surf.phi_u, dt)
        c["phi_b_surf"] = np.asarray(surf.phi_b, dt)
        c["taux_q"] = _quad_eval(fr.tau_x, surf.geom.xq, dt)
        c["tauy_q"] = _quad_eval(fr.tau_y, surf.geom.xq, dt)

        # Dirichlet masks; periodic slave dofs are inactive -> pinned 0
        u_bc, b_bc = sp.u_bc, sp.b_bc
        act_u = sp.u_space.active[:, None]
        free_u = ((~u_bc.mask) & act_u).reshape(-1).astype(dt)
        c["free_u"] = free_u
        c["udiri"] = (u_bc.values * sp.u_space.active[:, None]).reshape(-1).astype(dt)
        c["free_b"] = ((~b_bc.mask) & sp.b_space.active).astype(dt)
        c["bdiri"] = (b_bc.values * sp.b_space.active).astype(dt)
        # combined inversion mask: velocity masks + active pressure
        free_p = sp.p_space.active.astype(dt)
        c["free_inv"] = np.concatenate([free_u, free_p])
        c["xdiri_inv"] = np.concatenate(
            [c["udiri"], np.zeros(sp.n_p, dt)]
        )

        # two-grid prolongation: P1 vertex coarse space (pressure-space
        # numbering) -> P2 velocity nodes.  P2 nodes are vertices then
        # edge midpoints (fem/spaces.py), so the exact inclusion
        # P1 c P2 interpolates: vertex node = coarse value, midpoint =
        # mean of the edge endpoints.
        us, ps, mesh = sp.u_space, sp.p_space, fe.mesh
        nv = mesh.n_vertices
        orig_u = us._perm if hasattr(us, "_perm") else np.arange(us.ndof)
        is_vert = orig_u < nv
        edge_ids = np.clip(orig_u - nv, 0, max(mesh.n_edges - 1, 0))
        epar = mesh.edges[edge_ids] if mesh.n_edges else np.zeros((us.ndof, 2), np.int64)
        parents_orig = np.where(
            is_vert[:, None], np.stack([orig_u, orig_u], axis=1), epar
        )
        c["tg_parents"] = ps.map_ids(ps._dof_map_orig[parents_orig]).astype(np.int32)
        c["tg_weights"] = np.where(
            is_vert[:, None], np.array([1.0, 0.0]), np.array([0.5, 0.5])
        ).astype(dt)
        # coarse Dirichlet mask: vertex dof pinned iff the matching fine
        # vertex dof is pinned/inactive (periodic masters only)
        u_free2d = (~u_bc.mask) & act_u
        vids = np.arange(nv)
        own = ps._dof_map_orig[vids] == vids
        u_cur = us.map_ids(us._dof_map_orig[vids[own]])
        p_cur = ps.map_ids(vids[own])
        cf = np.zeros((ps.ndof, 3), dtype=bool)
        cf[p_cur] = u_free2d[u_cur]
        c["tg_coarse_free"] = cf.reshape(-1).astype(dt)
        self.const = c

    # ------------------------------------------------------------------
    # operator assembly (device, jitted once at setup + reused in-step)
    # ------------------------------------------------------------------
    def _grads_u(self):
        c = self.const
        return asm.physical_grads(c["invJT"], c["dphi_u"], c["embed"])

    def _grads_b(self):
        c = self.const
        return asm.physical_grads(c["invJT"], c["dphi_b"], c["embed"])

    def _chunked_cells(self, fn, *cell_arrays):
        """Apply a per-cell-block element builder via lax.map to bound
        transient memory: fn(blocks...) -> (chunk, ...) tensors.

        Chunk size adapts so huge meshes assemble block-by-block; the
        padded cell count is always a multiple of pad_multiple, so we
        pick a divisor chunk.
        """
        nc = cell_arrays[0].shape[0]
        target = self.assembly_chunk
        if nc <= target:
            return fn(*cell_arrays)
        # largest divisor of nc not exceeding target
        chunk = 1
        for d in range(1, int(np.sqrt(nc)) + 1):
            if nc % d == 0:
                if d <= target:
                    chunk = max(chunk, d)
                q = nc // d
                if q <= target:
                    chunk = max(chunk, q)
        nblk = nc // chunk
        tracing = any(isinstance(a, jax.core.Tracer) for a in cell_arrays)
        if tracing:
            # inside jit (eddy rebuild): unrolled loop.  NOT lax.map --
            # mapping the big einsum bodies triggers a pathologically
            # slow XLA compile (measured 129s vs 1.5s at 58k cells).
            outs = [
                fn(*[a[k * chunk:(k + 1) * chunk] for a in cell_arrays])
                for k in range(nblk)
            ]
            return jax.tree_util.tree_map(
                lambda *xs: jnp.concatenate(xs, axis=0), *outs
            )
        # at setup: one jitted chunk program invoked eagerly per block
        # with a device sync between blocks -- inside a single jit XLA
        # schedules independent chunks concurrently and the multi-GB
        # einsum transients all coexist (OOM/thrash at 240k dofs)
        import os as _os
        import time as _time

        _dbg = _os.environ.get("NUPGCM_DEBUG_TIMING")
        jfn = jax.jit(fn)
        outs = []
        for k in range(nblk):
            _t0 = _time.time()
            o = jfn(*[a[k * chunk:(k + 1) * chunk] for a in cell_arrays])
            jax.block_until_ready(o)
            if _dbg:
                print(f"[chunk] {k}/{nblk} {_time.time() - _t0:.1f}s", flush=True)
            outs.append(o)
        _t0 = _time.time()
        out = jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs, axis=0), *outs
        )
        jax.block_until_ready(out)
        if _dbg:
            print(f"[chunk] concat {_time.time() - _t0:.1f}s", flush=True)
        return out

    def _assemble_inversion_elems(self, nu_q):
        """Element tensors of the saddle operator -- kept element-local
        (never scattered to a sparse matrix): the Krylov hot loop
        applies them as batched dense matvecs (ops/element.py)."""
        c = self.const
        a2e2 = jnp.asarray(self.params.a2e2, self.dtype)

        def build(wq, nu_q, f_q, invJT):
            Gu3 = asm.physical_grads(invJT, c["dphi_u"], c["embed"])
            return asm.elem_inversion_blocks(
                wq, nu_q, f_q, c["phi_u"], Gu3, c["phi_p"], a2e2,
                self.variable_nu,
            )

        return self._chunked_cells(build, c["wq"], nu_q, c["f_q"], c["invJT"])

    def _assemble_visc_elems(self, nu_q):
        """Velocity-block preconditioner operator: viscous + |f| mass
        (SPD approximation of the u-block for inner Chebyshev/CG)."""
        c = self.const
        a2e2 = jnp.asarray(self.params.a2e2, self.dtype)
        eye3 = jnp.eye(3, dtype=self.dtype)
        nlu = c["phi_u"].shape[1]

        def build(wq, nu_q, f_q, invJT):
            Gu3 = asm.physical_grads(invJT, c["dphi_u"], c["embed"])
            lap = jnp.einsum("cq,cq,cqid,cqjd->cji", wq, nu_q, Gu3, Gu3)
            mf = jnp.einsum("cq,cq,qj,qi->cji", wq, jnp.abs(f_q),
                            c["phi_u"], c["phi_u"])
            elem = jnp.einsum("cji,ba->cjbia", a2e2 * lap + mf, eye3)
            return elem.reshape(wq.shape[0], 3 * nlu, 3 * nlu)

        return self._chunked_cells(build, c["wq"], nu_q, c["f_q"], c["invJT"])

    def _assemble_coarse(self, ops, nu_q=None):
        """Two-grid u-block coarse level: the P1-vertex (Galerkin)
        coarse viscous operator.  Because P1 c P2 is a nested
        inclusion, rediscretizing the same bilinear form with P1
        elements IS the Galerkin coarse operator P^T A P.

        Small meshes: precomputed dense inverse (one dense matvec per
        application).  Large meshes: element tensors for an inner-CG
        coarse solve (P1 matvecs are ~7x cheaper than fine P2 ones).

        ``nu_q`` overrides the build-time viscosity table so
        refresh_precond rebuilds the coarse level from the CURRENT
        eddy viscosity rather than the frozen c["nu_q"]."""
        c = self.const
        fe = self.fe
        nu_q = c["nu_q"] if nu_q is None else jnp.asarray(nu_q, self.dtype)
        a2e2 = jnp.asarray(self.params.a2e2, self.dtype)
        eye3 = jnp.eye(3, dtype=self.dtype)
        nlp = c["phi_p"].shape[1]
        Nc = 3 * fe.spaces.p_space.ndof

        def build(wq, nu_q, f_q, invJT):
            Gp3 = asm.physical_grads(invJT, c["dphi_p"], c["embed"])
            lap = jnp.einsum("cq,cq,cqid,cqjd->cji", wq, nu_q, Gp3, Gp3)
            mf = jnp.einsum("cq,cq,qj,qi->cji", wq, jnp.abs(f_q),
                            c["phi_p"], c["phi_p"])
            elem = jnp.einsum("cji,ba->cjbia", a2e2 * lap + mf, eye3)
            return elem.reshape(wq.shape[0], 3 * nlp, 3 * nlp)

        if not self.coarse_dense:
            ops["coarse_e"] = jax.jit(lambda: self._chunked_cells(
                build, c["wq"], nu_q, c["f_q"], c["invJT"]))()
            return

        cd_p = np.asarray(fe.cd_p, np.int64)
        idx = (3 * cd_p[:, :, None] + np.arange(3)).reshape(cd_p.shape[0], 3 * nlp)
        rows = np.repeat(idx, 3 * nlp, axis=1).ravel()
        cols = np.tile(idx, (1, 3 * nlp)).ravel()

        @jax.jit
        def dense_inv():
            elem = self._chunked_cells(build, c["wq"], nu_q, c["f_q"],
                                       c["invJT"])
            A = jnp.zeros((Nc, Nc), self.dtype).at[rows, cols].add(elem.ravel())
            free = jnp.asarray(c["tg_coarse_free"])
            A = free[:, None] * A * free[None, :] + jnp.diag(1.0 - free)
            cho = jax.scipy.linalg.cho_factor(A)
            return jax.scipy.linalg.cho_solve(cho, jnp.eye(Nc, dtype=self.dtype))

        ops["coarse_inv"] = dense_inv()

    def _assemble_saddle_coarse(self, ops, nu_q=None):
        """P1-P1 COARSE SADDLE system (velocity AND pressure) -- the
        geostrophic coarse solve for the rotation-dominated
        (small-Ekman) regime, where the block preconditioner's Mp/a2e2
        Schur surrogate breaks down (the reference's own open problem,
        scratch/inversion_log.md).

        Same forms as the fine system but with P1 velocity (exact
        Galerkin restriction by nestedness); equal-order P1-P1 is not
        inf-sup stable, so the pp block gets Brezzi-Pitkaranta
        stabilization  +delta sum_c h_c^2 (grad p, grad q)  which also
        removes the spurious-mode singularity.

        Small meshes (4 n_vert <= coarse_dense_max): dense LU inverse
        once at setup, applied as one dense matvec.  Larger meshes:
        element-local coarse blocks solved by an inner
        block-preconditioned FGMRES per application
        (_assemble_saddle_coarse_elems) -- O(n) memory, scales to
        production meshes.
        """
        if self.saddle_coarse_dense:
            self._assemble_saddle_coarse_dense(ops, nu_q)
        else:
            self._assemble_saddle_coarse_elems(ops, nu_q)

    def _assemble_saddle_coarse_elems(self, ops, nu_q=None):
        """Element tensors of the BP-stabilized P1-P1 coarse saddle
        operator + the coarse visc smoothing surrogate, all on device
        (dtype-native): the scalable coarse path."""
        c = self.const
        fe = self.fe
        dt = self.dtype
        a2e2 = jnp.asarray(self.params.a2e2, dt)
        delta = jnp.asarray(self.saddle_coarse_delta, dt)
        nu_q = c["nu_q"] if nu_q is None else nu_q
        nlp = c["phi_p"].shape[1]
        eye3 = jnp.eye(3, dtype=dt)
        h_ = np.asarray(fe.h_cells, np.float64)
        h2 = np.asarray(np.where(h_ > 1e9, 0.0, h_) ** 2, dt)  # pad sentinels

        def build(wq, nu_q, f_q, invJT, h2):
            Gp3 = asm.physical_grads(invJT, c["dphi_p"], c["embed"])
            uu, up, pu = asm.elem_inversion_blocks(
                wq, nu_q, f_q, c["phi_p"], Gp3, c["phi_p"], a2e2,
                self.variable_nu,
            )
            gg = jnp.einsum("cq,cqid,cqjd->cij", wq, Gp3, Gp3)
            pp = delta * h2[:, None, None] * gg
            # smoothing surrogate: viscous + |f| mass, SPD
            lap = jnp.einsum("cq,cq,cqid,cqjd->cji", wq, nu_q, Gp3, Gp3)
            mf = jnp.einsum("cq,cq,qj,qi->cji", wq, jnp.abs(f_q),
                            c["phi_p"], c["phi_p"])
            visc = jnp.einsum("cji,ba->cjbia", a2e2 * lap + mf, eye3)
            return uu, up, pu, pp, visc.reshape(wq.shape[0], 3 * nlp, 3 * nlp)

        (ops["sc_uu"], ops["sc_up"], ops["sc_pu"], ops["sc_pp"],
         ops["sc_visc_e"]) = self._chunked_cells(
            build, c["wq"], jnp.asarray(nu_q, dt), c["f_q"], c["invJT"], h2
        )

        # rank-one constant-pressure pin + spectral bound of the
        # smoothing surrogate (for Chebyshev), computed once
        nv = fe.spaces.p_space.ndof
        free_p = c["free_inv"][self.fe.spaces.n_u:]
        pw = np.zeros(nv)
        cd_p = np.asarray(fe.cd_p, np.int64)
        wq_np = np.asarray(fe.geom.wq, np.float64)
        phi_p = np.asarray(fe.tab_p.phi, np.float64)
        np.add.at(pw, cd_p.ravel(), np.einsum("cq,qk->ck", wq_np, phi_p).ravel())
        pw = pw * np.asarray(free_p, np.float64)
        w = np.concatenate([np.zeros(3 * nv), pw / np.linalg.norm(pw)])
        ops["sc_pin"] = jnp.asarray(w, dt)

        cop = self._saddle_coarse_operator(ops)
        free_c = jnp.concatenate([jnp.asarray(c["tg_coarse_free"]),
                                  jnp.asarray(free_p)])
        cmask = MaskedOperator(cop, free_c)
        ops["sc_sigma"] = jnp.mean(jnp.abs(cmask.diagonal()))
        from ..solvers.preconditioners import power_lmax

        cvisc = MaskedOperator(self._coarse_operator(ops["sc_visc_e"]),
                               c["tg_coarse_free"])
        ops["sc_lmax"] = power_lmax(cvisc, 1.0 / cvisc.diagonal(), 3 * nv)

        if self.saddle_coarse_l2:
            self._assemble_saddle_coarse_l2(ops, nu_q)

    def _assemble_saddle_coarse_l2(self, ops, nu_q=None):
        """Second (aggregate) coarse level for the iterative coarse
        path.

        The vertex P1-P1 coarse system is itself too large for a dense
        inverse at production sizes and is solved by a k-step inner
        FGMRES whose accuracy drives the OUTER iteration count
        (measured: 3 outer iterations with the dense coarse inverse at
        43k fine dofs vs 17 with the k=16 inner solve at 0.87M).  This
        builds a third grid at setup: vertices are clustered into
        contiguous aggregates by a capped BFS over the mesh
        connectivity (in the RCM vertex order, so aggregates are
        band-compact), the masked+pinned coarse saddle matrix is
        Galerkin-projected onto the piecewise-constant aggregate basis
        (host f64, element-level bincount scatter -- the global coarse
        matrix is never formed), and the O(10k) result is inverted
        dense once.  ``AggregateCoarseCorrection`` applies it
        multiplicatively after the coarse block smoother inside the
        inner FGMRES (solvers/preconditioners.py)."""
        import time as _time

        c = self.const
        fe = self.fe
        nv = fe.spaces.p_space.ndof
        _t0 = _time.time()
        uu, up, pu, stab, idx_u, idx_p, pv = self._sc_host_blocks(nu_q)
        free = np.concatenate([
            np.asarray(c["tg_coarse_free"], np.float64),
            np.asarray(c["free_inv"][fe.spaces.n_u:], np.float64),
        ])
        # aggregation + dofmap depend only on the mesh; cache them so
        # refresh_precond (every ~25 steps in eddy production runs)
        # skips the BFS and index rebuild (ADVICE r4)
        if not hasattr(self, "_sc2_cache"):
            agg, na = _aggregate_vertices(
                np.asarray(fe.cd_p[: fe.mesh.n_cells], np.int64), nv,
                max(1, self.coarse_dense_max // 4))
            dofmap = np.concatenate([
                (3 * agg[:, None] + np.arange(3)).reshape(-1),
                3 * na + agg])
            self._sc2_cache = (agg, na, dofmap)
        # fine coarse-level dof (3nv u then nv p) -> aggregate dof
        # (3*aggregate + component, then 3na + aggregate)
        agg, na, dofmap = self._sc2_cache
        N2 = 4 * na

        def scatter_idx(rows, cols, vals):
            r = np.repeat(rows, cols.shape[1], axis=1).ravel()
            cc = np.tile(cols, (1, rows.shape[1])).ravel()
            w = vals.ravel() * free[r] * free[cc]
            return dofmap[r] * N2 + dofmap[cc], w

        # one combined bincount: a single N2^2 allocation instead of
        # four sequential ones (ADVICE r4 host-memory churn)
        lins, ws = zip(*(scatter_idx(r, cols, v) for r, cols, v in
                         ((idx_u, idx_u, uu), (idx_u, idx_p, up),
                          (idx_p, idx_u, pu), (idx_p, idx_p, stab))))
        A2 = np.bincount(np.concatenate(lins), weights=np.concatenate(ws),
                         minlength=N2 * N2)
        A2 = A2.reshape(N2, N2)
        # Galerkin of the masked operator's identity-on-pinned part,
        # P^T (I-F) P: keeps aggregates fully inside the Dirichlet
        # boundary nonsingular
        A2[np.diag_indices(N2)] += np.bincount(
            dofmap, weights=1.0 - free, minlength=N2)
        # Galerkin of the rank-one pressure pin sigma w w^T.  pv must
        # be masked by the pressure free mask so the aggregate matrix
        # is the exact Galerkin projection of cmat's sc_pin (which is
        # free-masked, _assemble_saddle_coarse_elems) -- on meshes with
        # pinned pressure dofs (periodic slaves) the unmasked weights
        # would disagree (ADVICE r4)
        w = np.concatenate([np.zeros(3 * nv), pv * free[3 * nv:]])
        w /= np.linalg.norm(w)
        wc = np.bincount(dofmap, weights=w, minlength=N2)
        A2 += float(ops["sc_sigma"]) * np.outer(wc, wc)
        ops["sc2_inv"] = jnp.asarray(np.linalg.inv(A2), self.dtype)
        ops["sc2_agg"] = jnp.asarray(agg, jnp.int32)
        self._sc2_na = na
        if os.environ.get("NUPGCM_DEBUG_TIMING"):
            print(f"[build]   saddle_coarse_l2 {na} aggregates "
                  f"{_time.time() - _t0:.1f}s", flush=True)

    def _saddle_coarse_operator(self, ops) -> SaddleOperator:
        fe = self.fe
        return SaddleOperator(
            uu=ops["sc_uu"], up=ops["sc_up"], pu=ops["sc_pu"],
            pp=ops["sc_pp"],
            cd_u=np.asarray(fe.cd_p, np.int32),
            cd_p=np.asarray(fe.cd_p, np.int32),
            u_plan=fe.vec_plan_p, p_plan=fe.vec_plan_p,
            n_u_nodes=fe.spaces.p_space.ndof,
        )

    def _saddle_coarse_solver(self, ops, mp_op):
        """Inner coarse solve for the element-local path: FGMRES on
        the masked + pressure-pinned coarse saddle operator,
        preconditioned by a coarse-level block-triangular Stokes
        preconditioner (Chebyshev on the P1 visc surrogate + Mp).  A
        fixed inner budget with loose rtol -- the outer FGMRES is
        flexible, so an approximate, iteration-varying coarse solve is
        admissible."""
        c = self.const
        fe = self.fe
        nv = fe.spaces.p_space.ndof
        free_p = c["free_inv"][fe.spaces.n_u:]
        free_c = jnp.concatenate([jnp.asarray(c["tg_coarse_free"]),
                                  jnp.asarray(free_p)])
        cop = self._saddle_coarse_operator(ops)
        cmask = MaskedOperator(cop, free_c)
        w = ops["sc_pin"]
        sigma = ops["sc_sigma"]

        def cmat(x):
            return cmask(x) + sigma * w * jnp.vdot(w, x)

        cvisc = MaskedOperator(self._coarse_operator(ops["sc_visc_e"]),
                               c["tg_coarse_free"])
        tg_free = jnp.asarray(c["tg_coarse_free"])
        # the coarse level inherits the fine regime: rotation-dominated
        # runs smooth the full (nonsymmetric) coarse uu block
        cuu = MaskedOperator(self._coarse_operator(ops["sc_uu"]),
                             c["tg_coarse_free"])
        scv_dinv = ops.get("sc_visc_dinv")
        mp_dinv = ops.get("mp_dinv")
        Mc = BlockStokesPrecond(
            visc_op=cvisc,
            visc_diag_inv=(1.0 / cvisc.diagonal()
                           if scv_dinv is None else scv_dinv),
            mp_op=mp_op,
            mp_diag_inv=1.0 / mp_op.diagonal() if mp_dinv is None else mp_dinv,
            nu_dofs=3 * nv,
            inner_iters_u=6 if self.inner_method == "inner_gmres" else 3,
            inner_iters_p=3,
            method=self.inner_method,
            lmax_u=ops["sc_lmax"],
            lmax_p=ops["lmax_p"],
            cond_ratio=self.cond_ratio,
            ublock_op=cuu,
            up_coupling=lambda zp: tg_free * cop.up_matvec(zp),
        )
        k = self.saddle_coarse_inner
        # second (aggregate) level: multiplicative after the block
        # smoother, same pre-smooth -> coarse pattern as the fine level
        M_in = Mc
        if "sc2_inv" in ops:
            from ..solvers.preconditioners import AggregateCoarseCorrection

            sc2 = AggregateCoarseCorrection(
                inv=ops["sc2_inv"], agg=ops["sc2_agg"],
                n_agg=self._sc2_na, free_c=free_c)
            M_in = lambda r_: sc2(cmat, r_, Mc(r_))

        if k <= 0:
            # k=0: apply the two-level cycle once as the coarse solve
            # (no inner Krylov at all) -- admissible under the flexible
            # outer, and the fastest measured config once the aggregate
            # level makes the cycle strong
            return M_in

        def solve(rc):
            zc, _ = gmres(cmat, rc, jnp.zeros_like(rc), M=M_in,
                          flexible=True, m=k, itmax=k, atol=0.0, rtol=1e-2)
            return zc

        return solve

    def _sc_host_blocks(self, nu_q=None):
        """Host-float64 element blocks of the BP-stabilized P1-P1
        coarse saddle operator (shared by the dense-inverse coarse path
        and the second-level aggregate builder).

        float64 throughout: the BP-stabilized saddle matrix is too
        ill-conditioned for an f32 LU inverse (the f32 attempt stalled
        the outer FGMRES at 2e-5); only the final inverse is downcast
        to the device dtype (application error ~1e-7 relative,
        harmless for a flexible preconditioner)."""
        c = self.const
        fe = self.fe
        a2e2 = float(self.params.a2e2)
        wq = np.asarray(fe.geom.wq, np.float64)
        invJT = np.asarray(fe.geom.invJT, np.float64)
        embed = np.asarray(fe.embed, np.float64)
        phi_p = np.asarray(fe.tab_p.phi, np.float64)
        dphi_p = np.asarray(fe.tab_p.dphi, np.float64)
        f_q = np.asarray(c["f_q"], np.float64)
        nu_q = np.asarray(c["nu_q"] if nu_q is None else nu_q, np.float64)
        nlp = phi_p.shape[1]

        gp = np.einsum("cpr,qir->cqip", invJT, dphi_p)
        Gp3 = np.einsum("cqip,pd->cqid", gp, embed)
        eye3 = np.eye(3)
        lap = np.einsum("cq,cq,cqid,cqjd->cji", wq, nu_q, Gp3, Gp3)
        visc = a2e2 * np.einsum("cji,ba->cjbia", lap, eye3)
        if self.variable_nu:
            visc = visc + a2e2 * np.einsum(
                "cq,cq,cqib,cqja->cjbia", wq, nu_q, Gp3, Gp3
            )
        mf = np.einsum("cq,cq,qj,qi->cji", wq, f_q, phi_p, phi_p)
        Cskew = np.zeros((3, 3))
        Cskew[1, 0], Cskew[0, 1] = 1.0, -1.0
        nc = wq.shape[0]
        uu = (visc + np.einsum("cji,ba->cjbia", mf, Cskew)).reshape(
            nc, 3 * nlp, 3 * nlp
        )
        up = -np.einsum("cq,cqjb,qk->cjbk", wq, Gp3, phi_p).reshape(nc, 3 * nlp, nlp)
        pu = np.einsum("cq,qk,cqia->ckia", wq, phi_p, Gp3).reshape(nc, nlp, 3 * nlp)
        # BP stabilization on the pp block.  Sign: with our convention
        # up = -B^T, pu = +B the pressure Schur complement is
        # +B A^{-1} B^T + pp, so the stabilizer must be POSITIVE
        # definite (+delta h^2 grad-grad); the classic -delta of the
        # [[A,B^T],[B,0]] layout flips here.
        h_ = np.asarray(fe.h_cells[:nc], np.float64)
        h2 = np.where(h_ > 1e9, 0.0, h_) ** 2  # zero the pad sentinels
        stab = self.saddle_coarse_delta * h2[:, None, None] * np.einsum(
            "cq,cqid,cqjd->cji", wq, Gp3, Gp3
        )
        nv = self.fe.spaces.p_space.ndof
        cd_p = np.asarray(fe.cd_p, np.int64)
        idx_u = (3 * cd_p[:, :, None] + np.arange(3)).reshape(-1, 3 * nlp)
        idx_p = 3 * nv + cd_p
        pv = np.zeros(nv)
        np.add.at(pv, cd_p.ravel(),
                  np.einsum("cq,qk->ck", wq, phi_p).ravel())
        return uu, up, pu, stab, idx_u, idx_p, pv

    def _assemble_saddle_coarse_dense(self, ops, nu_q=None):
        """Dense-inverse coarse path (small meshes): host float64
        assembly + LU inverse once at setup."""
        c = self.const
        fe = self.fe
        nv = fe.spaces.p_space.ndof
        Nc = 4 * nv
        uu, up, pu, stab, idx_u, idx_p, pv = self._sc_host_blocks(nu_q)
        A = np.zeros((Nc, Nc))

        def scatter(rows, cols, vals):
            r = np.repeat(rows, cols.shape[1], axis=1).ravel()
            cc = np.tile(cols, (1, rows.shape[1])).ravel()
            np.add.at(A, (r, cc), vals.ravel())

        scatter(idx_u, idx_u, uu)
        scatter(idx_u, idx_p, up)
        scatter(idx_p, idx_u, pu)
        scatter(idx_p, idx_p, stab)
        free = np.concatenate([
            np.asarray(c["tg_coarse_free"], np.float64),
            # active pressure dofs (periodic slaves pinned)
            np.asarray(c["free_inv"][self.fe.spaces.n_u:], np.float64),
        ])
        A = free[:, None] * A * free[None, :] + np.diag(1.0 - free)
        # the constant-pressure mode is the (only) nullspace; pin the
        # mean with a rank-one volume-weight augmentation (the outer
        # solve projects constants away regardless)
        w = np.concatenate([np.zeros(3 * nv), pv])
        w /= np.linalg.norm(w)
        sigma = np.mean(np.abs(np.diagonal(A)))
        A += sigma * np.outer(w, w)
        ops["saddle_coarse_inv"] = jnp.asarray(np.linalg.inv(A), self.dtype)

    def _coarse_operator(self, coarse_e) -> SaddleOperator:
        """Vector-P1 operator over vertex nodes (node-grouped gathers,
        same layout 3*vertex+comp as the coarse correction vectors)."""
        fe = self.fe
        return SaddleOperator(
            uu=coarse_e, up=None, pu=None,
            cd_u=np.asarray(fe.cd_p, np.int32),
            cd_p=np.zeros((coarse_e.shape[0], 0), np.int32),
            u_plan=fe.vec_plan_p,
            p_plan=fe.vec_plan_p,
            n_u_nodes=fe.spaces.p_space.ndof,
        )

    def _build_operators(self):
        fe, c, dt = self.fe, self.const, self.dtype
        pr, fr = self.params, self.forcings
        sp = fe.spaces

        # separate small jits: faster compiles than one mega-graph and
        # the heavy element builders are internally chunked (lax.map)
        import os as _os
        import time as _time

        _dbg = _os.environ.get("NUPGCM_DEBUG_TIMING")
        ops = {}
        _t0 = _time.time()
        ops["A_uu_e"], ops["A_up_e"], ops["A_pu_e"] = (
            self._assemble_inversion_elems(c["nu_q"])
        )
        jax.block_until_ready(ops["A_uu_e"])
        if _dbg:
            print(f"[build]   A_inv_e {_time.time() - _t0:.1f}s", flush=True)
        _t0 = _time.time()
        ops["visc_e"] = self._assemble_visc_elems(c["nu_q"])
        jax.block_until_ready(ops["visc_e"])
        if _dbg:
            print(f"[build]   visc_e {_time.time() - _t0:.1f}s", flush=True)

        # per-cell-block builder for all the small evolution operators:
        # runs through the eager chunked path (ONE small jit compiled
        # once and invoked per block) -- a single fused setup jit with
        # unrolled chunk loops compiled for 860 s at 45k cells
        def build_small_elems(wq, kh_q, kv_q, invJT):
            Gb3 = asm.physical_grads(invJT, c["dphi_b"], c["embed"])
            return (
                asm.elem_buoyancy_to_velocity(
                    wq, c["phi_u"], c["phi_b"], jnp.asarray(1.0 / pr.alpha, dt)
                ),
                asm.elem_mass(wq, c["phi_b"], c["phi_b"]),
                asm.elem_stiffness(wq, kh_q, Gb3, (0, 1)),
                asm.elem_stiffness(wq, kv_q, Gb3, (2,)),
                asm.elem_rhs_diff(wq, kv_q, Gb3, jnp.asarray(pr.N2, dt)),
                asm.elem_mass(wq, c["phi_p"], c["phi_p"]) / jnp.asarray(pr.a2e2, dt),
                jnp.einsum("cq,qk->ck", wq, c["phi_p"]),
            )

        _t0 = _time.time()
        (ops["B_e"], ops["M_e"], ops["Kh_e"], ops["Kv_e"], rd_e,
         ops["Mp_e"], pv_e) = self._chunked_cells(
            build_small_elems, c["wq"], c["kh_q"], c["kv_q"], c["invJT"]
        )

        @jax.jit
        def setup_rhs(rd_e, pv_e):
            # wind-stress rhs over combined (u, p) vector
            wind = asm.elem_wind_rhs(
                c["wq_surf"], c["taux_q"], c["tauy_q"], c["phi_u_surf"],
                jnp.asarray(pr.alpha, dt),
            )
            s_u = fe.vec_plan_u_surf.assemble(wind)
            return {
                "s": jnp.concatenate([s_u, jnp.zeros(sp.n_p, dt)]),
                "rhs_diff": fe.vec_plan_b.assemble(rd_e),
                # pressure volume weights for the zero-mean constraint
                "p_volw": fe.vec_plan_p.assemble(pv_e),
            }

        small = setup_rhs(rd_e, pv_e)
        jax.block_until_ready(small)
        ops.update(small)
        if _dbg:
            print(f"[build]   setup_small {_time.time() - _t0:.1f}s", flush=True)

        @jax.jit
        def spectral_bounds(visc_e, Mp_e):
            visc = self._visc_operator(visc_e)
            mp = ElementOperator(
                Ae=Mp_e,
                cd_rows=jnp.asarray(fe.cd_p, jnp.int32),
                cd_cols=jnp.asarray(fe.cd_p, jnp.int32),
                row_plan=fe.vec_plan_p,
            )
            visc_op = MaskedOperator(visc, c["free_u"])
            mp_op = MaskedOperator(mp, c["free_inv"][sp.n_u:])
            from ..solvers.preconditioners import power_lmax

            return (
                power_lmax(visc_op, 1.0 / visc_op.diagonal(), sp.n_u),
                power_lmax(mp_op, 1.0 / mp_op.diagonal(), sp.n_p),
            )

        _t0 = _time.time()
        ops["lmax_u"], ops["lmax_p"] = spectral_bounds(ops["visc_e"], ops["Mp_e"])
        jax.block_until_ready(ops["lmax_u"])
        if _dbg:
            print(f"[build]   spectral_bounds {_time.time() - _t0:.1f}s", flush=True)

        if self.twogrid:
            _t0 = _time.time()
            self._assemble_coarse(ops)
            jax.block_until_ready(ops.get("coarse_inv", ops.get("coarse_e")))
            if _dbg:
                print(f"[build]   coarse {_time.time() - _t0:.1f}s", flush=True)
        if self.saddle_coarse:
            _t0 = _time.time()
            self._assemble_saddle_coarse(ops)
            jax.block_until_ready(ops.get("saddle_coarse_inv", ops.get("sc_uu")))
            if _dbg:
                print(f"[build]   saddle_coarse {_time.time() - _t0:.1f}s", flush=True)

        # Preconditioner block diagonals, hoisted out of the per-step
        # trace (they are loop-invariant: the visc/Mp/coarse tensors
        # never change in-step, and the eddy rebuild swaps only the
        # inversion blocks while keeping the preconditioner, reference
        # src/model.jl:160-170).  Saves one full pass over the big
        # velocity-block element tensor per step.
        @jax.jit
        def precond_diags(visc_e, Mp_e):
            visc_op = MaskedOperator(self._visc_operator(visc_e), c["free_u"])
            mp = ElementOperator(
                Ae=Mp_e, cd_rows=jnp.asarray(fe.cd_p, jnp.int32),
                cd_cols=jnp.asarray(fe.cd_p, jnp.int32),
                row_plan=fe.vec_plan_p)
            mp_op = MaskedOperator(mp, c["free_inv"][sp.n_u:])
            return 1.0 / visc_op.diagonal(), 1.0 / mp_op.diagonal()

        ops["visc_dinv"], ops["mp_dinv"] = precond_diags(
            ops["visc_e"], ops["Mp_e"])
        if "coarse_e" in ops:
            cop_ = MaskedOperator(self._coarse_operator(ops["coarse_e"]),
                                  c["tg_coarse_free"])
            ops["coarse_dinv"] = 1.0 / cop_.diagonal()
        if "sc_visc_e" in ops:
            cvisc_ = MaskedOperator(self._coarse_operator(ops["sc_visc_e"]),
                                    c["tg_coarse_free"])
            ops["sc_visc_dinv"] = 1.0 / cvisc_.diagonal()

        # surface buoyancy-flux rhs (static; zero under Dirichlet BC)
        if isinstance(fr.b_surface_bc, SurfaceFluxBC):
            flux_q = jnp.asarray(
                _quad_eval(fr.b_surface_bc.flux, fe.surface.geom.xq, dt)
            )
            ops["rhs_flux"] = fe.vec_plan_b_surf.assemble(
                asm.elem_flux_rhs(c["wq_surf"], flux_q, c["phi_b_surf"], jnp.asarray(pr.alpha, dt))
            )
        else:
            ops["rhs_flux"] = jnp.zeros(sp.n_b, dt)
        self.ops = ops

    # ------------------------------------------------------------------
    # pure step functions
    # ------------------------------------------------------------------
    def _inv_matrix(self, ops) -> SaddleOperator:
        fe = self.fe
        return SaddleOperator(
            uu=ops["A_uu_e"], up=ops["A_up_e"], pu=ops["A_pu_e"],
            cd_u=self.const["cd_u"],
            cd_p=np.asarray(fe.cd_p, np.int32),
            u_plan=fe.vec_plan_u_nodes,
            p_plan=fe.vec_plan_p,
            n_u_nodes=fe.spaces.u_space.ndof,
        )

    def _visc_operator(self, visc_e) -> SaddleOperator:
        fe = self.fe
        return SaddleOperator(
            uu=visc_e, up=None, pu=None,
            cd_u=self.const["cd_u"],
            cd_p=np.zeros((visc_e.shape[0], 0), np.int32),
            u_plan=fe.vec_plan_u_nodes,
            p_plan=fe.vec_plan_p,
            n_u_nodes=fe.spaces.u_space.ndof,
        )

    def _b_matvec(self, ops, b_full):
        """B b: buoyancy -> vertical momentum rows of the combined
        vector (node-grouped velocity scatter)."""
        fe = self.fe
        c = self.const
        b_e = b_full[c["cd_b"]]
        ye = jnp.einsum("cij,cj->ci", ops["B_e"], b_e)  # (nc, 3*nlu)
        yu = fe.vec_plan_u_nodes.assemble_rows(ye.reshape(-1, 3)).reshape(-1)
        return jnp.concatenate([yu, jnp.zeros(fe.spaces.n_p, self.dtype)])

    def _evo_matrix(self, ops, theta, Kv_e=None) -> ElementOperator:
        fe = self.fe
        Kv_e = ops["Kv_e"] if Kv_e is None else Kv_e
        return ElementOperator(
            Ae=ops["M_e"] + theta * (ops["Kh_e"] + Kv_e),
            cd_rows=self.const["cd_b"],
            cd_cols=self.const["cd_b"],
            row_plan=fe.vec_plan_b,
        )

    def _mp_operator(self, ops):
        fe = self.fe
        return ElementOperator(
            Ae=ops["Mp_e"],
            cd_rows=jnp.asarray(fe.cd_p, jnp.int32),
            cd_cols=jnp.asarray(fe.cd_p, jnp.int32),
            row_plan=fe.vec_plan_p,
        )

    def _make_inv_precond(self, ops):
        c = self.const
        fe = self.fe
        if self.precond_kind == "diag":
            scale = 1.0 / self.fe.h_median ** self.fe.mesh.tdim
            return lambda r: r / jnp.asarray(scale, self.dtype), False
        # block Stokes preconditioner (flexible GMRES)
        visc = self._visc_operator(ops["visc_e"])
        mp = self._mp_operator(ops)
        visc_op = MaskedOperator(visc, c["free_u"])
        mp_op = MaskedOperator(mp, c["free_inv"][self.fe.spaces.n_u:])
        # full (nonsymmetric) velocity block for the inner_gmres method
        ublock = self._visc_operator(ops["A_uu_e"])
        ublock_op = MaskedOperator(ublock, c["free_u"])
        iu, ip = self.inner_iters
        up_coupling = None
        if self.triangular:
            Amat = self._inv_matrix(ops)
            free_u = c["free_u"]
            up_coupling = lambda zp: free_u * Amat.up_matvec(zp)
        coarse = None
        if "coarse_inv" in ops or "coarse_e" in ops:
            from ..solvers.preconditioners import CoarseCorrection

            if "coarse_inv" in ops:
                cinv = ops["coarse_inv"]
                solve = lambda rc: cinv @ rc
            else:
                cop = MaskedOperator(
                    self._coarse_operator(ops["coarse_e"]), c["tg_coarse_free"]
                )
                cdiag_inv = ops.get("coarse_dinv")
                if cdiag_inv is None:
                    cdiag_inv = 1.0 / cop.diagonal()

                def solve(rc):
                    zc, _ = cg(cop, rc, jnp.zeros_like(rc),
                               M_diag_inv=cdiag_inv, atol=0.0, rtol=1e-2,
                               itmax=60)
                    return zc

            coarse = CoarseCorrection(
                solve=solve,
                parents=jnp.asarray(c["tg_parents"]),
                weights=jnp.asarray(c["tg_weights"]),
                coarse_free=jnp.asarray(c["tg_coarse_free"]),
                free_u=jnp.asarray(c["free_u"]),
                n_vert=self.fe.spaces.p_space.ndof,
            )
        saddle_coarse = None
        outer_op = None
        if "saddle_coarse_inv" in ops or "sc_uu" in ops:
            from ..solvers.preconditioners import SaddleCoarseCorrection

            if not self.triangular:
                Amat = self._inv_matrix(ops)
            outer_op = MaskedOperator(Amat, c["free_inv"])
            if "saddle_coarse_inv" in ops:
                cinv = ops["saddle_coarse_inv"]
                coarse_solve = lambda rc: cinv @ rc
            else:
                coarse_solve = self._saddle_coarse_solver(ops, mp_op)
            saddle_coarse = SaddleCoarseCorrection(
                solve=coarse_solve,
                parents=jnp.asarray(c["tg_parents"]),
                weights=jnp.asarray(c["tg_weights"]),
                coarse_free_u=jnp.asarray(c["tg_coarse_free"]),
                free_fine=jnp.asarray(c["free_inv"]),
                n_vert=self.fe.spaces.p_space.ndof,
                nu_dofs=self.fe.spaces.n_u,
            )
        visc_dinv = ops.get("visc_dinv")
        mp_dinv = ops.get("mp_dinv")
        M = BlockStokesPrecond(
            visc_op=visc_op,
            visc_diag_inv=(1.0 / visc_op.diagonal()
                           if visc_dinv is None else visc_dinv),
            mp_op=mp_op,
            mp_diag_inv=1.0 / mp_op.diagonal() if mp_dinv is None else mp_dinv,
            nu_dofs=self.fe.spaces.n_u,
            inner_iters_u=iu,
            inner_iters_p=ip,
            method=self.inner_method,
            lmax_u=ops["lmax_u"],
            lmax_p=ops["lmax_p"],
            cond_ratio=self.cond_ratio,
            ublock_op=ublock_op,
            up_coupling=up_coupling,
            coarse=coarse,
            saddle_coarse=saddle_coarse,
            outer_op=outer_op,
        )
        return M, True

    def _invert_pure(self, ops, b_full, x0):
        """Flow inversion: A x = B b + s on free dofs (reference
        invert!, src/inversion.jl:101-110 + sync_flow!,
        src/model.jl:302-317)."""
        c = self.const
        fe = self.fe
        Amat = self._inv_matrix(ops)
        A = MaskedOperator(Amat, c["free_inv"])
        y_full = self._b_matvec(ops, b_full) + ops["s"]
        xd = c["xdiri_inv"] * (1.0 - c["free_inv"])
        y = jnp.where(
            c["free_inv"].astype(bool),
            y_full - Amat.matvec(xd),
            c["xdiri_inv"],
        )
        M, flexible = self._make_inv_precond(ops)
        x, stats = gmres(A, y, x0, M=M, flexible=flexible, **self.inv_opts)
        # zero-mean pressure projection (reference: Gridap :zeromean
        # constrained space, src/spaces.jl:45)
        n_u = self.fe.spaces.n_u
        u_flat, p = x[:n_u], x[n_u:]
        pw = ops["p_volw"]
        p = p - jnp.vdot(pw, p) / jnp.sum(pw)
        u = u_flat.reshape(-1, 3)
        return u, p, stats

    def solve_inversion(self, y_full, x0=None):
        """Solve the saddle system A x = y for an arbitrary full-length
        rhs over the combined (u, p) dof vector — the manufactured-
        solution / diagnostic entry (reference
        scratch/convergence.jl constructed_problem_rhs +
        solve_constructed_problem!). Dirichlet dofs take their BC
        values; the returned pressure is zero-mean projected.

        Returns (u (n_nodes, 3), p (n_p,), stats).
        """
        c = self.const
        ops = self.ops
        Amat = self._inv_matrix(ops)
        A = MaskedOperator(Amat, c["free_inv"])
        y_full = jnp.asarray(y_full, self.dtype)
        xd = c["xdiri_inv"] * (1.0 - c["free_inv"])
        y = jnp.where(
            c["free_inv"].astype(bool),
            y_full - Amat.matvec(xd),
            c["xdiri_inv"],
        )
        M, flexible = self._make_inv_precond(ops)
        if x0 is None:
            x0 = jnp.zeros_like(y)
        x, stats = gmres(A, y, x0, M=M, flexible=flexible, **self.inv_opts)
        n_u = self.fe.spaces.n_u
        u, p = x[:n_u].reshape(-1, 3), x[n_u:]
        pw = ops["p_volw"]
        p = p - jnp.vdot(pw, p) / jnp.sum(pw)
        return u, p, stats

    def _evolve_pure(self, ops, state: State, r=None):
        """Buoyancy step (reference evolve!, src/model.jl:213-285).

        ``r``: step ratio dt_new/dt_old for variable-step BDF2
        coefficients (None = fixed step, r = 1)."""
        c = self.const
        fe, pr, fr = self.fe, self.params, self.forcings
        dt_ = state.dt
        mt = self.dtype
        r = jnp.asarray(1.0 if r is None else r, mt)

        Gb3 = self._grads_b()

        # convection: rebuild Kv and rhs_diff from current b
        if fr.conv_param.is_on:
            abz = pr.alpha * (
                pr.N2 + jnp.einsum("cqi,ci->cq", Gb3[..., 2], state.b[c["cd_b"]])
            )
            kv_q = fr.conv_param.kappa_v(c["kv_q"], abz)
            Kv_e = asm.elem_stiffness(c["wq"], kv_q, Gb3, (2,))
            rhs_diff = fe.vec_plan_b.assemble(
                asm.elem_rhs_diff(c["wq"], kv_q, Gb3, jnp.asarray(pr.N2, mt))
            )
        else:
            Kv_e = ops["Kv_e"]
            rhs_diff = ops["rhs_diff"]

        # BDF coefficients; BDF2 runs its first step as BDF1.
        # Variable-step BDF2 (ratio r): c0=(1+r)^2/(1+2r), c1=r^2/(1+2r),
        # implicit/advection weight w=(1+r)/(1+2r); fixed step r=1
        # recovers the reference's 4/3, 1/3, 2/3 (src/evolution.jl:187-193).
        is_bdf2 = isinstance(self.ts, BDF2)
        use2 = jnp.logical_and(jnp.asarray(is_bdf2), state.step > 0)
        base_theta = dt_ * pr.a2e2 / pr.mu_rho
        w = (1.0 + r) / (1.0 + 2.0 * r)
        theta = jnp.where(use2, w * base_theta, base_theta)
        c0 = jnp.where(use2, (1.0 + r) ** 2 / (1.0 + 2.0 * r), 1.0).astype(mt)
        c1 = jnp.where(use2, r ** 2 / (1.0 + 2.0 * r), 0.0).astype(mt)
        cdt = jnp.where(use2, w * dt_, dt_).astype(mt)

        Afull = self._evo_matrix(ops, theta, Kv_e)
        A = MaskedOperator(Afull, c["free_b"])

        # advection rhs (per-step element assembly)
        u_e = state.u[c["cd_u"]]
        up_e = state.u_prev[c["cd_u"]]
        b_e = state.b[c["cd_b"]]
        bp_e = state.b_prev[c["cd_b"]]
        w2 = jnp.where(use2, 1.0 + r, 1.0).astype(mt)
        ue = w2 * u_e - (w2 - 1.0) * up_e
        be = w2 * b_e - (w2 - 1.0) * bp_e
        u_q = jnp.einsum("qi,cia->cqa", c["phi_u"], ue)
        gb_q = jnp.einsum("cqid,ci->cqd", Gb3, be)
        adv = jnp.einsum("cqa,cqa->cq", u_q, gb_q) + u_q[..., 2] * jnp.asarray(pr.N2, mt)
        b_q = jnp.einsum("qi,ci->cq", c["phi_b"], b_e)
        bp_q = jnp.einsum("qi,ci->cq", c["phi_b"], bp_e)
        integ = c0 * b_q - c1 * bp_q - cdt * adv
        rhs_adv = fe.vec_plan_b.assemble(
            jnp.einsum("cq,qi,cq->ci", c["wq"], c["phi_b"], integ)
        )

        y_full = rhs_adv + theta * rhs_diff + dt_ * ops["rhs_flux"]
        xd = c["bdiri"] * (1.0 - c["free_b"])
        y = jnp.where(c["free_b"].astype(bool), y_full - Afull.matvec(xd), c["bdiri"])

        diag_inv = 1.0 / A.diagonal()
        b_new, stats = cg(A, y, state.b, M_diag_inv=diag_inv, **self.evo_opts)
        return b_new, stats

    def _update_dt(self, state: State):
        """CFL-adaptive dt (reference update_Dt!,
        src/timesteppers.jl:108-119; BDF1 there, both orders here --
        BDF2 growth is clamped to r <= 2 for variable-step
        zero-stability (bound r < 1 + sqrt(2)))."""
        if not getattr(self.ts, "adaptive", False):
            return state.dt
        c = self.const
        u_e = state.u[c["cd_u"]]
        u_q = jnp.einsum("qi,cia->cqa", c["phi_u"], u_e)
        speed = jnp.linalg.norm(u_q, axis=-1).max(axis=1)
        u_min = jnp.asarray(0.01, self.dtype)
        ratios = c["h_cells"] / jnp.maximum(speed, u_min)
        dt_new = jnp.asarray(self.ts.CFL_factor, self.dtype) * ratios.min()
        if isinstance(self.ts, BDF2):
            dt_new = jnp.minimum(dt_new, 2.0 * state.dt)
        return dt_new

    def refresh_precond(self, ops, state: State):
        """Host-side preconditioner refresh from the CURRENT eddy
        viscosity.

        The reference rebuilds the inversion matrix every 10 steps but
        keeps its preconditioner frozen (src/model.jl:160-170); in
        eddy runs nu drifts up to f^2/N2_min (~70x contrast in
        destratified boundary layers), the frozen Chebyshev bounds /
        coarse operators go stale, and the outer iteration count blows
        up -- the failure mode the reference's own preconditioner
        study logs (scratch/inversion_log.md).  This recomputes every
        nu-dependent preconditioner operator (smoother block +
        diagonals + spectral bound, saddle-coarse tensors, aggregate
        second-level dense inverse) from the current state.  All array
        shapes are unchanged, and ops ride as jit ARGUMENTS, so the
        refreshed values flow into the compiled step without any
        retrace.  Call between step blocks (seconds of host work);
        ``run(n_precond_refresh=...)`` does it on a cadence."""
        fr = self.forcings
        if not fr.eddy_param.is_on:
            return ops
        from ..solvers.preconditioners import power_lmax
        from ..utils.precision import precision_ctx

        c = self.const
        sp = self.fe.spaces
        with precision_ctx(self.matmul_precision):
            Gb3 = self._grads_b()
            abz = self.params.alpha * (
                self.params.N2 + jnp.einsum(
                    "cqi,ci->cq", Gb3[..., 2],
                    jnp.asarray(state.b)[c["cd_b"]])
            )
            nu_q = fr.eddy_param.nu(jnp.asarray(c["f_eddy_q"]), abz)
            ops = dict(ops)
            # inversion blocks: same values the next in-jit eddy
            # rebuild would produce (kept consistent with the refresh)
            ops["A_uu_e"], ops["A_up_e"], ops["A_pu_e"] = (
                self._assemble_inversion_elems(nu_q))
            # smoother block + hoisted diagonal + spectral bound
            ops["visc_e"] = self._assemble_visc_elems(nu_q)
            visc_op = MaskedOperator(self._visc_operator(ops["visc_e"]),
                                     c["free_u"])
            ops["visc_dinv"] = 1.0 / visc_op.diagonal()
            ops["lmax_u"] = power_lmax(visc_op, ops["visc_dinv"], sp.n_u)
            nu_host = np.asarray(nu_q, np.float64)
            if self.twogrid:
                self._assemble_coarse(ops, nu_q)
                # the dense coarse path stores only coarse_inv and needs
                # no diagonal
                if not self.coarse_dense:
                    cop_ = MaskedOperator(
                        self._coarse_operator(ops["coarse_e"]),
                        c["tg_coarse_free"])
                    ops["coarse_dinv"] = 1.0 / cop_.diagonal()
            if self.saddle_coarse:
                # rebuilds sc_* tensors, sc_sigma/sc_pin/sc_lmax and
                # (elems path) the aggregate second-level dense inverse
                self._assemble_saddle_coarse(ops, nu_host)
                if "sc_visc_e" in ops:
                    cvisc_ = MaskedOperator(
                        self._coarse_operator(ops["sc_visc_e"]),
                        c["tg_coarse_free"])
                    ops["sc_visc_dinv"] = 1.0 / cvisc_.diagonal()
        jax.block_until_ready(ops["visc_dinv"])
        return ops

    def _eddy_rebuild(self, ops, state: State):
        """Eddy-viscosity inversion-matrix rebuild (reference
        src/model.jl:160-170); preconditioner kept unchanged."""
        c = self.const
        pr, fr = self.params, self.forcings
        Gb3 = self._grads_b()
        abz = pr.alpha * (
            pr.N2 + jnp.einsum("cqi,ci->cq", Gb3[..., 2], state.b[c["cd_b"]])
        )
        nu_q = fr.eddy_param.nu(c["f_eddy_q"], abz)
        uu, up, pu = self._assemble_inversion_elems(nu_q)
        return dict(ops, A_uu_e=uu, A_up_e=up, A_pu_e=pu)

    # ------------------------------------------------------------------
    # "args" table mode: at trace time the pure functions read the
    # static tables through self.const / fe.vec_plan_* -- swapping in
    # the traced argument pytree makes every table flow through the
    # executable's parameters instead of being inlined as constants.
    # ------------------------------------------------------------------
    def _host_tables(self):
        from ..fem.assembly import VectorPlan

        fe = self.fe
        # ndof stays OUT of the pytree (it is a static shape parameter)
        return {
            "const": dict(self.const),
            "plans": {
                name: (p.gather_perm, p.dof_sorted)
                for name, p in (("vec_plan_b", fe.vec_plan_b),
                                ("vec_plan_p", fe.vec_plan_p),
                                ("vec_plan_u_nodes", fe.vec_plan_u_nodes))
            },
        }

    def _swap_tables(self, tables):
        from contextlib import contextmanager

        from ..fem.assembly import VectorPlan

        @contextmanager
        def swapped():
            if tables is None:
                yield
                return
            fe = self.fe
            old_const = self.const
            old_plans = {n: getattr(fe, n) for n in tables["plans"]}
            self.const = tables["const"]
            for n, (gp, ds) in tables["plans"].items():
                setattr(fe, n, VectorPlan(ndof=old_plans[n].ndof,
                                          gather_perm=gp, dof_sorted=ds))
            try:
                yield
            finally:
                self.const = old_const
                for n, p in old_plans.items():
                    setattr(fe, n, p)

        return swapped()

    def _build_functions(self):
        fr = self.forcings

        def step(ops, state: State):
            dt_old = state.dt
            dt_ = self._update_dt(state)
            state = State(
                u=state.u, p=state.p, b=state.b, u_prev=state.u_prev,
                b_prev=state.b_prev, t=state.t, dt=dt_, step=state.step,
            )
            b_new, evo_stats = self._evolve_pure(ops, state, r=dt_ / dt_old)
            x0 = jnp.concatenate([state.u.reshape(-1), state.p])
            u_new, p_new, inv_stats = self._invert_pure(ops, b_new, x0)
            new_state = State(
                u=u_new, p=p_new, b=b_new,
                u_prev=state.u, b_prev=state.b,
                t=state.t + dt_, dt=dt_, step=state.step + 1,
            )
            if fr.eddy_param.is_on:
                do = jnp.equal(jnp.mod(new_state.step, 10), 0)
                ops = jax.lax.cond(
                    do, lambda o: self._eddy_rebuild(o, new_state), lambda o: o, ops
                )
            freeb = self.const["free_b"].astype(bool)
            neg_inf = jnp.asarray(-jnp.inf, b_new.dtype)
            pos_inf = jnp.asarray(jnp.inf, b_new.dtype)
            u_max = jnp.abs(u_new).max()
            aux = {
                "evo_iters": evo_stats.iterations,
                "evo_res": evo_stats.residual,
                "inv_iters": inv_stats.iterations,
                "inv_res": inv_stats.residual,
                "u_max": u_max,
                "b_max": jnp.abs(b_new).max(),
                # progress-line diagnostics (reference src/model.jl:172-192)
                "b_free_min": jnp.where(freeb, b_new, pos_inf).min(),
                "b_free_max": jnp.where(freeb, b_new, neg_inf).max(),
                "db_dt_max": jnp.where(freeb, jnp.abs(b_new - state.b), 0.0).max()
                / dt_,
                "cfl_dt": self.const["h_cells"].min() / jnp.maximum(u_max, 1e-30),
            }
            return ops, new_state, aux

        # scoped matmul precision rides inside each exported function
        # (enters jax.default_matmul_precision at trace time -- part of
        # jit's trace context, so caching stays correct)
        from ..utils.precision import scoped_precision

        step = scoped_precision(step, self.matmul_precision)

        # note: no buffer donation -- state legitimately aliases (b is
        # also b_prev right after set_b) and donation would double-free
        self.step_fn = step  # unjitted, for external jit/sharding wrappers

        def invert_only(ops, state: State):
            x0 = jnp.concatenate([state.u.reshape(-1), state.p])
            u, p, stats = self._invert_pure(ops, state.b, x0)
            return u, p, {"inv_iters": stats.iterations, "inv_res": stats.residual}

        invert_only = scoped_precision(invert_only, self.matmul_precision)

        def multi_step(ops, state: State, n: int):
            if not fr.eddy_param.is_on:
                # ops never changes in-step without the eddy rebuild:
                # keep it OUT of the scan carry (a carried pytree of
                # element tensors costs ~GB of copies per step; as a
                # closed-over scan invariant it is aliased)
                def body(st, _):
                    _, st, aux = step(ops, st)
                    return st, aux

                state, auxs = jax.lax.scan(body, state, None, length=n)
                return ops, state, auxs

            def body(carry, _):
                ops, st = carry
                ops, st, aux = step(ops, st)
                return (ops, st), aux

            (ops, state), auxs = jax.lax.scan(body, (ops, state), None, length=n)
            return ops, state, auxs

        if self.table_mode == "args":
            tables_dev = jax.device_put(self._host_tables())
            self.tables_dev = tables_dev

            def with_tables(fn, static=()):
                def outer(tables, *a):
                    with self._swap_tables(tables):
                        return fn(*a)

                jitted = jax.jit(outer, static_argnums=tuple(1 + s for s in static))
                bound = lambda *a: jitted(tables_dev, *a)
                # ahead-of-time lowering, as on a plain jitted function
                bound.lower = lambda *a: jitted.lower(tables_dev, *a)
                return bound

            self.step_jit = with_tables(step)
            self.invert_jit = with_tables(invert_only)
            self.multi_step_jit = with_tables(multi_step, static=(2,))
        else:
            self.step_jit = jax.jit(step)
            self.invert_jit = jax.jit(invert_only)
            self.multi_step_jit = jax.jit(multi_step, static_argnums=(2,))

    # ------------------------------------------------------------------
    # host-level API
    # ------------------------------------------------------------------
    def retune(
        self,
        saddle_coarse_inner: Optional[int] = None,
        inner_iters_u: Optional[int] = None,
        inner_iters_p: Optional[int] = None,
        cond_ratio: Optional[float] = None,
        inv_rtol: Optional[float] = None,
        inv_atol: Optional[float] = None,
        inv_memory: Optional[int] = None,
        evo_rtol: Optional[float] = None,
        evo_atol: Optional[float] = None,
    ):
        """Re-tune solver budgets WITHOUT re-assembling operators.

        The assembled element tensors / spectral bounds / coarse
        operators in ``self.ops`` are independent of the Krylov
        budgets -- those enter only the jitted closures.  This swaps
        the budgets and rebuilds the closures (a re-jit, seconds of
        host work; the next call pays one XLA compile), skipping the
        minutes-scale operator build at production size.  The tuning
        harness ``tools/sweep_inner.py`` uses this to sweep the
        saddle-coarse inner budget at 0.87M dofs with ONE build.
        """
        if saddle_coarse_inner is not None:
            self.saddle_coarse_inner = saddle_coarse_inner
        iu, ip = self.inner_iters
        if inner_iters_u is not None:
            iu = inner_iters_u
        if inner_iters_p is not None:
            ip = inner_iters_p
        self.inner_iters = (iu, ip)
        if cond_ratio is not None:
            self.cond_ratio = cond_ratio
        for k, v in (("rtol", inv_rtol), ("atol", inv_atol),
                     ("m", inv_memory)):
            if v is not None:
                self.inv_opts[k] = v
        if inv_memory is not None:
            self.inv_opts["itmax"] = 25 * inv_memory
        for k, v in (("rtol", evo_rtol), ("atol", evo_atol)):
            if v is not None:
                self.evo_opts[k] = v
        from ..utils.precision import precision_ctx

        with precision_ctx(self.matmul_precision):
            self._build_functions()
        return self

    def rest_state(self) -> State:
        sp = self.fe.spaces
        dt = self.dtype
        zb = jnp.where(
            self.const["free_b"].astype(bool), jnp.zeros(sp.n_b, dt), self.const["bdiri"]
        )
        return State(
            u=jnp.zeros((sp.u_space.ndof, 3), dt),
            p=jnp.zeros(sp.n_p, dt),
            b=zb,
            u_prev=jnp.zeros((sp.u_space.ndof, 3), dt),
            b_prev=zb,
            t=jnp.asarray(self.ts.t_start, dt),
            dt=jnp.asarray(self.ts.dt, dt),
            step=jnp.asarray(0, jnp.int32),
        )

    def set_b(self, state: State, f) -> State:
        """Set buoyancy from a callable or array; Dirichlet dofs keep
        their BC values (reference set_b!, src/model.jl:77-88)."""
        if callable(f):
            vals = self.fe.spaces.b_space.interpolate(f)
        else:
            vals = np.asarray(f)
        b = jnp.where(
            self.const["free_b"].astype(bool),
            jnp.asarray(vals, self.dtype),
            self.const["bdiri"],
        )
        return State(
            u=state.u, p=state.p, b=b, u_prev=state.u_prev, b_prev=b,
            t=state.t, dt=state.dt, step=state.step,
        )

    def invert(self, state: State) -> State:
        u, p, aux = self.invert_jit(self.ops, state)
        return State(
            u=u, p=p, b=state.b, u_prev=state.u_prev, b_prev=state.b_prev,
            t=state.t, dt=state.dt, step=state.step,
        )

    def run(
        self,
        state: State,
        n_info: int = 10,
        n_save: Optional[int] = None,
        save_callback: Optional[Callable] = None,
        n_plot: Optional[int] = None,
        plot_callback: Optional[Callable] = None,
        max_steps: Optional[int] = None,
        steps_per_block: int = 1,
        n_precond_refresh: Optional[int] = None,
        log: Callable = print,
    ) -> State:
        """Advance until t >= t_stop (reference run!, src/model.jl:90-211).

        The progress block matches the reference's field-for-field
        (src/model.jl:172-192): t/t_stop, dt, elapsed, per-step
        duration, estimated time remaining, |u|max, CFL-dt estimate,
        free-b range, |db/dt|max, plus solver iteration counts.

        ``steps_per_block > 1`` dispatches blocks of steps as one
        lax.scan (production mode: one host round-trip per block);
        logging/saving cadence then applies at block granularity.
        """
        from ..utils.misc import hrs_mins_secs

        def hms(sec):
            return "%02d:%02d:%02d" % hrs_mins_secs(sec)

        t_stop = float(self.ts.t_stop)
        t0 = t_last_info = time.time()
        i = int(state.step)
        i0 = i
        last_refresh = i
        while float(state.t) < t_stop:
            if steps_per_block > 1:
                self.ops, state, auxs = self.multi_step_jit(
                    self.ops, state, steps_per_block
                )
                aux = jax.tree_util.tree_map(lambda a: a[-1], auxs)
                i += steps_per_block
            else:
                self.ops, state, aux = self.step_jit(self.ops, state)
                i += 1
            u_max = float(aux["u_max"])
            b_max = float(aux["b_max"])
            if max(u_max, b_max) > 1e3 or np.isnan(u_max) or np.isnan(b_max):
                raise BlowUpError(
                    f"Blow-up detected at step {i}: |u|max={u_max:.3e} |b|max={b_max:.3e}"
                )
            if n_info and i % n_info == 0:
                t1 = time.time()
                dt_ = float(state.dt)
                msg = (
                    f"t = {float(state.t):.3e}/{t_stop:.3e} (i = {i}, dt = {dt_:.3e})\n"
                    f"time elapsed: {hms(t1 - t0)}\n"
                )
                if i - i0 > n_info:  # skip ETR first time (contains compile)
                    t_step = (t1 - t_last_info) / n_info
                    steps_left = max(0.0, (t_stop - float(state.t)) // max(dt_, 1e-30))
                    msg += (
                        f"timestep duration ~ {t_step:.3e} s\n"
                        f"estimated time remaining: {hms(t_step * steps_left)}\n"
                    )
                msg += (
                    f"|u|max = {u_max:.3e}, CFL dt ~ {float(aux['cfl_dt']):.3e}\n"
                    f"{float(aux['b_free_min']):.3e} <= b_free <= "
                    f"{float(aux['b_free_max']):.3e}, "
                    f"|db/dt|max = {float(aux['db_dt_max']):.3e}\n"
                    f"evo_it = {int(aux['evo_iters'])}, inv_it = {int(aux['inv_iters'])}"
                )
                log(msg)
                t_last_info = t1
                sys.stdout.flush()
                sys.stderr.flush()
            if n_save and i % n_save == 0 and save_callback is not None:
                save_callback(self, state, i)
            if n_plot and i % n_plot == 0 and plot_callback is not None:
                plot_callback(self, state, i)
            # steps-since-last counter, NOT a modulo test: with
            # steps_per_block > 1, i only hits multiples of the block
            # size, and a cadence the block size does not divide would
            # otherwise never fire (ADVICE r4)
            if (n_precond_refresh and i - last_refresh >= n_precond_refresh
                    and self.forcings.eddy_param.is_on):
                self.ops = self.refresh_precond(self.ops, state)
                last_refresh = i
            if max_steps is not None and i >= int(max_steps):
                break
        return state
