"""Domain-decomposed (sharded-state) full model step.

The scalable successor to parallel/sharding.py's replicated-state
GSPMD path: every state vector is PARTITIONED across the device mesh
(contiguous owned blocks in each space's RCM ordering), each operator
application exchanges only neighbor chunks between devices via
``jax.lax.ppermute``, and Krylov reductions are local partials +
``psum``.  Per-matvec communication is O(halo), independent of the
global problem size -- the FEM analog of ring-attention halo passing
(SURVEY.md §2.3 rows 1-2; replaces the reference's single-device
offload, reference ext/nuPGCMCUDAExt.jl:24-33).

Design
------
* Each FE space (u nodes / p vertices / b nodes) is split into S
  contiguous blocks of its RCM ordering (chunk = ceil(N/S)); RCM makes
  every element's dof span band-limited, so all off-block references
  fall within K neighboring chunks (K measured at setup, typically 1).
* Cells are assigned to the shard owning their median velocity node;
  per-shard cell batches are padded to equal count with zero-weight
  dummies (exact no-ops).
* An operator application is: exchange (2K ppermutes of whole
  neighbor chunks) -> local gather -> batched element einsum -> local
  segment-sum scatter into the extended vector -> fold-back (2K
  ppermutes returning halo partial sums to their owners).
* The WHOLE timestep (advection assembly, evolution CG, B-product,
  saddle FGMRES with the block-triangular Chebyshev/inner-GMRES
  preconditioner, zero-mean projection, CFL, diagnostics) runs inside
  one ``shard_map`` -- state never materializes on a single device.
* The saddle-coarse correction (the flagship preconditioner,
  solvers/preconditioners.py SaddleCoarseCorrection) runs with
  REPLICATED coarse vectors: the coarse space is 4*n_vert by
  construction, so restriction is a local segment-sum + one psum,
  the coarse solve is either the replicated dense inverse (one dense
  matvec per shard) or an inner FGMRES whose coarse matvecs use each
  shard's own cells + one psum (coarse element tensors stay SHARDED
  -- no per-shard duplication), and prolongation is purely local.
  This keeps the DD outer iteration count at the single-device level
  (vs ~10x more with block smoothing alone).  The u-block two-grid
  (redundant once the saddle coarse is on) is not supported.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.model import State
from ..models.timesteppers import BDF2
from ..solvers.cg import cg
from ..solvers.gmres import gmres
from ..solvers.preconditioners import AggregateCoarseCorrection, chebyshev
from .sharding import AXIS, make_device_mesh


def _ceil_div(a, b):
    return -(-a // b)


@dataclass
class _SpacePart:
    """Per-space partition constants (static)."""

    n: int  # true dof count
    chunk: int  # owned block size per shard
    K: int  # halo depth in chunks
    ext_len: int  # (2K+1)*chunk


class DDModel:
    """Sharded-state wrapper around a built PGModel.

    Usage::

        model = PGModel(fe, params, forcings, ts)   # single-device build
        dd = DDModel(model, n_shards=8)
        state = dd.run(model.rest_state(), max_steps=10)
    """

    def __init__(self, model, n_shards: int, mesh: Mesh = None):
        self.model = model
        self.S = int(n_shards)
        self.mesh = mesh if mesh is not None else make_device_mesh(n_shards)
        if self.mesh.devices.size != self.S:
            raise ValueError(
                f"DDModel: n_shards={self.S} but the device mesh has "
                f"{self.mesh.devices.size} device(s) "
                f"(jax.devices()={len(jax.devices())}); on CPU set "
                f"XLA_FLAGS=--xla_force_host_platform_device_count={self.S} "
                f"before importing jax")
        if model.twogrid:
            raise NotImplementedError(
                "DD step: u-block two-grid not supported (use the saddle "
                "coarse correction, which subsumes it)"
            )
        # periodic meshes need no special handling: cell dof tables
        # already map slaves to masters (fem/spaces.py), the RCM graph
        # includes the identification so the ordering stays band-
        # limited on the torus, and slave dofs are pinned by the
        # active masks like any Dirichlet dof.
        self.eddy_on = bool(model.forcings.eddy_param.is_on)

        from ..utils.precision import precision_ctx

        with precision_ctx(model.matmul_precision):
            self._build_partition()
            self._build_tables()
            self._build_step()

    # ------------------------------------------------------------------
    # host setup
    # ------------------------------------------------------------------
    def _build_partition(self):
        fe = self.model.fe
        sp = fe.spaces
        S = self.S
        cd_u = np.asarray(fe.cd_u)  # (ncp, nlu) node ids, current numbering
        cd_p = np.asarray(fe.cd_p)
        cd_b = np.asarray(fe.cd_b)
        ncp = cd_u.shape[0]

        cu = _ceil_div(sp.u_space.ndof, S)
        cp = _ceil_div(sp.p_space.ndof, S)
        cb = _ceil_div(sp.b_space.ndof, S)

        # owner by median velocity node
        owner = np.clip(np.median(cd_u, axis=1).astype(np.int64) // cu, 0, S - 1)
        # fe pad cells (zero wq) can go anywhere; spread for balance
        wq = np.asarray(fe.geom.wq)
        is_pad = np.abs(wq).sum(axis=1) == 0
        owner[is_pad] = np.arange(is_pad.sum()) % S

        counts = np.bincount(owner, minlength=S)
        nc_max = int(counts.max())
        order = np.zeros((S, nc_max), dtype=np.int64)
        valid = np.zeros((S, nc_max), dtype=bool)
        for s in range(S):
            ids = np.where(owner == s)[0]
            # order each shard's batch by smallest velocity node with
            # pad cells last (mirrors FEData's global cell sort): any
            # run of consecutive cells then touches a narrow contiguous
            # dof window, which keeps gathers and scatters local
            key = np.where(is_pad[ids], np.iinfo(np.int64).max,
                           cd_u[ids].min(axis=1))
            ids = ids[np.argsort(key, kind="stable")]
            order[s, : len(ids)] = ids
            # fe pad cells (zero quadrature weight) carry all-zero dof
            # rows that would fall outside far shards' halo windows --
            # treat them as invalid slots (their tensors are zero anyway)
            valid[s, : len(ids)] = ~is_pad[ids]
        self.cell_order = order  # (S, nc_max) indices into the ncp cell axis
        self.cell_valid = valid
        self.nc_max = nc_max

        # halo depth per space: max reach of any cell's dofs outside its
        # owner block, in chunks
        def halo_K(cd, chunk):
            lo = owner * chunk
            mn = cd.min(axis=1)
            mx = cd.max(axis=1)
            r_lo = np.maximum(lo - mn, 0)
            r_hi = np.maximum(mx - (lo + chunk - 1), 0)
            r_lo[is_pad] = 0
            r_hi[is_pad] = 0
            H = int(max(r_lo.max() if len(r_lo) else 0,
                        r_hi.max() if len(r_hi) else 0))
            return _ceil_div(H, chunk) if H else 0

        Ku = halo_K(cd_u, cu)
        Kp = halo_K(cd_p, cp)
        Kb = halo_K(cd_b, cb)
        if max(Ku, Kp, Kb) >= S:
            raise ValueError(
                f"halo depth ({Ku},{Kp},{Kb}) chunks >= {S} shards: mesh too "
                f"small for this shard count (or RCM bandwidth too large)"
            )
        self.part_u = _SpacePart(sp.u_space.ndof, cu, Ku, (2 * Ku + 1) * cu)
        self.part_p = _SpacePart(sp.p_space.ndof, cp, Kp, (2 * Kp + 1) * cp)
        self.part_b = _SpacePart(sp.b_space.ndof, cb, Kb, (2 * Kb + 1) * cb)

    def _ext_ids(self, cd, part) -> np.ndarray:
        """Map global dof ids (per shard-owned cells) to extended-vector
        indices: ext = gid - (s - K) * chunk."""
        S = self.S
        out = np.zeros((S, self.nc_max, cd.shape[1]), dtype=np.int32)
        for s in range(S):
            g = cd[self.cell_order[s]]
            e = g - (s - part.K) * part.chunk
            e[~self.cell_valid[s]] = 0
            if e.min() < 0 or e.max() >= part.ext_len:
                raise AssertionError("ext index out of halo window")
            out[s] = e
        return out

    @staticmethod
    def _plan(ids2d: np.ndarray, ext_len: int):
        """Per-shard sorted scatter plan: ids2d (S, E) -> gperm, seg."""
        S, E = ids2d.shape
        gperm = np.argsort(ids2d, axis=1, kind="stable").astype(np.int32)
        seg = np.take_along_axis(ids2d, gperm, axis=1).astype(np.int32)
        return gperm, seg

    def _reorder_cells(self, arr) -> np.ndarray:
        """(ncp, ...) cell-axis array -> (S, nc_max, ...), zeroed pads."""
        a = np.asarray(arr)[self.cell_order]  # (S, nc_max, ...)
        mask = self.cell_valid.reshape(self.S, self.nc_max,
                                       *([1] * (a.ndim - 2)))
        if np.issubdtype(a.dtype, np.floating):
            a = a * mask
        return a

    def _build_tables(self):
        m = self.model
        fe, c, ops = m.fe, m.const, m.ops
        sp = fe.spaces
        S = self.S
        pu_, pp_, pb_ = self.part_u, self.part_p, self.part_b
        dt = m.dtype

        cd_u = self._ext_ids(np.asarray(fe.cd_u), pu_)
        cd_p = self._ext_ids(np.asarray(fe.cd_p), pp_)
        cd_b = self._ext_ids(np.asarray(fe.cd_b), pb_)

        gperm_u, seg_u = self._plan(cd_u.reshape(S, -1), pu_.ext_len)
        gperm_p, seg_p = self._plan(cd_p.reshape(S, -1), pp_.ext_len)
        gperm_b, seg_b = self._plan(cd_b.reshape(S, -1), pb_.ext_len)

        def vec_dd(v, part, width=1):
            v = np.asarray(v).reshape(-1)
            return np.asarray(
                np.pad(v, (0, S * part.chunk * width - v.shape[0])), v.dtype
            )

        t = {}
        t["cd_u"], t["cd_p"], t["cd_b"] = cd_u, cd_p, cd_b
        t["gperm_u"], t["seg_u"] = gperm_u, seg_u
        t["gperm_p"], t["seg_p"] = gperm_p, seg_p
        t["gperm_b"], t["seg_b"] = gperm_b, seg_b
        # element tensors (reordered to shard batches); the inversion
        # blocks live in the scan-carried state instead when the eddy
        # parameterization rebuilds them in-step
        elem_keys = ["visc_e", "Mp_e", "B_e", "M_e", "Kh_e", "Kv_e"]
        if not self.eddy_on:
            elem_keys += ["A_uu_e", "A_up_e", "A_pu_e"]
        for k in elem_keys:
            t[k] = np.asarray(self._reorder_cells(np.asarray(ops[k])), dt)
        self._eddy_init = None
        if self.eddy_on:
            self._eddy_init = {
                k: np.asarray(self._reorder_cells(np.asarray(ops[k])), dt)
                for k in ("A_uu_e", "A_up_e", "A_pu_e")
            }
            t["f_q"] = np.asarray(self._reorder_cells(c["f_q"]), dt)
            t["f_eddy_q"] = np.asarray(self._reorder_cells(c["f_eddy_q"]), dt)
        # geometry + coefficients for the in-step assemblies
        t["wq"] = np.asarray(self._reorder_cells(c["wq"]), dt)
        t["invJT"] = np.asarray(self._reorder_cells(c["invJT"]), dt)
        t["kv_q"] = np.asarray(self._reorder_cells(c["kv_q"]), dt)
        t["h_cells"] = np.asarray(
            np.where(self.cell_valid, np.asarray(c["h_cells"])[self.cell_order],
                     1e30), dt)
        # masks / lifts / rhs in dd layout
        n_u = sp.n_u
        t["free_u"] = vec_dd(c["free_u"], pu_, 3)
        t["udiri"] = vec_dd(c["udiri"], pu_, 3)
        t["free_b"] = vec_dd(c["free_b"], pb_)
        t["bdiri"] = vec_dd(c["bdiri"], pb_)
        t["free_p"] = vec_dd(c["free_inv"][n_u:], pp_)
        t["s_u"] = vec_dd(np.asarray(ops["s"])[:n_u], pu_, 3)
        t["rhs_diff"] = vec_dd(np.asarray(ops["rhs_diff"]), pb_)
        t["rhs_flux"] = vec_dd(np.asarray(ops["rhs_flux"]), pb_)
        t["p_volw"] = vec_dd(np.asarray(ops["p_volw"]), pp_)

        # preconditioner diagonals (single-device computation, resharded)
        visc = m._visc_operator(ops["visc_e"])
        from ..ops.sparse import MaskedOperator

        visc_d = MaskedOperator(visc, c["free_u"]).diagonal()
        t["visc_dinv"] = vec_dd(1.0 / np.asarray(visc_d), pu_, 3)
        from ..ops.element import ElementOperator

        mp = ElementOperator(Ae=ops["Mp_e"],
                             cd_rows=jnp.asarray(fe.cd_p, jnp.int32),
                             cd_cols=jnp.asarray(fe.cd_p, jnp.int32),
                             row_plan=fe.vec_plan_p)
        mp_d = MaskedOperator(mp, c["free_inv"][n_u:]).diagonal()
        t["mp_dinv"] = vec_dd(1.0 / np.asarray(mp_d), pp_)
        self.lmax_p = float(ops["lmax_p"])

        # ---- saddle-coarse correction tables -------------------------
        # Coarse vectors (4 n_vert) are REPLICATED; restriction tables
        # are sharded by owned fine u nodes, coarse element tensors (if
        # the iterative coarse path is active) are sharded by cell.
        tr = {}  # replicated tables (P() specs)
        self.has_saddle_coarse = bool(m.saddle_coarse) and (
            "saddle_coarse_inv" in ops or "sc_uu" in ops
        )
        # nu-dependent spectral bounds ride as REPLICATED 0-d tables
        # (not trace-time constants) so refresh_precond can update them
        # without retracing the compiled step
        tr["lmax_u"] = np.asarray(ops["lmax_u"], dt)
        if self.has_saddle_coarse:
            nv = sp.p_space.ndof
            tr["tg_coarse_free"] = np.asarray(c["tg_coarse_free"], dt)
            tr["free_p_c"] = np.asarray(c["free_inv"][n_u:], dt)
            # per-shard slices of the P1 c P2 inclusion (fine u node ->
            # two parent vertices in p numbering); pad nodes -> weight 0
            tp = np.asarray(c["tg_parents"])
            tw = np.asarray(c["tg_weights"], dt)
            nn = sp.u_space.ndof
            par = np.zeros((S, pu_.chunk, 2), np.int32)
            wts = np.zeros((S, pu_.chunk, 2), dt)
            for s in range(S):
                lo, hi = s * pu_.chunk, min((s + 1) * pu_.chunk, nn)
                if hi > lo:
                    par[s, : hi - lo] = tp[lo:hi]
                    wts[s, : hi - lo] = tw[lo:hi]
            t["tg_parents_dd"] = par
            t["tg_weights_dd"] = wts
            if "saddle_coarse_inv" in ops:
                tr["sc_inv"] = np.asarray(ops["saddle_coarse_inv"], dt)
            else:
                # iterative coarse path: coarse element tensors sharded
                # by cell; coarse matvecs gather from the replicated
                # coarse vector by GLOBAL vertex id (no halo exchange)
                # and scatter via a sorted global-id plan + one psum
                for k in ("sc_uu", "sc_up", "sc_pu", "sc_pp", "sc_visc_e"):
                    t[k] = np.asarray(self._reorder_cells(np.asarray(ops[k])), dt)
                cdg = np.asarray(fe.cd_p)[self.cell_order]
                cdg[~self.cell_valid] = 0
                t["cd_pg"] = cdg.astype(np.int32)
                t["gperm_pg"], t["seg_pg"] = self._plan(cdg.reshape(S, -1), nv)
                tr["sc_pin"] = np.asarray(ops["sc_pin"], dt)
                tr["sc_sigma"] = np.asarray(ops["sc_sigma"], dt)
                tr["sc_lmax"] = np.asarray(ops["sc_lmax"], dt)
                if "sc2_inv" in ops:
                    tr["sc2_inv"] = np.asarray(ops["sc2_inv"], dt)
                    tr["sc2_agg"] = np.asarray(ops["sc2_agg"], np.int32)
                    self.sc2_na = m._sc2_na
                cvisc = MaskedOperator(
                    m._coarse_operator(ops["sc_visc_e"]), c["tg_coarse_free"]
                )
                tr["cvisc_dinv"] = np.asarray(1.0 / cvisc.diagonal(), dt)
                tr["mp_c_dinv"] = np.asarray(1.0 / mp_d, dt)
        self.tables = t
        self.tables_repl = tr

    # ------------------------------------------------------------------
    # state conversion
    # ------------------------------------------------------------------
    def to_dd(self, state: State) -> dict:
        pu_, pp_, pb_ = self.part_u, self.part_p, self.part_b
        S = self.S

        def padv(v, part, width=1):
            v = np.asarray(v).reshape(-1)
            padded = np.asarray(
                np.pad(v, (0, S * part.chunk * width - v.shape[0])),
                self.model.dtype)
            return self._global(padded, P(AXIS))

        dd = {
            "u": padv(state.u, pu_, 3),
            "u_prev": padv(state.u_prev, pu_, 3),
            "p": padv(state.p, pp_),
            "b": padv(state.b, pb_),
            "b_prev": padv(state.b_prev, pb_),
            "t": jnp.asarray(state.t, self.model.dtype),
            "dt": jnp.asarray(state.dt, self.model.dtype),
            "step": jnp.asarray(state.step, jnp.int32),
        }
        if self.eddy_on:
            # state-dependent inversion blocks ride in the scan carry
            for k, v in self._eddy_init.items():
                dd[k] = self._global(v, P(AXIS))
        return dd

    def from_dd(self, dd: dict) -> State:
        pu_, pp_, pb_ = self.part_u, self.part_p, self.part_b
        return State(
            u=dd["u"][: 3 * pu_.n].reshape(-1, 3),
            p=dd["p"][: pp_.n],
            b=dd["b"][: pb_.n],
            u_prev=dd["u_prev"][: 3 * pu_.n].reshape(-1, 3),
            b_prev=dd["b_prev"][: pb_.n],
            t=dd["t"], dt=dd["dt"], step=dd["step"],
        )

    # ------------------------------------------------------------------
    # device step
    # ------------------------------------------------------------------
    def _build_step(self):
        m = self.model
        fe, c = m.fe, m.const
        pr = m.params
        S = self.S
        pu_, pp_, pb_ = self.part_u, self.part_p, self.part_b
        dt_ = m.dtype
        phi_u = np.asarray(c["phi_u"], dt_)
        phi_b = np.asarray(c["phi_b"], dt_)
        dphi_b = np.asarray(c["dphi_b"], dt_)
        embed = np.asarray(c["embed"], dt_)
        nlu = phi_u.shape[1]
        nlb = phi_b.shape[1]
        iu, ip = m.inner_iters
        lmax_p = self.lmax_p
        cond_ratio = m.cond_ratio
        inner_method = m.inner_method
        conv = m.forcings.conv_param
        is_bdf2 = isinstance(m.ts, BDF2)
        adaptive = bool(getattr(m.ts, "adaptive", False))
        CFL = float(getattr(m.ts, "CFL_factor", 0.5))
        inv_opts = m.inv_opts
        evo_opts = m.evo_opts

        fwd = lambda h: [(i, (i + h) % S) for i in range(S)]

        def make_exchange(part):
            K, ch = part.K, part.chunk

            def exchange(x, width=1):
                """owned (width*chunk,) -> extended (width*(2K+1)*chunk,)."""
                if K == 0:
                    return x
                left = [jax.lax.ppermute(x, AXIS, fwd(h)) for h in range(K, 0, -1)]
                right = [jax.lax.ppermute(x, AXIS, fwd(-h)) for h in range(1, K + 1)]
                return jnp.concatenate(left + [x] + right)

            def fold(y_ext, width=1):
                """extended partial sums -> owned, halo parts returned
                to their owners (reverse ppermute)."""
                w = width * ch
                own = jax.lax.dynamic_slice_in_dim(y_ext, K * w, w)
                for h in range(1, K + 1):
                    up = jax.lax.dynamic_slice_in_dim(y_ext, (K + h) * w, w)
                    dn = jax.lax.dynamic_slice_in_dim(y_ext, (K - h) * w, w)
                    own = own + jax.lax.ppermute(up, AXIS, fwd(h))
                    own = own + jax.lax.ppermute(dn, AXIS, fwd(-h))
                return own

            return exchange, fold

        ex_u, fold_u = make_exchange(pu_)
        ex_p, fold_p = make_exchange(pp_)
        ex_b, fold_b = make_exchange(pb_)

        def scatter(ye_flat, gperm, seg, ext_len):
            v = ye_flat[gperm]
            return jax.ops.segment_sum(v, seg, num_segments=ext_len,
                                       indices_are_sorted=True)

        def scatter_rows3(ye_rows, gperm, seg, ext_nodes):
            v = ye_rows[gperm]
            return jax.ops.segment_sum(v, seg, num_segments=ext_nodes,
                                       indices_are_sorted=True).reshape(-1)

        has_coarse = self.has_saddle_coarse
        sc_dense = has_coarse and "sc_inv" in self.tables_repl
        sc_inner_k = m.saddle_coarse_inner if has_coarse else 0
        sc2_na = getattr(self, "sc2_na", 0)
        nlp = np.asarray(fe.cd_p).shape[1]
        eddy_on = self.eddy_on
        eddy = m.forcings.eddy_param
        variable_nu = m.variable_nu
        phi_p = np.asarray(c["phi_p"], dt_)
        dphi_u = np.asarray(c["dphi_u"], dt_)

        def shard_ops(t, Ae_uu, Ae_up, Ae_pu):
            """Per-shard gathers and masked matvecs on local vectors:
            exchange -> gather -> element einsum -> sorted segment-sum
            scatter -> fold-back."""
            # ---- gathered element views -------------------------------
            def gath_u(x):
                xe = ex_u(x).reshape(-1, 3)
                return xe[t["cd_u"]].reshape(-1, 3 * nlu)

            def gath_p(x):
                return ex_p(x)[t["cd_p"]]

            def gath_b(x):
                return ex_b(x)[t["cd_b"]]

            # ---- operators -------------------------------------------
            free_u, free_p = t["free_u"], t["free_p"]

            def saddle_mv(x):
                """masked saddle matvec on local [u | p]."""
                xu, xp = x[: 3 * pu_.chunk], x[3 * pu_.chunk:]
                xu_m, xp_m = xu * free_u, xp * free_p
                xe_u = gath_u(xu_m)
                xe_p = gath_p(xp_m)
                yu_e = jnp.einsum("cij,cj->ci", Ae_uu, xe_u)
                yu_e = yu_e + jnp.einsum("cij,cj->ci", Ae_up, xe_p)
                yp_e = jnp.einsum("cij,cj->ci", Ae_pu, xe_u)
                yu = fold_u(scatter_rows3(yu_e.reshape(-1, 3), t["gperm_u"],
                                          t["seg_u"], pu_.ext_len), 3)
                yp = fold_p(scatter(yp_e.reshape(-1), t["gperm_p"],
                                    t["seg_p"], pp_.ext_len))
                yu = jnp.where(free_u.astype(bool), yu, xu)
                yp = jnp.where(free_p.astype(bool), yp, xp)
                return jnp.concatenate([yu, yp])

            def visc_mv(xu):
                xu_m = xu * free_u
                xe_u = gath_u(xu_m)
                yu_e = jnp.einsum("cij,cj->ci", t["visc_e"], xe_u)
                yu = fold_u(scatter_rows3(yu_e.reshape(-1, 3), t["gperm_u"],
                                          t["seg_u"], pu_.ext_len), 3)
                return jnp.where(free_u.astype(bool), yu, xu)

            def ublock_mv(xu):
                xu_m = xu * free_u
                xe_u = gath_u(xu_m)
                yu_e = jnp.einsum("cij,cj->ci", Ae_uu, xe_u)
                yu = fold_u(scatter_rows3(yu_e.reshape(-1, 3), t["gperm_u"],
                                          t["seg_u"], pu_.ext_len), 3)
                return jnp.where(free_u.astype(bool), yu, xu)

            def up_mv(xp):
                xe_p = gath_p(xp)
                yu_e = jnp.einsum("cij,cj->ci", Ae_up, xe_p)
                return free_u * fold_u(
                    scatter_rows3(yu_e.reshape(-1, 3), t["gperm_u"],
                                  t["seg_u"], pu_.ext_len), 3)

            def mp_mv(xp):
                xp_m = xp * free_p
                xe_p = gath_p(xp_m)
                yp_e = jnp.einsum("cij,cj->ci", t["Mp_e"], xe_p)
                yp = fold_p(scatter(yp_e.reshape(-1), t["gperm_p"],
                                    t["seg_p"], pp_.ext_len))
                return jnp.where(free_p.astype(bool), yp, xp)

            return (gath_u, gath_p, gath_b, saddle_mv, visc_mv, ublock_mv,
                    up_mv, mp_mv)

        def step_kernel(t, tr, sv):
            """Per-shard body (inside shard_map).  ``t``: tables with
            the leading shard axis sliced off; ``tr``: replicated
            coarse-level tables; ``sv``: state values."""
            u_loc, p_loc, b_loc = sv["u"], sv["p"], sv["b"]
            up_loc, bp_loc = sv["u_prev"], sv["b_prev"]
            tt, dtv, stp = sv["t"], sv["dt"], sv["step"]
            if eddy_on:
                Ae_uu, Ae_up, Ae_pu = sv["A_uu_e"], sv["A_up_e"], sv["A_pu_e"]
            else:
                Ae_uu, Ae_up, Ae_pu = t["A_uu_e"], t["A_up_e"], t["A_pu_e"]

            psum = lambda x: jax.lax.psum(x, AXIS)
            (gath_u, gath_p, gath_b, saddle_mv, visc_mv, ublock_mv, up_mv,
             mp_mv) = shard_ops(t, Ae_uu, Ae_up, Ae_pu)
            free_u, free_b, free_p = t["free_u"], t["free_b"], t["free_p"]

            # ---- CFL dt ----------------------------------------------
            dt_old = dtv
            if adaptive:
                u_e = gath_u(u_loc).reshape(-1, nlu, 3)
                u_q = jnp.einsum("qi,cia->cqa", phi_u, u_e)
                speed = jnp.linalg.norm(u_q, axis=-1).max(axis=1)
                ratios = t["h_cells"] / jnp.maximum(speed, 0.01)
                dt_new = CFL * jax.lax.pmin(ratios.min(), AXIS)
                if is_bdf2:
                    dt_new = jnp.minimum(dt_new, 2.0 * dtv)
                dtv = dt_new.astype(dt_)
            r = (dtv / dt_old).astype(dt_)

            # ---- evolution (advection + diffusion solve) --------------
            Gb3 = jnp.einsum(
                "cqip,pd->cqid",
                jnp.einsum("cpr,qir->cqip", t["invJT"], dphi_b), embed)
            b_e = gath_b(b_loc)
            bp_e = gath_b(bp_loc)
            u_e = gath_u(u_loc).reshape(-1, nlu, 3)
            upv_e = gath_u(up_loc).reshape(-1, nlu, 3)

            if conv.is_on:
                abz = pr.alpha * (
                    pr.N2 + jnp.einsum("cqi,ci->cq", Gb3[..., 2], b_e))
                kv_q = conv.kappa_v(t["kv_q"], abz)
                Kv_e = jnp.einsum("cq,cq,cqi,cqj->cij", t["wq"], kv_q,
                                  Gb3[..., 2], Gb3[..., 2])
                rhs_diff = fold_b(scatter(
                    (-pr.N2 * jnp.einsum("cq,cq,cqi->ci", t["wq"], kv_q,
                                         Gb3[..., 2])).reshape(-1),
                    t["gperm_b"], t["seg_b"], pb_.ext_len))
            else:
                Kv_e = t["Kv_e"]
                rhs_diff = t["rhs_diff"]

            use2 = jnp.logical_and(jnp.asarray(is_bdf2), stp > 0)
            base_theta = dtv * pr.a2e2 / pr.mu_rho
            wbdf = (1.0 + r) / (1.0 + 2.0 * r)
            theta = jnp.where(use2, wbdf * base_theta, base_theta)
            c0 = jnp.where(use2, (1.0 + r) ** 2 / (1.0 + 2.0 * r), 1.0).astype(dt_)
            c1 = jnp.where(use2, r ** 2 / (1.0 + 2.0 * r), 0.0).astype(dt_)
            cdt = jnp.where(use2, wbdf * dtv, dtv).astype(dt_)
            w2 = jnp.where(use2, 1.0 + r, 1.0).astype(dt_)

            ue = w2 * u_e - (w2 - 1.0) * upv_e
            be = w2 * b_e - (w2 - 1.0) * bp_e
            u_q = jnp.einsum("qi,cia->cqa", phi_u, ue)
            gb_q = jnp.einsum("cqid,ci->cqd", Gb3, be)
            adv = jnp.einsum("cqa,cqa->cq", u_q, gb_q) + u_q[..., 2] * jnp.asarray(pr.N2, dt_)
            b_q = jnp.einsum("qi,ci->cq", phi_b, b_e)
            bpq = jnp.einsum("qi,ci->cq", phi_b, bp_e)
            integ = c0 * b_q - c1 * bpq - cdt * adv
            rhs_adv = fold_b(scatter(
                jnp.einsum("cq,qi,cq->ci", t["wq"], phi_b, integ).reshape(-1),
                t["gperm_b"], t["seg_b"], pb_.ext_len))

            evo_Ae = t["M_e"] + theta * (t["Kh_e"] + Kv_e)

            def evo_mv(x):
                x_m = x * free_b
                xe = gath_b(x_m)
                ye = jnp.einsum("cij,cj->ci", evo_Ae, xe)
                y = fold_b(scatter(ye.reshape(-1), t["gperm_b"],
                                   t["seg_b"], pb_.ext_len))
                return jnp.where(free_b.astype(bool), y, x)

            # Jacobi diag of the evolution LHS (masked)
            de = jnp.einsum("cii->ci", evo_Ae)
            evo_diag = fold_b(scatter(de.reshape(-1), t["gperm_b"],
                                      t["seg_b"], pb_.ext_len))
            evo_dinv = 1.0 / jnp.where(free_b.astype(bool), evo_diag, 1.0)

            y_full = rhs_adv + theta * rhs_diff + dtv * t["rhs_flux"]
            xd = t["bdiri"] * (1.0 - free_b)
            y = jnp.where(free_b.astype(bool), y_full - evo_mv(xd), t["bdiri"])
            b_new, evo_stats = cg(evo_mv, y, b_loc, M_diag_inv=evo_dinv,
                                  psum_axis=AXIS, **evo_opts)

            # ---- inversion -------------------------------------------
            b_e_new = gath_b(b_new)
            Bye = jnp.einsum("cij,cj->ci", t["B_e"], b_e_new)
            yu = fold_u(scatter_rows3(Bye.reshape(-1, 3), t["gperm_u"],
                                      t["seg_u"], pu_.ext_len), 3)
            y_inv = jnp.concatenate([yu + t["s_u"], jnp.zeros(pp_.chunk, dt_)])
            free_inv = jnp.concatenate([free_u, free_p])
            xdiri = jnp.concatenate([t["udiri"], jnp.zeros(pp_.chunk, dt_)])
            xd_inv = xdiri * (1.0 - free_inv)
            y_inv = jnp.where(free_inv.astype(bool),
                              y_inv - saddle_mv(xd_inv), xdiri)

            visc_dinv, mp_dinv = t["visc_dinv"], t["mp_dinv"]

            def solve_p(rp):
                return chebyshev(mp_mv, mp_dinv, rp, ip, lmax_p / 4.0, lmax_p)

            def solve_u(ru):
                if inner_method == "inner_gmres":
                    zu, _ = gmres(ublock_mv, ru, jnp.zeros_like(ru),
                                  M=lambda v: visc_dinv * v, m=iu, itmax=iu,
                                  atol=0.0, rtol=1e-8, psum_axis=AXIS)
                    return zu
                return chebyshev(visc_mv, visc_dinv, ru, iu,
                                 tr["lmax_u"] / cond_ratio, tr["lmax_u"])

            # ---- replicated saddle-coarse correction -----------------
            # (solvers/preconditioners.py SaddleCoarseCorrection, DD
            # form: coarse 4*n_vert vectors replicated on every shard)
            if has_coarse:
                nv = pp_.n
                tgf, fpc = tr["tg_coarse_free"], tr["free_p_c"]
                free_c = jnp.concatenate([tgf, fpc])
                sidx = jax.lax.axis_index(AXIS)

                def restrict(rv):
                    ru = rv[: 3 * pu_.chunk].reshape(-1, 3)
                    contrib = t["tg_weights_dd"][:, :, None] * ru[:, None, :]
                    rcu = jax.ops.segment_sum(
                        contrib.reshape(-1, 3),
                        t["tg_parents_dd"].reshape(-1), num_segments=nv)
                    rp_full = jax.lax.dynamic_update_slice(
                        jnp.zeros(S * pp_.chunk, dt_), rv[3 * pu_.chunk:],
                        (sidx * pp_.chunk,))
                    rcu, rp_full = jax.lax.psum((rcu, rp_full), AXIS)
                    return jnp.concatenate(
                        [rcu.reshape(-1) * tgf, rp_full[:nv]])

                def prolong(zc):
                    zcu = (zc[: 3 * nv] * tgf).reshape(-1, 3)
                    z3 = zcu[t["tg_parents_dd"]]  # (chunk, 2, 3)
                    zu = (t["tg_weights_dd"][:, :, None] * z3).sum(1).reshape(-1)
                    zp_full = jnp.pad(zc[3 * nv:], (0, S * pp_.chunk - nv))
                    zp = jax.lax.dynamic_slice(
                        zp_full, (sidx * pp_.chunk,), (pp_.chunk,))
                    return jnp.concatenate([zu, zp])

                if sc_dense:
                    coarse_solve = lambda rc: tr["sc_inv"] @ rc
                else:
                    # coarse matvecs: gather replicated coarse vector by
                    # global vertex id over this shard's own cells,
                    # scatter locally, psum -> replicated result
                    def c_scatter3(ye_rows):
                        s = jax.ops.segment_sum(
                            ye_rows[t["gperm_pg"]], t["seg_pg"],
                            num_segments=nv, indices_are_sorted=True)
                        return jax.lax.psum(s, AXIS).reshape(-1)

                    def c_scatter1(ye_flat):
                        s = jax.ops.segment_sum(
                            ye_flat[t["gperm_pg"]], t["seg_pg"],
                            num_segments=nv, indices_are_sorted=True)
                        return jax.lax.psum(s, AXIS)

                    def cgath(xc3):  # (3nv,) -> (nc, 3*nlp)
                        return xc3.reshape(-1, 3)[t["cd_pg"]].reshape(
                            -1, 3 * nlp)

                    def cmat(xc):
                        xcu = (xc[: 3 * nv] * tgf)
                        xcp = xc[3 * nv:] * fpc
                        xe_u = cgath(xcu)
                        xe_p = xcp[t["cd_pg"]]
                        yu_e = (jnp.einsum("cij,cj->ci", t["sc_uu"], xe_u)
                                + jnp.einsum("cij,cj->ci", t["sc_up"], xe_p))
                        yp_e = (jnp.einsum("cij,cj->ci", t["sc_pu"], xe_u)
                                + jnp.einsum("cij,cj->ci", t["sc_pp"], xe_p))
                        yu = c_scatter3(yu_e.reshape(-1, 3))
                        yp = c_scatter1(yp_e.reshape(-1))
                        y = jnp.concatenate([yu, yp])
                        y = jnp.where(free_c.astype(bool), y, xc)
                        w = tr["sc_pin"]
                        return y + tr["sc_sigma"] * w * jnp.vdot(w, xc)

                    def cvisc_mv(xu):
                        xu_m = xu * tgf
                        ye = jnp.einsum("cij,cj->ci", t["sc_visc_e"],
                                        cgath(xu_m))
                        y = c_scatter3(ye.reshape(-1, 3))
                        return jnp.where(tgf.astype(bool), y, xu)

                    def cuu_mv(xu):
                        xu_m = xu * tgf
                        ye = jnp.einsum("cij,cj->ci", t["sc_uu"], cgath(xu_m))
                        y = c_scatter3(ye.reshape(-1, 3))
                        return jnp.where(tgf.astype(bool), y, xu)

                    def cmp_mv(xp):
                        # coarse p space == fine p space: reuse the
                        # sharded Mp_e tensors with the global-id plan
                        xp_m = xp * fpc
                        ye = jnp.einsum("cij,cj->ci", t["Mp_e"],
                                        xp_m[t["cd_pg"]])
                        y = c_scatter1(ye.reshape(-1))
                        return jnp.where(fpc.astype(bool), y, xp)

                    def cup_mv(xp):
                        ye = jnp.einsum("cij,cj->ci", t["sc_up"],
                                        xp[t["cd_pg"]])
                        return tgf * c_scatter3(ye.reshape(-1, 3))

                    iu_c = 6 if inner_method == "inner_gmres" else 3

                    def Mc(rv):
                        rcu, rcp = rv[: 3 * nv], rv[3 * nv:]
                        zp = chebyshev(cmp_mv, tr["mp_c_dinv"], rcp, 3,
                                       lmax_p / 4.0, lmax_p)
                        rcu = rcu - cup_mv(zp)
                        if inner_method == "inner_gmres":
                            zu, _ = gmres(cuu_mv, rcu, jnp.zeros_like(rcu),
                                          M=lambda v: tr["cvisc_dinv"] * v,
                                          m=iu_c, itmax=iu_c, atol=0.0,
                                          rtol=1e-8)
                        else:
                            zu = chebyshev(cvisc_mv, tr["cvisc_dinv"], rcu,
                                           iu_c, tr["sc_lmax"] / cond_ratio,
                                           tr["sc_lmax"])
                        return jnp.concatenate([zu, zp])

                    # second (aggregate) level: coarse vectors are
                    # replicated, so the correction (segment-sum
                    # restrict -> dense solve -> gather prolong) is
                    # identical to the single-device one
                    M_in = Mc
                    if "sc2_inv" in tr:
                        sc2 = AggregateCoarseCorrection(
                            inv=tr["sc2_inv"], agg=tr["sc2_agg"],
                            n_agg=sc2_na, free_c=free_c)
                        M_in = lambda rv: sc2(cmat, rv, Mc(rv))

                    if sc_inner_k <= 0:
                        # one two-level cycle as the coarse solve (see
                        # models/model.py::_saddle_coarse_solver)
                        coarse_solve = M_in
                    else:
                        def coarse_solve(rc):
                            zc, _ = gmres(cmat, rc, jnp.zeros_like(rc),
                                          M=M_in, flexible=True,
                                          m=sc_inner_k, itmax=sc_inner_k,
                                          atol=0.0, rtol=1e-2)
                            return zc

            def M_block(rv):
                ru, rp = rv[: 3 * pu_.chunk], rv[3 * pu_.chunk:]
                zp = solve_p(rp)
                zu = solve_u(ru - up_mv(zp))
                z = jnp.concatenate([zu, zp])
                if has_coarse:
                    # multiplicative two-level step: block pre-smooth ->
                    # geostrophic coarse, no post smooth (see
                    # BlockStokesPrecond.__call__)
                    rc = restrict(rv - saddle_mv(z))
                    z = z + prolong(coarse_solve(rc)) * free_inv
                return z

            x0 = jnp.concatenate([u_loc, p_loc])
            x, inv_stats = gmres(saddle_mv, y_inv, x0, M=M_block,
                                 flexible=True, psum_axis=AXIS, **inv_opts)
            u_new = x[: 3 * pu_.chunk]
            p_new = x[3 * pu_.chunk:]
            pw = t["p_volw"]
            p_new = p_new - psum(jnp.vdot(pw, p_new)) / psum(jnp.sum(pw))

            freeb = free_b.astype(bool)
            pos_inf = jnp.asarray(jnp.inf, dt_)
            u_max = jax.lax.pmax(jnp.abs(u_new).max(), AXIS)
            aux = {
                "evo_iters": evo_stats.iterations,
                "evo_res": evo_stats.residual,
                "inv_iters": inv_stats.iterations,
                "inv_res": inv_stats.residual,
                "u_max": u_max,
                "b_max": jax.lax.pmax(jnp.abs(b_new).max(), AXIS),
                # progress-line diagnostics (reference src/model.jl:172-192)
                "b_free_min": jax.lax.pmin(
                    jnp.where(freeb, b_new, pos_inf).min(), AXIS),
                "b_free_max": jax.lax.pmax(
                    jnp.where(freeb, b_new, -pos_inf).max(), AXIS),
                "db_dt_max": jax.lax.pmax(
                    jnp.where(freeb, jnp.abs(b_new - b_loc), 0.0).max(),
                    AXIS) / dtv,
                "cfl_dt": jax.lax.pmin(t["h_cells"].min(), AXIS)
                / jnp.maximum(u_max, 1e-30),
            }
            out = {
                "u": u_new, "p": p_new, "b": b_new,
                "u_prev": u_loc, "b_prev": b_loc,
                "t": tt + dtv, "dt": dtv, "step": stp + 1,
            }
            if eddy_on:
                # eddy-viscosity inversion-block rebuild every 10 steps
                # (reference src/model.jl:160-170), assembled from this
                # shard's own cells; preconditioner kept unchanged like
                # the single-device path (models/model.py _eddy_rebuild)
                from ..fem import assembly as asm_

                def rebuild(_):
                    Gu3 = jnp.einsum(
                        "cqip,pd->cqid",
                        jnp.einsum("cpr,qir->cqip", t["invJT"], dphi_u),
                        embed)
                    abz = pr.alpha * (
                        pr.N2 + jnp.einsum("cqi,ci->cq", Gb3[..., 2],
                                           gath_b(b_new)))
                    nu_q = eddy.nu(t["f_eddy_q"], abz)
                    return asm_.elem_inversion_blocks(
                        t["wq"], nu_q, t["f_q"], phi_u, Gu3, phi_p,
                        jnp.asarray(pr.a2e2, dt_), variable_nu)

                do = jnp.equal(jnp.mod(stp + 1, 10), 0)
                uu, up, pu = jax.lax.cond(
                    do, rebuild, lambda _: (Ae_uu, Ae_up, Ae_pu), None)
                out["A_uu_e"] = uu
                out["A_up_e"] = up
                out["A_pu_e"] = pu
            return out, aux

        vec_keys = ("u", "p", "b", "u_prev", "b_prev")
        elem_keys = ("A_uu_e", "A_up_e", "A_pu_e") if self.eddy_on else ()
        tab_in_specs = {k: P(AXIS) for k in self.tables}
        repl_in_specs = {k: P() for k in self.tables_repl}
        sv_names = ("u", "p", "b", "u_prev", "b_prev", "t", "dt", "step")
        sv_in_specs = {k: (P(AXIS) if k in vec_keys else P())
                       for k in sv_names}
        for k in elem_keys:
            sv_in_specs[k] = P(AXIS)
        aux_keys = ("evo_iters", "evo_res", "inv_iters", "inv_res",
                    "u_max", "b_max", "b_free_min", "b_free_max",
                    "db_dt_max", "cfl_dt")

        def local(t):
            # tables arrive with leading axis sliced to 1 for
            # (S, nc, ...) arrays and to (chunk,) for dd vectors
            return {k: (v if k in ("free_u", "udiri", "free_b", "bdiri",
                                   "free_p", "s_u", "rhs_diff", "rhs_flux",
                                   "p_volw", "visc_dinv", "mp_dinv")
                        else v[0])
                    for k, v in t.items()}

        def wrapper(tables, tables_repl, sv):
            def body(t, tr, s):
                s2 = {k: (v[0] if k in elem_keys else v)
                      for k, v in s.items()}
                out, aux = step_kernel(local(t), tr, s2)
                out = {k: (v[None] if k in elem_keys else v)
                       for k, v in out.items()}
                return out, aux

            return shard_map(
                body, mesh=self.mesh,
                in_specs=(tab_in_specs, repl_in_specs, sv_in_specs),
                out_specs=(sv_in_specs, {k: P() for k in aux_keys}),
                check_vma=False,
            )(tables, tables_repl, sv)

        # DD traces the model's kernels itself, so it must carry the
        # model's scoped matmul-precision policy (utils/precision.py)
        from ..utils.precision import scoped_precision

        wrapper = scoped_precision(wrapper, self.model.matmul_precision)
        self._step = jax.jit(wrapper)

        def saddle(tables, u, p):
            def body(t, u_loc, p_loc):
                t2 = local(t)
                mv = shard_ops(t2, t2["A_uu_e"], t2["A_up_e"],
                               t2["A_pu_e"])[3]
                y = mv(jnp.concatenate([u_loc, p_loc]))
                return y[: 3 * pu_.chunk], y[3 * pu_.chunk:]

            return shard_map(body, mesh=self.mesh,
                             in_specs=(tab_in_specs, P(AXIS), P(AXIS)),
                             out_specs=(P(AXIS), P(AXIS)),
                             check_vma=False)(tables, u, p)

        self._saddle = jax.jit(
            scoped_precision(saddle, self.model.matmul_precision))
        # device-resident tables (sharded placement); make_array_from_
        # callback works identically in single- and multi-process mode
        # (each process materializes only its addressable shards)
        self.tables_dev = {
            k: self._global(v, P(AXIS)) for k, v in self.tables.items()
        }
        self.tables_repl_dev = {
            k: self._global(v, P()) for k, v in self.tables_repl.items()
        }

        def _norms(tables, sv):
            def body(t, s):
                sq = lambda v: jax.lax.psum(jnp.vdot(v, v), AXIS)
                return {"u2": sq(s["u"]), "p2": sq(s["p"]), "b2": sq(s["b"])}

            vecs = {k: (P(AXIS) if (k in vec_keys or k in elem_keys) else P())
                    for k in sv}
            return shard_map(body, mesh=self.mesh,
                             in_specs=({k: P(AXIS) for k in tables}, vecs),
                             out_specs={"u2": P(), "p2": P(), "b2": P()},
                             check_vma=False)(tables, sv)

        self._norms = jax.jit(_norms)

        def multi_step(tables, tables_repl, sv, n):
            def body(sv, _):
                sv, aux = wrapper(tables, tables_repl, sv)
                return sv, aux

            return jax.lax.scan(body, sv, None, length=n)

        self._multi_step = jax.jit(
            scoped_precision(multi_step, self.model.matmul_precision),
            static_argnums=(3,))

    def _global(self, host_arr, spec):
        """Build a (possibly multi-process) global device array from an
        identical host copy on every process."""
        a = np.asarray(host_arr)
        sh = NamedSharding(self.mesh, spec)
        return jax.make_array_from_callback(a.shape, sh, lambda idx: a[idx])

    def norms(self, dd_state: dict) -> dict:
        """Replicated global squared L2 norms of the state -- readable
        on every process (multi-host verification)."""
        out = self._norms(self.tables_dev, dd_state)
        return {k: float(v) for k, v in out.items()}

    def saddle_matvec(self, x) -> np.ndarray:
        """Dirichlet-masked saddle matvec over the global combined
        (u, p) vector, applied shard by shard with halo exchange -- the
        operator the sharded FGMRES iterates on.  Equals
        ``MaskedOperator(model._inv_matrix(model.ops), free_inv)(x)``
        up to summation order."""
        if self.eddy_on:
            raise ValueError("saddle_matvec: the inversion blocks of an "
                             "eddy-parameterized run live in the state")
        pu_, pp_ = self.part_u, self.part_p
        x = np.asarray(x)
        n_u = 3 * pu_.n

        def padv(v, n):
            return self._global(
                np.pad(v, (0, n - v.shape[0])).astype(self.model.dtype),
                P(AXIS))

        yu, yp = self._saddle(self.tables_dev,
                              padv(x[:n_u], 3 * self.S * pu_.chunk),
                              padv(x[n_u:], self.S * pp_.chunk))
        return np.concatenate([np.asarray(yu)[:n_u],
                               np.asarray(yp)[: pp_.n]])

    # ------------------------------------------------------------------
    def step(self, dd_state: dict):
        return self._step(self.tables_dev, self.tables_repl_dev, dd_state)

    def multi_step(self, dd_state: dict, n: int):
        """n steps as ONE dispatch (lax.scan inside jit): a single host
        round-trip per block -- the production loop granularity."""
        return self._multi_step(self.tables_dev, self.tables_repl_dev,
                                dd_state, int(n))

    def refresh_precond(self, dd_state: dict) -> dict:
        """DD counterpart of PGModel.refresh_precond (ADVICE r4 /
        ROADMAP 13): rebuild every nu-dependent preconditioner table
        from the CURRENT eddy viscosity and re-shard it.

        The host PGModel recomputes the operators (seconds of work,
        models/model.py refresh_precond); the affected sharded tables
        (smoother block + diagonal, coarse saddle tensors) and
        replicated tables (spectral bounds, aggregate dense inverse)
        are then re-pushed to the mesh.  All shapes are unchanged and
        every refreshed value flows through jit arguments, so the
        compiled step is reused without retrace.  The state's own
        inversion element blocks are refreshed too (same values the
        next in-step eddy rebuild would produce).  Returns the updated
        dd state; without the eddy parameterization this is a no-op."""
        m = self.model
        if not self.eddy_on:
            return dd_state
        state = self.from_dd(dd_state)
        m.ops = m.refresh_precond(m.ops, state)
        ops, dt = m.ops, m.dtype
        pu_ = self.part_u

        def vec_dd(v, part, width=1):
            v = np.asarray(v).reshape(-1)
            return np.asarray(
                np.pad(v, (0, self.S * part.chunk * width - v.shape[0])),
                dt)

        shard_new = {"visc_e": self._reorder_cells(np.asarray(ops["visc_e"])),
                     "visc_dinv": vec_dd(ops["visc_dinv"], pu_, 3)}
        repl_new = {"lmax_u": np.asarray(ops["lmax_u"], dt)}
        if self.has_saddle_coarse:
            if "sc_inv" in self.tables_repl:
                repl_new["sc_inv"] = np.asarray(ops["saddle_coarse_inv"], dt)
            else:
                for k in ("sc_uu", "sc_up", "sc_pu", "sc_pp", "sc_visc_e"):
                    shard_new[k] = self._reorder_cells(np.asarray(ops[k]))
                repl_new["sc_pin"] = np.asarray(ops["sc_pin"], dt)
                repl_new["sc_sigma"] = np.asarray(ops["sc_sigma"], dt)
                repl_new["sc_lmax"] = np.asarray(ops["sc_lmax"], dt)
                repl_new["cvisc_dinv"] = np.asarray(ops["sc_visc_dinv"], dt)
                if "sc2_inv" in self.tables_repl:
                    repl_new["sc2_inv"] = np.asarray(ops["sc2_inv"], dt)
        for k, v in shard_new.items():
            self.tables[k] = np.asarray(v, dt)
            self.tables_dev[k] = self._global(self.tables[k], P(AXIS))
        for k, v in repl_new.items():
            self.tables_repl[k] = v
            self.tables_repl_dev[k] = self._global(v, P())
        out = dict(dd_state)
        for k in ("A_uu_e", "A_up_e", "A_pu_e"):
            out[k] = self._global(
                np.asarray(self._reorder_cells(np.asarray(ops[k])), dt),
                P(AXIS))
        return out

    def run(self, state, max_steps: int = None, n_info: int = 10,
            n_save=None, save_callback=None, steps_per_block: int = 1,
            n_precond_refresh: int = None, log=print) -> State:
        """Production run loop over the sharded state: scan-blocked
        dispatch, blow-up guard, and the reference's progress block
        (field parity with PGModel.run / reference src/model.jl:90-211).

        ``state`` may be a host ``State`` or an already-sharded dd
        dict (e.g. from ``load_checkpoint``).  ``save_callback``
        receives (dd_model, dd_state, step) -- use ``save_checkpoint``
        or ``from_dd`` inside it.
        """
        import sys
        import time

        from ..models.model import BlowUpError
        from ..utils.misc import hrs_mins_secs

        def hms(sec):
            return "%02d:%02d:%02d" % hrs_mins_secs(sec)

        dd = state if isinstance(state, dict) else self.to_dd(state)
        t_stop = float(self.model.ts.t_stop)
        t0 = t_last = time.time()
        i = i0 = int(jax.device_get(dd["step"]))
        last_refresh = i
        while float(jax.device_get(dd["t"])) < t_stop:
            if steps_per_block > 1:
                dd, auxs = self.multi_step(dd, steps_per_block)
                aux = jax.tree_util.tree_map(lambda a: a[-1], auxs)
                i += steps_per_block
            else:
                dd, aux = self.step(dd)
                i += 1
            u_max, b_max = float(aux["u_max"]), float(aux["b_max"])
            if max(u_max, b_max) > 1e3 or np.isnan(u_max) or np.isnan(b_max):
                raise BlowUpError(
                    f"Blow-up detected at step {i}: "
                    f"|u|max={u_max:.3e} |b|max={b_max:.3e}")
            if n_info and i % n_info == 0:
                t1 = time.time()
                dt_ = float(jax.device_get(dd["dt"]))
                tv = float(jax.device_get(dd["t"]))
                msg = (f"t = {tv:.3e}/{t_stop:.3e} (i = {i}, dt = {dt_:.3e})\n"
                       f"time elapsed: {hms(t1 - t0)}\n")
                if i - i0 > n_info:
                    t_step = (t1 - t_last) / n_info
                    left = max(0.0, (t_stop - tv) // max(dt_, 1e-30))
                    msg += (f"timestep duration ~ {t_step:.3e} s\n"
                            f"estimated time remaining: {hms(t_step * left)}\n")
                msg += (f"|u|max = {u_max:.3e}, "
                        f"CFL dt ~ {float(aux['cfl_dt']):.3e}\n"
                        f"{float(aux['b_free_min']):.3e} <= b_free <= "
                        f"{float(aux['b_free_max']):.3e}, "
                        f"|db/dt|max = {float(aux['db_dt_max']):.3e}\n"
                        f"evo_it = {int(aux['evo_iters'])}, "
                        f"inv_it = {int(aux['inv_iters'])}")
                log(msg)
                t_last = t1
                sys.stdout.flush()
                sys.stderr.flush()
            if n_save and i % n_save == 0 and save_callback is not None:
                save_callback(self, dd, i)
            # steps-since-last counter (not modulo): robust to block
            # sizes that do not divide the cadence (ADVICE r4)
            if (n_precond_refresh and i - last_refresh >= n_precond_refresh
                    and self.eddy_on):
                dd = self.refresh_precond(dd)
                last_refresh = i
            if max_steps is not None and i >= int(max_steps):
                break
        return self.from_dd(dd)

    # ------------------------------------------------------------------
    # sharded checkpoint I/O: each process writes/reads only its own
    # addressable shards -- no gather, scales to multi-host runs
    # ------------------------------------------------------------------
    def _ckpt_path(self, path: str) -> str:
        if jax.process_count() > 1:
            return f"{path}.proc{jax.process_index()}"
        return path

    def save_checkpoint(self, dd_state: dict, path: str) -> None:
        """Write this process's shards of the dd state to ``path``
        (npz).  Multi-process runs write one file per process
        (``path.procK``); pair with ``load_checkpoint`` on the same
        mesh/process layout."""
        data = {}
        for k, v in dd_state.items():
            if v.ndim == 0:
                data[f"scalar:{k}"] = np.asarray(v)
            else:
                for sh in v.addressable_shards:
                    start = sh.index[0].start or 0
                    data[f"shard:{k}:{start}"] = np.asarray(sh.data)
        np.savez_compressed(self._ckpt_path(path), **data)

    def load_checkpoint(self, path: str) -> dict:
        """Rebuild a sharded dd state from ``save_checkpoint`` output;
        the callback feeds each device only its own block."""
        p = self._ckpt_path(path)
        if not p.endswith(".npz"):
            p = p + ".npz"
        f = np.load(p)
        keys = set()
        blocks = {}
        scalars = {}
        for name in f.files:
            kind, rest = name.split(":", 1)
            if kind == "scalar":
                scalars[rest] = f[name]
            else:
                k, start = rest.rsplit(":", 1)
                keys.add(k)
                blocks.setdefault(k, {})[int(start)] = f[name]
        out = {}
        for k, v in scalars.items():
            out[k] = self._global(v, P())
        for k in keys:
            bl = blocks[k]
            some = next(iter(bl.values()))
            n0 = sum(b.shape[0] for b in bl.values()) * (
                jax.process_count())
            shape = (n0,) + some.shape[1:]
            sh = NamedSharding(self.mesh, P(AXIS))

            def cb(idx, bl=bl):
                return bl[idx[0].start or 0]

            out[k] = jax.make_array_from_callback(shape, sh, cb)
        return out
