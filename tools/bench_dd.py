"""DD (sharded-state) bench: iteration invariance + comm volume.

Runs on 8 VIRTUAL CPU devices, so wall-clock here measures
mechanics, not device throughput.  What IS meaningful and reported:

  * halo depth K per space at each shard count (K=1 = the
    band-limited regime the DD design argues for, parallel/dd.py),
  * outer/inner iteration counts vs shard count (DD preconditioning
    is replicated-coarse + local smoothing: iteration invariance
    across S is the property that makes multi-chip scaling work),
  * analytic per-matvec halo-exchange volume (ppermute bytes), the
    traffic the device links would carry, vs the element-tensor bytes
    each shard streams locally (compute:comm ratio).

Launched by bench.py section E as a subprocess with
XLA_FLAGS=--xla_force_host_platform_device_count=8; prints one JSON
line on stdout.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# CPU only: the parent process (bench.py) holds the GPU
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402


def main():
    import nupgcm as npg
    from nupgcm.parallel.dd import DDModel

    eps, alpha, mu = 2e-1, 0.5, 1e1
    params = npg.Parameters(
        eps=eps, alpha=alpha, mu_rho=mu, N2=1 / alpha,
        f=lambda x: 1.0 + 0.5 * x[1],
        H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2),
    )
    kap = lambda x: 1e-2 + np.exp(
        -(x[2] + alpha * (1 - x[0] ** 2 - x[1] ** 2)) / (0.1 * alpha))
    forc = npg.Forcings(nu=1.0, kappa_h=kap, kappa_v=kap, tau_x=0.0,
                        tau_y=0.0, b_surface_bc=npg.SurfaceDirichletBC(0.0))
    mesh = npg.generators.bowl3D(0.12, alpha, nz=5)
    spaces = npg.Spaces(
        mesh, u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True),
                      (False, False, True)],
        b_diri_tags=["coastline", "surface"], b_diri_vals=[0.0, 0.0])
    fe = npg.FEData(mesh, spaces)
    dt = 1e-4 * mu / (alpha * eps) ** 2
    ts = npg.BDF2(t_start=0, t_stop=1e9, dt=dt)
    bic = lambda x: 0.1 * np.exp(
        -(x[2] + alpha * (1 - x[0] ** 2 - x[1] ** 2)) / 0.05)

    out = {"dd_n_dof": fe.n_inv}
    fb = np.dtype(np.float32).itemsize

    # single-device iteration reference
    m0 = npg.PGModel(fe, params, forc, ts)
    s0 = m0.set_b(m0.rest_state(), bic)
    _, s0b, aux0 = m0.multi_step_jit(m0.ops, s0, 5)
    ref_inv = int(np.asarray(aux0["inv_iters"])[-1])
    ref_evo = int(np.asarray(aux0["evo_iters"])[-1])
    out["dd_iters_single"] = [ref_evo, ref_inv]

    for S in (2, 8):
        m = npg.PGModel(fe, params, forc, ts)
        from nupgcm.parallel.sharding import make_device_mesh

        dd = DDModel(m, S, mesh=make_device_mesh(S))
        st = dd.to_dd(m.set_b(m.rest_state(), bic))
        t0 = time.time()
        st, auxs = dd.multi_step(st, 5)
        jax.block_until_ready(st["b"])
        t_compile = time.time() - t0
        t0 = time.time()
        st, auxs = dd.multi_step(st, 5)
        jax.block_until_ready(st["b"])
        t_run = time.time() - t0
        inv_it = int(np.asarray(auxs["inv_iters"])[-1])
        evo_it = int(np.asarray(auxs["evo_iters"])[-1])
        # per-saddle-matvec ppermute traffic: exchange (gather side)
        # + fold-back (scatter side), 2K neighbor chunks each, for the
        # 3-component u block and the scalar p block
        pu, pp = dd.part_u, dd.part_p
        comm = 2 * (3 * 2 * pu.K * pu.chunk + 2 * pp.K * pp.chunk) * fb
        # element tensors each shard streams per saddle matvec
        nc_shard = dd.nc_max
        nlu3, nlp = 3 * fe.cd_u.shape[1], fe.cd_p.shape[1]
        local = nc_shard * (nlu3 * nlu3 + 2 * nlu3 * nlp) * fb
        out[f"dd_S{S}"] = {
            "halo_K": [pu.K, pp.K, dd.part_b.K],
            "iters": [evo_it, inv_it],
            "comm_bytes_per_matvec": int(comm),
            "local_bytes_per_matvec": int(local),
            "compute_comm_ratio": round(local / comm, 1),
            "cpu_5step_s": round(t_run, 2),
            "compile_s": round(t_compile, 1),
        }
    # iteration invariance: sharded counts within 30% of single-device
    out["dd_iter_invariant"] = all(
        abs(out[f"dd_S{S}"]["iters"][1] - ref_inv) <= max(3, 0.3 * ref_inv)
        for S in (2, 8))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
