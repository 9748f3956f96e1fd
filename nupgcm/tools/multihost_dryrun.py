"""Multi-process (multi-host) dryrun of the sharded-state PG step.

The reference has no multi-node story at all (SURVEY.md §2.3 row 5:
single process, single GPU).  Here the domain-decomposed step
(parallel/dd.py) runs unchanged over a process-spanning device mesh:
``jax.distributed.initialize`` connects the processes, every process
executes the same SPMD program, and the ppermute/psum collectives ride
the cross-process transport (NVLink/network between GPUs, the
coordination service on CPU test meshes).

Run one process per "host"::

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \
    python -m nupgcm.tools.multihost_dryrun \
        --nproc 2 --pid 0 --port 9954 &
    XLA_FLAGS=--xla_force_host_platform_device_count=4 \
    python -m nupgcm.tools.multihost_dryrun \
        --nproc 2 --pid 1 --port 9954

Each process prints one JSON line with the replicated post-step state
norms -- identical across processes and identical to a single-process
run with the same total shard count (tests/test_multihost.py asserts
both).
"""

from __future__ import annotations

import argparse
import json


def build_model():
    import numpy as np

    import nupgcm as npg

    eps, alpha, mu = 2e-1, 0.5, 1e1
    params = npg.Parameters(
        eps=eps, alpha=alpha, mu_rho=mu, N2=1 / alpha,
        f=lambda x: 1.0 + 0.5 * x[1],
        H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2),
    )
    kap = lambda x: 1e-2 + np.exp(
        -(x[2] + alpha * (1 - x[0] ** 2 - x[1] ** 2)) / (0.1 * alpha)
    )
    forc = npg.Forcings(
        nu=1.0, kappa_h=kap, kappa_v=kap,
        tau_x=lambda x: -0.05 * np.cos(np.pi / 2 * x[1]), tau_y=0.0,
        b_surface_bc=npg.SurfaceDirichletBC(0.0),
    )
    mesh = npg.generators.bowl3D(0.4, alpha, nz=2)
    spaces = npg.Spaces(
        mesh,
        u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True),
                      (False, False, True)],
        b_diri_tags=["coastline", "surface"], b_diri_vals=[0.0, 0.0],
    )
    fe = npg.FEData(mesh, spaces)
    dt = 1e-4 * mu / (alpha * eps) ** 2
    ts = npg.BDF2(t_start=0, t_stop=50 * dt, dt=dt)
    return npg.PGModel(
        fe, params, forc, ts, inv_itmax=300, evo_itmax=300,
        saddle_coarse=False, twogrid=False, inner_method="chebyshev",
        inner_iters_u=10,
    )


def run(n_steps: int = 1) -> dict:
    import jax
    import numpy as np

    from nupgcm.parallel.dd import DDModel
    from nupgcm.parallel.sharding import make_device_mesh

    model = build_model()
    n_dev = len(jax.devices())
    dd = DDModel(model, n_dev, mesh=make_device_mesh())
    state = model.set_b(model.rest_state(),
                        lambda x: 0.05 * np.exp(2.0 * x[2]))
    sv = dd.to_dd(state)
    aux = None
    for _ in range(n_steps):
        sv, aux = dd.step(sv)
    out = dd.norms(sv)
    out.update(
        u_max=float(aux["u_max"]), b_max=float(aux["b_max"]),
        inv_iters=int(aux["inv_iters"]),
        n_devices=n_dev, n_processes=jax.process_count(),
        process_id=jax.process_index(),
        halo_K=[dd.part_u.K, dd.part_p.K, dd.part_b.K],
    )
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=1)
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--port", type=int, default=9954)
    ap.add_argument("--steps", type=int, default=1)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.nproc > 1:
        jax.distributed.initialize(
            coordinator_address=f"127.0.0.1:{args.port}",
            num_processes=args.nproc,
            process_id=args.pid,
        )
    jax.config.update("jax_enable_x64", True)
    print(json.dumps(run(args.steps)), flush=True)


if __name__ == "__main__":
    main()
