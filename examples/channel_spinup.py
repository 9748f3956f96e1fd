"""Wind-driven spin-up of a re-entrant periodic channel (ACC-like).

Demonstrates the x-periodic channel config (reference meshes/channel.jl
geometry with gmsh setPeriodic replaced by dof-level identification).

Run:  python examples/channel_spinup.py [--gpu]
"""

import argparse
import os

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--h", type=float, default=0.06)
    ap.add_argument("--gpu", action="store_true")
    ap.add_argument("--out", default="out/channel")
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args()

    import jax

    if not args.gpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    import nupgcm as npg
    from nupgcm.io.vtk import save_vtk
    from nupgcm.postprocess import Grid3, overturning_streamfunction

    os.makedirs(args.out, exist_ok=True)

    mesh = npg.generators.channel3D(args.h)
    print(mesh.summary())
    params = npg.Parameters(
        eps=0.2, alpha=1.0, mu_rho=1.0, N2=1.0,
        f=lambda x: 1.0 + 0.5 * x[1], H=lambda x: 0.5,
    )
    forcings = npg.Forcings(
        nu=1.0, kappa_h=1e-2, kappa_v=1e-2,
        tau_x=lambda x: -0.05 * np.cos(2 * np.pi * x[1]), tau_y=0.0,
        b_surface_bc=npg.SurfaceDirichletBC(0.0),
    )
    spaces = npg.Spaces(
        mesh,
        u_diri_tags=["bottom", "coastline"],
        u_diri_vals=[(0, 0, 0)] * 2,
        u_diri_masks=[(True, True, True)] * 2,
        b_diri_tags=[], b_diri_vals=[],
    )
    fe = npg.FEData(mesh, spaces)
    ts = npg.BDF2(t_start=0, t_stop=args.steps * 1e-2, dt=1e-2)
    model = npg.PGModel(fe, params, forcings, ts)
    state = model.set_b(model.rest_state(), lambda x: 0.1 * x[2])
    state = model.run(state, n_info=10)

    save_vtk(model, state, f"{args.out}/channel_final.vtu")
    psi, v_int, b_bar, grid = overturning_streamfunction(
        model, state, Grid3.from_mesh(mesh, nx=32, ny=64, nz=32)
    )
    print("overturning psi range:", np.nanmin(psi), np.nanmax(psi))
    print(f"done -> {args.out}")


if __name__ == "__main__":
    main()
