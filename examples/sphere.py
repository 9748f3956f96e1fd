"""Rotating-ball circulation on the sphere mesh.

The reference generates a sphere geometry (reference
meshes/mesh_sphere.jl:1-17) but ships no script that runs it; this
example closes that gap end-to-end: a stratified, rotating solid ball
(f = z, the projection of the rotation axis) with a warm equatorial
buoyancy anomaly spun up to thermal-wind balance.

Run:  python examples/sphere.py [--n 6] [--gpu] [--steps 100]
"""

import argparse
import json
import os

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=6,
                    help="cells per cube half-axis (resolution ~ 1/n)")
    ap.add_argument("--eps", type=float, default=0.1, help="Ekman number")
    ap.add_argument("--gpu", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--block", type=int, default=10)
    ap.add_argument("--out", default="out/sphere")
    args = ap.parse_args()

    import jax

    if not args.gpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    import nupgcm as npg

    os.makedirs(args.out, exist_ok=True)
    mesh = npg.generators.sphere_mesh(args.n)
    print(mesh.summary())

    params = npg.Parameters(
        eps=args.eps, alpha=1.0, mu_rho=1.0, N2=1.0,
        f=lambda x: x[2], H=lambda x: 1.0,
    )
    forc = npg.Forcings(nu=1.0, kappa_h=1e-2, kappa_v=1e-2,
                        tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0))
    spaces = npg.Spaces(
        mesh,
        u_diri_tags=["boundary"], u_diri_vals=[(0, 0, 0)],
        u_diri_masks=[(True, True, True)],
        b_diri_tags=["surface"], b_diri_vals=[0.0],
    )
    fe = npg.FEData(mesh, spaces)
    print(fe.summary())
    ts = npg.BDF2(t_start=0, t_stop=1e9, dt=2e-3)
    model = npg.PGModel(fe, params, forc, ts)

    # warm equatorial band: drives an axisymmetric thermal-wind jet
    b0 = lambda x: 0.1 * np.exp(-(x[2] ** 2) / 0.1) * np.exp(
        -(1.0 - x[0] ** 2 - x[1] ** 2 - x[2] ** 2) / 0.5)
    state = model.set_b(model.rest_state(), b0)

    def save_cb(m, st, i):
        from nupgcm.io.checkpoint import save_state

        save_state(m, st, os.path.join(args.out, f"state_{i:08d}.npz"))

    state = model.run(state, n_info=max(1, args.steps // 10),
                      max_steps=args.steps, steps_per_block=args.block,
                      n_save=max(1, args.steps // 2), save_callback=save_cb)

    u = np.asarray(state.u)
    xy = np.asarray(fe.spaces.u_space.dof_coords)[:, :2]
    rho = np.linalg.norm(xy, axis=1)
    az = np.stack([-xy[:, 1], xy[:, 0]], axis=1) / np.maximum(
        rho, 1e-12)[:, None]
    u_az = (u[:, :2] * az).sum(axis=1)
    summary = {
        "n_dof": fe.n_inv,
        "steps": int(state.step),
        "u_max": float(np.abs(u).max()),
        "u_az_max": float(np.abs(u_az).max()),
        "b_range": [float(np.asarray(state.b).min()),
                    float(np.asarray(state.b).max())],
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
