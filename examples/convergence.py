"""Spatial convergence study of the evolution (diffusion) solver.

Capability parity with the reference's informal convergence checks
(reference scratch/convergence.jl, scratch/timestep_convergence.jl):
measure the error of the analytic decaying mode against mesh size and
time step, confirming the expected orders.

Run: python examples/convergence.py
"""

import numpy as np


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import nupgcm as npg

    params = npg.Parameters(eps=1.0, alpha=1.0, mu_rho=1.0, N2=0.0,
                            f=lambda x: 1.0 + 0 * x[0], H=lambda x: 1.0)
    forc = npg.Forcings(nu=1.0, kappa_h=0.0, kappa_v=1.0, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0))
    lam = np.pi ** 2

    print("# spatial convergence (BDF2, dt fixed small)")
    dt, nsteps = 1e-4, 20
    errs = []
    for nz in (4, 8, 16):
        mesh = npg.generators.rect_mesh(3, nz)
        spaces = npg.Spaces(mesh, u_diri_tags=["boundary"],
                            u_diri_masks=[(True, True, True)],
                            b_diri_tags=["top", "bottom"], b_diri_vals=[0.0, 0.0])
        fe = npg.FEData(mesh, spaces)
        ts = npg.BDF2(t_start=0, t_stop=nsteps * dt, dt=dt)
        # tight solver tolerances so discretization error dominates
        model = npg.PGModel(fe, params, forc, ts, evo_atol=1e-13, evo_rtol=1e-12,
                            inv_atol=1e-12, inv_rtol=1e-10)
        st = model.set_b(model.rest_state(), lambda x: np.sin(np.pi * x[2]))
        st = model.run(st, n_info=0)
        zc = spaces.b_space.dof_coords[:, 2]
        exact = np.exp(-lam * float(st.t)) * np.sin(np.pi * zc)
        err = np.abs(np.asarray(st.b) - exact).max()
        errs.append(err)
        print(f"  nz={nz:3d}  err={err:.3e}")
    orders = np.log2(np.array(errs[:-1]) / np.array(errs[1:]))
    print(f"  observed spatial orders: {orders}")

    print("# temporal convergence (fixed fine mesh)")
    mesh = npg.generators.rect_mesh(3, 24)
    spaces = npg.Spaces(mesh, u_diri_tags=["boundary"],
                        u_diri_masks=[(True, True, True)],
                        b_diri_tags=["top", "bottom"], b_diri_vals=[0.0, 0.0])
    fe = npg.FEData(mesh, spaces)
    t_end = 0.04

    def solve(TS, n):
        ts = TS(t_start=0, t_stop=t_end, dt=t_end / n)
        model = npg.PGModel(fe, params, forc, ts, evo_atol=1e-13, evo_rtol=1e-12,
                            inv_atol=1e-12, inv_rtol=1e-10)
        st = model.set_b(model.rest_state(), lambda x: np.sin(np.pi * x[2]))
        # exact step count: the while t < t_stop loop can overshoot by
        # one step under float accumulation, misaligning end times
        return np.asarray(model.run(st, n_info=0, max_steps=n).b)

    # same-mesh fine-dt reference isolates the temporal error
    b_ref = solve(npg.BDF2, 512)
    for TS in (npg.BDF1, npg.BDF2):
        errs = [np.abs(solve(TS, n) - b_ref).max() for n in (8, 16, 32)]
        orders = np.log2(np.array(errs[:-1]) / np.array(errs[1:]))
        print(f"  {TS.__name__}: errs={['%.2e' % e for e in errs]} orders={orders}")


if __name__ == "__main__":
    main()
