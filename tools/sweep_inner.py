"""Sweep the saddle-coarse inner budget / smoother depths at section-C
scale (0.87M dof) and report steps/s -- the ROADMAP item-6 tuning
harness.  Run on the GPU::

    python tools/sweep_inner.py [--h 0.033] [--nz 12]

Mesh + FEData + PGModel (operators) are built ONCE; each config is a
``model.retune(...)`` (budgets enter only the jitted closures, not the
assembled operators) and times a 5-step multi-step block twice
(compile, then steady).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--h", type=float, default=0.033)
    ap.add_argument("--nz", type=int, default=12)
    ap.add_argument("--eps", type=float, default=2e-1,
                    help="Ekman number; <=0.05 lands in the rotation-"
                         "dominated inner-GMRES regime (VERDICT r4 "
                         "item 5 sweeps k there)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="out/sweep_inner.json")
    args = ap.parse_args()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    import jax

    import nupgcm as npg

    log = lambda *a: print(*a, file=sys.stderr, flush=True)
    eps, alpha, mu = args.eps, 0.5, 1e1
    params = npg.Parameters(
        eps=eps, alpha=alpha, mu_rho=mu, N2=1 / alpha,
        f=lambda x: 1.0 + 0.5 * x[1],
        H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2),
    )
    kap = lambda x: 1e-2 + np.exp(
        -(x[2] + alpha * (1 - x[0] ** 2 - x[1] ** 2)) / (0.1 * alpha))
    forc = npg.Forcings(nu=1.0, kappa_h=kap, kappa_v=kap, tau_x=0.0,
                        tau_y=0.0, b_surface_bc=npg.SurfaceDirichletBC(0.0))
    t0 = time.time()
    mesh = npg.generators.bowl3D(args.h, alpha, nz=args.nz)
    spaces = npg.Spaces(
        mesh,
        u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True),
                      (False, False, True)],
        b_diri_tags=["coastline", "surface"], b_diri_vals=[0.0, 0.0],
    )
    fe = npg.FEData(mesh, spaces)
    log(f"mesh+fe {time.time() - t0:.0f}s: {fe.summary()}")
    dt = 1e-4 * mu / (alpha * eps) ** 2
    ts = npg.BDF2(t_start=0, t_stop=1e6 * dt, dt=dt)

    configs = [
        {},                                     # model-chosen defaults
        {"saddle_coarse_inner": 16},
        {"saddle_coarse_inner": 8},
        {"saddle_coarse_inner": 4},
        {"saddle_coarse_inner": 2},
        {"saddle_coarse_inner": 0},
    ]
    t0 = time.time()
    model = npg.PGModel(fe, params, forc, ts)
    build_s = time.time() - t0
    log(f"model build {build_s:.0f}s")
    state = model.set_b(model.rest_state(), lambda x: 0.1 * np.exp(
        -(x[2] + 0.5 * (1 - x[0] ** 2 - x[1] ** 2)) / 0.05))
    base_iu = model.inner_iters[0]
    results = []
    for cfg in configs:
        model.retune(
            saddle_coarse_inner=cfg.get("saddle_coarse_inner"),
            inner_iters_u=cfg.get("inner_iters_u", base_iu),
        )
        row = dict(cfg)
        t0 = time.time()
        ops, st, auxs = model.multi_step_jit(model.ops, state, args.steps)
        jax.block_until_ready(st.b)
        compile_s = time.time() - t0
        t0 = time.time()
        ops, st, auxs = model.multi_step_jit(ops, st, args.steps)
        jax.block_until_ready(st.b)
        sps = args.steps / (time.time() - t0)
        row.update({
            "steps_per_s": round(sps, 4),
            "evo_it": float(np.asarray(auxs["evo_iters"]).mean()),
            "inv_it": float(np.asarray(auxs["inv_iters"]).mean()),
            "inv_res": float(np.asarray(auxs["inv_res"])[-1]),
            "b_max": float(np.asarray(auxs["b_max"])[-1]),
            "compile_s": round(compile_s, 1),
        })
        del ops, st, auxs
        results.append(row)
        log(json.dumps(row))
        gc.collect()
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
