"""Break the production timestep into its cost components.

Times each part as a difference quotient of jitted loops of N1 and N2
repetitions, each ended with block_until_ready:

  invert     full saddle FGMRES solve (solve + preconditioner)
  evolve     buoyancy step (advection assembly + CG)
  adv        the advection-rhs element assembly alone (the per-step
             XLA gather/scatter pass ROADMAP item 3 proposes fusing)
  step       the complete fused timestep

Usage: python tools/profile_step.py [h] [nz]
"""

import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

N1, N2 = 3, 13


def timed(fn, *args, label=""):
    t0 = time.time()
    jax.block_until_ready(fn(N1, *args))
    compile_s = time.time() - t0

    def t_of(n):
        ts = []
        for _ in range(3):
            t0 = time.time()
            jax.block_until_ready(fn(n, *args))
            ts.append(time.time() - t0)
        return float(np.median(ts))

    run_s = (t_of(N2) - t_of(N1)) / (N2 - N1)
    print(f"  {label:10s} {run_s * 1e3:9.2f} ms  (compile {compile_s:.1f}s)",
          flush=True)
    return run_s


def main():
    h = float(sys.argv[1]) if len(sys.argv) > 1 else 0.033
    nz = int(sys.argv[2]) if len(sys.argv) > 2 else 12

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench
    from nupgcm.utils.precision import scoped_precision

    t0 = time.time()
    import nupgcm as npg

    mesh = npg.generators.bowl3D(h, 0.5, nz=nz)
    model = bench.mixing_setup(mesh)
    print(f"build {time.time() - t0:.1f}s: {model.fe.summary()}", flush=True)

    state = model.set_b(model.rest_state(), lambda x: 0.1 * np.exp(
        -(x[2] + 0.5 * (1 - x[0] ** 2 - x[1] ** 2)) / 0.05))
    # two steps so u/b_prev are physical
    ops, state, aux = model.multi_step_jit(model.ops, state, 2)
    print(f"warmed: evo_it={int(np.asarray(aux['evo_iters'])[-1])} "
          f"inv_it={int(np.asarray(aux['inv_iters'])[-1])}", flush=True)
    prec = model.matmul_precision
    tabs = getattr(model, "tables_dev", None)

    import dataclasses

    def jitloop(body):
        # tables/ops ride as jit ARGUMENTS (args-table discipline):
        # closing over device arrays would inline them as constants
        # and overflow the remote compile service's payload limit
        def fn(n, tables, ops, st):
            def step(i, st):
                with model._swap_tables(tables):
                    return body(ops, st)
            return jax.lax.fori_loop(0, n, step, st)

        jitted = jax.jit(scoped_precision(fn, prec))
        return lambda n, ops, st: jitted(n, tabs, ops, st)

    # full fused step (the production dispatch)
    def body_step(ops, st):
        _, st2, _ = model.step_fn(ops, st)
        return st2

    def chain(st, val):
        return dataclasses.replace(st, b=st.b + 0.0 * val.reshape(-1)[0])

    def body_invert(ops, st):
        x0 = jnp.concatenate([st.u.reshape(-1), st.p])
        u, p, stats = model._invert_pure(ops, st.b, x0)
        return chain(st, u)

    def body_evolve(ops, st):
        b_new, stats = model._evolve_pure(ops, st)
        return chain(st, b_new)

    def body_adv(ops, st):
        # model.const reads INSIDE the swap context pick up the traced
        # tables (args mode)
        c = model.const
        fe, pr = model.fe, model.params
        mt = model.dtype
        Gb3 = model._grads_b()
        u_e = st.u[c["cd_u"]]
        b_e = st.b[c["cd_b"]]
        u_q = jnp.einsum("qi,cia->cqa", c["phi_u"], u_e)
        gb_q = jnp.einsum("cqid,ci->cqd", Gb3, b_e)
        adv = (jnp.einsum("cqa,cqa->cq", u_q, gb_q)
               + u_q[..., 2] * jnp.asarray(pr.N2, mt))
        b_q = jnp.einsum("qi,ci->cq", c["phi_b"], b_e)
        integ = b_q - st.dt * adv
        rhs_adv = fe.vec_plan_b.assemble(
            jnp.einsum("cq,qi,cq->ci", c["wq"], c["phi_b"], integ))
        return chain(st, rhs_adv)

    results = {}
    for name, body in (("step", body_step), ("invert", body_invert),
                       ("evolve", body_evolve), ("adv", body_adv)):
        results[name] = timed(jitloop(body), ops, state, label=name)

    print("\ncomposition: step = invert + evolve + dt/eddy overhead;"
          "\n  evolve = adv + CG;  shares:", flush=True)
    for k, v in results.items():
        print(f"  {k:8s} {v * 1e3:8.2f} ms "
              f"({100 * v / results['step']:.0f}% of step)")


if __name__ == "__main__":
    main()
