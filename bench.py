"""Benchmark suite: PG inversion + timestep throughput on one GPU.

Sections (any failure ends the run with a non-zero exit; diagnostics
on stderr):

  A. 16.5k-DoF inversion solve -- directly comparable to the
     reference's logged 5.97 s at 15,946 DoFs (its GPU-default 1/h^3
     diagonal preconditioner; reference scratch/inversion_log.md:143-157,
     BASELINE.md).  Headline metric.
  B. generated bowl3D h=0.08, nz=9 (the size of the reference's
     largest shipped mesh, reference
     meshes/bowl3D_8.000000e-02_5.000000e-01.msh): converged inversion
     seconds + end-to-end BDF2 steps/s.
  C. bowl3D h=0.033, nz=12 (866,397 inversion DoFs): saddle-operator
     matvec DOF/s and achieved bytes/s against the device's peak
     memory bandwidth (the matvec streams ~4.5 KB of element tensors
     per cell at ~2 flops/byte, so the bound is bandwidth), plus
     full-step steps/s and set-up times.
  D. f32 validation: 50-step bowl2D mixing in f32 (the model scopes
     matmul precision to float32 for its own traces --
     utils/precision.py) against the committed f64 golden
     (tests/data/bowl_mixing_2d.npz) in the FE-integral norm: the
     reference's 1e-3 bar on the device.
  E. DD mechanics on 8 virtual CPU devices (tools/bench_dd.py, a
     child process that never opens the GPU).

Prints ONE JSON line: headline {"metric", "value", "unit",
"vs_baseline"}, the device it ran on, and the section metrics as
extra keys.
"""

import gc
import json
import sys
import time

import numpy as np

BASELINE_SECONDS = 5.97  # reference inversion @ 15,946 DoF (BASELINE.md)
# the reference's STRONG preconditioner line at the same size: full
# sparse-LU BlockDiagonal, 121 iters / 31.2 s on CPU (reference
# scratch/inversion_log.md:132-157).  Reported alongside so the
# headline vs_baseline (like-for-like vs the GPU-default diagonal
# preconditioner's 5.97 s) is unambiguous.
BASELINE_SECONDS_BLOCKLU = 31.2
# Published peaks by jax device_kind.  Source: NVIDIA H100 SXM data
# sheet, dense rates without sparsity, at the 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "bf16_tflops": 989.0,
                              "tf32_tflops": 495.0, "f32_tflops": 67.0},
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def device_peaks(kind=None):
    """Peak rates of ``kind`` (default: the first JAX device's
    device_kind).  A device missing from PEAKS is an error."""
    import jax

    kind = jax.devices()[0].device_kind if kind is None else kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device_kind {kind!r}; "
                       f"add them to bench.PEAKS (known: {sorted(PEAKS)})")
    return PEAKS[kind]


def device_info():
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def saddle_matvec_bytes(model):
    """Bytes one saddle-operator application moves at least: the
    element tensors (read once), the gathered/scattered element
    vectors, the dof vector, and the index rows (f32 values)."""
    ops, N = model.ops, model.fe.n_inv
    nc, nlu3 = ops["A_uu_e"].shape[:2]
    nlp = ops["A_up_e"].shape[2]
    fbytes = np.dtype(np.float32).itemsize
    elem = nc * (nlu3 * nlu3 + 2 * nlu3 * nlp) * fbytes
    vec = nc * (2 * (nlu3 + nlp)) * fbytes + 3 * N * fbytes
    idx = nc * (nlu3 // 3 + nlp) * 2 * 4
    return {"elem": elem, "total": elem + vec + idx}


def fe_sq_norm(fe, v, cd, phi):
    """FE-integral squared L2 norm of a nodal field (host float64)."""
    wq = np.asarray(fe.geom.wq, np.float64)
    fq = np.einsum("qi,ci->cq", np.asarray(phi, np.float64),
                   np.asarray(v, np.float64)[np.asarray(cd)])
    return float(np.einsum("cq,cq->", wq, fq ** 2))


def state_rel_l2(fe, u, b, u_ref, b_ref):
    """FE-integral relative L2 errors (u, b) of a state against a
    reference on the same mesh and dof order: squared error norm over
    squared reference norm, as the repository's golden tests measure
    the reference's bar (reference test/bowl_mixing_tests.jl:101-103)."""
    u, u_ref = np.asarray(u), np.asarray(u_ref)
    pu, pb = fe.tab_u.phi, fe.tab_b.phi
    eu = (sum(fe_sq_norm(fe, u[:, c] - u_ref[:, c], fe.cd_u, pu)
              for c in range(3))
          / sum(fe_sq_norm(fe, u_ref[:, c], fe.cd_u, pu) for c in range(3)))
    eb = (fe_sq_norm(fe, np.asarray(b) - np.asarray(b_ref), fe.cd_b, pb)
          / fe_sq_norm(fe, b_ref, fe.cd_b, pb))
    return float(eu), float(eb)


def median_steps_per_s(run_block, n, reps=3):
    """Median steps/s over ``reps`` timed blocks of n steps each
    (first block assumed already compiled by the caller)."""
    import jax

    ts = []
    for _ in range(reps):
        t0 = time.time()
        jax.block_until_ready(run_block())
        ts.append(time.time() - t0)
    return n / float(np.median(ts))


def mixing_setup(mesh, dt_factor=1e-4, **model_kw):
    import nupgcm as npg

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
    spaces = npg.Spaces(
        mesh,
        u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True),
                      (False, False, True)],
        b_diri_tags=["coastline", "surface"], b_diri_vals=[0.0, 0.0],
    )
    fe = npg.FEData(mesh, spaces)
    dt = dt_factor * mu / (alpha * eps) ** 2
    # t_stop far out: benchmark runs are step-count-controlled
    ts = npg.BDF2(t_start=0, t_stop=1e6 * dt, dt=dt)
    model = npg.PGModel(fe, params, forc, ts, **model_kw)
    return model


def bench_16k():
    """Section A: the reference-comparable 16k-DoF inversion."""
    import jax

    import nupgcm as npg

    eps, alpha, mu = 0.5, 0.5, 1.0
    params = npg.Parameters(
        eps=eps, alpha=alpha, mu_rho=mu, N2=1 / alpha,
        f=lambda x: 1.0 + 0.5 * x[1],
        H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2),
    )
    kap = lambda x: 1e-2 + np.exp(
        -(x[2] + alpha * (1 - x[0] ** 2 - x[1] ** 2)) / (0.1 * alpha))
    forc = npg.Forcings(nu=1.0, kappa_h=kap, kappa_v=kap, tau_x=0.0,
                        tau_y=0.0, b_surface_bc=npg.SurfaceDirichletBC(0.0))
    mesh = npg.generators.bowl3D(0.14, alpha, nz=5)
    spaces = npg.Spaces(
        mesh,
        u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True),
                      (False, False, True)],
        b_diri_tags=["coastline", "surface"], b_diri_vals=[0.0, 0.0],
    )
    fe = npg.FEData(mesh, spaces)
    n_free = int(np.sum(~spaces.u_bc.mask)) + spaces.n_p
    log(f"[A] {fe.summary()}; free inversion dofs = {n_free}")
    dt = 1e-4 * mu / (alpha * eps) ** 2
    ts = npg.BDF2(t_start=0, t_stop=1.0, dt=dt)
    model = npg.PGModel(fe, params, forc, ts,
                        inv_atol=1e-6, inv_rtol=1e-6, inv_itmax=2000)
    bfun = lambda amp: (lambda x: amp * np.exp(
        -(x[2] + 0.5 * (1 - x[0] ** 2 - x[1] ** 2)) / 0.05))

    state = model.set_b(model.rest_state(), bfun(0.1))
    t0 = time.time()
    u, p, aux = model.invert_jit(model.ops, state)
    jax.block_until_ready(u)
    log(f"[A] invert compile+first run: {time.time() - t0:.2f}s")

    times = []
    for rep in range(4):
        st = model.set_b(model.rest_state(), bfun(0.1 * (1.0 + 0.01 * rep)))
        t0 = time.time()
        u, p, aux = model.invert_jit(model.ops, st)
        jax.block_until_ready(u)
        times.append(time.time() - t0)
        log(f"[A] rep {rep}: solve {times[-1]:.3f}s "
            f"iters={int(aux['inv_iters'])} res={float(aux['inv_res']):.3e}")
    t_solve = float(np.median(times[1:]))

    ops, st, auxs = model.multi_step_jit(model.ops, state, 10)
    jax.block_until_ready(st.b)
    t0 = time.time()
    ops, st, auxs = model.multi_step_jit(model.ops, st, 10)
    jax.block_until_ready(st.b)
    sps = 10 / (time.time() - t0)
    log(f"[A] steady {sps:.2f} steps/s")
    return {"inv_seconds_16k": t_solve, "steps_per_s_16k": round(sps, 2)}


def bench_bowl3d_h008():
    """Section B: bowl3D at the reference's largest shipped h."""
    import jax

    import nupgcm as npg

    mesh = npg.generators.bowl3D(0.08, 0.5, nz=9)
    src = "generated bowl3D h=0.08 nz=9"
    t0 = time.time()
    model = mixing_setup(mesh)
    log(f"[B] {src}: {model.fe.summary()}; build {time.time() - t0:.1f}s")
    state = model.set_b(model.rest_state(), lambda x: 0.1 * np.exp(
        -(x[2] + 0.5 * (1 - x[0] ** 2 - x[1] ** 2)) / 0.05))

    t0 = time.time()
    u, p, aux = model.invert_jit(model.ops, state)
    jax.block_until_ready(u)
    log(f"[B] invert compile+run: {time.time() - t0:.1f}s "
        f"iters={int(aux['inv_iters'])}")
    t0 = time.time()
    u, p, aux = model.invert_jit(model.ops, state)
    jax.block_until_ready(u)
    t_solve = time.time() - t0
    log(f"[B] inversion solve: {t_solve:.3f}s iters={int(aux['inv_iters'])} "
        f"res={float(aux['inv_res']):.3e}")

    t0 = time.time()
    ops, st, auxs = model.multi_step_jit(model.ops, state, 10)
    jax.block_until_ready(st.b)
    log(f"[B] 10-step compile+run: {time.time() - t0:.1f}s")
    holder = {"st": st}

    def block():
        _, holder["st"], _aux = model.multi_step_jit(model.ops,
                                                     holder["st"], 10)
        return holder["st"].b

    sps = median_steps_per_s(block, 10)
    log(f"[B] steady {sps:.2f} steps/s "
        f"(evo_it~{int(np.asarray(auxs['evo_iters']).mean())}, "
        f"inv_it~{int(np.asarray(auxs['inv_iters']).mean())})")
    n = model.fe.n_inv
    del model
    gc.collect()
    return {"n_dof_bowl3d_h008": n,
            "inv_seconds_bowl3d_h008": round(t_solve, 3),
            "steps_per_s_bowl3d_h008": round(sps, 3)}


def bench_1m_roofline():
    """Section C: ~1M-DoF matvec DOF/s + HBM bandwidth roofline."""
    import jax
    import jax.numpy as jnp

    import nupgcm as npg
    from nupgcm.ops.sparse import MaskedOperator

    t0 = time.time()
    mesh = npg.generators.bowl3D(0.033, 0.5, nz=12)
    t_mesh = time.time() - t0
    log(f"[C] mesh gen {t_mesh:.1f}s: {mesh.summary()}")
    t0 = time.time()
    model = mixing_setup(mesh)
    fe = model.fe
    N = fe.n_inv
    t_build = time.time() - t0
    log(f"[C] build {t_build:.1f}s: {fe.summary()}")

    free_inv = jax.device_put(jnp.asarray(model.const["free_inv"]))
    tabs = getattr(model, "tables_dev", None)

    # the operator and its index tables ride as jit ARGUMENTS (args
    # table mode): nothing large may be inlined into the HLO at this
    # scale
    @jax.jit
    def mv_loop(n, tables, ops, free, x):
        with model._swap_tables(tables):
            A = MaskedOperator(model._inv_matrix(ops), free)

        def body(i, x):
            y = A(x)
            return y / jnp.linalg.norm(y)

        return jax.lax.fori_loop(0, n, body, x)

    x0 = jnp.asarray(np.random.default_rng(0).standard_normal(N),
                     model.dtype)
    # differential (T(n2) - T(n1)) / (n2 - n1): dispatch constants cancel
    n1, n2 = 5, 25
    t0 = time.time()
    jax.block_until_ready(mv_loop(n1, tabs, model.ops, free_inv, x0))
    log(f"[C] matvec compile+first: {time.time() - t0:.1f}s")

    def t_of(n):
        ts = []
        for _ in range(3):
            t0 = time.time()
            jax.block_until_ready(mv_loop(n, tabs, model.ops, free_inv, x0))
            ts.append(time.time() - t0)
        return float(np.median(ts))

    t_app = (t_of(n2) - t_of(n1)) / (n2 - n1)
    dof_per_s = N / t_app
    nbytes = saddle_matvec_bytes(model)
    gbps = nbytes["total"] / t_app / 1e9
    peak = device_peaks()["hbm_gbps"]
    frac = gbps / peak
    log(f"[C] matvec {t_app * 1e3:.3f} ms; {dof_per_s / 1e6:.1f}M DOF/s, "
        f"{gbps:.0f} GB/s achieved = {100 * frac:.1f}% of {peak:.0f} GB/s "
        f"peak (bytes/app: elem {nbytes['elem'] / 1e6:.0f}MB)")

    # full-step throughput at this scale
    state = model.set_b(model.rest_state(), lambda x: 0.1 * np.exp(
        -(x[2] + 0.5 * (1 - x[0] ** 2 - x[1] ** 2)) / 0.05))
    t0 = time.time()
    ops, st, auxs = model.multi_step_jit(model.ops, state, 5)
    jax.block_until_ready(st.b)
    t_step_compile = time.time() - t0
    log(f"[C] 5-step compile+run: {t_step_compile:.1f}s")
    # time fresh cold-start trajectories (distinct ICs): iteration
    # counts stay at the working regime's level rather than collapsing
    # as the trajectory equilibrates -- the conservative throughput
    # number
    states = [model.set_b(model.rest_state(), lambda x, a=0.1 + 0.003 * k:
                          a * np.exp(-(x[2] + 0.5 * (1 - x[0] ** 2
                                                     - x[1] ** 2)) / 0.05))
              for k in range(3)]
    holder = {"i": 0, "aux": auxs}

    def block():
        stk = states[holder["i"] % 3]
        holder["i"] += 1
        _, st2, holder["aux"] = model.multi_step_jit(model.ops, stk, 5)
        return st2.b

    sps = median_steps_per_s(block, 5)
    auxs = holder["aux"]
    log(f"[C] cold-start {sps:.3f} steps/s at {N} DoF "
        f"(evo_it~{int(np.asarray(auxs['evo_iters']).mean())}, "
        f"inv_it~{int(np.asarray(auxs['inv_iters']).mean())})")

    res = {
        "n_dof_1m": N,
        "matvec_ms_1m": round(t_app * 1e3, 3),
        "matvec_dof_per_s_1m": round(dof_per_s, 0),
        "matvec_gbps_1m": round(gbps, 1),
        "matvec_roofline_frac": round(frac, 3),
        "steps_per_s_1m": round(sps, 3),
        # set-up latency; the compile entry hits the persistent
        # compilation cache on warm runs (nupgcm/__init__.py)
        "setup_mesh_s_1m": round(t_mesh, 1),
        "setup_build_s_1m": round(t_build, 1),
        "compile_5step_s_1m": round(t_step_compile, 1),
    }
    del model
    gc.collect()
    return res


def golden_rel_l2(model, state):
    """FE-integral rel-L2 (u, b) of a 50-step bowl2D mixing state
    against the committed f64 golden (tests/data/bowl_mixing_2d.npz,
    stored in mesh-canonical dof order)."""
    import pathlib

    golden = pathlib.Path(__file__).parent / "tests" / "data" / "bowl_mixing_2d.npz"
    fe = model.fe
    us, bs = fe.spaces.u_space, fe.spaces.b_space
    ref = np.load(golden)
    ref_b = bs.from_original_order(ref["b"])
    uref_can = ref["u"].reshape(-1, 3)
    ref_u = np.stack([us.from_original_order(uref_can[:, c])
                      for c in range(3)], axis=1)
    return state_rel_l2(fe, state.u, state.b, ref_u, ref_b)


def run_golden_2d():
    """50-step bowl2D mixing (the reference's test configuration) in
    the process's default dtype; returns (model, state)."""
    import nupgcm as npg

    model = mixing_setup(npg.generators.bowl2D(0.1, 0.5))
    state = model.run(model.rest_state(), n_info=0, max_steps=50,
                      steps_per_block=10)
    return model, state


def bench_golden():
    """Section D: 50-step bowl2D mixing f32 on the device vs the
    committed golden, FE-integral rel-L2 (the reference bar: 1e-3)."""
    model, state = run_golden_2d()
    eu, eb = golden_rel_l2(model, state)
    ok = eu < 1e-3 and eb < 1e-3
    log(f"[D] f32 50-step golden: rel-L2 u={eu:.3e} b={eb:.3e} "
        f"({'PASS' if ok else 'FAIL'} @ 1e-3, "
        f"matmul_precision={model.matmul_precision})")
    return {"f32_golden_rel_l2_u": eu, "f32_golden_rel_l2_b": eb,
            "f32_golden_pass": bool(ok)}


def bench_dd():
    """Section E: DD sharded-state mechanics on 8 virtual CPU devices
    (tools/bench_dd.py subprocess, CPU only -- it never opens the GPU,
    which this process holds): halo depth, iteration invariance vs
    shard count, per-matvec ppermute comm volume vs local element
    bytes.  Its wall-clock is CPU mechanics, not device throughput."""
    import os
    import subprocess

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tools", "bench_dd.py")
    p = subprocess.run([sys.executable, script], capture_output=True,
                       text=True, timeout=1800, env=env)
    if p.returncode != 0:
        raise RuntimeError(f"bench_dd failed (rc={p.returncode}): "
                           f"{p.stderr.strip().splitlines()[-3:]}")
    out = json.loads(p.stdout.strip().splitlines()[-1])
    log(f"[E] {json.dumps(out)}")
    flat = {}
    for k, v in out.items():
        if isinstance(v, dict):
            for k2, v2 in v.items():
                flat[f"{k}_{k2}"] = v2
        else:
            flat[k] = v
    return flat


def main():
    import jax

    dev = device_info()
    log(f"devices: {jax.devices()}")
    if dev["platform"] != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {dev['platform']!r}")
    device_peaks()  # fail now, not after an hour, on an unknown device
    extras = {}
    for name, fn in [("A", bench_16k), ("D", bench_golden),
                     ("B", bench_bowl3d_h008), ("C", bench_1m_roofline),
                     ("E", bench_dd)]:
        t0 = time.time()
        extras.update(fn())
        log(f"[{name}] section done in {time.time() - t0:.0f}s")
        gc.collect()
    t_solve = extras["inv_seconds_16k"]
    headline = {
        "metric": "inversion_solve_seconds_16k_dof",
        "value": round(t_solve, 4),
        "unit": "s",
        "vs_baseline": round(BASELINE_SECONDS / t_solve, 2),
        "vs_baseline_blockdiag_lu": round(BASELINE_SECONDS_BLOCKLU / t_solve, 2),
        "device": dev,
    }
    headline.update(extras)
    print(json.dumps(headline))


if __name__ == "__main__":
    main()
