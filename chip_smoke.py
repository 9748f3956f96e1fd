"""On-card smoke check of the PG model on NVIDIA GPUs.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py          # one card: phases 1-4
    python chip_smoke.py --four   # four cards: the domain-decomposition
                                  # phase and what it is compared with

One card, in order; a failure in any phase raises and exits non-zero:

  1. Device check: JAX's platform, device_kind and device count, and
     nvidia-smi's name and power limit.  Anything but a GPU is an error.
  2. Golden: 50-step bowl2D mixing in f32 against the committed f64
     golden (tests/data/bowl_mixing_2d.npz), FE-integral rel-L2 < 1e-3
     for u and b (the reference's bar).
  3. Operator parity at the flagship size: the saddle, evolution and
     P1-P1 coarse-saddle operators against NumPy float64 references
     built from the same element tensors and dof tables, under the
     model's matmul precision (asserted) and JAX's default (printed);
     the saddle operators both through the fused kernel
     (ops/fused.py) and XLA's take path; then the saddle matvec's time
     and achieved bandwidth on each path.
  4. Flagship run: bowl3D h=0.033 nz=12 (866,397 inversion DoFs, bench.py
     section C) in f32 through PGModel, invert and multi_step_jit: host
     build, compile, steps/s, iterations, memory; steps/s again with
     the take path in place of the fused kernel; one step of
     __graft_entry__.entry().

--four: (a) f64 DDModel(model, 4) against the single-card PGModel on
bowl3D h=0.08 nz=9, 5 steps, tight tolerances; (b) f32 at the flagship
size, 5 steps, default tolerances; the shards' placement on 4 devices.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

import argparse
import gc
import json
import subprocess
import sys
import time
from functools import partial

import numpy as np

import bench
import nupgcm as npg

FLAGSHIP = dict(h=0.033, nz=12)  # bench.py section C: 866,397 inversion DoFs
N_STEPS = 5


def b_ic(x):
    """Bottom-intensified buoyancy IC of bench.py sections B and C."""
    return 0.1 * np.exp(-(x[2] + 0.5 * (1 - x[0] ** 2 - x[1] ** 2)) / 0.05)


def log(msg):
    print(msg, flush=True)


def result_line(devices) -> str:
    """The last line: the contract's keys and nothing more."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


# ----------------------------------------------------------------------
# 1. device check
# ----------------------------------------------------------------------
def phase_device(n_cards: int) -> str:
    import jax

    devs = jax.devices()
    d = devs[0]
    log(f"[1] jax: platform={d.platform} device_kind={d.device_kind!r} "
        f"count={len(devs)} jax={jax.__version__}")
    if d.platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (platform "
                         f"{d.platform!r})")
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} GPUs, JAX found "
                         f"{len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    log("[1] nvidia-smi name, power.limit:")
    for line in smi.strip().splitlines():
        log(line)
    log(f"[1] published peaks: {bench.device_peaks(d.device_kind)}")
    return smi.strip().splitlines()[0]


# ----------------------------------------------------------------------
# 2. golden
# ----------------------------------------------------------------------
def phase_golden():
    import jax.numpy as jnp

    t0 = time.time()
    model, state = bench.run_golden_2d()
    assert model.dtype == jnp.float32, model.dtype
    eu, eb = bench.golden_rel_l2(model, state)
    log(f"[2] golden bowl2D 50 BDF2 steps f32 ({model.fe.n_inv} DoF, "
        f"matmul_precision={model.matmul_precision}): rel-L2 u={eu:.3e} "
        f"b={eb:.3e} (bar 1e-3), {time.time() - t0:.1f}s")
    # the reference's acceptance bar (test/bowl_mixing_tests.jl:101-103)
    assert eu < 1e-3 and eb < 1e-3, (eu, eb)


# ----------------------------------------------------------------------
# flagship build (shared by phases 3 and 4)
# ----------------------------------------------------------------------
def build_flagship(h=FLAGSHIP["h"], nz=FLAGSHIP["nz"], **model_kw):
    t0 = time.time()
    mesh = npg.generators.bowl3D(h, 0.5, nz=nz)
    t_mesh = time.time() - t0
    t0 = time.time()
    model = bench.mixing_setup(mesh, **model_kw)
    t_build = time.time() - t0
    log(f"[build] bowl3D h={h} nz={nz}: {model.fe.summary()}; dtype="
        f"{np.dtype(model.dtype).name} table_mode={model.table_mode}; "
        f"host build: mesh {t_mesh:.1f}s + model {t_build:.1f}s = "
        f"{t_mesh + t_build:.1f}s")
    return model


# ----------------------------------------------------------------------
# 3. operator parity at real size
# ----------------------------------------------------------------------
def phase_parity(model):
    import jax
    import jax.numpy as jnp

    from nupgcm.ops.element import (element_matvec_reference,
                                    saddle_matvec_reference)
    from nupgcm.ops.fused import use_fused
    from nupgcm.utils.precision import precision_ctx

    fe, ops = model.fe, model.ops
    tabs = getattr(model, "tables_dev", None)
    n_u, n_p = fe.spaces.u_space.ndof, fe.spaces.p_space.ndof
    theta = float(model.ts.dt * model.params.a2e2 / model.params.mu_rho)
    rng = np.random.default_rng(0)
    h = lambda a: np.asarray(a, np.float64)

    def operator(name, ops_):
        if name == "saddle":
            return model._inv_matrix(ops_)
        if name == "evolution":
            return model._evo_matrix(ops_, theta)
        return model._saddle_coarse_operator(ops_)

    def on_device(name, precision, x, take=False):
        # index tables ride as jit arguments (args table mode), as in
        # the model's own step
        @jax.jit
        def apply(tables, ops_, x):
            with precision_ctx(precision), model._swap_tables(tables):
                op = operator(name, ops_)
                return (op.take_matvec if take else op.matvec)(x)

        return np.asarray(apply(tabs, ops, jnp.asarray(x, model.dtype)))

    assert "sc_pp" in ops, "flagship must take the element-local coarse path"
    cases = {
        "saddle": (fe.n_inv, lambda x: saddle_matvec_reference(
            fe.cd_u, fe.cd_p, n_u, n_p, x, uu=h(ops["A_uu_e"]),
            up=h(ops["A_up_e"]), pu=h(ops["A_pu_e"]))),
        "evolution": (fe.spaces.n_b, lambda x: element_matvec_reference(
            h(ops["M_e"]) + theta * (h(ops["Kh_e"]) + h(ops["Kv_e"])),
            fe.cd_b, fe.cd_b, fe.spaces.n_b, x)),
        "coarse_saddle_pp": (4 * n_p, lambda x: saddle_matvec_reference(
            fe.cd_p, fe.cd_p, n_p, n_p, x, uu=h(ops["sc_uu"]),
            up=h(ops["sc_up"]), pu=h(ops["sc_pu"]), pp=h(ops["sc_pp"]))),
    }
    log(f"[3] SaddleOperator.matvec path: "
        f"{'fused kernel' if use_fused(jax.default_backend(), model.dtype) else 'take'}")
    for name, (n, ref_fn) in cases.items():
        x = rng.standard_normal(n).astype(model.dtype)
        t0 = time.time()
        ref = ref_fn(x)
        t_ref = time.time() - t0
        paths = ["matvec"] + (["take_matvec"] if name != "evolution" else [])
        for path in paths:
            take = path == "take_matvec"
            err = rel_l2(on_device(name, model.matmul_precision, x, take), ref)
            err_default = rel_l2(on_device(name, None, x, take), ref)
            log(f"[3] {name} {path} ({n} rows) vs NumPy f64: rel-L2 "
                f"{err:.3e} at matmul_precision={model.matmul_precision}, "
                f"{err_default:.3e} at JAX's default precision "
                f"(reference {t_ref:.1f}s)")
            # f32 tensors and vectors, f32 products summed per element
            # and then by atomic scatter-adds in a run-dependent order:
            # the error is a few f32 roundoffs (~1e-7); 1e-5 leaves
            # margin for the summation order while a TF32 product
            # (~5e-4 relative) would fail it
            assert err <= 1e-5, (name, path, err)

    # saddle matvec time: n applications inside one jitted fori_loop
    free = jnp.asarray(model.const["free_inv"])

    @partial(jax.jit, static_argnames="take")
    def loop(n, tables, ops_, free, x, take):
        with precision_ctx(model.matmul_precision), model._swap_tables(tables):
            op = model._inv_matrix(ops_)
            mv = op.take_matvec if take else op.matvec

            def body(i, x):
                y = jnp.where(free.astype(bool), mv(x * free), x)
                return y / jnp.linalg.norm(y)

            return jax.lax.fori_loop(0, n, body, x)

    x0 = jnp.asarray(rng.standard_normal(fe.n_inv), model.dtype)
    nbytes = bench.saddle_matvec_bytes(model)
    peak = bench.device_peaks()["hbm_gbps"]
    for take in (False, True):
        jax.block_until_ready(loop(2, tabs, ops, free, x0, take))

        def t_of(n):
            t0 = time.perf_counter()
            jax.block_until_ready(loop(n, tabs, ops, free, x0, take))
            return time.perf_counter() - t0

        n1, n2 = 10, 60
        t_app = min((t_of(n2) - t_of(n1)) / (n2 - n1) for _ in range(3))
        gbps = nbytes["total"] / t_app / 1e9
        log(f"[3] saddle {'take_matvec' if take else 'matvec'} "
            f"({fe.n_inv} DoF): {t_app * 1e3:.4f} ms/application; "
            f"{nbytes['total'] / 1e6:.1f} MB moved ({nbytes['elem'] / 1e6:.1f} "
            f"MB element tensors) -> {gbps:.1f} GB/s = "
            f"{100 * gbps / peak:.2f}% of {peak:.0f} GB/s")


# ----------------------------------------------------------------------
# 4. flagship run
# ----------------------------------------------------------------------
def cold_blocks(model):
    """Three N_STEPS blocks from fresh cold ICs of distinct amplitude,
    as in bench.py section C: a warm-started trajectory of this slow
    problem settles within a few steps and its Krylov solves then take
    0 iterations, which would time an empty step."""
    import jax

    times, evo, inv = [], [], []
    for amp in (1.03, 1.06, 1.09):
        s0 = model.set_b(model.rest_state(), lambda x, a=amp: a * b_ic(x))
        t0 = time.perf_counter()
        _, st, aux = model.multi_step_jit(model.ops, s0, N_STEPS)
        jax.block_until_ready(st.b)
        times.append(time.perf_counter() - t0)
        evo += np.asarray(aux["evo_iters"]).tolist()
        inv += np.asarray(aux["inv_iters"]).tolist()
    return times, evo, inv, st, aux


def phase_flagship(model):
    import jax

    fe = model.fe
    state0 = model.set_b(model.rest_state(), b_ic)
    t0 = time.time()
    st = model.invert(state0)
    jax.block_until_ready(st.u)
    log(f"[4] invert (compile + solve): {time.time() - t0:.1f}s")

    t0 = time.time()
    compiled = model.multi_step_jit.lower(model.ops, st, N_STEPS).compile()
    t_compile = time.time() - t0
    ma = compiled.memory_analysis()
    mem = {k: getattr(ma, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "alias_size_in_bytes", "temp_size_in_bytes",
        "generated_code_size_in_bytes") if hasattr(ma, k)}
    log(f"[4] {N_STEPS}-step multi_step compile: {t_compile:.1f}s; "
        f"memory_analysis: {mem}")

    times, evo, inv, st2, aux = cold_blocks(model)
    res = float(np.asarray(aux["inv_res"])[-1])
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    log(f"[4] {N_STEPS}-step blocks from cold ICs: {times} s -> median "
        f"{N_STEPS / float(np.median(times))} steps/s at {fe.n_inv} DoF")
    log(f"[4] iterations per step: evo {evo} (mean {np.mean(evo)}), inv "
        f"{inv} (mean {np.mean(inv)}); last inv residual {res:.3e}")
    log(f"[4] device peak_bytes_in_use over the process: {peak} "
        f"({peak / 2**30:.3f} GiB)")
    u, b = np.asarray(st2.u), np.asarray(st2.b)
    assert u.shape == (fe.spaces.u_space.ndof, 3) and b.shape == (fe.spaces.n_b,)
    assert np.isfinite(u).all() and np.isfinite(b).all()
    assert int(st2.step) == N_STEPS
    log(f"[4] final state finite: |u|max={np.abs(u).max():.4e} "
        f"|b|max={np.abs(b).max():.4e}")

    # the same blocks with XLA's take path in place of the fused kernel
    from nupgcm.ops.element import SaddleOperator

    fused_mv = SaddleOperator.matvec
    SaddleOperator.matvec = SaddleOperator.take_matvec
    try:
        model.retune()
        t0 = time.time()
        jax.block_until_ready(model.multi_step_jit(model.ops, st, N_STEPS)[1].b)
        log(f"[4] take-path step compile + first block: {time.time() - t0:.1f}s")
        t_take, _, inv_take, st_take, _ = cold_blocks(model)
    finally:
        SaddleOperator.matvec = fused_mv
        model.retune()
    eu, eb = bench.state_rel_l2(fe, st2.u, st2.b, st_take.u, st_take.b)
    sps, sps_take = (N_STEPS / float(np.median(t)) for t in (times, t_take))
    log(f"[4] take path instead of SaddleOperator.matvec's kernel: blocks "
        f"{t_take} s -> {sps_take} steps/s; this run's path {sps} steps/s "
        f"= {sps / sps_take:.3f}x; inv iterations {inv_take}; final state "
        f"FE rel-L2 between the paths u={eu:.3e} b={eb:.3e}")
    # the two paths differ only in the order of the scatter sums
    assert eu < 1e-6 and eb < 1e-6, (eu, eb)

    import __graft_entry__

    fn, args = __graft_entry__.entry()
    _, st_g, aux_g = jax.jit(fn)(*args)
    jax.block_until_ready(st_g.b)
    assert np.isfinite(np.asarray(st_g.u)).all()
    assert np.isfinite(np.asarray(st_g.b)).all()
    log(f"[4] __graft_entry__.entry() step: evo_it={int(aux_g['evo_iters'])} "
        f"inv_it={int(aux_g['inv_iters'])} |u|max={float(aux_g['u_max']):.3e}")


# ----------------------------------------------------------------------
# --four: domain decomposition on 4 cards
# ----------------------------------------------------------------------
def check_placement(dd, sv):
    import jax

    devs = {sh.device for sh in sv["u"].addressable_shards}
    used = {d.id: d.memory_stats()["bytes_in_use"] for d in jax.devices()[:4]}
    log(f"[dd] state shards on devices {sorted(d.id for d in devs)}; "
        f"bytes_in_use per device {used}")
    assert len(devs) == 4 and dd.mesh.devices.size == 4
    assert all(v > 0 for v in used.values()), used


def phase_dd_f64(h=0.08, nz=9):
    import jax.numpy as jnp

    from nupgcm.parallel.dd import DDModel

    t0 = time.time()
    kw = dict(inv_atol=1e-10, inv_rtol=1e-10, evo_atol=1e-12,
              evo_rtol=1e-12, inv_itmax=400)
    model = bench.mixing_setup(npg.generators.bowl3D(h, 0.5, nz=nz),
                               dtype=jnp.float64, **kw)
    st0 = model.set_b(model.rest_state(), b_ic)
    s1 = model.run(st0, n_info=0, max_steps=N_STEPS)
    dd = DDModel(model, 4)
    sv = dd.to_dd(st0)
    check_placement(dd, sv)
    s2 = dd.run(sv, n_info=0, max_steps=N_STEPS)
    du = float(np.abs(np.asarray(s1.u) - np.asarray(s2.u)).max())
    db = float(np.abs(np.asarray(s1.b) - np.asarray(s2.b)).max())
    log(f"[dd-a] f64 {model.fe.n_inv} DoF, {N_STEPS} steps, 4 shards (halo "
        f"K={dd.part_u.K},{dd.part_p.K},{dd.part_b.K}) vs one card: max abs "
        f"diff u={du:.3e} b={db:.3e} (bar 1e-9), {time.time() - t0:.1f}s")
    # solver tolerances 1e-10: only the psum order of the Krylov
    # reductions differs between the two runs
    assert du <= 1e-9 and db <= 1e-9, (du, db)


def phase_dd_f32(**flagship):
    import jax
    import jax.numpy as jnp

    from nupgcm.parallel.dd import DDModel

    model = build_flagship(dtype=jnp.float32, **flagship)
    st0 = model.set_b(model.rest_state(), b_ic)
    t0 = time.time()
    _, s1, aux1 = model.multi_step_jit(model.ops, st0, N_STEPS)
    jax.block_until_ready(s1.b)
    t_single = time.time() - t0
    t0 = time.time()
    dd = DDModel(model, 4)
    t_dd_build = time.time() - t0
    sv = dd.to_dd(st0)
    check_placement(dd, sv)
    t0 = time.time()
    sv, aux2 = dd.multi_step(sv, N_STEPS)
    jax.block_until_ready(sv["b"])
    t_dd = time.time() - t0
    s2 = dd.from_dd(sv)
    it1 = {k: np.asarray(aux1[k]) for k in ("evo_iters", "inv_iters")}
    it2 = {k: np.asarray(aux2[k]) for k in ("evo_iters", "inv_iters")}
    eu, eb = bench.state_rel_l2(model.fe, s2.u, s2.b, s1.u, s1.b)
    log(f"[dd-b] f32 {model.fe.n_inv} DoF, {N_STEPS} steps (compile "
        f"included): one card {t_single:.1f}s, 4 shards {t_dd:.1f}s "
        f"(DD host build {t_dd_build:.1f}s, halo K={dd.part_u.K},"
        f"{dd.part_p.K},{dd.part_b.K})")
    log(f"[dd-b] iterations one card evo {it1['evo_iters'].tolist()} inv "
        f"{it1['inv_iters'].tolist()}; 4 shards evo "
        f"{it2['evo_iters'].tolist()} inv {it2['inv_iters'].tolist()}; "
        f"FE rel-L2 vs one card u={eu:.3e} b={eb:.3e} (bar 1e-3)")
    for k in it1:
        assert np.abs(it1[k] - it2[k]).max() <= 1, (k, it1[k], it2[k])
    assert eu <= 1e-3 and eb <= 1e-3, (eu, eb)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="On-card smoke check (see the module docstring).")
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card domain-decomposition phase")
    args = ap.parse_args(argv)
    import jax

    if args.four:
        # phase (a) runs in f64; (b) passes dtype=float32 explicitly
        jax.config.update("jax_enable_x64", True)
    t_start = time.time()
    card = phase_device(4 if args.four else 1)
    if args.four:
        phase_dd_f64()
        gc.collect()
        phase_dd_f32()
    else:
        phase_golden()
        model = build_flagship()
        phase_parity(model)
        phase_flagship(model)
    log(f"[done] all phases passed in {time.time() - t_start:.0f}s on {card}")
    print(result_line(jax.devices()), flush=True)


if __name__ == "__main__":
    sys.exit(main())
