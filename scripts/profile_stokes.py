"""Micro-profile of the Stokes phase at the bench configuration.

Times the building blocks of the mixed-precision Stokes solve separately
(f32 saddle apply, MG preconditioner application, f64 saddle apply +
norm, per-level lambda_max power iteration,
FGMRES orthogonalization cost) and runs one full instrumented
solve_stokes_mixed so optimization effort goes where the milliseconds are
(SURVEY.md §5 tracing row).

Usage: python scripts/profile_stokes.py [--nx 1024] [--bench-tuning]
"""
import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp


def timeit(f, *args, n=20):
    out = f(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = f(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=1024)
    ap.add_argument("--plain-tuning", action="store_true",
                    help="default SolverConfig instead of the bench tuning")
    args = ap.parse_args()

    from pylamp_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    from functools import partial

    from pylamp_tpu.models.benchmarks import fk_stagnant_lid
    from pylamp_tpu.models.config import SolverConfig
    from pylamp_tpu.models.setup import build
    from pylamp_tpu.models.step import make_step, make_step_phases
    from pylamp_tpu.ops.stokes import stokes_operator, stokes_rhs
    from pylamp_tpu.solvers.mg import make_mg_preconditioner, make_velocity_mg
    from pylamp_tpu.solvers.scaling import characteristic_viscosity, stokes_scales

    cfg = fk_stagnant_lid(nx=args.nx, ny=args.nx, max_steps=10**9)
    if args.plain_tuning:
        solver = SolverConfig(stokes_tol=1e-8, energy_tol=1e-10)
    else:  # bench.py round-3 tuning
        solver = SolverConfig(
            stokes_tol=1e-8, stokes_restart=12, stokes_maxiter=250,
            mg_cycles=2, mg_pre_smooth=4, mg_post_smooth=4, energy_tol=1e-10,
        )
    cfg = dataclasses.replace(cfg, solver=solver)
    grid, table, state = build(cfg, dtype=jnp.float32)
    step = jax.jit(make_step(grid, cfg, table))
    for _ in range(2):  # get realistic eta/rho fields
        state, diag = step(state)
    print(json.dumps({"iters_per_step": float(diag["stokes_iterations"])}))

    phases = make_step_phases(grid, cfg, table)
    io = jax.jit(phases.interp)(state)
    jax.block_until_ready(io.eta_n)

    f32, f64 = jnp.float32, jnp.float64
    eta_s64 = io.eta_s.astype(f64)
    eta_n64 = io.eta_n.astype(f64)
    eta_char = characteristic_viscosity(eta_n64)
    kcont, kbnd = stokes_scales(eta_char, grid)
    eta_s32, eta_n32 = eta_s64.astype(f32), eta_n64.astype(f32)
    kcont32, kbnd32 = kcont.astype(f32), kbnd.astype(f32)
    vbc = cfg.physics.velocity_bcs

    u32 = (state.vx.astype(f32), state.vy.astype(f32), state.p.astype(f32))
    u64 = tuple(l.astype(f64) for l in u32)

    @jax.jit
    def op32(u):
        vx, vy, p = u
        return stokes_operator(vx, vy, p, eta_s32, eta_n32, grid, vbc,
                               kcont=kcont32, kbnd=kbnd32)

    @jax.jit
    def op64(u):
        vx, vy, p = u
        return stokes_operator(vx, vy, p, eta_s64, eta_n64, grid, vbc,
                               kcont=kcont, kbnd=kbnd)

    from pylamp_tpu.solvers.krylov import tnorm, tsub

    b64 = stokes_rhs(io.rho_vx.astype(f64), io.rho_vy.astype(f64),
                     cfg.physics.gx, cfg.physics.gy, grid, vbc, kbnd=kbnd,
                     dtype=f64, eta_s=eta_s64)

    @jax.jit
    def resid64(u):
        return tnorm(tsub(b64, op64(u)))

    mk = partial(
        make_mg_preconditioner,
        levels=solver.mg_levels, cycles=solver.mg_cycles,
        pre_smooth=solver.mg_pre_smooth, post_smooth=solver.mg_post_smooth,
        schur=solver.schur,
    )
    M32 = mk(eta_s32, eta_n32, grid, kcont32, kbnd32, bcs=vbc)
    Mj = jax.jit(M32)

    # lambda_max estimation cost: time make_velocity_mg's per-level power
    # iterations alone (jitted as a function of the viscosities)
    from pylamp_tpu.solvers.mg import estimate_mg_lambdas

    @jax.jit
    def lam_cold(es, en):
        return estimate_mg_lambdas(
            es, en, grid, vbc, kbnd32, levels=solver.mg_levels,
            semicoarsen=solver.mg_semicoarsen,
        )

    @jax.jit
    def lam_warm(es, en, hint):
        return estimate_mg_lambdas(
            es, en, grid, vbc, kbnd32, levels=solver.mg_levels,
            semicoarsen=solver.mg_semicoarsen, hint=hint,
        )

    lam_cold_ms = round(timeit(lam_cold, eta_s32, eta_n32, n=10) * 1e3, 3)
    hint = lam_cold(eta_s32, eta_n32)
    lam_warm_ms = round(timeit(lam_warm, eta_s32, eta_n32, hint, n=10) * 1e3, 3)

    # FGMRES per-iteration overhead outside op+M: CGS projection against a
    # growing basis + vector updates.  Approximate with the mean basis
    # depth (restart/2) of axpy-like traffic.
    k = solver.stokes_restart // 2

    @jax.jit
    def ortho(u):
        vx, vy, p = u
        acc = jnp.zeros((), f32)
        ox, oy, op_ = jnp.zeros_like(vx), jnp.zeros_like(vy), jnp.zeros_like(p)
        for i in range(k):
            c = 1.0 + 1e-6 * i
            acc = acc + jnp.vdot(vx, vx * c) + jnp.vdot(vy, vy) + jnp.vdot(p, p)
            ox = ox + c * vx
            oy = oy + c * vy
            op_ = op_ + c * p
        return acc, ox, oy, op_

    # one full mixed solve (the production call) with refinement count
    from pylamp_tpu.solvers.stokes_solver import solve_stokes_mixed

    @jax.jit
    def full_solve(es, en, rvx, rvy, x0):
        return solve_stokes_mixed(
            es, en, rvx, rvy, cfg.physics.gx, cfg.physics.gy, grid, vbc,
            tol=solver.stokes_tol, inner_tol=solver.inner_tol,
            restart=solver.stokes_restart, maxiter=solver.stokes_maxiter,
            max_refinements=solver.max_refinements, x0=x0,
            make_preconditioner=mk,
        )

    x0 = (state.vx, state.vy, state.p)
    sol = full_solve(io.eta_s, io.eta_n, io.rho_vx, io.rho_vy, x0)
    jax.block_until_ready(sol.vx)
    t0 = time.perf_counter()
    for _ in range(5):
        sol = full_solve(io.eta_s, io.eta_n, io.rho_vx, io.rho_vy, x0)
        jax.block_until_ready(sol.vx)
    solve_ms = (time.perf_counter() - t0) / 5 * 1e3

    res = {
        "nx": args.nx,
        "iters": float(sol.info.iterations),
        "solve_ms": round(solve_ms, 2),
        "op32_ms": round(timeit(op32, u32) * 1e3, 3),
        "mg_precond_ms": round(timeit(Mj, u32) * 1e3, 3),
        "op64_ms": round(timeit(op64, u64, n=5) * 1e3, 3),
        "resid64_norm_ms": round(timeit(resid64, u64, n=5) * 1e3, 3),
        f"ortho_k{k}_ms": round(timeit(ortho, u32) * 1e3, 3),
        "lam_cold_ms": lam_cold_ms,
        "lam_warm_ms": lam_warm_ms,
    }
    print(json.dumps(res))


if __name__ == "__main__":
    main()
