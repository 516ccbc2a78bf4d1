"""Time ONE step phase per process at sizes where the all-phases-resident
phased runner (models/step.py make_phased_runner) exhausts HBM.

At 2048^2 with 75M markers the phased runner holds four phase executables
plus their workspaces at once; this script builds only the prerequisite
phases, materializes the target
phase's inputs, drops every earlier executable (del + jax.clear_caches()),
and then times just the target.  Usage:

    python scripts/profile_phase.py <interp|stokes|energy|advect> [nx] [reps]

Prints one JSON line {"phase": ..., "nx": ..., "seconds_median": ...}.
The sum over phases exceeds the fused-step time (each phase is separately
jitted + synced; XLA cannot fuse across the splits) — it attributes, it
does not add up to bench.py's number.
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))

import gc
import json
import sys
import time

import jax

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp

PHASES = ("interp", "stokes", "energy", "advect")


def main(target: str, nx: int = 2048, reps: int = 5):
    from pylamp_tpu.utils.cache import enable_persistent_cache
    from pylamp_tpu.utils.device import device_fields

    enable_persistent_cache()
    from pylamp_tpu.models.benchmarks import fk_stagnant_lid
    from pylamp_tpu.models.setup import build
    from pylamp_tpu.models.step import make_step, make_step_phases

    cfg = fk_stagnant_lid(nx)
    grid, table, state = build(cfg, jnp.float32)

    # one fused warm step so every phase sees production-shaped state
    step = jax.jit(make_step(grid, cfg, table))
    state, _ = step(state)
    jax.block_until_ready(state.vx)
    del step
    gc.collect()
    jax.clear_caches()

    ph = make_step_phases(grid, cfg, table)

    def drop(*exes):
        for e in exes:
            del e
        gc.collect()
        jax.clear_caches()

    # prerequisites, each dropped as soon as its outputs are materialized
    io = vx = vy = dt = None
    if target in ("interp", "stokes", "energy", "advect"):
        interp_j = jax.jit(ph.interp)
        io = jax.block_until_ready(interp_j(state))
        if target == "interp":
            fn, args = interp_j, (state,)
        else:
            drop(interp_j)
    if target in ("stokes", "energy", "advect"):
        stokes_j = jax.jit(ph.stokes)
        vx, vy, p, diag = stokes_j(state, io)
        jax.block_until_ready(vx)
        if target == "stokes":
            print(f"# stokes iters {float(diag['stokes_iterations']):.0f} "
                  f"converged {bool(diag['stokes_converged'])}",
                  file=sys.stderr)
            fn, args = stokes_j, (state, io)
        else:
            drop(stokes_j)
            ts_j = jax.jit(ph.timestep)
            dt = ts_j(vx, vy, io.k_m, io.rhocp_m)
            drop(ts_j)
    if target in ("energy", "advect"):
        energy_j = jax.jit(ph.energy)
        markers, T_new, _ = jax.block_until_ready(
            energy_j(state, io, vx, vy, dt))
        if target == "energy":
            fn, args = energy_j, (state, io, vx, vy, dt)
        else:
            drop(energy_j)
    if target == "advect":
        advect_j = jax.jit(ph.advect)
        out, _ = advect_j(markers, vx, vy, dt, T_new)
        jax.block_until_ready(out.x)
        fn, args = advect_j, (markers, vx, vy, dt, T_new)

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    print(json.dumps({
        "phase": target, "nx": nx,
        "seconds_median": round(times[len(times) // 2], 4),
        "seconds_min": round(times[0], 4),
        "device": device_fields(),
    }))


if __name__ == "__main__":
    tgt = sys.argv[1] if len(sys.argv) > 1 else ""
    if tgt not in PHASES:
        sys.exit(f"usage: profile_phase.py <{'|'.join(PHASES)}> [nx] [reps]")
    nx = int(sys.argv[2]) if len(sys.argv) > 2 else 2048
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 5
    main(tgt, nx, reps)
