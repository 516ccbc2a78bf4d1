"""Sticky-air solver A/B probe at spec 1024x256 on a warmed state.

Builds 3 steps of the production preset, extracts the interpolated fields,
then times solve_stokes_mixed under variant solver settings (interleaved
repeats to counter chip time-sharing)."""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), "..", ".."))

import sys
import time
from functools import partial

import jax

jax.config.update("jax_enable_x64", True)
from pylamp_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

import jax.numpy as jnp
import numpy as np

from pylamp_tpu.markers.bucket import bucket_markers_to_grid
from pylamp_tpu.models.benchmarks import sticky_air
from pylamp_tpu.models.setup import build
from pylamp_tpu.models.step import make_step
from pylamp_tpu.solvers.mg import make_mg_preconditioner
from pylamp_tpu.solvers.stokes_solver import solve_stokes_mixed

cfg = sticky_air(1024, 256, max_steps=4)
grid, table, state = build(cfg, jnp.float32)
step = jax.jit(make_step(grid, cfg, table))
t0 = time.time()
prev = None
for _ in range(3):
    prev = (state.vx, state.vy, state.p)
    state, diag = step(state)
jax.block_until_ready(state.vx)
print(f"warm state ready in {time.time()-t0:.0f}s; last iters "
      f"{int(diag['stokes_iterations'])}", flush=True)

m = state.markers
phys = cfg.physics
eta_m = jnp.clip(table.viscosity_of(m.mat, m.T), phys.eta_min, phys.eta_max)


def interp_fb(vals, loc, mode, fb):
    f, w = bucket_markers_to_grid(m, vals, grid, loc, mode)
    return jnp.where(w > 0, f, fb)


eta_s = interp_fb(eta_m, "corner", phys.eta_avg, state.eta_s)
eta_n = interp_fb(eta_m, "center", phys.eta_avg, state.eta_n)
rho_m = table.density(m.mat, m.T)
mmean = jnp.sum(jnp.where(m.valid, rho_m, 0.0)) / jnp.sum(m.valid)
rho_vy = interp_fb(rho_m, "vy", "arithmetic", mmean)
rho_vx = jnp.zeros(grid.shape_vx, jnp.float32)
x0 = (state.vx, state.vy, state.p)
# linear-extrapolated initial guess from the last two step solutions:
# x0_ex = 2*x_n - x_{n-1} (free-surface velocity decays smoothly in time)
x0_ex = jax.tree.map(lambda a, b: 2.0 * a - b, x0, prev)
X0 = {"x0ex": x0_ex}

BASE = dict(pre_smooth=8, post_smooth=8, velocity_inner_iters=16,
            velocity_inner_tol=3e-3, eta_cap=1e2, semicoarsen=2.0)

VARIANTS = {
    "preset":      (dict(BASE), dict(restart=60)),
    "fcg":         (dict(BASE, velocity_inner_method="fcg"), dict(restart=60)),
    "restart120":  (dict(BASE), dict(restart=120)),
    "ii24_t1e3":   (dict(BASE, velocity_inner_iters=24,
                         velocity_inner_tol=1e-3), dict(restart=60)),
    "ii8_t1e2":    (dict(BASE, velocity_inner_iters=8,
                         velocity_inner_tol=1e-2), dict(restart=60)),
    "fcg24_t1e3":  (dict(BASE, velocity_inner_iters=24,
                         velocity_inner_tol=1e-3,
                         velocity_inner_method="fcg"), dict(restart=60)),
    # round-4 second set: cheaper inner exits, deeper cycles, wBFBT retry
    "ii16_t1e2":   (dict(BASE, velocity_inner_tol=1e-2), dict(restart=60)),
    "cyc2_ii8":    (dict(BASE, cycles=2, velocity_inner_iters=8),
                    dict(restart=60)),
    "pre12":       (dict(BASE, pre_smooth=12, post_smooth=12),
                    dict(restart=60)),
    "restart30":   (dict(BASE), dict(restart=30)),
    "wbfbt_ii16":  (dict(BASE, schur="wbfbt"), dict(restart=60)),
    # round-5: augmented-Lagrangian grad-div (solvers/al.py) — the Schur
    # remedy the round-4 verdict named; gamma sweep + inner-depth interplay
    "al_g01":      (dict(BASE, al_gamma=0.1),
                    dict(restart=60, al_gamma=0.1)),
    "al_g03":      (dict(BASE, al_gamma=0.3),
                    dict(restart=60, al_gamma=0.3)),
    "al_g1":       (dict(BASE, al_gamma=1.0),
                    dict(restart=60, al_gamma=1.0)),
    "al_g3":       (dict(BASE, al_gamma=3.0),
                    dict(restart=60, al_gamma=3.0)),
    "al_g1_ii24":  (dict(BASE, al_gamma=1.0, velocity_inner_iters=24,
                         velocity_inner_tol=1e-3),
                    dict(restart=60, al_gamma=1.0)),
    "al_g1_ii8":   (dict(BASE, al_gamma=1.0, velocity_inner_iters=8,
                         velocity_inner_tol=1e-2),
                    dict(restart=60, al_gamma=1.0)),
    # round-5 CPU 256x64 sweep (iteration counts, platform-independent):
    # preset 180, g3 129, g10+ii16 66, g10+ii24@1e-3 40, g30+ii24 40,
    # g10+ii32@3e-4 32, g100 355 (collapses), g10+ii8 202 (inner too
    # weak).  gamma ~10 with a deeper inner solve is the frontier; these
    # measure its spec-size wall on the chip.
    "al_g10_ii24": (dict(BASE, al_gamma=10.0, velocity_inner_iters=24,
                         velocity_inner_tol=1e-3),
                    dict(restart=60, al_gamma=10.0)),
    "al_g10_ii24_pre4": (dict(BASE, al_gamma=10.0, velocity_inner_iters=24,
                              velocity_inner_tol=1e-3, pre_smooth=4,
                              post_smooth=4),
                         dict(restart=60, al_gamma=10.0)),
    "al_g10_ii32": (dict(BASE, al_gamma=10.0, velocity_inner_iters=32,
                         velocity_inner_tol=3e-4),
                    dict(restart=60, al_gamma=10.0)),
    "al_g10_ii16": (dict(BASE, al_gamma=10.0),
                    dict(restart=60, al_gamma=10.0)),
    # the per-inner-iteration cost (fcg short recurrence) and the
    # smoothing depth frontier between pre4 and pre8
    "al_g10_ii16_fcg": (dict(BASE, al_gamma=10.0,
                             velocity_inner_method="fcg"),
                        dict(restart=60, al_gamma=10.0)),
    "al_g10_ii24_fcg": (dict(BASE, al_gamma=10.0, velocity_inner_iters=24,
                             velocity_inner_tol=1e-3,
                             velocity_inner_method="fcg"),
                        dict(restart=60, al_gamma=10.0)),
    "al_g10_ii20_pre6": (dict(BASE, al_gamma=10.0, velocity_inner_iters=20,
                              velocity_inner_tol=1e-3, pre_smooth=6,
                              post_smooth=6),
                         dict(restart=60, al_gamma=10.0)),
    "al_g10_ii12_t3e3": (dict(BASE, al_gamma=10.0, velocity_inner_iters=12),
                         dict(restart=60, al_gamma=10.0)),
    # bracket pre6 + ii20
    "al_g10_ii16_pre6": (dict(BASE, al_gamma=10.0, pre_smooth=6,
                              post_smooth=6),
                         dict(restart=60, al_gamma=10.0)),
    "al_g10_ii24_pre6": (dict(BASE, al_gamma=10.0, velocity_inner_iters=24,
                              velocity_inner_tol=1e-3, pre_smooth=6,
                              post_smooth=6),
                         dict(restart=60, al_gamma=10.0)),
    "al_g10_ii20_pre5": (dict(BASE, al_gamma=10.0, velocity_inner_iters=20,
                              velocity_inner_tol=1e-3, pre_smooth=5,
                              post_smooth=5),
                         dict(restart=60, al_gamma=10.0)),
    "al_g15_ii20_pre6": (dict(BASE, al_gamma=15.0, velocity_inner_iters=20,
                              velocity_inner_tol=1e-3, pre_smooth=6,
                              post_smooth=6),
                         dict(restart=60, al_gamma=15.0)),
}
names = sys.argv[1:] or list(VARIANTS)

x0_of = lambda name: X0.get(name, x0)  # noqa: E731

solvers = {}
for name in names:
    mgkw, skw = VARIANTS.get(name, VARIANTS["preset"])
    mk = partial(make_mg_preconditioner, **mgkw)

    def run(eta_s, eta_n, rho_vx, rho_vy, x0, mk=mk, skw=skw):
        sol = solve_stokes_mixed(
            eta_s, eta_n, rho_vx, rho_vy, 0.0, 9.81, grid,
            phys.velocity_bcs, tol=1e-8, inner_tol=1e-4,
            maxiter=3000, max_refinements=6, x0=x0,
            make_preconditioner=mk, **skw)
        return sol.vx, sol.info.iterations, sol.info.converged, sol.info.residual

    solvers[name] = jax.jit(run)

# compile all first
for name in names:
    t0 = time.time()
    out = solvers[name](eta_s, eta_n, rho_vx, rho_vy, x0_of(name))
    jax.block_until_ready(out[0])
    print(f"{name}: compiled in {time.time()-t0:.0f}s  iters={int(out[1])} "
          f"conv={bool(out[2])}", flush=True)

walls = {n: [] for n in names}
for rep in range(3):
    for name in names:
        t0 = time.time()
        out = solvers[name](eta_s, eta_n, rho_vx, rho_vy, x0_of(name))
        jax.block_until_ready(out[0])
        dt = time.time() - t0
        walls[name].append(dt)
        print(f"rep{rep} {name}: {dt:.3f}s iters={int(out[1])} "
              f"conv={bool(out[2])}", flush=True)

print("--- summary (median wall, iters) ---")
for name in names:
    print(f"{name}: {np.median(walls[name]):.3f}s")
