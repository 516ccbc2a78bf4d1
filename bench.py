"""Benchmark harness: the BASELINE.json metric.

Measures 1024^2 variable-viscosity Stokes + energy + marker timesteps/sec
(mixed precision, every step solved to 1e-8 relative residual) on the GPU,
and prints ONE JSON line naming the device it ran on.  Without a GPU it
refuses to run unless ``--platform cpu`` is given, and a CPU result is not
a device metric.

Baseline: the reference's method (scipy assemble + SuperLU spsolve; the
reference repo publishes no numbers and the mount was empty — BASELINE.md)
measured here via tests/oracle on this machine's CPU at 128^2/256^2/512^2
(scripts/measure_baseline.py -> validation/baseline_cpu.json): solve_s =
4.97e-7 * N^1.576 (MEASURED exponent; rounds 1-3 assumed 1.5 from a single
256^2 point), assembly 2.33e-4 s/cell.  Extrapolated 1024^2 full step
(Stokes + energy + assembly) = 2115 s => 4.7e-4 steps/s.
"""
import argparse
import dataclasses
import json
import sys
import time

sys.path.insert(0, ".")

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

# Reference-method CPU model, MEASURED at 128^2..512^2 on this machine
# (validation/baseline_cpu.json): SuperLU solve 4.97e-7 * N^1.576 s,
# assembly 2.33e-4 s/cell; the energy solve is a scalar system with ~1/3
# the unknowns plus ~1/3 the assembly.  The fit is loaded from the committed
# artifact so re-running scripts/measure_baseline.py on another machine
# cannot leave vs_baseline silently stale (round-4 advisor finding); the
# hardcoded values are the fallback when the artifact is absent.
_SOLVE_C, _SOLVE_P, _ASM_PER_CELL = 4.968e-7, 1.576, 2.33e-4
try:
    import os as _os

    with open(_os.path.join(_os.path.dirname(_os.path.abspath(__file__)),
                            "validation", "baseline_cpu.json")) as _fh:
        _base = json.load(_fh)
    _SOLVE_C = float(_base["fit"]["coeff_c"])
    _SOLVE_P = float(_base["fit"]["exponent_p"])
    _m = max(_base["measured"], key=lambda r: r["nx"])
    _ASM_PER_CELL = float(_m["assemble_s"]) / (_m["nx"] * _m["nx"])
except (OSError, KeyError, ValueError):
    pass


def baseline_seconds_per_step(ncells, energy=True):
    solve = _SOLVE_C * ncells ** _SOLVE_P
    asm = _ASM_PER_CELL * ncells
    if energy:
        solve += _SOLVE_C * (ncells / 3.0) ** _SOLVE_P
        asm += asm / 3.0
    return solve + asm


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--benchmark", type=str, default="fk",
                    choices=("fk", "sticky_air"),
                    help="fk = 1024^2 FK stagnant lid (the BASELINE metric);"
                         " sticky_air = spec 1024x256 Crameri free-surface "
                         "relaxation (1e4 sharp contrast, hardest config)")
    ap.add_argument("--nx", type=int, default=1024)
    ap.add_argument("--stretch-y", type=float, default=0.0, metavar="R",
                    help="geometric y-stretching (last/first cell ratio R): "
                         "measures the non-uniform-grid path")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--phase-steps", type=int, default=2,
                    help="extra per-phase-instrumented steps for the phase "
                         "breakdown (0 = skip)")
    ap.add_argument("--scan", type=int, default=5,
                    help="also time a lax.scan chunk of N steps (no host "
                         "syncs between steps) and report its per-step time "
                         "(0 = skip)")
    ap.add_argument("--solver", type=str, default="",
                    help="comma-separated SolverConfig overrides for A/Bs, "
                         "e.g. 'schur=wbfbt,mg_pre_smooth=4'")
    ap.add_argument("--mesh", type=str, default=None, metavar="YxX",
                    help="measure domain-decomposed over a YxX device mesh "
                         "(e.g. 2x4) or a device count; explicit-halo "
                         "operators by default (the measured-faster path)")
    ap.add_argument("--explicit-halo", dest="explicit_halo",
                    action="store_true", default=None,
                    help="force explicit shard_map+ppermute operators under "
                         "--mesh (the default)")
    ap.add_argument("--no-explicit-halo", dest="explicit_halo",
                    action="store_false",
                    help="keep GSPMD auto-partitioning under --mesh")
    ap.add_argument("--platform", choices=["cpu"], default=None,
                    help="run on the CPU (without it, bench.py refuses to "
                         "run where JAX finds no GPU); CPU timings are not "
                         "device metrics")
    ap.add_argument("--devices", type=int, default=0, metavar="N",
                    help="with --platform cpu: virtual host device count "
                         "(exercise --mesh without several GPUs)")
    ap.add_argument("--artifact", type=str, default="", metavar="PATH",
                    help="also write the result JSON to PATH via the atomic "
                         "artifact writer (refuses empty payloads) — the "
                         "committed validation/bench_*.json evidence files")
    args = ap.parse_args()

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.devices:
        jax.config.update("jax_num_cpu_devices", args.devices)

    from pylamp_tpu.utils.cache import enable_persistent_cache
    from pylamp_tpu.utils.device import require_gpu

    device = require_gpu(args.platform, "bench.py")
    enable_persistent_cache()

    from pylamp_tpu.models.benchmarks import fk_stagnant_lid, sticky_air
    from pylamp_tpu.models.config import SolverConfig
    from pylamp_tpu.models.setup import build
    from pylamp_tpu.models.step import make_step

    overrides = {}
    for kv in filter(None, args.solver.split(",")):
        k, v = kv.split("=", 1)
        t = type(getattr(SolverConfig(), k))
        overrides[k] = (v.lower() in ("1", "true")) if t is bool else t(v)

    if args.benchmark == "sticky_air":
        # Spec 1024x256 Crameri free-surface relaxation: 1e4 cell-sharp
        # viscosity contrast, no energy solve.  Uses the preset's tuned
        # solver (round-4 tuning matrix in models/benchmarks.py).
        ny = max(args.nx // 4, 64)
        cfg = sticky_air(nx=args.nx, ny=ny, max_steps=10**9)
        base = dataclasses.asdict(cfg.solver)
        base["stokes_tol"] = args.tol
        metric = (f"{args.nx}x{ny} sticky-air free-surface Stokes+marker "
                  f"timesteps/sec (cell-sharp 1e4 viscosity contrast, "
                  f"{args.tol:g} rel residual, mixed f32/f64)")
    else:
        # Variable-viscosity (Frank-Kamenetskii, 1e4 contrast) convection
        # with energy + markers: the full BASELINE metric workload.
        ny = args.nx
        cfg = fk_stagnant_lid(nx=args.nx, ny=ny, max_steps=10**9)
        base = dict(
            stokes_tol=args.tol,
            # round-3 tuning at 1024^2: restart 12 + two V-cycles + degree-4
            # smoothing = 0.25 s/step @ ~28 iters vs 0.30 @ ~52 for the old
            # restart-25/1-cycle/degree-3 (the short restart cuts the
            # full-basis CGS traffic, the second cycle halves iterations)
            stokes_restart=12,
            stokes_maxiter=250,
            mg_cycles=2,
            mg_pre_smooth=4,
            mg_post_smooth=4,
            energy_tol=1e-10,
        )
        metric = (f"{args.nx}^2 variable-viscosity Stokes+energy+marker "
                  f"timesteps/sec (1e-8 rel residual, mixed f32/f64)")
    base.update(overrides)
    cfg = dataclasses.replace(cfg, solver=SolverConfig(**base))
    if args.stretch_y:
        from pylamp_tpu.core.grid import geometric_edges

        cfg = dataclasses.replace(
            cfg, y_edges=geometric_edges(cfg.ny, cfg.ly, args.stretch_y))
        metric = metric.replace("timesteps/sec",
                                f"timesteps/sec (y-stretched {args.stretch_y:g}x)")
    # reference-method baseline at this problem size from the measured
    # scaling fit (scripts/measure_baseline.py)
    baseline_sps = 1.0 / baseline_seconds_per_step(
        args.nx * ny, energy=cfg.physics.solve_energy)

    mesh = mesh_tag = shardings = None
    if args.mesh:
        from pylamp_tpu.cli import _parse_mesh

        mesh = _parse_mesh(args.mesh)
        mesh_tag = f"{mesh.shape['y']}x{mesh.shape['x']}"
        explicit = args.explicit_halo if args.explicit_halo is not None else True
        cfg = dataclasses.replace(
            cfg, solver=dataclasses.replace(
                cfg.solver, explicit_halo=explicit, mg_coarse_replicate=16))
        metric = metric.replace(
            "timesteps/sec",
            f"timesteps/sec ({mesh_tag} mesh, "
            f"{'explicit-halo' if explicit else 'gspmd'})")

    grid, table, state = build(cfg, dtype=jnp.float32)
    if mesh is not None:
        from pylamp_tpu.parallel.mesh import shard_state, state_shardings

        shardings = state_shardings(mesh, state)
        state = shard_state(state, mesh)
        step = jax.jit(make_step(grid, cfg, table, mesh=mesh),
                       in_shardings=(shardings,))
    else:
        step = jax.jit(make_step(grid, cfg, table))

    # warmup / compile (2 steps: the first post-compile step still pays
    # one-time buffer setup)
    for _ in range(2):
        state, diag = step(state)
        _ = float(diag["stokes_residual"])  # force full sync (host read)

    # Per-step host-synced timing, reported as a median.
    times = []
    iters = 0
    for _ in range(args.steps):
        t0 = time.perf_counter()
        state, diag = step(state)
        iters += int(diag["stokes_iterations"])
        _ = float(diag["stokes_residual"])
        times.append(time.perf_counter() - t0)
    times.sort()
    median = times[len(times) // 2]
    # materialize diag scalars now: later sections (scan/phased) may fail
    # or donate buffers, and async errors surface at the next host read
    residual_rel = float(diag["stokes_residual_rel"])
    converged = bool(diag["stokes_converged"])

    # lax.scan multi-step: the production no-host-sync path; reported
    # alongside the single-step median (which stays the headline so rounds
    # remain comparable)
    scan_per_step = None
    if args.scan > 0:
        from pylamp_tpu.models.step import make_multi_step

        if mesh is not None:
            multi = jax.jit(make_multi_step(grid, cfg, table, args.scan,
                                            mesh=mesh),
                            in_shardings=(shardings,))
        else:
            multi = jax.jit(make_multi_step(grid, cfg, table, args.scan))
        state_s, _ = multi(state)  # compile + warm
        jax.block_until_ready(state_s.vx)
        t0 = time.perf_counter()
        state_s, _ = multi(state_s)
        jax.block_until_ready(state_s.vx)
        scan_per_step = (time.perf_counter() - t0) / args.scan

    # per-phase breakdown (interp / stokes / energy / advect), separately
    # jitted + synced — informs where the step time goes (SURVEY.md §5)
    phases = {}
    if args.phase_steps > 0 and mesh is None:  # phased runner is 1-device
        import gc

        from pylamp_tpu.models.step import make_phased_runner

        # drop the fused-step/multi-step executables + their states before
        # the phased runner compiles its own
        if args.scan > 0:
            del multi, state_s
        del step
        gc.collect()
        jax.clear_caches()  # drop executables' device workspaces too

        runner = make_phased_runner(grid, cfg, table)
        state_p, d = runner(state)  # compile
        acc = {}
        for _ in range(args.phase_steps):
            state_p, d = runner(state_p)
            for k, v in d["phase_seconds"].items():
                acc[k] = acc.get(k, 0.0) + v
        jax.block_until_ready(state_p.vx)  # surface async errors here
        phases = {k: round(v / args.phase_steps, 4) for k, v in acc.items()}

    steps_per_sec = 1.0 / median
    result = {
        "metric": metric,
        "value": round(steps_per_sec, 5),
        "unit": "steps/sec",
        "vs_baseline": round(steps_per_sec / baseline_sps, 2),
        "detail": {
            "seconds_per_step_median": round(median, 3),
            "seconds_per_step_min": round(times[0], 3),
            "seconds_per_step_max": round(times[-1], 3),
            "krylov_iters_per_step": round(iters / args.steps, 1),
            "stokes_residual_rel": residual_rel,
            "stokes_converged": converged,
            "device": device,
            "phase_seconds": phases,
        },
    }
    if mesh_tag is not None:
        result["detail"]["mesh"] = mesh_tag
        result["detail"]["explicit_halo"] = bool(cfg.solver.explicit_halo)
    if scan_per_step is not None:
        result["detail"]["seconds_per_step_scanned"] = round(scan_per_step, 3)
    if args.artifact:
        from pylamp_tpu.utils.artifacts import write_json_artifact

        write_json_artifact(args.artifact, result)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
