"""Command-line entry point (the reference is configured by editing the
script; SURVEY.md §5 'Config / flag system' prescribes a CLI).

    python -m pylamp_tpu run <benchmark> [--nx N] [--steps N] [--out DIR]
    python -m pylamp_tpu bench [--nx N]
    python -m pylamp_tpu list
"""
from __future__ import annotations

import argparse
import dataclasses
import sys


def _parse_mesh(spec: str):
    """Build a jax.sharding.Mesh from "YxX" (e.g. "2x4") or a device count
    (e.g. "8" -> near-square factorization)."""
    import jax

    from pylamp_tpu.parallel.mesh import make_mesh

    devices = jax.devices()
    if "x" in spec:
        my, mx = (int(p) for p in spec.lower().split("x", 1))
        need = my * mx
        if need > len(devices):
            raise SystemExit(
                f"--mesh {spec}: needs {need} devices, have {len(devices)}"
            )
        import numpy as np
        from jax.sharding import Mesh

        return Mesh(np.asarray(devices[:need]).reshape(my, mx), ("y", "x"))
    n = int(spec)
    if n > len(devices):
        raise SystemExit(f"--mesh {spec}: needs {n} devices, have {len(devices)}")
    return make_mesh(n)


BENCHMARKS = {
    "falling_block": "falling_block",
    "falling_block_periodic": "falling_block_periodic",
    "blankenbach": "blankenbach_case1a",
    "fk_stagnant_lid": "fk_stagnant_lid",
    "rt_van_keken": "rt_van_keken",
    "sticky_air": "sticky_air",
}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pylamp_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="run a benchmark model")
    runp.add_argument("benchmark", choices=sorted(BENCHMARKS))
    runp.add_argument("--nx", type=int, default=None)
    runp.add_argument("--ny", type=int, default=None)
    runp.add_argument("--steps", type=int, default=None)
    runp.add_argument("--out", type=str, default=None)
    runp.add_argument("--checkpoint-every", type=int, default=0)
    runp.add_argument("--output-every", type=int, default=0)
    runp.add_argument("--plot-every", type=int, default=0,
                      help="write a quick-look figure every N steps")
    runp.add_argument("--profile-phases", action="store_true",
                      help="per-phase wall-clock (interp/stokes/energy/advect) "
                           "into metrics.jsonl")
    runp.add_argument("--scan", type=int, default=0, metavar="N",
                      help="fuse N steps per lax.scan chunk (one host sync "
                           "per chunk instead of per step)")
    runp.add_argument("--resume", type=str, default=None)
    runp.add_argument("--step-delay", type=float, default=0.0,
                      help="sleep this many seconds after each step "
                           "(widens the kill window for fault-injection "
                           "tests; no effect on the computed results)")
    runp.add_argument("--f32", action="store_true",
                      help="f32 state + mixed-precision solves (the default)")
    runp.add_argument("--x64", action="store_true",
                      help="full float64 state and solves")
    runp.add_argument("--stretch-x", type=float, default=0.0, metavar="R",
                      help="geometric grid stretching in x: last/first cell "
                           "width ratio R (> 1 refines toward x=0)")
    runp.add_argument("--stretch-y", type=float, default=0.0, metavar="R",
                      help="geometric grid stretching in y (> 1 refines "
                           "toward the top)")
    runp.add_argument("--mg-smoother", default=None,
                      choices=["chebyshev", "jacobi", "line", "line_y",
                               "line_x"],
                      help="multigrid V-cycle smoother (line relaxation "
                           "for anisotropic stretched grids)")
    runp.add_argument("--mesh", type=str, default=None, metavar="YxX",
                      help="run domain-decomposed over a YxX device mesh "
                           "(e.g. 2x2 on four GPUs), or a device count "
                           "(e.g. 4) for a near-square auto factorization")
    runp.add_argument("--explicit-halo", dest="explicit_halo",
                      action="store_true", default=None,
                      help="force the explicit shard_map+ppermute operators "
                           "(the default whenever --mesh is given)")
    runp.add_argument("--no-explicit-halo", dest="explicit_halo",
                      action="store_false",
                      help="keep GSPMD auto-partitioning under --mesh")
    runp.add_argument("--coarse-replicate", type=int, default=None,
                      metavar="N",
                      help="replicate MG levels with <= N cells across the "
                           "mesh (default 16 under --mesh; 0 disables)")
    runp.add_argument("--platform", choices=["cpu"], default=None,
                      help="run on the CPU (the default is the GPU JAX "
                           "finds); set through jax.config, as "
                           "tests/conftest.py does")
    runp.add_argument("--devices", type=int, default=0, metavar="N",
                      help="with --platform cpu: virtual host device count "
                           "(e.g. 8 to exercise --mesh 2x4 without several "
                           "GPUs)")

    benchp = sub.add_parser("bench", help="run the BASELINE metric harness")
    benchp.add_argument("--nx", type=int, default=1024)
    benchp.add_argument("--steps", type=int, default=5)

    plotp = sub.add_parser("plot", help="post-process an output directory "
                                        "(time series + final fields figure)")
    plotp.add_argument("out_dir", help="directory written by `run --out`")

    sub.add_parser("list", help="list available benchmark models")

    args = ap.parse_args(argv)

    if args.cmd == "list":
        for name in sorted(BENCHMARKS):
            print(name)
        return 0

    if args.cmd == "plot":
        import glob
        import os

        from pylamp_tpu.io.output import plot_timeseries

        metrics = os.path.join(args.out_dir, "metrics.jsonl")
        made = []
        if os.path.exists(metrics):
            if plot_timeseries(os.path.join(args.out_dir, "timeseries.png"), metrics):
                made.append("timeseries.png")
        fields = sorted(glob.glob(os.path.join(args.out_dir, "fields_*.npz")))
        if fields:
            from pylamp_tpu.io.output import plot_npz_fields

            if plot_npz_fields(
                os.path.join(args.out_dir, "fields_final.png"), fields[-1]
            ):
                made.append("fields_final.png")
        if not made:
            print(f"nothing to plot in {args.out_dir} (need metrics.jsonl or "
                  f"fields_*.npz; is matplotlib available?)")
            return 1
        print("wrote " + ", ".join(os.path.join(args.out_dir, m) for m in made))
        return 0

    if args.cmd == "bench":
        import subprocess

        return subprocess.call(
            [sys.executable, "bench.py", "--nx", str(args.nx), "--steps", str(args.steps)]
        )

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.devices:
        if args.platform != "cpu":
            raise SystemExit("--devices requires --platform cpu")
        jax.config.update("jax_num_cpu_devices", args.devices)

    # x64 is ALWAYS enabled: the default mixed-precision path (f32 state)
    # needs f64 for the iterative-refinement outer loop.  Without it the
    # "f64" refinement silently truncates to f32 and the solve floors at
    # ~6e-7 relative instead of the 1e-8 tolerance (every step then
    # reports "did not reach tolerance" while the math quietly runs pure
    # f32).  --x64 selects a full-f64 STATE; --f32 (the default) a
    # f32 state with f64 refinement.
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    state_dtype = jnp.float64 if args.x64 else jnp.float32

    from pylamp_tpu.models import benchmarks as B
    from pylamp_tpu.models.driver import run_model
    from pylamp_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    factory = getattr(B, BENCHMARKS[args.benchmark])
    kw = {}
    if args.nx:
        kw["nx"] = args.nx
        kw["ny"] = args.ny or args.nx
    cfg = factory(**kw)
    if args.steps:
        cfg = dataclasses.replace(
            cfg, time=dataclasses.replace(cfg.time, max_steps=args.steps)
        )
    if args.stretch_x or args.stretch_y:
        from pylamp_tpu.core.grid import geometric_edges

        kw2 = {}
        if args.stretch_x:
            kw2["x_edges"] = geometric_edges(cfg.nx, cfg.lx, args.stretch_x)
        if args.stretch_y:
            kw2["y_edges"] = geometric_edges(cfg.ny, cfg.ly, args.stretch_y)
        cfg = dataclasses.replace(cfg, **kw2)
    if args.mg_smoother:
        omega = 0.7 if args.mg_smoother.startswith("line") else 0.6
        cfg = dataclasses.replace(
            cfg, solver=dataclasses.replace(
                cfg.solver, mg_smoother=args.mg_smoother, mg_omega=omega
            )
        )

    mesh = None
    if args.mesh:
        mesh = _parse_mesh(args.mesh)
        # explicit halo is the multi-device default; ineligible
        # grids/levels fall back to GSPMD per application, so forcing it
        # on is always safe.  --no-explicit-halo opts out for A/Bs.
        explicit = args.explicit_halo if args.explicit_halo is not None else True
        replicate = args.coarse_replicate if args.coarse_replicate is not None else 16
        cfg = dataclasses.replace(
            cfg, solver=dataclasses.replace(
                cfg.solver, explicit_halo=explicit,
                mg_coarse_replicate=replicate,
            )
        )
    elif args.explicit_halo or args.coarse_replicate:
        print("warning: --explicit-halo/--coarse-replicate have no effect "
              "without --mesh", file=sys.stderr)

    state, diags, grid = run_model(
        cfg,
        out_dir=args.out,
        checkpoint_every=args.checkpoint_every,
        output_every=args.output_every,
        plot_every=args.plot_every,
        resume_from=args.resume,
        echo=True,
        profile_phases=args.profile_phases,
        scan_chunk=args.scan,
        dtype=state_dtype,
        step_delay=args.step_delay,
        mesh=mesh,
    )
    print(f"done: {int(state.step)} steps, t={float(state.time):.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
