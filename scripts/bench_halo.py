"""A/B the whole domain-decomposed step: GSPMD auto-partitioning vs the
explicit shard_map + ppermute halo path (parallel/halo_ops.py).

Runs on the 8-virtual-device CPU mesh, the way the distributed test tier
does (SURVEY.md §4).  CPU collectives ride shared memory, so the numbers
probe partitioning/communication *structure* (how many reshards XLA
inserts, how the halo pattern schedules), not interconnect bandwidth, and
no CPU time here is a device metric.

Usage: python scripts/bench_halo.py [--nx 256] [--steps 3]
"""
import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

from pylamp_tpu.models.benchmarks import falling_block
from pylamp_tpu.models.config import SolverConfig
from pylamp_tpu.models.setup import build
from pylamp_tpu.models.step import make_step
from pylamp_tpu.parallel.mesh import make_mesh, shard_state, state_shardings


def run(cfg, grid, table, state0, mesh, steps):
    step = make_step(grid, cfg, table, mesh=mesh)
    sharded = shard_state(state0, mesh)
    shardings = state_shardings(mesh, state0)
    f = jax.jit(step, in_shardings=(shardings,))
    t0 = time.perf_counter()
    s, d = f(sharded)
    jax.block_until_ready(s.vx)
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        s, d = f(s)
        jax.block_until_ready(s.vx)
        times.append(time.perf_counter() - t0)
    times.sort()
    return {
        "compile_s": round(compile_s, 2),
        "step_s_median": round(times[len(times) // 2], 4),
        "step_s_min": round(times[0], 4),
        "iters": float(d["stokes_iterations"]),
        "converged": bool(d["stokes_converged"]),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=256)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--tol", type=float, default=1e-8)
    args = ap.parse_args()

    mesh = make_mesh(8)
    cfg0 = falling_block(nx=args.nx, ny=args.nx, max_steps=1)
    results = {}
    for name, halo in (("gspmd", False), ("explicit_halo", True)):
        cfg = dataclasses.replace(
            cfg0,
            solver=SolverConfig(
                precision="f64", stokes_tol=args.tol, stokes_restart=40,
                stokes_maxiter=600, explicit_halo=halo,
            ),
        )
        grid, table, state0 = build(cfg)
        results[name] = run(cfg, grid, table, state0, mesh, args.steps)
        print(json.dumps({"path": name, "nx": args.nx, **results[name]}))

    ratio = results["gspmd"]["step_s_median"] / max(
        results["explicit_halo"]["step_s_median"], 1e-12
    )
    print(json.dumps({"explicit_over_gspmd_speedup": round(ratio, 3)}))


if __name__ == "__main__":
    main()
