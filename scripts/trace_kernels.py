"""Profile the Frank-Kamenetskii step on the GPU with ``jax.profiler``.

Two kinds of trace, each in a profiler session of its own:

- ``step``: the fused production step (``cli.py run`` configuration),
  ``N_STEP`` steps after warm-up: device busy time per step, the device's
  idle share of the window, and the device kernels that take the most time;
- one per operation that a deleted hand-written kernel used to cover, run
  alone ``N_CALLS`` times on the state of a warmed step: device time per
  call, the bytes the operation must move (computed from its shapes), and
  achieved bytes/s against the H100's 3.35 TB/s.

Usage: python scripts/trace_kernels.py [nx] [out_dir]
Writes <out_dir>/trace_summary_<nx>.json and prints it as one JSON line.
Device times come only from a GPU trace; on the CPU they print as null.
"""
import glob
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

N_STEP = 2
N_CALLS = 20
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}  # NVIDIA data sheet, SXM


def _union_ns(intervals):
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def device_time(trace_dir):
    """(busy ns: union of device-event intervals, {kernel name: ns}) of the
    GPU planes in one trace; (None, {}) where the trace has no device."""
    from jax.profiler import ProfileData

    pbs = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True)
    pd = ProfileData.from_file(pbs[0])
    intervals, by_name = [], {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        streams = [l for l in lines if "Stream" in l.name] or lines
        for line in streams:
            for e in line.events:
                intervals.append((e.start_ns, e.start_ns + e.duration_ns))
                by_name[e.name] = by_name.get(e.name, 0) + e.duration_ns
    if not intervals:
        return None, {}
    return _union_ns(intervals), by_name


def traced(fn, args, n):
    """Warm ``fn`` up, then trace ``n`` calls; returns (device ns, host s,
    kernel times)."""
    jax.block_until_ready(fn(*args))
    d = tempfile.mkdtemp(prefix="trace_")
    with jax.profiler.trace(d):
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn(*args)
        jax.block_until_ready(out)
        host = time.perf_counter() - t0
    busy, names = device_time(d)
    return busy, host, names


def _size(*arrays):
    return sum(int(a.size) for a in arrays)


def main(nx=1024, out_dir="out"):
    from pylamp_tpu.markers.bucket import bucket_advect_rk4, rebucket
    from pylamp_tpu.models.benchmarks import fk_stagnant_lid
    from pylamp_tpu.models.setup import build
    from pylamp_tpu.models.step import make_step, make_step_phases
    from pylamp_tpu.ops.stokes import stokes_operator
    from pylamp_tpu.solvers.mg import (
        chebyshev_smooth,
        coarsen_eta,
        coarsening_plan,
        estimate_mg_lambdas,
        make_velocity_mg,
    )
    from pylamp_tpu.solvers.scaling import characteristic_viscosity, stokes_scales
    from pylamp_tpu.utils.cache import enable_persistent_cache
    from pylamp_tpu.utils.device import device_fields, gpu_name_and_power_limit

    enable_persistent_cache()
    device = device_fields()
    cfg = fk_stagnant_lid(nx=nx, ny=nx, max_steps=10)
    grid, table, state = build(cfg, dtype=jnp.float32)
    step = jax.jit(make_step(grid, cfg, table))
    for _ in range(2):
        state, diag = step(state)
    iters = int(diag["stokes_iterations"])

    res = {"nx": nx, "device": device, "card": gpu_name_and_power_limit(),
           "krylov_iterations_last_warm_step": iters}
    busy, host, names = traced(step, (state,), N_STEP)
    top = sorted(names.items(), key=lambda kv: -kv[1])[:15]
    res["step"] = {
        "device_s_per_step": None if busy is None else busy * 1e-9 / N_STEP,
        "host_s_per_step": host / N_STEP,
        "idle_share": None if busy is None else 1.0 - busy * 1e-9 / host,
        "top_kernels_s_per_step": {k: v * 1e-9 / N_STEP for k, v in top},
    }

    # the operations the deleted kernels covered, on the warmed state
    solver, vbc = cfg.solver, cfg.physics.velocity_bcs
    ph = make_step_phases(grid, cfg, table)
    io = jax.jit(ph.interp)(state)
    f32 = jnp.float32
    es, en = io.eta_s.astype(f32), io.eta_n.astype(f32)
    kcont, kbnd = stokes_scales(characteristic_viscosity(en), grid)
    kcont, kbnd = kcont.astype(f32), kbnd.astype(f32)
    vx, vy, p = state.vx, state.vy, state.p
    lams = estimate_mg_lambdas(es, en, grid, vbc, kbnd, mode="gershgorin",
                               semicoarsen=solver.mg_semicoarsen)
    m = state.markers
    slots = int(m.x.size)
    sweeps = solver.mg_cycles * (solver.mg_pre_smooth + solver.mg_post_smooth)

    plan = coarsening_plan(grid, solver.mg_levels,
                           semi_threshold=solver.mg_semicoarsen)
    g, ec, lvl = grid, (es, en), 0
    while max(g.nx, g.ny) >= 256 and lvl < len(plan):
        g = g.coarsen(*plan[lvl])
        ec = coarsen_eta(*ec, *plan[lvl])
        lvl += 1
    kb_c = kbnd * (grid.dx_min * grid.dy_min) / (g.dx_min * g.dy_min)
    coarse_bytes = 0
    gg = g
    for cx, cy in plan[lvl:] + [(None, None)]:
        v_l = (gg.ny * (gg.nx + 1) + (gg.ny + 1) * gg.nx)
        coarse_bytes += (solver.mg_pre_smooth + solver.mg_post_smooth + 1) * 4 * (
            6 * v_l + (gg.ny + 1) * (gg.nx + 1) + gg.ny * gg.nx)
        if cx is not None:
            gg = gg.coarsen(cx, cy)

    rx, ry = vx * 1e-3, vy * 1e-3
    v_fine = _size(vx, vy)
    ops = {
        # name: (fn, args, calls per step, bytes per call)
        "saddle_apply": (
            jax.jit(lambda a, b, c: stokes_operator(a, b, c, es, en, grid, vbc,
                                                    kcont=kcont, kbnd=kbnd)),
            (vx, vy, p), iters, 4 * (2 * _size(vx, vy, p) + _size(es, en))),
        "fine_smoother_sweep_x4": (
            jax.jit(lambda a, b: chebyshev_smooth(a, b, rx, ry, es, en, grid, vbc,
                                                  kbnd, lams[0], 4)),
            (vx, vy), iters * sweeps / 4, 4 * 4 * (6 * v_fine + _size(es, en))),
        f"coarse_tail_from_{g.nx}x{g.ny}": (
            jax.jit(make_velocity_mg(*ec, g, vbc, kb_c,
                                     levels=len(plan) - lvl + 1,
                                     pre_smooth=solver.mg_pre_smooth,
                                     post_smooth=solver.mg_post_smooth,
                                     lam_max=lams[lvl:])),
            (jnp.ones(g.shape_vx, f32), jnp.ones(g.shape_vy, f32)),
            iters * solver.mg_cycles, coarse_bytes),
        "m2g_interp_phase": (
            jax.jit(ph.interp), (state,), 1,
            17 * slots + 4 * _size(io.eta_s, io.eta_n, io.rho_vy)),
        "rk4_advect": (
            jax.jit(lambda mk, a, b: bucket_advect_rk4(mk, a, b, state.dt, grid,
                                                       vbc, stage_reach=1)),
            (m, vx, vy), 1, 17 * slots + 4 * v_fine),
        "rebucket": (jax.jit(lambda mk: rebucket(mk, grid)), (m,), 1, 34 * slots),
    }
    peak = PEAK_BYTES_PER_S.get(device["kind"])
    if device["platform"] == "gpu" and peak is None:
        raise SystemExit(f"no peak bandwidth on record for {device['kind']!r}")
    res["ops"] = {}
    for name, (fn, args, per_step, nbytes) in ops.items():
        busy, host, _ = traced(fn, args, N_CALLS)
        per_call = None if busy is None else busy * 1e-9 / N_CALLS
        rate = None if per_call is None else nbytes / per_call
        res["ops"][name] = {
            "device_s_per_call": per_call,
            "host_s_per_call": host / N_CALLS,
            "calls_per_step": per_step,
            "device_s_per_step": None if per_call is None else per_call * per_step,
            "bytes_per_call": nbytes,
            "bytes_per_s": rate,
            "roofline_share": None if rate is None or peak is None else rate / peak,
        }
    res["peak_bytes_per_s"] = peak
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"trace_summary_{nx}.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1024,
         sys.argv[2] if len(sys.argv) > 2 else "out")
