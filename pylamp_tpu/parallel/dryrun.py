"""Multi-device dry run: jit the FULL timestep over an n-device mesh with the
production shardings and execute one step on tiny shapes (SURVEY.md §4
'Distributed' tier; on virtual CPU devices in the tests, on the GPUs in
``chip_smoke.py --four``).

Four sub-checks cover the whole multi-chip surface (round-3 verdict item 5),
each asserted equal to its single-device reference:

  gspmd             default auto-partitioned step (Blankenbach physics)
  explicit_halo     hand-placed ppermute operators + marker halo engine
  coarse_replicate  MG coarse levels replicated across the mesh
  periodic          wrapped-seam stencils/markers under GSPMD
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np


def _assert_close(new_state, ref_state, diag, tag, tol, fields=("vx", "vy", "T")):
    import jax.numpy as jnp

    assert bool(diag["stokes_converged"]), f"[{tag}] sharded Stokes did not converge"
    vref = max(float(jnp.max(jnp.abs(ref_state.vy))), 1.0)
    for name in fields:
        a = np.asarray(getattr(new_state, name))
        b = np.asarray(getattr(ref_state, name))
        assert np.all(np.isfinite(a)), f"[{tag}] non-finite {name} in sharded step"
        err = np.max(np.abs(a - b))
        assert err <= tol * vref, (
            f"[{tag}] sharded {name} deviates from single-device by {err:.3e} "
            f"(allowed {tol * vref:.3e})"
        )


def _run_pair(cfg, mesh, dtype, mesh_aware: bool, ref_state=None):
    """One (single-device, sharded) step pair on ``cfg``; returns
    (sharded_state, ref_state, diag).  ``ref_state``: reuse a previously
    computed single-device reference (solver-option sub-checks share the
    physics config, so the reference step need only compile once)."""
    import jax.numpy as jnp

    from pylamp_tpu.models.setup import build
    from pylamp_tpu.models.step import make_step
    from pylamp_tpu.parallel.mesh import shard_state, state_shardings

    grid, table, state0 = build(cfg, dtype=dtype)
    if ref_state is None:
        ref_state, _ = jax.jit(make_step(grid, cfg, table))(state0)
        jax.block_until_ready(ref_state.vx)

    step_fn = make_step(grid, cfg, table, mesh=mesh if mesh_aware else None)
    state = shard_state(state0, mesh)
    shardings = state_shardings(mesh, state0)
    new_state, diag = jax.jit(step_fn, in_shardings=(shardings,))(state)
    jax.block_until_ready(new_state.vx)
    return new_state, ref_state, diag


def dryrun_multichip(n_devices: int) -> None:
    """Run the four sub-checks on the first ``n_devices`` devices of the
    current backend (GPUs, or virtual CPU devices set up by the caller)."""
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)  # equivalence checked in f64
    devs = jax.devices()
    if len(devs) < n_devices:
        raise RuntimeError(
            f"need {n_devices} devices, have {len(devs)} — on the CPU set "
            f"jax_num_cpu_devices before first backend use"
        )

    from pylamp_tpu.models.benchmarks import (
        blankenbach_case1a,
        falling_block,
        falling_block_periodic,
    )
    from pylamp_tpu.models.config import SolverConfig
    from pylamp_tpu.parallel.mesh import make_mesh
    from pylamp_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    mesh = make_mesh(n_devices)
    checks = []

    # -- (a) GSPMD default: flagship physics (Stokes + energy + markers) ---
    cfg = blankenbach_case1a(nx=32, ny=32, max_steps=1)
    solver64 = SolverConfig(
        precision="f64", stokes_tol=1e-10, stokes_restart=40,
        stokes_maxiter=400, mg_levels=2,
    )
    cfg = dataclasses.replace(cfg, solver=solver64)
    new, ref_bb, diag = _run_pair(cfg, mesh, jnp.float64, mesh_aware=False)
    _assert_close(new, ref_bb, diag, "gspmd", 1e-8)
    gspmd_iters = int(diag["stokes_iterations"])
    checks.append(("gspmd", 1e-8))

    # -- (b) explicit halo + marker halo engine ----------------------------
    # f32 state, the production precision of the marker engine.
    # Equivalence at f32 solver tolerance.
    cfg = falling_block(nx=32, ny=32, max_steps=1)
    cfg = dataclasses.replace(
        cfg,
        solver=SolverConfig(
            precision="f32", stokes_tol=1e-5, stokes_restart=40,
            stokes_maxiter=600, explicit_halo=True,
        ),
    )
    new, ref, diag = _run_pair(cfg, mesh, jnp.float32, mesh_aware=True)
    _assert_close(new, ref, diag, "explicit_halo", 2e-4)
    checks.append(("explicit_halo", 2e-4))

    # -- (c) MG coarse-level replication ------------------------------------
    cfg = blankenbach_case1a(nx=32, ny=32, max_steps=1)
    cfg = dataclasses.replace(
        cfg,
        solver=dataclasses.replace(solver64, mg_coarse_replicate=8),
    )
    # same physics + solver tolerance as (a): reuse its reference
    new, ref, diag = _run_pair(cfg, mesh, jnp.float64, mesh_aware=True,
                               ref_state=ref_bb)
    _assert_close(new, ref, diag, "coarse_replicate", 1e-8)
    checks.append(("coarse_replicate", 1e-8))

    # -- (d) periodic side walls through the EXPLICIT-HALO stencils ---------
    # (ring ppermute over the periodic seam + half-convention seam rows;
    # the marker transfers stay GSPMD under periodic)
    cfg = falling_block_periodic(nx=32, ny=32, max_steps=1)
    cfg = dataclasses.replace(
        cfg,
        solver=dataclasses.replace(solver64, explicit_halo=True),
    )
    new, ref, diag = _run_pair(cfg, mesh, jnp.float64, mesh_aware=True)
    _assert_close(new, ref, diag, "periodic+halo", 1e-8)
    checks.append(("periodic+halo", 1e-8))

    detail = ", ".join(f"{name}@{tol:g}" for name, tol in checks)
    print(
        f"dryrun_multichip OK: mesh {dict(zip(mesh.axis_names, mesh.devices.shape))}, "
        f"stokes iters {gspmd_iters}, each sub-check == single-device to its "
        f"stated tolerance (f64 paths 1e-8; the f32 explicit-halo path "
        f"at f32 solver tolerance): {detail}"
    )
