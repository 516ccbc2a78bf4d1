"""End-to-end timestep parity: our fully iterative matrix-free step vs a
reference-style step that uses the SAME marker pipeline but solves Stokes
with the oracle's assembled matrix + direct spsolve (the reference's method,
SURVEY.md §3.2).  This is the '1e-8 relative residual vs the CPU reference'
parity test of BASELINE.json, made executable."""
import numpy as np
import jax
import jax.numpy as jnp

from pylamp_tpu.core.bc import VelocityBCs
from pylamp_tpu.markers.advect import advect_rk4
from pylamp_tpu.markers.interp import markers_to_grid
from pylamp_tpu.models.benchmarks import falling_block
from pylamp_tpu.models.config import SolverConfig
from pylamp_tpu.models.setup import build
from pylamp_tpu.models.step import make_step
from pylamp_tpu.physics.materials import MaterialTable

from tests.oracle.stokes_oracle import StokesOracle

import dataclasses


def _reference_style_step(state, grid, cfg, table):
    """One timestep the reference's way: same interp/advection code, Stokes
    via assembled matrix + spsolve."""
    m = state.markers
    phys = cfg.physics
    rho_m = table.density(m.mat, m.T)
    eta_m = jnp.clip(table.viscosity_of(m.mat, m.T), phys.eta_min, phys.eta_max)

    eta_s, _ = markers_to_grid(m.x, m.y, eta_m, grid, "corner", phys.eta_avg)
    eta_n, _ = markers_to_grid(m.x, m.y, eta_m, grid, "center", phys.eta_avg)
    rho_vy, _ = markers_to_grid(m.x, m.y, rho_m, grid, "vy", "arithmetic")

    oracle = StokesOracle(grid.nx, grid.ny, grid.lx, grid.ly, phys.velocity_bcs)
    vx, vy, p = oracle.solve(
        np.asarray(eta_s), np.asarray(eta_n),
        np.zeros(grid.shape_vx), np.asarray(rho_vy), phys.gx, phys.gy,
    )
    vx, vy = jnp.asarray(vx), jnp.asarray(vy)

    vmax_x, vmax_y = jnp.max(jnp.abs(vx)), jnp.max(jnp.abs(vy))
    dt = cfg.time.courant * jnp.minimum(grid.dx / vmax_x, grid.dy / vmax_y)
    px, py = advect_rk4(m.x, m.y, vx, vy, dt, grid, phys.velocity_bcs)
    return state.replace(
        markers=m.replace(x=px, y=py), vx=vx, vy=vy, p=jnp.asarray(p), dt=dt
    ), dt


def test_falling_block_step_matches_reference_path():
    cfg = falling_block(nx=16, ny=16, max_steps=3)
    cfg = dataclasses.replace(
        cfg, marker_engine="flat",  # flat semantics match the reference path 1:1
        solver=SolverConfig(stokes_tol=1e-11, stokes_restart=60,
                            stokes_maxiter=4000, preconditioner="jacobi")
    )
    grid, table, state0 = build(cfg)
    step = jax.jit(make_step(grid, cfg, table))

    ours = state0
    ref = state0
    for _ in range(3):
        ours, diag = step(ours)
        assert bool(diag["stokes_converged"])
        ref, _ = _reference_style_step(ref, grid, cfg, table)

    vscale = float(jnp.max(jnp.abs(ref.vy)))
    np.testing.assert_allclose(np.asarray(ours.vx), np.asarray(ref.vx),
                               atol=1e-7 * vscale)
    np.testing.assert_allclose(np.asarray(ours.vy), np.asarray(ref.vy),
                               atol=1e-7 * vscale)
    # marker positions agree to interpolation precision
    np.testing.assert_allclose(np.asarray(ours.markers.x), np.asarray(ref.markers.x),
                               atol=1e-8 * grid.lx)
    np.testing.assert_allclose(np.asarray(ours.markers.y), np.asarray(ref.markers.y),
                               atol=1e-8 * grid.ly)
    # the dense block actually sinks: mean vy over block markers > 0 (y down)
    blk = np.asarray(state0.markers.mat) == 1
    vy_blk = np.asarray(ours.vy)
    assert float(np.asarray(ours.markers.y)[blk].mean()) > float(
        np.asarray(state0.markers.y)[blk].mean()
    )


def test_step_runs_with_energy_and_is_finite():
    from pylamp_tpu.models.benchmarks import blankenbach_case1a

    cfg = blankenbach_case1a(nx=16, ny=16, max_steps=3)
    cfg = dataclasses.replace(
        cfg, solver=SolverConfig(stokes_tol=1e-8, stokes_restart=60,
                                 stokes_maxiter=3000, preconditioner="jacobi")
    )  # default bucket engine: exercises the dense marker path end-to-end
    grid, table, state = build(cfg)
    step = jax.jit(make_step(grid, cfg, table))
    for _ in range(3):
        state, diag = step(state)
        assert bool(diag["stokes_converged"]), diag
        assert np.isfinite(float(diag["vrms"]))
        assert np.isfinite(float(diag["T_mean"]))
    # convection should be starting: vrms > 0, T stays within [0, 1] + eps
    assert float(diag["vrms"]) > 1.0
    T = np.asarray(state.T)
    assert T.min() > -0.2 and T.max() < 1.2
