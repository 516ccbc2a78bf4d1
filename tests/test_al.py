"""Augmented-Lagrangian grad-div acceleration (solvers/al.py).

The AL is a pure row operation: the augmented system must have the SAME
solution.  These tests pin (a) the discrete adjointness D^T = -G the
formulation relies on, (b) SPD-ness of the grad-div term on the free
DOFs, and (c) end-to-end solution equality on a variable-viscosity solve.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pylamp_tpu.core.bc import VelocityBCs
from pylamp_tpu.core.grid import StaggeredGrid
from pylamp_tpu.solvers.al import make_grad_div
from pylamp_tpu.solvers.mg import _pressure_gradient


GRID = StaggeredGrid(nx=32, ny=24, lx=1.5, ly=1.0)


def _rand_fields(seed=3):
    rng = np.random.default_rng(seed)
    vx = jnp.asarray(rng.normal(size=GRID.shape_vx))
    vy = jnp.asarray(rng.normal(size=GRID.shape_vy))
    q = jnp.asarray(rng.normal(size=GRID.shape_center))
    return vx, vy, q


def test_discrete_adjointness():
    """<Gq, u> == -<q, Du> on the free DOFs (G zeroes Dirichlet faces; u
    restricted to zero on them so D sees the same subspace)."""
    bcs = VelocityBCs()
    vx, vy, q = _rand_fields()
    vx = vx.at[:, 0].set(0.0).at[:, -1].set(0.0)
    vy = vy.at[0, :].set(0.0).at[-1, :].set(0.0)
    gx, gy = _pressure_gradient(q, GRID, vx.dtype, bcs=bcs)
    du = (vx[:, 1:] - vx[:, :-1]) / GRID.dx + (vy[1:, :] - vy[:-1, :]) / GRID.dy
    lhs = float(jnp.vdot(gx, vx) + jnp.vdot(gy, vy))
    rhs = float(-jnp.vdot(q, du))
    assert abs(lhs - rhs) < 1e-12 * max(abs(lhs), 1.0)


def test_grad_div_spd():
    """-<gd(u), u> = gamma <Du, eta Du> >= 0 on the free subspace (gd
    returns the term to ADD, which is -G(w Du) = +D^T w D u)."""
    rng = np.random.default_rng(11)
    eta_n = jnp.asarray(np.exp(rng.normal(size=GRID.shape_center)))
    gd = make_grad_div(eta_n, GRID, VelocityBCs(), 0.7, jnp.float64)
    for seed in range(3):
        vx, vy, _ = _rand_fields(seed)
        vx = vx.at[:, 0].set(0.0).at[:, -1].set(0.0)
        vy = vy.at[0, :].set(0.0).at[-1, :].set(0.0)
        tx, ty = gd(vx, vy)
        quad = float(jnp.vdot(tx, vx) + jnp.vdot(ty, vy))
        assert quad >= 0.0


@pytest.mark.parametrize("gamma", [0.3, 1.0])
def test_al_solution_matches_plain(gamma):
    """Sharp two-layer viscosity jump: the AL solve must return the same
    velocity/pressure as the plain solve (both to 1e-8 rel residual), in
    fewer or equal outer iterations."""
    from functools import partial

    from pylamp_tpu.solvers.mg import make_mg_preconditioner
    from pylamp_tpu.solvers.stokes_solver import solve_stokes_mixed

    g = StaggeredGrid(nx=64, ny=64, lx=1.0, ly=1.0)
    bcs = VelocityBCs()
    yc = (jnp.arange(g.ny) + 0.5) * g.dy
    xc = (jnp.arange(g.nx) + 0.5) * g.dx
    Y, X = jnp.meshgrid(yc, xc, indexing="ij")
    eta_n = jnp.where(Y < 0.25, 1e-2, jnp.where(Y < 0.5, 1e2, 1.0))
    yn = jnp.arange(g.ny + 1) * g.dy
    Yn, _ = jnp.meshgrid(yn, jnp.arange(g.nx + 1) * g.dx, indexing="ij")
    eta_s = jnp.where(Yn < 0.25, 1e-2, jnp.where(Yn < 0.5, 1e2, 1.0))
    rho_vy = jnp.where(
        (Yn[:, :-1] > 0.3) & (Yn[:, :-1] < 0.5)
        & (jnp.abs(jnp.meshgrid(yn, xc, indexing="ij")[1] - 0.5) < 0.2),
        2.0, 1.0)
    rho_vx = jnp.zeros(g.shape_vx)

    def solve(al):
        mk = partial(make_mg_preconditioner,
                     velocity_inner_iters=8, velocity_inner_tol=1e-2,
                     al_gamma=al)
        return solve_stokes_mixed(
            eta_s, eta_n, rho_vx, rho_vy, 0.0, 1.0, g, bcs,
            tol=1e-8, restart=40, maxiter=600,
            make_preconditioner=mk, al_gamma=al,
        )

    plain = solve(0.0)
    aug = solve(gamma)
    assert bool(plain.info.converged) and bool(aug.info.converged)
    vscale = float(jnp.max(jnp.abs(plain.vy)))
    np.testing.assert_allclose(np.asarray(aug.vx), np.asarray(plain.vx),
                               atol=1e-6 * vscale)
    np.testing.assert_allclose(np.asarray(aug.vy), np.asarray(plain.vy),
                               atol=1e-6 * vscale)
    pscale = float(jnp.max(jnp.abs(plain.p)))
    np.testing.assert_allclose(np.asarray(aug.p), np.asarray(plain.p),
                               atol=1e-5 * pscale)


@pytest.mark.slow
def test_sticky_air_preset_al_production_step():
    """The sticky-air production preset ships stokes_al_gamma=10 (66 outer
    iterations at spec against 144 without AL) — the full fused step
    must converge with the augmented operator + (1+gamma)-scaled Schur
    surrogate wired through models/step.py."""
    import dataclasses

    from pylamp_tpu.models.benchmarks import sticky_air
    from pylamp_tpu.models.setup import build
    from pylamp_tpu.models.step import make_step

    cfg = sticky_air(nx=64, ny=16, max_steps=2)
    assert cfg.solver.stokes_al_gamma == 10.0
    # keep the tiny-grid solve cheap but leave AL + inner solve active
    cfg = dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, mg_levels=3))
    grid, table, state = build(cfg, jnp.float32)
    step = jax.jit(make_step(grid, cfg, table))
    for _ in range(2):
        state, diag = step(state)
    assert bool(diag["stokes_converged"])
    assert float(diag["stokes_residual_rel"]) <= cfg.solver.stokes_tol * 1.01
    assert np.isfinite(float(jnp.max(jnp.abs(state.vy))))
