"""Geometric multigrid tests: transfer operator identities, V-cycle
contraction, and preconditioned iteration counts across viscosity contrasts
(SURVEY.md §7.2 step 6 / §7.3 risk 1)."""
import numpy as np
import jax.numpy as jnp
import pytest
from functools import partial

from pylamp_tpu.core.grid import StaggeredGrid
from pylamp_tpu.core.bc import VelocityBCs
from pylamp_tpu.solvers.krylov import tnorm
from pylamp_tpu.solvers.mg import (
    make_mg_preconditioner,
    make_velocity_mg,
    momentum_apply,
    prolong_vx,
    prolong_vy,
    restrict_vx,
    restrict_vy,
)
from pylamp_tpu.solvers.stokes_solver import solve_stokes

from tests.test_solvers import _falling_block

RNG = np.random.default_rng(7)


@pytest.mark.parametrize(
    "P,R,cshape,fshape",
    [
        (prolong_vx, restrict_vx, (8, 9), (16, 17)),
        (prolong_vy, restrict_vy, (9, 8), (17, 16)),
    ],
)
@pytest.mark.parametrize("slip", ["free_slip", "no_slip"])
def test_transfer_adjointness(P, R, cshape, fshape, slip):
    """restriction == P^T / 4 exactly (including BC ghost folding and
    Dirichlet-subspace projection)."""
    bcs = VelocityBCs(top=slip, bottom=slip, left=slip, right=slip)
    c = jnp.asarray(RNG.normal(size=cshape))
    f = jnp.asarray(RNG.normal(size=fshape))
    lhs = float(jnp.vdot(P(c, bcs), f))
    rhs = float(jnp.vdot(c, 4.0 * R(f, bcs)))
    assert abs(lhs - rhs) < 1e-12 * max(1.0, abs(lhs))


def _probe(fn, shape):
    """The matrix of the linear map ``fn`` on arrays of ``shape``, by
    applying it to every unit vector."""
    import jax

    n = int(np.prod(shape))
    cols = jax.vmap(lambda e: fn(e.reshape(shape)).ravel())(jnp.eye(n))
    return np.asarray(cols).T


@pytest.mark.parametrize("bc", ["free_slip", "no_slip"])
@pytest.mark.parametrize("ny,nx", [(16, 24), (32, 32)])
def test_restriction_is_scaled_prolongation_transpose(bc, ny, nx):
    """As matrices built by probing: R = P^T / 4 on both velocity
    lattices (BC ghost folding and the Dirichlet projection included)."""
    bcs = VelocityBCs(top=bc, bottom=bc, left=bc, right=bc)
    for P, R, fshape, cshape in (
        (prolong_vx, restrict_vx, (ny, nx + 1), (ny // 2, nx // 2 + 1)),
        (prolong_vy, restrict_vy, (ny + 1, nx), (ny // 2 + 1, nx // 2)),
    ):
        Pm = _probe(lambda c: P(c, bcs), cshape)
        Rm = _probe(lambda f: R(f, bcs), fshape)
        assert Pm.shape == (int(np.prod(fshape)), int(np.prod(cshape)))
        np.testing.assert_allclose(Rm, Pm.T / 4.0, atol=1e-15)


def test_vcycle_contracts_isoviscous():
    grid = StaggeredGrid(nx=64, ny=64, lx=1.0, ly=1.0)
    bcs = VelocityBCs()
    eta_s = jnp.ones(grid.shape_corner)
    eta_n = jnp.ones(grid.shape_center)
    kbnd = 4.0 / min(grid.dx, grid.dy) ** 2
    mg = make_velocity_mg(eta_s, eta_n, grid, bcs, kbnd, pre_smooth=3, post_smooth=3)

    rx = jnp.asarray(RNG.normal(size=grid.shape_vx)).at[:, 0].set(0).at[:, -1].set(0)
    ry = jnp.asarray(RNG.normal(size=grid.shape_vy)).at[0, :].set(0).at[-1, :].set(0)
    ex = jnp.zeros_like(rx)
    ey = jnp.zeros_like(ry)
    r0 = float(tnorm((rx, ry)))
    for _ in range(5):
        ax, ay = momentum_apply(ex, ey, eta_s, eta_n, grid, bcs, kbnd)
        dx_, dy_ = mg(rx - ax, ry - ay)
        ex, ey = ex + dx_, ey + dy_
    ax, ay = momentum_apply(ex, ey, eta_s, eta_n, grid, bcs, kbnd)
    rel = float(tnorm((rx - ax, ry - ay))) / r0
    assert rel < 5e-3, rel  # ~0.3/cycle contraction or better


@pytest.mark.parametrize("contrast,max_iters", [(1.0, 25), (100.0, 80), (1e4, 400)])
def test_mg_preconditioned_iteration_counts(contrast, max_iters):
    grid = StaggeredGrid(nx=64, ny=64, lx=1.0, ly=1.0)
    bcs = VelocityBCs()
    eta_s, eta_n, rho_vx, rho_vy = _falling_block(grid, contrast)
    sol = solve_stokes(
        jnp.asarray(eta_s), jnp.asarray(eta_n),
        jnp.asarray(rho_vx), jnp.asarray(rho_vy), 0.0, 1.0, grid, bcs,
        tol=1e-8, restart=60, maxiter=500,
        make_preconditioner=partial(make_mg_preconditioner, pre_smooth=3, post_smooth=3),
    )
    assert bool(sol.info.converged)
    assert int(sol.info.iterations) <= max_iters, int(sol.info.iterations)


def test_mg_mesh_independence_isoviscous():
    """Iteration count must not grow with resolution (the whole point of
    multigrid; the reference's spsolve cost grows superlinearly)."""
    iters = []
    for n in (32, 64):
        grid = StaggeredGrid(nx=n, ny=n, lx=1.0, ly=1.0)
        bcs = VelocityBCs()
        eta_s, eta_n, rho_vx, rho_vy = _falling_block(grid, 1.0)
        sol = solve_stokes(
            jnp.asarray(eta_s), jnp.asarray(eta_n),
            jnp.asarray(rho_vx), jnp.asarray(rho_vy), 0.0, 1.0, grid, bcs,
            tol=1e-8, restart=60, maxiter=200,
            make_preconditioner=make_mg_preconditioner,
        )
        assert bool(sol.info.converged)
        iters.append(int(sol.info.iterations))
    assert iters[1] <= iters[0] + 10, iters


def test_mg_eta_capped_hierarchy_converges_sharp_contrast():
    """mg_eta_cap clips COARSE-level viscosity around the level geometric
    mean (sharp-interface remedy; measured ~20% outer-iteration cut on
    spec sticky air).  The fine level keeps the true operator, so the
    preconditioner change must not change the answer — only the path."""
    from tests.test_vanka import _sharp_problem

    grid, bcs, eta_s, eta_n, rho_vx, rho_vy = _sharp_problem(nx=48)

    sols = {}
    for cap in (0.0, 1e2):
        sols[cap] = solve_stokes(
            eta_s, eta_n, rho_vx, rho_vy, 0.0, 1.0, grid, bcs,
            tol=1e-8, restart=60, maxiter=1500,
            make_preconditioner=partial(
                make_mg_preconditioner, pre_smooth=8, post_smooth=8,
                velocity_inner_iters=10, velocity_inner_tol=1e-2,
                eta_cap=cap,
            ),
        )
        assert bool(sols[cap].info.converged), cap
    ref = sols[0.0]
    got = sols[1e2]
    scale = float(jnp.max(jnp.abs(ref.vy)))
    assert float(jnp.max(jnp.abs(got.vx - ref.vx))) < 1e-6 * scale
    assert float(jnp.max(jnp.abs(got.vy - ref.vy))) < 1e-6 * scale
