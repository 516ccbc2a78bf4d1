"""Krylov solvers must reproduce the oracle's direct spsolve solutions
(SURVEY.md §4: the iterative path replaces SuperLU; equivalence to the
assembled-matrix solve is the core parity test)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pylamp_tpu.core.grid import StaggeredGrid
from pylamp_tpu.core.bc import ThermalBC, ThermalBCs, VelocityBCs
from pylamp_tpu.solvers.krylov import cg, fgmres
from pylamp_tpu.solvers.stokes_solver import solve_stokes
from pylamp_tpu.solvers.energy_solver import solve_energy

from tests.oracle.stokes_oracle import StokesOracle
from tests.oracle.energy_oracle import EnergyOracle

RNG = np.random.default_rng(42)


def test_cg_dense_spd():
    n = 40
    Q = RNG.normal(size=(n, n))
    A = Q @ Q.T + n * np.eye(n)
    b = RNG.normal(size=n)
    x, info = cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), jnp.zeros(n), tol=1e-12)
    assert bool(info.converged)
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b), rtol=1e-8)


def test_fgmres_dense_nonsymmetric():
    n = 50
    A = RNG.normal(size=(n, n)) + n * np.eye(n)
    b = RNG.normal(size=n)
    # pytree unknown: split the vector in two leaves to exercise tree ops
    A1, A2 = A[:, :20], A[:, 20:]

    def op(u):
        u1, u2 = u
        r = A1 @ u1 + A2 @ u2
        return r[:20], r[20:]

    x, info = fgmres(op, (jnp.asarray(b[:20]), jnp.asarray(b[20:])),
                     (jnp.zeros(20), jnp.zeros(30)), tol=1e-12, restart=15, maxiter=200)
    assert bool(info.converged)
    got = np.concatenate([np.asarray(x[0]), np.asarray(x[1])])
    np.testing.assert_allclose(got, np.linalg.solve(A, b), rtol=1e-7, atol=1e-9)


def _falling_block(grid, eta_block=1.0):
    """Isoviscous(ish) falling block: dense square in the domain center."""
    eta_s = np.ones(grid.shape_corner)
    eta_n = np.ones(grid.shape_center)
    Yc, Xc = np.meshgrid(grid.y_corner, grid.x_corner, indexing="ij")

    def in_block(X, Y):
        return ((np.abs(X - grid.lx / 2) < grid.lx / 5) &
                (np.abs(Y - grid.ly / 2) < grid.ly / 5))

    eta_s = np.where(in_block(Xc, Yc), eta_block, eta_s)
    Ycc, Xcc = np.meshgrid(grid.y_center, grid.x_center, indexing="ij")
    eta_n = np.where(in_block(Xcc, Ycc), eta_block, eta_n)

    rho_vx = np.ones(grid.shape_vx)
    Yvx, Xvx = np.meshgrid(grid.y_center, grid.x_corner, indexing="ij")
    rho_vx = np.where(in_block(Xvx, Yvx), 2.0, rho_vx)
    rho_vy = np.ones(grid.shape_vy)
    Yvy, Xvy = np.meshgrid(grid.y_corner, grid.x_center, indexing="ij")
    rho_vy = np.where(in_block(Xvy, Yvy), 2.0, rho_vy)
    return eta_s, eta_n, rho_vx, rho_vy


@pytest.mark.parametrize("eta_block", [1.0, 100.0])
def test_stokes_solve_matches_oracle(eta_block):
    grid = StaggeredGrid(nx=16, ny=16, lx=1.0, ly=1.0)
    bcs = VelocityBCs()
    eta_s, eta_n, rho_vx, rho_vy = _falling_block(grid, eta_block)
    gx, gy = 0.0, 1.0

    oracle = StokesOracle(grid.nx, grid.ny, grid.lx, grid.ly, bcs)
    vx_o, vy_o, p_o = oracle.solve(eta_s, eta_n, rho_vx, rho_vy, gx, gy)

    # Plain block-Jacobi preconditioning needs a generous restart at high
    # viscosity contrast (truncation stalls it); the multigrid
    # preconditioner (solvers/mg.py) is the production path.
    restart = 40 if eta_block == 1.0 else 150
    sol = solve_stokes(
        jnp.asarray(eta_s), jnp.asarray(eta_n),
        jnp.asarray(rho_vx), jnp.asarray(rho_vy), gx, gy,
        grid, bcs, tol=1e-10, restart=restart, maxiter=4000,
    )
    assert bool(sol.info.converged), sol.info
    vscale = np.abs(vy_o).max()
    np.testing.assert_allclose(np.asarray(sol.vx), vx_o, atol=1e-6 * vscale)
    np.testing.assert_allclose(np.asarray(sol.vy), vy_o, atol=1e-6 * vscale)
    pscale = np.abs(p_o).max()
    np.testing.assert_allclose(np.asarray(sol.p), p_o, atol=1e-5 * pscale)


def test_energy_solve_matches_oracle():
    grid = StaggeredGrid(nx=12, ny=10, lx=1.0, ly=1.0)
    bcs = ThermalBCs(
        top=ThermalBC("dirichlet", 0.0),
        bottom=ThermalBC("dirichlet", 1.0),
        left=ThermalBC("neumann", 0.0),
        right=ThermalBC("neumann", 0.3),
    )
    k = np.exp(RNG.normal(size=grid.shape_corner) * 0.5)
    rhocp_dt = np.full(grid.shape_corner, 50.0)
    T0 = RNG.normal(size=grid.shape_corner) * 0.1 + 0.5
    H = np.full(grid.shape_corner, 0.2)

    oracle = EnergyOracle(grid.nx, grid.ny, grid.lx, grid.ly, bcs)
    kbnd = float(np.mean(rhocp_dt) + 4.0 * np.mean(k) / min(grid.dx, grid.dy) ** 2)
    A = oracle.assemble(k, rhocp_dt, kbnd=kbnd)
    import scipy.sparse.linalg as spla
    T_o = spla.spsolve(A, oracle.rhs(T0.copy(), k, rhocp_dt, H.copy(), kbnd=kbnd)).reshape(
        grid.shape_corner
    )

    sol = solve_energy(
        jnp.asarray(T0), jnp.asarray(k), jnp.asarray(rhocp_dt), jnp.asarray(H),
        grid, bcs, tol=1e-12,
    )
    assert bool(sol.info.converged)
    np.testing.assert_allclose(np.asarray(sol.T), T_o, rtol=1e-8, atol=1e-10)
