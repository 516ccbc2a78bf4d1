"""Matrix-free operators must reproduce the independently assembled oracle
matrices to near machine precision (SURVEY.md §4 'unit' tier)."""
import numpy as np
import jax.numpy as jnp
import pytest

from pylamp_tpu.core.grid import StaggeredGrid
from pylamp_tpu.core.bc import VelocityBCs, ThermalBC, ThermalBCs
from pylamp_tpu.ops.stokes import stokes_operator, stokes_rhs
from pylamp_tpu.ops.energy import energy_operator, energy_rhs

from tests.oracle.stokes_oracle import StokesOracle
from tests.oracle.energy_oracle import EnergyOracle

RNG = np.random.default_rng(0)


def _rand_fields(grid):
    eta_s = np.exp(RNG.normal(size=grid.shape_corner) * 2.0)
    eta_n = np.exp(RNG.normal(size=grid.shape_center) * 2.0)
    vx = RNG.normal(size=grid.shape_vx)
    vy = RNG.normal(size=grid.shape_vy)
    p = RNG.normal(size=grid.shape_center)
    return eta_s, eta_n, vx, vy, p


@pytest.mark.parametrize("slip", ["free_slip", "no_slip"])
@pytest.mark.parametrize("nx,ny", [(7, 5), (8, 8)])
def test_stokes_operator_matches_oracle(slip, nx, ny):
    grid = StaggeredGrid(nx=nx, ny=ny, lx=1.3, ly=0.9)
    bcs = VelocityBCs(top=slip, bottom="free_slip", left=slip, right="no_slip")
    eta_s, eta_n, vx, vy, p = _rand_fields(grid)
    kcont, kbnd = 3.7, 11.0

    oracle = StokesOracle(nx, ny, grid.lx, grid.ly, bcs)
    A = oracle.assemble(eta_s, eta_n, kcont=kcont, kbnd=kbnd)
    want = A @ oracle.pack(vx, vy, p)

    rx, ry, rc = stokes_operator(
        jnp.asarray(vx), jnp.asarray(vy), jnp.asarray(p),
        jnp.asarray(eta_s), jnp.asarray(eta_n), grid, bcs,
        kcont=kcont, kbnd=kbnd,
    )
    got = oracle.pack(np.asarray(rx), np.asarray(ry), np.asarray(rc))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _seam_fields(grid, periodic, seed):
    """Random f64 fields; under periodic side walls vx and eta_s carry equal
    values in columns 0 and nx (one physical node)."""
    rng = np.random.default_rng(seed)
    eta_s = np.exp(rng.normal(size=grid.shape_corner) * 2.0)
    eta_n = np.exp(rng.normal(size=grid.shape_center) * 2.0)
    vx = rng.normal(size=grid.shape_vx)
    vy = rng.normal(size=grid.shape_vy)
    p = rng.normal(size=grid.shape_center)
    if periodic:
        vx[:, -1] = vx[:, 0]
        eta_s[:, -1] = eta_s[:, 0]
    return eta_s, eta_n, vx, vy, p


def _apply_bcs(slip, periodic):
    side = "periodic" if periodic else "no_slip"
    return VelocityBCs(top=slip, bottom="free_slip", left=side,
                       right="periodic" if periodic else slip)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("slip", ["free_slip", "no_slip"])
@pytest.mark.parametrize("nx,ny", [(16, 16), (24, 32)])
def test_momentum_apply_matches_oracle(slip, nx, ny, periodic):
    """The MG momentum-block apply (solvers/mg.py) == the oracle's momentum
    rows at zero pressure."""
    from pylamp_tpu.solvers.mg import momentum_apply

    grid = StaggeredGrid(nx=nx, ny=ny, lx=1.3, ly=0.9)
    bcs = _apply_bcs(slip, periodic)
    eta_s, eta_n, vx, vy, _ = _seam_fields(grid, periodic, seed=11)
    kbnd = 7.5

    oracle = StokesOracle(nx, ny, grid.lx, grid.ly, bcs)
    A = oracle.assemble(eta_s, eta_n, kcont=1.0, kbnd=kbnd)
    want = A @ oracle.pack(vx, vy, np.zeros(grid.shape_center))
    rx, ry = momentum_apply(jnp.asarray(vx), jnp.asarray(vy),
                            jnp.asarray(eta_s), jnp.asarray(eta_n), grid, bcs,
                            kbnd)
    got = np.concatenate([np.asarray(rx).ravel(), np.asarray(ry).ravel()])
    want = want[: got.size]
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.max(np.abs(want)))


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("slip", ["free_slip", "no_slip"])
@pytest.mark.parametrize("nx,ny", [(16, 16), (24, 32)])
def test_saddle_apply_matches_oracle(slip, nx, ny, periodic):
    """The full saddle apply (momentum + grad p + continuity) == the
    oracle's matrix product."""
    grid = StaggeredGrid(nx=nx, ny=ny, lx=1.3, ly=0.9)
    bcs = _apply_bcs(slip, periodic)
    eta_s, eta_n, vx, vy, p = _seam_fields(grid, periodic, seed=13)
    kcont, kbnd = 3.5, 7.5

    oracle = StokesOracle(nx, ny, grid.lx, grid.ly, bcs)
    want = oracle.assemble(eta_s, eta_n, kcont=kcont, kbnd=kbnd) @ oracle.pack(vx, vy, p)
    rx, ry, rc = stokes_operator(
        *(jnp.asarray(a) for a in (vx, vy, p, eta_s, eta_n)), grid, bcs,
        kcont=kcont, kbnd=kbnd,
    )
    got = oracle.pack(np.asarray(rx), np.asarray(ry), np.asarray(rc))
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.max(np.abs(want)))


def test_stokes_rhs_matches_oracle():
    grid = StaggeredGrid(nx=6, ny=9, lx=2.0, ly=3.0)
    bcs = VelocityBCs(vn_left=0.1, vn_right=-0.1)
    rho_vx = RNG.normal(size=grid.shape_vx) + 3.0
    rho_vy = RNG.normal(size=grid.shape_vy) + 3.0
    gx, gy, kbnd = 0.5, 9.81, 7.0

    oracle = StokesOracle(grid.nx, grid.ny, grid.lx, grid.ly, bcs)
    want = oracle.rhs(rho_vx.copy(), rho_vy.copy(), gx, gy, kbnd=kbnd)
    bx, by, bc = stokes_rhs(
        jnp.asarray(rho_vx), jnp.asarray(rho_vy), gx, gy, grid, bcs,
        kbnd=kbnd, dtype=jnp.float64,
    )
    got = oracle.pack(np.asarray(bx), np.asarray(by), np.asarray(bc))
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("k_avg", ["arithmetic", "harmonic"])
@pytest.mark.parametrize(
    "bcs",
    [
        ThermalBCs(),  # dirichlet top/bottom, zero-flux sides
        ThermalBCs(
            top=ThermalBC("dirichlet", 0.0),
            bottom=ThermalBC("neumann", 2.5),
            left=ThermalBC("neumann", -1.0),
            right=ThermalBC("dirichlet", 3.0),
        ),
    ],
)
def test_energy_operator_matches_oracle(k_avg, bcs):
    nx, ny = 7, 6
    grid = StaggeredGrid(nx=nx, ny=ny, lx=1.1, ly=2.3)
    k = np.exp(RNG.normal(size=grid.shape_corner))
    rhocp_dt = np.exp(RNG.normal(size=grid.shape_corner)) * 10.0
    T = RNG.normal(size=grid.shape_corner)
    H = RNG.normal(size=grid.shape_corner)
    kbnd = 5.0

    oracle = EnergyOracle(nx, ny, grid.lx, grid.ly, bcs, k_avg=k_avg)
    A = oracle.assemble(k, rhocp_dt, kbnd=kbnd)
    want_op = A @ T.ravel()
    got_op = energy_operator(
        jnp.asarray(T), jnp.asarray(k), jnp.asarray(rhocp_dt), grid, bcs,
        kbnd=kbnd, k_avg=k_avg,
    )
    np.testing.assert_allclose(np.asarray(got_op).ravel(), want_op, rtol=1e-12, atol=1e-12)

    want_b = oracle.rhs(T.copy(), k, rhocp_dt, H.copy(), kbnd=kbnd)
    got_b = energy_rhs(
        jnp.asarray(T), jnp.asarray(k), jnp.asarray(rhocp_dt), jnp.asarray(H),
        grid, bcs, kbnd=kbnd, k_avg=k_avg,
    )
    np.testing.assert_allclose(np.asarray(got_b).ravel(), want_b, rtol=1e-12, atol=1e-12)


def test_energy_oracle_manufactured_solution():
    """MMS sanity for the shared discretization: T = sin(pi x)sin(pi y),
    k = 1 -> -lap(T) = 2 pi^2 T; steady solve (rhocp/dt -> 0 via one huge dt)
    converges at 2nd order."""
    errs = []
    for n in (8, 16, 32):
        grid = StaggeredGrid(nx=n, ny=n, lx=1.0, ly=1.0)
        bcs = ThermalBCs(
            top=ThermalBC("dirichlet", 0.0),
            bottom=ThermalBC("dirichlet", 0.0),
            left=ThermalBC("dirichlet", 0.0),
            right=ThermalBC("dirichlet", 0.0),
        )
        X, Y = np.meshgrid(grid.x_corner, grid.y_corner)
        T_exact = np.sin(np.pi * X) * np.sin(np.pi * Y)
        H = 2.0 * np.pi**2 * T_exact
        oracle = EnergyOracle(n, n, 1.0, 1.0, bcs)
        T = oracle.solve(np.zeros_like(T_exact), np.ones_like(T_exact), 1e-12, H)
        errs.append(np.abs(T - T_exact).max())
    order = np.log2(errs[0] / errs[1]), np.log2(errs[1] / errs[2])
    assert min(order) > 1.8, (errs, order)
