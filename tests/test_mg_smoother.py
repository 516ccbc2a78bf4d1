"""The multigrid Chebyshev smoother (solvers/mg.py chebyshev_smooth) against
a numpy Chebyshev recurrence on the oracle's assembled momentum block
(tests/oracle/stokes_oracle.py), in f64."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from pylamp_tpu.core.bc import VelocityBCs
from pylamp_tpu.core.grid import StaggeredGrid
from pylamp_tpu.solvers.mg import chebyshev_smooth
from pylamp_tpu.solvers.stokes_solver import velocity_diagonals

from tests.oracle.stokes_oracle import StokesOracle

GRID = StaggeredGrid(nx=24, ny=16, lx=2.0, ly=1.0)
KBND = 7.5
LAM = 3.7


def _bcs(bc, periodic):
    side = "periodic" if periodic else bc
    return VelocityBCs(top=bc, bottom=bc, left=side, right=side)


def _fields(seed, zero_init, periodic):
    rng = np.random.default_rng(seed)
    eta_s = np.exp(rng.standard_normal(GRID.shape_corner) * 2.0)
    eta_n = np.exp(rng.standard_normal(GRID.shape_center) * 2.0)
    rx = rng.standard_normal(GRID.shape_vx)
    ry = rng.standard_normal(GRID.shape_vy)
    ex = np.zeros(GRID.shape_vx) if zero_init else rng.standard_normal(GRID.shape_vx)
    ey = np.zeros(GRID.shape_vy) if zero_init else rng.standard_normal(GRID.shape_vy)
    if periodic:
        # seam conventions: corner viscosity, residual and solution-like
        # arrays carry equal values in vx columns 0 and nx
        eta_s[:, -1] = eta_s[:, 0]
        rx[:, -1] = rx[:, 0]
        ex[:, -1] = ex[:, 0]
    return ex, ey, rx, ry, eta_s, eta_n


@functools.lru_cache(maxsize=None)
def _momentum_block(bc, periodic, seed):
    _, _, _, _, eta_s, eta_n = _fields(seed, True, periodic)
    oracle = StokesOracle(GRID.nx, GRID.ny, GRID.lx, GRID.ly, _bcs(bc, periodic))
    nv = oracle.nvx + oracle.nvy
    return oracle.assemble(eta_s, eta_n, kcont=1.0, kbnd=KBND)[:nv, :nv].tocsr()


def _numpy_chebyshev(A, D, e, r, lam, iters, zero_init):
    """Saad's Chebyshev acceleration of Jacobi on D^-1 A over
    [lam/4, lam], written against the assembled matrix."""
    lmin = lam / 4.0
    theta, delta = 0.5 * (lam + lmin), 0.5 * (lam - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    res = r if zero_init else r - A @ e
    d = res / D / theta
    e = e + d
    for _ in range(iters - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * (r - A @ e) / D
        e = e + d
        rho = rho_new
    return e


def _check_case(iters, zero_init, bc, periodic, emit, seed):
    bcs = _bcs(bc, periodic)
    ex, ey, rx, ry, eta_s, eta_n = _fields(seed, zero_init, periodic)
    A = _momentum_block(bc, periodic, seed)
    dvx, dvy = velocity_diagonals(jnp.asarray(eta_s), jnp.asarray(eta_n),
                                  GRID, KBND, bcs=bcs)
    D = np.concatenate([np.asarray(dvx).ravel(), np.asarray(dvy).ravel()])
    pack = lambda a, b: np.concatenate([np.asarray(a).ravel(), np.asarray(b).ravel()])

    want = _numpy_chebyshev(A, D, pack(ex, ey), pack(rx, ry), LAM, iters,
                            zero_init)
    out = chebyshev_smooth(*(jnp.asarray(a) for a in (ex, ey, rx, ry, eta_s, eta_n)),
                           GRID, bcs, KBND, jnp.asarray(LAM), iters,
                           zero_init=zero_init, emit_residual=emit)
    got = pack(out[0], out[1])
    np.testing.assert_allclose(got, want, atol=1e-11 * np.max(np.abs(want)))
    if periodic:  # the seam columns stay one physical DOF
        np.testing.assert_allclose(np.asarray(out[0])[:, 0],
                                   np.asarray(out[0])[:, -1], rtol=1e-12)
    if emit:
        res_want = pack(rx, ry) - A @ want
        np.testing.assert_allclose(pack(out[2], out[3]), res_want,
                                   atol=1e-11 * np.max(np.abs(A @ want)))


@pytest.mark.parametrize(
    "iters,zero_init",
    [(3, False), (3, True), (2, False), (1, False), (4, False), (5, True),
     (7, False)],
)
@pytest.mark.parametrize("bc", ["free_slip", "no_slip"])
def test_chebyshev_smoother_matches_numpy(iters, zero_init, bc):
    _check_case(iters, zero_init, bc, periodic=False, emit=False, seed=7)


@pytest.mark.parametrize("iters,zero_init", [(2, True), (4, True), (4, False),
                                             (6, False)])
@pytest.mark.parametrize("bc", ["free_slip", "no_slip"])
def test_chebyshev_smoother_emit_residual(iters, zero_init, bc):
    """emit_residual: the returned residual is r - A e of the smoothed e
    (the V-cycle's restriction input)."""
    _check_case(iters, zero_init, bc, periodic=False, emit=True, seed=3)


@pytest.mark.parametrize(
    "iters,zero_init,emit",
    [(3, False, False), (3, True, False), (1, False, False),
     (5, True, False), (7, False, False), (2, True, True), (4, False, True)],
)
@pytest.mark.parametrize("bc", ["free_slip", "no_slip"])
def test_chebyshev_smoother_periodic(iters, zero_init, emit, bc):
    """Wrapped ghost columns + half-convention seam rows under periodic
    side walls."""
    _check_case(iters, zero_init, bc, periodic=True, emit=emit, seed=17)
