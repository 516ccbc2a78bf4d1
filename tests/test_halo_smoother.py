"""The MG Chebyshev smoother under the explicit-halo engine (every apply
through parallel/halo_ops.py on the 8-virtual-device CPU mesh) against the
same smoother on a single device, in f64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pylamp_tpu.core.bc import VelocityBCs
from pylamp_tpu.core.grid import StaggeredGrid
from pylamp_tpu.parallel.halo_ops import halo_eligible
from pylamp_tpu.parallel.mesh import make_mesh
from pylamp_tpu.solvers.mg import chebyshev_smooth

GRID = StaggeredGrid(nx=64, ny=64, lx=1.3, ly=1.0)


@pytest.fixture(scope="module")
def mesh():
    m = make_mesh(8)
    assert halo_eligible(GRID, m)
    return m


def _fields(seed, zero_init):
    rng = np.random.default_rng(seed)
    eta_s = np.exp(rng.standard_normal(GRID.shape_corner) * 2.0)
    eta_n = np.exp(rng.standard_normal(GRID.shape_center) * 2.0)
    rx = rng.standard_normal(GRID.shape_vx)
    ry = rng.standard_normal(GRID.shape_vy)
    ex = np.zeros(GRID.shape_vx) if zero_init else rng.standard_normal(GRID.shape_vx)
    ey = np.zeros(GRID.shape_vy) if zero_init else rng.standard_normal(GRID.shape_vy)
    return tuple(jnp.asarray(a) for a in (ex, ey, rx, ry, eta_s, eta_n))


def _compare(mesh, bcs, iters, zero_init, emit, seed, kbnd, lam):
    args = _fields(seed, zero_init)

    def run(halo_mesh):
        return jax.jit(lambda *a: chebyshev_smooth(
            *a, GRID, bcs, kbnd, jnp.asarray(lam), iters, zero_init=zero_init,
            emit_residual=emit, halo_mesh=halo_mesh))(*args)

    want = run(None)
    got = run(mesh)
    assert len(got) == len(want) == (4 if emit else 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   atol=1e-12 * float(jnp.max(jnp.abs(w))))


@pytest.mark.parametrize(
    "iters,zero_init", [(3, False), (3, True), (2, False), (1, True),
                        (5, False)]
)
@pytest.mark.parametrize("bc", ["free_slip", "no_slip"])
def test_halo_smoother_matches_single_device(mesh, iters, zero_init, bc):
    bcs = VelocityBCs(top=bc, bottom=bc, left=bc, right=bc)
    _compare(mesh, bcs, iters, zero_init, False, 5 + iters, 7.5, 3.7)


@pytest.mark.parametrize("iters,zero_init", [(2, True), (3, False)])
def test_halo_smoother_emit_residual(mesh, iters, zero_init):
    """emit_residual under the halo engine: the residual of the smoothed
    iterate, as on one device."""
    _compare(mesh, VelocityBCs(), iters, zero_init, True, 31 + iters, 2.5, 4.1)
