"""Every dot product of the solvers asks for full precision (read from the
traced jaxpr): on a GPU an f32 dot without it may run in TF32 and quietly
spoil the Krylov basis."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from pylamp_tpu.core.bc import VelocityBCs
from pylamp_tpu.core.grid import StaggeredGrid
from pylamp_tpu.ops.stokes import stokes_operator
from pylamp_tpu.solvers import krylov
from pylamp_tpu.solvers.mg import make_mg_preconditioner
from pylamp_tpu.solvers.stokes_solver import solve_stokes_mixed

GRID = StaggeredGrid(nx=8, ny=8, lx=1.0, ly=1.0)
HIGHEST = lax.Precision.HIGHEST


def _dot_precisions(jaxpr):
    """The precision of every dot_general in ``jaxpr`` and its sub-jaxprs."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out += _dot_precisions(sub)
    return out


def _fields(dtype):
    rng = np.random.default_rng(1)
    es = jnp.asarray(np.exp(rng.normal(size=GRID.shape_corner)), dtype)
    en = jnp.asarray(np.exp(rng.normal(size=GRID.shape_center)), dtype)
    b = tuple(jnp.asarray(rng.normal(size=s), dtype)
              for s in (GRID.shape_vx, GRID.shape_vy, GRID.shape_center))
    return es, en, b


def _fgmres(passes):
    es, en, b = _fields(jnp.float32)
    op = lambda u: stokes_operator(*u, es, en, GRID, VelocityBCs())
    x0 = jax.tree.map(jnp.zeros_like, b)
    return lambda: krylov.fgmres(op, b, x0, restart=5, maxiter=10,
                                 cgs_passes=passes)


def _cg(method):
    rng = np.random.default_rng(2)
    m = rng.normal(size=(6, 6)).astype(np.float32)
    A = jnp.asarray(m @ m.T + 6 * np.eye(6, dtype=np.float32))
    b = jnp.ones((6,), jnp.float32)
    op = lambda x: jnp.sum(A * x[None, :], axis=1)
    return lambda: method(op, b, jnp.zeros_like(b), maxiter=10)


def _stokes_mixed():
    es, en, _ = _fields(jnp.float64)
    rho = jnp.ones(GRID.shape_vy)
    return lambda: solve_stokes_mixed(
        es, en, jnp.zeros(GRID.shape_vx), rho, 0.0, 1.0, GRID, VelocityBCs(),
        maxiter=20, make_preconditioner=functools.partial(
            make_mg_preconditioner, levels=2))


@pytest.mark.parametrize("build", [
    pytest.param(lambda: _fgmres(1), id="fgmres_cgs1"),
    pytest.param(lambda: _fgmres(2), id="fgmres_cgs2"),
    pytest.param(lambda: _cg(krylov.cg), id="cg"),
    pytest.param(lambda: _cg(krylov.fcg), id="fcg"),
    pytest.param(_stokes_mixed, id="stokes_mixed_mg"),
])
def test_solver_dots_are_highest_precision(build):
    precs = _dot_precisions(jax.make_jaxpr(build())().jaxpr)
    assert precs, "no dot product traced"
    for p in precs:
        assert p == (HIGHEST, HIGHEST), p
