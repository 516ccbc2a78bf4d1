"""Augmented-Lagrangian (grad-div) Stokes acceleration for extreme sharp
viscosity contrast.

Round-4 verdict item 3: sticky-air (cell-sharp 1e4 contrast) plateaued at
~0.84-0.99 s/step with ~92-231 outer iterations, and the measured
diagnosis (models/benchmarks.py round-3/4 notes) is that the SCHUR
SURROGATE, not the velocity multigrid, is the bottleneck: with the
velocity block solved exactly the diag-mass Schur still needs > 600 outer
iterations, and wBFBT genuinely diverges on cell-sharp jumps
(solvers/bfbt.py).  The textbook remedy aimed exactly at Schur quality is
the augmented Lagrangian (Benzi & Olshanskii 2006; Farrell, Mitchell &
Wechsung 2019 for the variable-viscosity form):

    momentum rows  +=  gamma * D^T ( eta_n * (div u) )        (operator)
    rhs            +=  gamma / kcont * D^T ( eta_n * g_c )    (same row op)
    Schur surrogate:   z_p = -(1 + gamma) * eta_n / kcont * r_c

Adding multiples of the continuity ROWS to the momentum rows leaves the
solution unchanged (a pure row operation), but the augmented velocity
block A_gamma = A + gamma D^T W D makes the eta-weighted pressure mass an
O(1 + 1/gamma)-quality Schur approximation INDEPENDENT of the viscosity
contrast — the property the plain mass scaling loses at a sharp interface.
The price is a stiffer velocity block: grad-div has a large near-kernel,
so A_gamma is solved by the inner velocity Krylov (FGMRES/FCG) applying
A_gamma, PRECONDITIONED by the existing V-cycle on the un-augmented A —
robust for moderate gamma (the sticky-air preset in models/benchmarks.py
uses gamma = 10).

Discrete adjointness (uniform staggered grid): our momentum pressure-
gradient term is +G with (Gq)_vx[i] = (q[i] - q[i-1])/dx and the cell
divergence (Du) = dvx/dx + dvy/dy, which satisfy <Gq, u> = -<q, Du>
exactly on the free DOFs (Dirichlet faces carry zero G rows — the same
masking ops the pressure gradient uses), so D^T = -G and the grad-div
term is SPD on the free subspace.
"""
from __future__ import annotations

import jax.numpy as jnp

from pylamp_tpu.core.bc import VelocityBCs
from pylamp_tpu.core.grid import StaggeredGrid


def make_grad_div(eta_n, grid: StaggeredGrid, bcs: VelocityBCs, gamma,
                  dtype):
    """Returns gd(vx, vy) -> (tx, ty): the term gamma * D^T(eta_n * Du)
    to ADD to the momentum rows (= -G(gamma * eta_n * Du))."""
    from pylamp_tpu.solvers.mg import _pressure_gradient

    if not grid.uniform:
        raise NotImplementedError(
            "al_gamma > 0 requires a uniform grid (stretched divergence "
            "weights not plumbed; the sticky-air target is uniform)")
    w = (jnp.asarray(gamma, dtype) * eta_n).astype(dtype)

    def gd(vx, vy):
        du = (vx[:, 1:] - vx[:, :-1]) / grid.dx + (
            vy[1:, :] - vy[:-1, :]) / grid.dy
        gx, gy = _pressure_gradient(w * du, grid, dtype, bcs=bcs)
        return -gx, -gy

    return gd


def augment_saddle_op(op, gd):
    """Wrap a (vx, vy, p) -> (rx, ry, rc) saddle operator with the AL
    momentum augmentation (works identically around the jnp stencil and
    the explicit-halo shard_map path — the grad-div term is a plain XLA
    stencil on top)."""

    def op_aug(u):
        rx, ry, rc = op(u)
        tx, ty = gd(u[0], u[1])
        return rx + tx, ry + ty, rc

    return op_aug


def augment_rhs(b, eta_n, grid: StaggeredGrid, bcs: VelocityBCs, gamma,
                kcont, dtype):
    """f_gamma = f + gamma/kcont * D^T(eta_n * g_c): the rhs side of the
    same row operation (zero whenever the continuity rhs is zero, i.e.
    every no-inflow model)."""
    from pylamp_tpu.solvers.mg import _pressure_gradient

    fx, fy, g_c = b
    q = (jnp.asarray(gamma, dtype) * eta_n / kcont) * g_c
    gx, gy = _pressure_gradient(q, grid, dtype, bcs=bcs)
    return fx - gx, fy - gy, g_c
