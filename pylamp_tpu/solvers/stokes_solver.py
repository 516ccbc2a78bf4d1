"""Matrix-free Stokes solve: FGMRES + block preconditioner + pressure gauge.

Replaces the reference's `spsolve(A, rhs)` on the assembled saddle-point
matrix (SURVEY.md §3.2).  The pressure nullspace (constant mode) is handled
by mean-zero projection rather than pinning one DOF — pinning doesn't shard
cleanly across chips, whereas the projection is one `psum` (SURVEY.md §7.3
item 3); the final pressure is then shifted to the requested gauge so results
remain comparable with the reference's pinned-DOF convention.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

from pylamp_tpu.core.bc import VelocityBCs
from pylamp_tpu.core.grid import StaggeredGrid
from pylamp_tpu.ops.stokes import stokes_operator, stokes_rhs
from pylamp_tpu.solvers.krylov import SolveInfo, fgmres
from pylamp_tpu.solvers.scaling import characteristic_viscosity, stokes_scales


class StokesSolution(NamedTuple):
    vx: Any
    vy: Any
    p: Any
    info: SolveInfo


def velocity_diagonals(eta_s, eta_n, grid: StaggeredGrid, kbnd,
                       bcs: VelocityBCs | None = None):
    """Analytic diagonals of the momentum stencils (for Jacobi-type
    preconditioning/smoothing).  With periodic side walls the vx seam
    columns carry the wrapped stencil diagonal under the half-row
    convention (ops/stokes.py)."""
    if not grid.uniform:
        from pylamp_tpu.ops.stretched import velocity_diagonals_stretched

        return velocity_diagonals_stretched(eta_s, eta_n, grid, kbnd)
    dx, dy = grid.dx, grid.dy
    dvx_int = (
        2.0 * (eta_n[:, 1:] + eta_n[:, :-1]) / dx**2
        + (eta_s[1:, 1:-1] + eta_s[:-1, 1:-1]) / dy**2
    )
    if bcs is not None and bcs.periodic_x:
        dvx_seam = 0.5 * (
            2.0 * (eta_n[:, :1] + eta_n[:, -1:]) / dx**2
            + (eta_s[1:, :1] + eta_s[:-1, :1]) / dy**2
        )
        dvx = jnp.concatenate([dvx_seam, dvx_int, dvx_seam], axis=1)
    else:
        dvx = jnp.concatenate(
            [jnp.full_like(dvx_int[:, :1], kbnd), dvx_int, jnp.full_like(dvx_int[:, :1], kbnd)],
            axis=1,
        )
    dvy_int = (
        2.0 * (eta_n[1:, :] + eta_n[:-1, :]) / dy**2
        + (eta_s[1:-1, 1:] + eta_s[1:-1, :-1]) / dx**2
    )
    dvy = jnp.concatenate(
        [jnp.full_like(dvy_int[:1, :], kbnd), dvy_int, jnp.full_like(dvy_int[:1, :], kbnd)],
        axis=0,
    )
    return dvx, dvy


def vx_nullspace(bcs: VelocityBCs) -> bool:
    """True when the operator has a constant-vx nullspace: periodic sides
    with free-slip (zero-shear) top AND bottom — a uniform horizontal
    translation then produces zero stress, divergence and BC residual."""
    from pylamp_tpu.core.bc import FREE_SLIP

    return bcs.periodic_x and bcs.top == FREE_SLIP and bcs.bottom == FREE_SLIP


def project_vx_mean(vx):
    """Remove the constant-vx mode (mean over the unique columns — the
    duplicated seam column is counted once)."""
    return vx - jnp.mean(vx[:, :-1])


def make_block_jacobi_preconditioner(eta_s, eta_n, grid, kcont, kbnd, bcs=None):
    """Block-diagonal preconditioner:
    velocity — pointwise Jacobi on the momentum diagonals;
    pressure — viscosity-scaled mass matrix (Schur complement surrogate
    S ~ -kcont/eta), projected to the zero-mean gauge."""
    dvx, dvy = velocity_diagonals(eta_s, eta_n, grid, kbnd, bcs=bcs)
    project = bcs is not None and vx_nullspace(bcs)

    def M(r):
        rx, ry, rc = r
        zx = rx / dvx
        zy = ry / dvy
        if project:
            zx = project_vx_mean(zx)
        zp = -(eta_n / kcont) * rc
        zp = zp - jnp.mean(zp)
        return (zx, zy, zp)

    return M


def solve_stokes(
    eta_s,
    eta_n,
    rho_vx,
    rho_vy,
    gx,
    gy,
    grid: StaggeredGrid,
    bcs: VelocityBCs,
    tol: float = 1e-8,
    restart: int = 40,
    maxiter: int = 2000,
    x0=None,
    preconditioner: Callable | None = None,
    make_preconditioner: Callable | None = None,
    halo_mesh=None,
) -> StokesSolution:
    """Solve the variable-viscosity Stokes system to ``tol`` relative
    residual (of the scaled system).

    ``make_preconditioner(eta_s, eta_n, grid, kcont, kbnd) -> M`` overrides
    the default block-Jacobi (e.g. the multigrid preconditioner in mg.py).
    ``halo_mesh``: route every operator application through the explicit
    shard_map halo-exchange path (parallel/halo_ops.py)."""
    dtype = eta_n.dtype
    eta_char = characteristic_viscosity(eta_n)
    kcont, kbnd = stokes_scales(eta_char, grid)

    def op(u):
        vx, vy, p = u
        return stokes_operator(vx, vy, p, eta_s, eta_n, grid, bcs, kcont=kcont,
                               kbnd=kbnd, halo_mesh=halo_mesh)

    b = stokes_rhs(rho_vx, rho_vy, gx, gy, grid, bcs, kbnd=kbnd, dtype=dtype,
                   eta_s=eta_s)

    if preconditioner is not None:
        M = preconditioner
    elif make_preconditioner is not None:
        M = make_preconditioner(eta_s, eta_n, grid, kcont, kbnd, bcs=bcs)
    else:
        M = make_block_jacobi_preconditioner(eta_s, eta_n, grid, kcont, kbnd, bcs=bcs)

    if x0 is None:
        x0 = (
            jnp.zeros(grid.shape_vx, dtype),
            jnp.zeros(grid.shape_vy, dtype),
            jnp.zeros(grid.shape_center, dtype),
        )

    (vx, vy, p), info = fgmres(
        op, b, x0, M=M, tol=tol, restart=restart, maxiter=maxiter
    )
    p = p - jnp.mean(p)  # zero-mean gauge
    if vx_nullspace(bcs):
        vx = project_vx_mean(vx)
    return StokesSolution(vx, vy, p, info)


def solve_stokes_mixed(
    eta_s,
    eta_n,
    rho_vx,
    rho_vy,
    gx,
    gy,
    grid: StaggeredGrid,
    bcs: VelocityBCs,
    tol: float = 1e-8,
    inner_tol: float = 1e-4,
    restart: int = 40,
    maxiter: int = 300,
    max_refinements: int = 6,
    x0=None,
    make_preconditioner: Callable | None = None,
    halo_mesh=None,
    al_gamma: float = 0.0,
) -> StokesSolution:
    """Mixed-precision Stokes solve: f32 FGMRES+MG inner solves inside f64
    iterative refinement (solvers/refine.py) — reaches 1e-8 relative
    residual where f32 alone floors at ~1e-4 (SURVEY.md §7.3 item 5).

    Inputs may be f32 or f64; the system is DEFINED by the f64 casts (the
    same stencil), and the reported residual is measured in f64.
    ``maxiter`` bounds each inner solve.

    ``al_gamma`` > 0: augmented-Lagrangian row operation (solvers/al.py) —
    same solution, contrast-robust Schur surrogate; pair with a
    make_preconditioner built with the same al_gamma.  The residual is then
    measured on the (equivalent) augmented system."""
    from pylamp_tpu.solvers.refine import refine

    f64 = jnp.float64
    f32 = jnp.float32
    eta_s64, eta_n64 = eta_s.astype(f64), eta_n.astype(f64)
    eta_char = characteristic_viscosity(eta_n64)
    kcont, kbnd = stokes_scales(eta_char, grid)

    def op64(u):
        vx, vy, p = u
        return stokes_operator(
            vx, vy, p, eta_s64, eta_n64, grid, bcs, kcont=kcont, kbnd=kbnd,
            halo_mesh=halo_mesh,
        )

    b64 = stokes_rhs(
        rho_vx.astype(f64), rho_vy.astype(f64), gx, gy, grid, bcs, kbnd=kbnd,
        dtype=f64, eta_s=eta_s64,
    )

    eta_s32, eta_n32 = eta_s64.astype(f32), eta_n64.astype(f32)
    kcont32, kbnd32 = kcont.astype(f32), kbnd.astype(f32)

    if al_gamma > 0.0:
        from pylamp_tpu.solvers.al import (
            augment_rhs,
            augment_saddle_op,
            make_grad_div,
        )

        op64 = augment_saddle_op(
            op64, make_grad_div(eta_n64, grid, bcs, al_gamma, f64))
        b64 = augment_rhs(b64, eta_n64, grid, bcs, al_gamma, kcont, f64)
        _gd32 = make_grad_div(eta_n32, grid, bcs, al_gamma, f32)

    def op32(u):
        vx, vy, p = u
        return stokes_operator(
            vx, vy, p, eta_s32, eta_n32, grid, bcs, kcont=kcont32,
            kbnd=kbnd32, halo_mesh=halo_mesh,
        )

    if al_gamma > 0.0:
        from pylamp_tpu.solvers.al import augment_saddle_op

        op32 = augment_saddle_op(op32, _gd32)

    mk = make_preconditioner or make_block_jacobi_preconditioner
    M32 = mk(eta_s32, eta_n32, grid, kcont32, kbnd32, bcs=bcs)

    def inner_solve(r32, tol32):
        z0 = jax.tree.map(jnp.zeros_like, r32)
        # single-pass CGS: the loose inner tolerance tolerates mild
        # orthogonality loss, and the basis reads are a real HBM cost
        return fgmres(
            op32, r32, z0, M=M32, tol=tol32, restart=restart,
            maxiter=maxiter, cgs_passes=1,
        )

    if x0 is None:
        x0 = (
            jnp.zeros(grid.shape_vx, f64),
            jnp.zeros(grid.shape_vy, f64),
            jnp.zeros(grid.shape_center, f64),
        )
    else:
        x0 = jax.tree.map(lambda l: l.astype(f64), x0)

    (vx, vy, p), info = refine(
        op64, inner_solve, b64, x0, tol=tol, max_refinements=max_refinements,
        inner_tol=inner_tol,
    )
    p = p - jnp.mean(p)
    if vx_nullspace(bcs):
        vx = project_vx_mean(vx)
    return StokesSolution(vx, vy, p, info)
