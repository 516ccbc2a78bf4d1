"""Line (tridiagonal) relaxation for the momentum block — the anisotropy
remedy for stretched grids.

Point smoothers (Chebyshev-Jacobi, solvers/mg.py) degrade when grid cells
become anisotropic (dy << dx or vice versa, the normal state of a stretched
grid): errors smooth along the weakly-coupled axis but stay rough along the
strongly-coupled one, and V-cycle convergence decays with the cell aspect
ratio.  The classic fix is LINE relaxation: solve, per sweep, the 1-D
tridiagonal system that couples each grid line along one axis exactly,
treating the other axis' coupling through the (full) diagonal — alternating
the axis between sweeps ("xy" lines) handles mixed-aspect grids, e.g.
geometric stretching in both directions.

Array shape: a line solve is a batch of independent tridiagonal systems (one
per column), which this module solves with PARALLEL CYCLIC REDUCTION —
ceil(log2 n) elementwise passes over the full array, fully vectorized over
the batch axis, no sequential scan.  On a (ny, nx) level that is ~10 shifted
fused passes, comparable to a couple of stencil applications.

The tridiagonal coefficients are the exact sub/super-diagonals of the
momentum stencil (ops/stokes.py, ops/stretched.py) along the chosen axis;
the diagonal is the exact full operator diagonal
(solvers/stokes_solver.velocity_diagonals), so each sweep is a damped
line-Jacobi iteration x += omega * T^{-1} (r - A x) with
T = D + L_axis + U_axis.

Periodic side walls make the x-direction coupling cyclic, which breaks the
tridiagonal structure; line smoothing is therefore restricted to
non-periodic runs (stretched grids are non-periodic by construction).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from pylamp_tpu.core.bc import VelocityBCs
from pylamp_tpu.core.grid import StaggeredGrid


# -- batched tridiagonal solve (parallel cyclic reduction) ----------------------

def _shift0(x, s, fill=0.0):
    """x[i + s] along axis 0, `fill` outside the range."""
    if s == 0:
        return x
    pad = [(max(-s, 0), max(s, 0))] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad, constant_values=fill)[
        max(s, 0) : max(s, 0) + x.shape[0]
    ]


def tridiag_pcr(a, b, c, d, axis: int = 0):
    """Solve a_i x_{i-1} + b_i x_i + c_i x_{i+1} = d_i along ``axis``,
    batched over every other axis, by parallel cyclic reduction.

    a[0] and c[n-1] are ignored (forced to zero).  Stable for the
    diagonally-dominant systems produced by the momentum stencil (the full
    diagonal includes the other axis' coupling, so |b| > |a| + |c|
    strictly).  ceil(log2 n) elementwise passes; no scan.
    """
    a = jnp.moveaxis(a, axis, 0)
    b = jnp.moveaxis(b, axis, 0)
    c = jnp.moveaxis(c, axis, 0)
    d = jnp.moveaxis(d, axis, 0)
    n = a.shape[0]
    a = a.at[0].set(0.0)
    c = c.at[-1].set(0.0)

    s = 1
    while s < n:
        # neighbors at distance s; out-of-range: identity equation rows
        # (b=1, a=c=d=0) so alpha/gamma vanish exactly where a/c are 0
        b_m = _shift0(b, -s, fill=1.0)
        b_p = _shift0(b, s, fill=1.0)
        alpha = -a / b_m
        gamma = -c / b_p
        b = b + alpha * _shift0(c, -s) + gamma * _shift0(a, s)
        d = d + alpha * _shift0(d, -s) + gamma * _shift0(d, s)
        a = alpha * _shift0(a, -s)
        c = gamma * _shift0(c, s)
        s *= 2

    return jnp.moveaxis(d / b, 0, axis)


# -- momentum-stencil line coefficients ------------------------------------------

def _spacings(grid: StaggeredGrid, dtype=None):
    dxc = np.asarray(grid.dxs)
    dyc = np.asarray(grid.dys)
    dxv = 0.5 * (dxc[:-1] + dxc[1:])
    dyv = 0.5 * (dyc[:-1] + dyc[1:])
    dxn = np.concatenate([[dxc[0]], dxv, [dxc[-1]]])
    dyn = np.concatenate([[dyc[0]], dyv, [dyc[-1]]])
    out = (dxc, dyc, dxv, dyv, dxn, dyn)
    if dtype is not None:
        # numpy f64 vectors promote f32 applies under x64
        out = tuple(a.astype(dtype) for a in out)
    return out


def momentum_line_coeffs(eta_s, eta_n, grid: StaggeredGrid, bcs: VelocityBCs,
                         axis: int):
    """Exact sub/super-diagonals (sub_vx, sup_vx, sub_vy, sup_vy) of the
    momentum stencil along ``axis`` (0 = y lines, 1 = x lines), zeroed on
    Dirichlet rows/cols (whose diagonal is kbnd in velocity_diagonals).
    Signs follow the operator convention of ops/stokes.py:64 /
    ops/stretched.py:75 (coupling entries are negative; the full diagonal
    dominates).  Shapes match the vx (ny, nx+1) / vy (ny+1, nx) lattices.
    """
    if bcs.periodic_x:
        raise ValueError("line smoothing requires non-periodic side walls "
                         "(cyclic x coupling is not tridiagonal)")
    ny, nx = grid.ny, grid.nx
    dt = eta_n.dtype
    dxc, dyc, dxv, dyv, dxn, dyn = _spacings(grid, dt)

    def row(v):  # (nx-ish,) -> (1, n)
        return jnp.asarray(v, dt)[None, :]

    def col(v):
        return jnp.asarray(v, dt)[:, None]

    if axis == 0:
        # vx: shear coupling through sxy rows; eta_s[j] over dyn[j]*dyc[j]
        sub_vx = -eta_s[:-1, :] / col(dyn[:-1] * dyc)
        sup_vx = -eta_s[1:, :] / col(dyn[1:] * dyc)
        sub_vx = sub_vx.at[0, :].set(0.0)      # ghost row -> diagonal
        sup_vx = sup_vx.at[-1, :].set(0.0)
        sub_vx = sub_vx.at[:, 0].set(0.0).at[:, -1].set(0.0)  # Dirichlet cols
        sup_vx = sup_vx.at[:, 0].set(0.0).at[:, -1].set(0.0)

        # vy: normal-stress coupling through syy; rows 0/ny are Dirichlet
        zrow = jnp.zeros((1, nx), dt)
        sub_vy = jnp.concatenate(
            [zrow, -2.0 * eta_n[:-1, :] / col(dyc[:-1] * dyv), zrow], axis=0
        )
        sup_vy = jnp.concatenate(
            [zrow, -2.0 * eta_n[1:, :] / col(dyc[1:] * dyv), zrow], axis=0
        )
        return sub_vx, sup_vx, sub_vy, sup_vy

    if axis == 1:
        # vx: normal-stress coupling through sxx; cols 0/nx are Dirichlet
        zcol = jnp.zeros((ny, 1), dt)
        sub_vx = jnp.concatenate(
            [zcol, -2.0 * eta_n[:, :-1] / row(dxc[:-1] * dxv), zcol], axis=1
        )
        sup_vx = jnp.concatenate(
            [zcol, -2.0 * eta_n[:, 1:] / row(dxc[1:] * dxv), zcol], axis=1
        )

        # vy: shear coupling through sxy cols; eta_s[:, i] over dxn[i]*dxc[i]
        sub_vy = -eta_s[:, :-1] / row(dxn[:-1] * dxc)
        sup_vy = -eta_s[:, 1:] / row(dxn[1:] * dxc)
        sub_vy = sub_vy.at[:, 0].set(0.0)      # ghost col -> diagonal
        sup_vy = sup_vy.at[:, -1].set(0.0)
        sub_vy = sub_vy.at[0, :].set(0.0).at[-1, :].set(0.0)  # Dirichlet rows
        sup_vy = sup_vy.at[0, :].set(0.0).at[-1, :].set(0.0)
        return sub_vx, sup_vx, sub_vy, sup_vy

    raise ValueError(f"axis must be 0 (y lines) or 1 (x lines), got {axis}")


def stencil_line_coeffs(apply_fn, shape, axis: int, dtype):
    """Exact sub/super-diagonals along ``axis`` of ANY linear distance-1
    (5-point) stencil operator, extracted with nine 3-periodic comb probes:
    e_{r,s}[j,i] = 1 iff (j mod 3, i mod 3) == (r, s).  Reading (A e)[j,i]
    at (j ± 1) mod 3 == r, i mod 3 == s isolates the single y-neighbor
    coupling (no same-node or x-neighbor of (j,i) lies in that comb — this
    also holds under periodic x wrap for axis=0), and symmetrically for x.
    Boundary entries come out exactly zero.  Nine operator applications;
    used by the energy multigrid where the coefficients would otherwise
    need BC-ghost-aware rederivation per discretization."""
    import jax.lax as lax

    j = lax.broadcasted_iota(jnp.int32, shape, 0)
    i = lax.broadcasted_iota(jnp.int32, shape, 1)
    sub = jnp.zeros(shape, dtype)
    sup = jnp.zeros(shape, dtype)
    jm, jp = (j - 1) % 3, (j + 1) % 3
    im, ip = (i - 1) % 3, (i + 1) % 3
    for r in range(3):
        for s in range(3):
            e = ((j % 3 == r) & (i % 3 == s)).astype(dtype)
            Ae = apply_fn(e)
            if axis == 0:
                sub = jnp.where((jm == r) & (i % 3 == s), Ae, sub)
                sup = jnp.where((jp == r) & (i % 3 == s), Ae, sup)
            else:
                sub = jnp.where((j % 3 == r) & (im == s), Ae, sub)
                sup = jnp.where((j % 3 == r) & (ip == s), Ae, sup)
    return sub, sup


def line_axes(smoother: str):
    """The sweep-axis sequence of a line-smoother name."""
    return {
        "line": (0, 1),     # alternating y then x lines (mixed aspect)
        "line_y": (0,),     # y lines only (dy << dx, e.g. y-refined surface)
        "line_x": (1,),
    }[smoother]
