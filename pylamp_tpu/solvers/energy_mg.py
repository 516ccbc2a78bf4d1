"""Geometric multigrid preconditioner for the energy (heat) equation.

The Jacobi-CG energy solve (solvers/energy_solver.py) is fine while the
rho*Cp/dt mass term dominates, but its iteration count grows with grid
size once diffusion dominates (steady/large-dt problems) — the classic
mesh-dependence of single-level methods (SURVEY.md §3.5 asks for the
spsolve replacement to be mesh-independent like the momentum solve).

Vertex-centered GMG on the corner lattice: coarse nodes coincide with
even fine nodes, bilinear prolongation, full-weighting restriction
(P^T/4), rediscretized coarse operators with node-sampled coefficients,
Chebyshev-Jacobi smoothing (the same smoothing machinery that mg.py uses
for the momentum block).  Everything is static-shaped slicing — XLA fuses
each level into a few HBM passes and GSPMD shards it like any other field.
"""
from __future__ import annotations

import jax.numpy as jnp

from pylamp_tpu.core.bc import ThermalBCs
from pylamp_tpu.core.grid import StaggeredGrid
from pylamp_tpu.ops.energy import _dirichlet_masks, energy_operator
from pylamp_tpu.solvers.krylov import vdot


def _interleave_rows(a, b):
    """rows [a0, b0, a1, b1, ..., a_{n-1}]; a: (n, m), b: (n-1, m)."""
    n, m = a.shape
    out = jnp.zeros((2 * n - 1, m), a.dtype)
    return out.at[0::2, :].set(a).at[1::2, :].set(b)


def prolong_corner(c, cx: bool = True, cy: bool = True):
    """Bilinear prolongation on the corner lattice: coarse (NY+1, NX+1) ->
    fine (2NY+1, 2NX+1), coincident at even fine nodes.  ``cx``/``cy``
    select the coarsened axes (semi-coarsening skips the interpolation
    along the axis the two levels share)."""
    if cy:
        mid_r = 0.5 * (c[:-1, :] + c[1:, :])
        e = _interleave_rows(c, mid_r)  # (2NY+1, NX+1)
    else:
        e = c
    if cx:
        mid_c = 0.5 * (e[:, :-1] + e[:, 1:])
        e = _interleave_rows(e.T, mid_c.T).T  # (2NY+1, 2NX+1)
    return e


def restrict_corner(f, periodic_x: bool = False, cx: bool = True,
                    cy: bool = True):
    """Full weighting (P^T/4 — P^T/2 along a single semi-coarsened axis):
    fine (2NY+1, 2NX+1) -> coarse (NY+1, NX+1).  Boundary rows use the
    truncated stencil (exact adjoint of the prolongation above).

    ``periodic_x``: the fine seam columns (0 and 2NX, one physical node)
    each carry HALF the residual (ops/energy.py half-row convention); fold
    them, restrict with x wrap-around, and re-emit equal coarse halves."""
    if periodic_x and cx:
        fu = f[:, :-1].at[:, 0].add(f[:, -1])  # unique columns, physical seam
        fz = jnp.concatenate([fu[:, -1:], fu], axis=1)  # left wrap ghost
        g = (0.5 * fz[:, 0:-2:2] + fz[:, 1:-1:2] + 0.5 * fz[:, 2::2]) / 2.0
    elif cx:
        # x: coarse col I <- 0.5 f[2I-1] + f[2I] + 0.5 f[2I+1]
        fp = jnp.pad(f, ((0, 0), (1, 1)))
        g = (0.5 * fp[:, 0:-2:2] + fp[:, 1:-1:2] + 0.5 * fp[:, 2::2]) / 2.0
    else:
        g = f
    if cy:
        gp = jnp.pad(g, ((1, 1), (0, 0)))
        c = (0.5 * gp[0:-2:2, :] + gp[1:-1:2, :] + 0.5 * gp[2::2, :]) / 2.0
    else:
        c = g
    if periodic_x and cx:
        seam = 0.5 * c[:, :1]
        c = jnp.concatenate([seam, c[:, 1:], seam], axis=1)
    return c


def _power_lambda_max(apply_binv_a, shape, dtype, iters: int = 12):
    from jax import lax

    n = shape[0] * shape[1]
    v0 = ((jnp.arange(n, dtype=dtype) * 0.754877666 + 0.1) % 1.0 - 0.5).reshape(shape)

    def body(_, st):
        v, _ = st
        v = v / jnp.sqrt(vdot(v, v))
        w = apply_binv_a(v)
        return w, vdot(v, w)

    _, lam = lax.fori_loop(0, iters, body, (v0, jnp.asarray(1.0, dtype)))
    return jnp.abs(lam)


def make_energy_mg_preconditioner(
    k,
    rhocp_over_dt,
    grid: StaggeredGrid,
    bcs: ThermalBCs,
    kbnd,
    k_avg: str = "arithmetic",
    levels: int = 0,
    pre_smooth: int = 2,
    post_smooth: int = 2,
    coarse_iters: int = 16,
    halo_mesh=None,
    smoother: str = "chebyshev",
    omega: float = 0.7,
    semicoarsen: float = 0.0,
):
    """Returns M(r) -> z: one V-cycle on the energy operator from a zero
    initial guess (an SPD-ish preconditioner for CG).  ``halo_mesh`` routes
    every level's operator application through the explicit shard_map halo
    path (parallel/halo_ops.py; per-level eligibility is checked inside
    ops.energy.energy_operator).

    ``smoother``: "chebyshev" (default), or damped line relaxation for
    anisotropic stretched grids — "line" (alternating y/x tridiagonal
    sweeps), "line_y"/"line_x" (one axis).  Line coefficients are probe-
    extracted from the level operator itself (solvers/lines.py
    stencil_line_coeffs), so every BC/averaging variant is exact by
    construction; x lines require non-periodic side walls."""
    from pylamp_tpu.solvers.energy_solver import energy_diagonal

    from pylamp_tpu.solvers.mg import coarsening_plan

    plan = coarsening_plan(grid, levels, semi_threshold=semicoarsen)
    nlev = len(plan) + 1
    dtype = k.dtype

    grids = [grid]
    coeffs = [(k, rhocp_over_dt)]
    for cx, cy in plan:
        grids.append(grids[-1].coarsen(cx, cy))
        kl, rl = coeffs[-1]
        # corner nodes coincide: sample coefficients at the surviving nodes
        sy = slice(None, None, 2) if cy else slice(None)
        sx = slice(None, None, 2) if cx else slice(None)
        coeffs.append((kl[sy, sx], rl[sy, sx]))
    # kbnd scales with 1/(dx*dy) like the stencil (per-axis form so
    # semi-coarsened levels scale correctly)
    kbnds = [
        kbnd * (grids[0].dx_min * grids[0].dy_min) / (g.dx_min * g.dy_min)
        for g in grids
    ]
    diags = [
        energy_diagonal(kl, rl, g, bcs, kb, k_avg)
        for (kl, rl), g, kb in zip(coeffs, grids, kbnds)
    ]
    masks = [_dirichlet_masks(g, bcs, dtype)[0] for g in grids]

    def apply_l(l, T):
        kl, rl = coeffs[l]
        return energy_operator(T, kl, rl, grids[l], bcs, kbnd=kbnds[l],
                               k_avg=k_avg, halo_mesh=halo_mesh)

    lines = None
    if smoother in ("line", "line_y", "line_x"):
        from pylamp_tpu.solvers.lines import line_axes, stencil_line_coeffs

        sweep_axes = line_axes(smoother)
        if bcs.periodic_x and 1 in sweep_axes:
            raise ValueError("x-line smoothing requires non-periodic side "
                             "walls (use smoother='line_y')")
        lines = [
            {
                ax: stencil_line_coeffs(
                    (lambda v, l=l: apply_l(l, v)),
                    grids[l].shape_corner, ax, dtype,
                )
                for ax in sweep_axes
            }
            for l in range(nlev)
        ]
    elif smoother != "chebyshev":
        raise ValueError(f"unknown energy MG smoother {smoother!r}")

    lam = [
        1.1
        * _power_lambda_max(
            (lambda v, l=l: apply_l(l, v) / diags[l]), grids[l].shape_corner, dtype
        )
        for l in range(nlev)
    ] if lines is None else None

    def smooth(l, x, b, iters):
        from jax import lax

        d = diags[l]
        if lines is not None:
            from pylamp_tpu.solvers.lines import tridiag_pcr

            def lbody(_, x):
                for ax, (sub, sup) in lines[l].items():
                    r = b - apply_l(l, x)
                    x = x + omega * tridiag_pcr(sub, d, sup, r, axis=ax)
                return x

            return lax.fori_loop(0, iters, lbody, x)
        lmax = lam[l]
        lmin = lmax / 4.0
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        s1 = theta / delta
        dx_ = (b - apply_l(l, x)) / d / theta
        x = x + dx_
        ro = 1.0 / s1

        def body(_, st):
            x, dx_, ro = st
            rho = 1.0 / (2.0 * s1 - ro)
            dx_n = rho * ro * dx_ + (2.0 * rho / delta) * (b - apply_l(l, x)) / d
            return x + dx_n, dx_n, rho

        x, _, _ = lax.fori_loop(0, iters - 1, body, (x, dx_, ro))
        return x

    def vcycle(l, b):
        if l == nlev - 1:
            return smooth(l, jnp.zeros_like(b), b, coarse_iters)
        x = smooth(l, jnp.zeros_like(b), b, pre_smooth)
        r = b - apply_l(l, x)
        pcx, pcy = plan[l]
        # Dirichlet rows belong to the smoother on each level
        rc = restrict_corner(jnp.where(masks[l], 0.0, r), bcs.periodic_x,
                             cx=pcx, cy=pcy)
        ec = vcycle(l + 1, jnp.where(masks[l + 1], 0.0, rc))
        x = x + jnp.where(masks[l], 0.0, prolong_corner(ec, cx=pcx, cy=pcy))
        return smooth(l, x, b, post_smooth)

    return lambda r: vcycle(0, r)
