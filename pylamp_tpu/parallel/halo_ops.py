"""Explicit-halo production stencil operators under ``shard_map``.

The default multi-chip path lets GSPMD partition the jnp stencils and insert
halo collectives automatically (parallel/mesh.py).  This module is the
explicit alternative for the PRODUCTION operators — the variable-viscosity
Stokes saddle-point apply (ops/stokes.py) and the energy diffusion apply
(ops/energy.py) — with hand-placed ``lax.ppermute`` neighbor exchanges over
the ICI mesh (SURVEY.md §2.3 "SP analogue": the ring/torus neighbor-exchange
building block promoted from the demo diffusion stencil in parallel/halo.py
to the full operators that the Krylov/multigrid hot loop applies).

Layout: the staggered lattices carry one extra node row/column (vx is
(ny, nx+1), vy (ny+1, nx), corners (ny+1, nx+1)) which does not divide
evenly over the mesh.  Each operator therefore splits its fields into a
divisible interior block array plus thin seam strips:

    vx    -> vx[:, :-1]  (ny, nx)  sharded P(y, x)   + last column  P(y)
    vy    -> vy[:-1, :]  (ny, nx)  sharded P(y, x)   + last row     P(x)
    corner-> f[:-1, :-1] (ny, nx)  sharded P(y, x)   + last row/col + corner

Inside ``shard_map`` every block reconstructs a one-deep extended array from
4 ppermute exchanges (rows first, then columns of the row-extended block, so
diagonal-corner halo values ride along for free); physical-wall edges are
filled with the same BC ghosts the global operators use (free-slip mirrors /
no-slip anti-mirrors for velocity, reflect ghosts for the energy mirror
padding) and the seam strips supply the true last-node values.  Outputs at
the seams are either trivial Dirichlet rows (computed outside the
shard_map) or psum-reduced thin strips.

Equivalence vs the global operators is tested to 1e-13 on an 8-virtual-
device mesh in tests/test_halo_ops.py for every BC combination.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.8
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from pylamp_tpu.core.bc import DIRICHLET, ThermalBCs, VelocityBCs
from pylamp_tpu.core.grid import StaggeredGrid


def halo_eligible(grid: StaggeredGrid, mesh: Mesh) -> bool:
    """The explicit-halo operators need evenly divisible blocks of at least
    2x2 cells (one-deep halos; smaller levels are latency-bound anyway and
    stay on the GSPMD / replicated path).  Stretched grids stay on GSPMD."""
    if not grid.uniform:
        return False
    my, mx = mesh.shape["y"], mesh.shape["x"]
    return (
        grid.ny % my == 0
        and grid.nx % mx == 0
        and grid.ny // my >= 2
        and grid.nx // mx >= 2
    )


def _pp(x, axis, pairs):
    if not pairs:
        return jnp.zeros_like(x)
    return lax.ppermute(x, axis, pairs)


def _from_prev(x, axis, n, ring: bool = False):
    """Receive the payload of the (i-1) neighbor along ``axis`` (edge
    devices receive zeros, or wrap around with ``ring`` — the torus-seam
    exchange periodic side walls use)."""
    pairs = [(i, i + 1) for i in range(n - 1)]
    if ring and n > 1:
        pairs.append((n - 1, 0))
    if ring and n == 1:
        return x
    return _pp(x, axis, pairs)


def _from_next(x, axis, n, ring: bool = False):
    """Receive the payload of the (i+1) neighbor along ``axis``."""
    pairs = [(i, i - 1) for i in range(1, n)]
    if ring and n > 1:
        pairs.append((0, n - 1))
    if ring and n == 1:
        return x
    return _pp(x, axis, pairs)


# -- Stokes -------------------------------------------------------------------


def stokes_operator_halo(
    vx, vy, p, eta_s, eta_n, grid: StaggeredGrid, bcs: VelocityBCs,
    mesh: Mesh, kcont=1.0, kbnd=1.0,
):
    """Explicit-halo application of the Stokes operator; identical to
    ops.stokes.stokes_operator (same stencil, same BC ghosts) with all
    neighbor communication placed by hand."""
    my, mx = mesh.shape["y"], mesh.shape["x"]
    dx, dy = grid.dx, grid.dy
    dtype = eta_n.dtype
    kcont = jnp.asarray(kcont, dtype)
    kbnd = jnp.asarray(kbnd, dtype)

    periodic = bcs.periodic_x

    def local(vxI, vxR, vyI, vyB, esI, esR, esB, esC, en, pc, kc_, kb_):
        iy = lax.axis_index("y")
        ix = lax.axis_index("x")
        by, bx = vxI.shape

        # vx extended (by+2, bx+2): BC ghost rows at the walls, true last
        # column (vxR) at the right seam; left halo of the leftmost block is
        # unused (col 0 is a Dirichlet row) and stays zero.  Periodic sides:
        # the x-exchanges become a RING over the torus seam — the rightmost
        # block's right halo is the leftmost's col 0 (== the duplicated
        # seam node), the leftmost's left halo is the rightmost's last
        # interior column (global nx-1), exactly the wrap the global
        # operator's ghosting reads.
        t = _from_prev(vxI[-1:, :], "y", my)
        b = _from_next(vxI[:1, :], "y", my)
        t = jnp.where(iy == 0, bcs.s_top * vxI[:1, :], t)
        b = jnp.where(iy == my - 1, bcs.s_bottom * vxI[-1:, :], b)
        rows = jnp.concatenate([t, vxI, b], axis=0)
        left = _from_prev(rows[:, -1:], "x", mx, ring=periodic)
        right = _from_next(rows[:, :1], "x", mx, ring=periodic)
        if not periodic:
            tR = _from_prev(vxR[-1:, :], "y", my)
            bR = _from_next(vxR[:1, :], "y", my)
            tR = jnp.where(iy == 0, bcs.s_top * vxR[:1, :], tR)
            bR = jnp.where(iy == my - 1, bcs.s_bottom * vxR[-1:, :], bR)
            vxR_ext = jnp.concatenate([tR, vxR, bR], axis=0)
            right = jnp.where(ix == mx - 1, vxR_ext, right)
        vx_ext = jnp.concatenate([left, rows, right], axis=1)

        # vy extended: BC ghost columns at the side walls (wrap halos under
        # periodic), true last row (vyB) at the bottom seam.
        t = _from_prev(vyI[-1:, :], "y", my)
        b = _from_next(vyI[:1, :], "y", my)
        b = jnp.where(iy == my - 1, vyB, b)
        rows = jnp.concatenate([t, vyI, b], axis=0)
        left = _from_prev(rows[:, -1:], "x", mx, ring=periodic)
        right = _from_next(rows[:, :1], "x", mx, ring=periodic)
        if not periodic:
            left = jnp.where(ix == 0, bcs.s_left * rows[:, :1], left)
            right = jnp.where(ix == mx - 1, bcs.s_right * rows[:, -1:], right)
        vy_ext = jnp.concatenate([left, rows, right], axis=1)

        # eta_s extended (by+1, bx+1): corner lattice, +1 row/col from the
        # next block (or the seam strips at the domain edge).
        b = _from_next(esI[:1, :], "y", my)
        b = jnp.where(iy == my - 1, esB, b)
        rows = jnp.concatenate([esI, b], axis=0)
        bR = _from_next(esR[:1, :], "y", my)
        bR = jnp.where(iy == my - 1, esC, bR)
        esR_ext = jnp.concatenate([esR, bR], axis=0)
        right = _from_next(rows[:, :1], "x", mx)
        right = jnp.where(ix == mx - 1, esR_ext, right)
        es_ext = jnp.concatenate([rows, right], axis=1)

        # cell-centered ring halos (outside-domain fill values are only read
        # by boundary rows that get overwritten below; zero keeps them finite)
        def ring(blk):
            t = _from_prev(blk[-1:, :], "y", my)
            b = _from_next(blk[:1, :], "y", my)
            r_ = jnp.concatenate([t, blk, b], axis=0)
            left = _from_prev(r_[:, -1:], "x", mx, ring=periodic)
            right = _from_next(r_[:, :1], "x", mx, ring=periodic)
            return jnp.concatenate([left, r_, right], axis=1)

        en_ext = ring(en)
        p_ext = ring(pc)

        # the same stencil as ops.stokes.stokes_operator, on extended
        # blocks
        dvxdx = (vx_ext[:, 1:] - vx_ext[:, :-1]) / dx  # (by+2, bx+1)
        dvydy = (vy_ext[1:, :] - vy_ext[:-1, :]) / dy  # (by+1, bx+2)
        sxx = 2.0 * en_ext[:, :-1] * dvxdx
        syy = 2.0 * en_ext[:-1, :] * dvydy
        sxy = es_ext * (
            (vx_ext[1:, 1:] - vx_ext[:-1, 1:]) / dy
            + (vy_ext[1:, 1:] - vy_ext[1:, :-1]) / dx
        )  # corners (by+1, bx+1)

        rx_blk = (
            -(sxx[1:-1, 1:] - sxx[1:-1, :-1]) / dx
            - (sxy[1:, :-1] - sxy[:-1, :-1]) / dy
            + (p_ext[1:-1, 1:-1] - p_ext[1:-1, :-2]) / dx
        )
        ry_blk = (
            -(syy[1:, 1:-1] - syy[:-1, 1:-1]) / dy
            - (sxy[:-1, 1:] - sxy[:-1, :-1]) / dx
            + (p_ext[1:-1, 1:-1] - p_ext[:-2, 1:-1]) / dy
        )
        rc = kc_ * (dvxdx[1:-1, 1:] + dvydy[1:, 1:-1])

        col = lax.broadcasted_iota(jnp.int32, (1, bx), 1)
        row = lax.broadcasted_iota(jnp.int32, (by, 1), 0)
        ryI = jnp.where((iy == 0) & (row == 0), kb_ * vyI, ry_blk)
        if periodic:
            # seam momentum row (global vx cols 0 and nx are one node):
            # the wrapped stencil came out of the ring halos naturally at
            # the leftmost blocks' col 0; emit each duplicate column under
            # the HALF-ROW convention (ops/stokes.py)
            seam_mask = (ix == 0) & (col == 0)
            rxI = jnp.where(seam_mask, 0.5 * rx_blk, rx_blk)
            rseam = jnp.where(ix == 0, 0.5 * rx_blk[:, :1],
                              jnp.zeros_like(rx_blk[:, :1]))
            rseam = lax.psum(rseam, "x")
            return rxI, ryI, rc, rseam
        rxI = jnp.where((ix == 0) & (col == 0), kb_ * vxI, rx_blk)
        return rxI, ryI, rc, jnp.zeros_like(rx_blk[:, :1])

    blk = P("y", "x")
    rxI, ryI, rc, rseam = shard_map(
        local,
        mesh=mesh,
        in_specs=(
            blk, P("y", None),           # vx interior + last column
            blk, P(None, "x"),           # vy interior + last row
            blk, P("y", None), P(None, "x"), P(None, None),  # eta_s pieces
            blk, blk,                     # eta_n, p
            P(), P(),                     # kcont, kbnd
        ),
        out_specs=(blk, blk, blk, P("y", None)),
        # the seam strip is replicated over x by construction (zeros, or a
        # psum over x), which the varying-axes check cannot infer
        check_vma=False,
    )(
        vx[:, :-1], vx[:, -1:],
        vy[:-1, :], vy[-1:, :],
        eta_s[:-1, :-1], eta_s[:-1, -1:], eta_s[-1:, :-1], eta_s[-1:, -1:],
        eta_n, p, kcont, kbnd,
    )
    # seam outputs: Dirichlet rows (walled) or the wrapped half-equation
    # (periodic), assembled outside the shard_map
    if periodic:
        rx = jnp.concatenate([rxI, rseam], axis=1)
    else:
        rx = jnp.concatenate([rxI, kbnd * vx[:, -1:]], axis=1)
    ry = jnp.concatenate([ryI, kbnd * vy[-1:, :]], axis=0)
    return rx, ry, rc


# -- Energy -------------------------------------------------------------------


def _favg(a, b, mode: str):
    if mode == "arithmetic":
        return 0.5 * (a + b)
    if mode == "harmonic":
        return 2.0 * a * b / (a + b)
    raise ValueError(f"unknown k averaging mode {mode!r}")


def energy_operator_halo(
    T, k, rhocp_over_dt, grid: StaggeredGrid, bcs: ThermalBCs,
    mesh: Mesh, kbnd=1.0, k_avg: str = "arithmetic",
):
    """Explicit-halo application of the energy operator; identical to
    ops.energy.energy_operator (mirror ghosts for the Neumann walls,
    Dirichlet identity rows, face-averaged conductivity).  Periodic side
    walls: ring ppermute over the torus seam; the duplicated seam columns
    (0 and nx) each carry HALF the wrapped equation (ops/energy.py), with
    the col-nx equation computed on the LEFTMOST blocks — they hold the
    west ring halo (col nx-1), their own col 1, and the replicated R/C
    strips, i.e. every value the wrapped stencil reads."""
    my, mx = mesh.shape["y"], mesh.shape["x"]
    dx, dy = grid.dx, grid.dy
    dtype = T.dtype
    kbnd = jnp.asarray(kbnd, dtype)
    rc_arr = jnp.broadcast_to(jnp.asarray(rhocp_over_dt, dtype), T.shape)

    periodic = bcs.periodic_x
    top_dir = bcs.top.kind == DIRICHLET
    bottom_dir = bcs.bottom.kind == DIRICHLET
    left_dir = (not periodic) and bcs.left.kind == DIRICHLET
    right_dir = (not periodic) and bcs.right.kind == DIRICHLET

    def split(f):
        return f[:-1, :-1], f[:-1, -1:], f[-1:, :-1], f[-1:, -1:]

    def local(TI, TR, TB, TC, kI, kR, kB, kC, cI, cR, cB, cC, kb_):
        iy = lax.axis_index("y")
        ix = lax.axis_index("x")
        by, bx = TI.shape

        def ext_corner(I, R, B, C):
            """(by+2, bx+2) frame + the y-extended right strip (by+2, 1):
            mirror ghosts outside the domain (ring wrap in x under
            periodic), true last-node values (R/B/C strips) at the
            seams."""
            t = _from_prev(I[-1:, :], "y", my)
            b = _from_next(I[:1, :], "y", my)
            t = jnp.where(iy == 0, I[1:2, :], t)  # reflect ghost row -1
            b = jnp.where(iy == my - 1, B, b)  # true last row ny
            rows = jnp.concatenate([t, I, b], axis=0)
            tR = _from_prev(R[-1:, :], "y", my)
            bR = _from_next(R[:1, :], "y", my)
            tR = jnp.where(iy == 0, R[1:2, :], tR)
            bR = jnp.where(iy == my - 1, C, bR)
            R_ext = jnp.concatenate([tR, R, bR], axis=0)
            left = _from_prev(rows[:, -1:], "x", mx, ring=periodic)
            right = _from_next(rows[:, :1], "x", mx, ring=periodic)
            if not periodic:
                left = jnp.where(ix == 0, rows[:, 1:2], left)  # reflect
            right = jnp.where(ix == mx - 1, R_ext, right)  # true col nx
            return jnp.concatenate([left, rows, right], axis=1), R_ext

        T_ext, TR_ext = ext_corner(TI, TR, TB, TC)
        k_ext, kR_ext = ext_corner(kI, kR, kB, kC)

        kx = _favg(k_ext[:, :-1], k_ext[:, 1:], k_avg)
        fx = kx * (T_ext[:, 1:] - T_ext[:, :-1]) / dx  # (by+2, bx+1)
        ky = _favg(k_ext[:-1, :], k_ext[1:, :], k_avg)
        fy = ky * (T_ext[1:, :] - T_ext[:-1, :]) / dy  # (by+1, bx+2)
        div = (fx[1:-1, 1:] - fx[1:-1, :-1]) / dx + (
            fy[1:, 1:-1] - fy[:-1, 1:-1]
        ) / dy
        r_blk = cI * TI - div

        row = lax.broadcasted_iota(jnp.int32, (by, 1), 0)
        col = lax.broadcasted_iota(jnp.int32, (1, bx), 1)
        if periodic:
            # duplicated seam column 0: half the wrapped equation (the
            # ring halo already made r_blk's col 0 the full wrapped one)
            r_blk = jnp.where((ix == 0) & (col == 0), 0.5 * r_blk, r_blk)
        mask = jnp.zeros((by, bx), bool)
        if left_dir:
            mask = mask | ((ix == 0) & (col == 0))
        if right_dir:
            pass  # col nx lives in the seam output
        if top_dir:
            mask = mask | ((iy == 0) & (row == 0))
        rI_out = jnp.where(mask, kb_ * TI, r_blk)

        # -- right seam column (global col nx, rows 0..ny-1) ---------------
        # 3-col strip (west, self, east); walled: (nx-1, nx, mirror=nx-1)
        # on the RIGHTMOST blocks.  Periodic: (nx-1, nx, wrap=1) on the
        # LEFTMOST blocks, which hold the west ring halo, the replicated
        # R strip, and their own col 1.  psum over x replicates the output.
        if periodic:
            Ts = jnp.concatenate(
                [T_ext[:, 0:1], TR_ext, T_ext[:, 2:3]], axis=1)
            ks = jnp.concatenate(
                [k_ext[:, 0:1], kR_ext, k_ext[:, 2:3]], axis=1)
        else:
            Ts = jnp.concatenate([T_ext[:, -2:], T_ext[:, -2:-1]], axis=1)
            ks = jnp.concatenate([k_ext[:, -2:], k_ext[:, -2:-1]], axis=1)
        fxs = _favg(ks[:, :-1], ks[:, 1:], k_avg) * (Ts[:, 1:] - Ts[:, :-1]) / dx
        fys = _favg(ks[:-1, 1:2], ks[1:, 1:2], k_avg) * (
            Ts[1:, 1:2] - Ts[:-1, 1:2]
        ) / dy
        divR = (fxs[1:-1, 1:2] - fxs[1:-1, 0:1]) / dx + (fys[1:, :] - fys[:-1, :]) / dy
        rR_blk = cR * TR - divR
        if periodic:
            rR_blk = 0.5 * rR_blk
        maskR = jnp.zeros((by, 1), bool)
        if right_dir:
            maskR = maskR | jnp.ones((by, 1), bool)
        if top_dir:
            maskR = maskR | ((iy == 0) & (row == 0))
        rR_out = jnp.where(maskR, kb_ * TR, rR_blk)
        _seam_owner = (ix == 0) if periodic else (ix == mx - 1)
        rR_out = jnp.where(_seam_owner, rR_out, jnp.zeros_like(rR_out))
        rR_out = lax.psum(rR_out, "x")

        # -- bottom seam row (global row ny, cols 0..nx-1) ------------------
        Tb = jnp.concatenate([T_ext[-2:, :], T_ext[-2:-1, :]], axis=0)
        kb2 = jnp.concatenate([k_ext[-2:, :], k_ext[-2:-1, :]], axis=0)
        fxb = _favg(kb2[:, :-1], kb2[:, 1:], k_avg) * (Tb[:, 1:] - Tb[:, :-1]) / dx
        fyb = _favg(kb2[:-1, :], kb2[1:, :], k_avg) * (Tb[1:, :] - Tb[:-1, :]) / dy
        divB = (fxb[1:2, 1:] - fxb[1:2, :-1]) / dx + (
            fyb[1:2, 1:-1] - fyb[0:1, 1:-1]
        ) / dy
        rB_blk = cB * TB - divB
        if periodic:
            # seam column 0 of the bottom row: half the wrapped equation
            rB_blk = jnp.where((ix == 0) & (col == 0), 0.5 * rB_blk,
                               rB_blk)
        maskB = jnp.zeros((1, bx), bool)
        if left_dir:
            maskB = maskB | ((ix == 0) & (col == 0))
        if bottom_dir:
            maskB = maskB | jnp.ones((1, bx), bool)
        rB_out = jnp.where(maskB, kb_ * TB, rB_blk)
        rB_out = jnp.where(iy == my - 1, rB_out, jnp.zeros_like(rB_out))
        rB_out = lax.psum(rB_out, "y")

        # -- bottom-right corner node (ny, nx) -------------------------------
        # walled: (rows ny-1, ny, mirror) x (cols nx-1, nx, mirror) on the
        # bottom-RIGHT block.  Periodic: cols (nx-1, nx, wrap=1) on the
        # bottom-LEFT block (ring halo + replicated strips), half-weighted.
        if periodic:
            def strip3(ext, R_ext):
                return jnp.concatenate(
                    [ext[-2:, 0:1], R_ext[-2:, :], ext[-2:, 2:3]], axis=1)

            Tw = strip3(T_ext, TR_ext)  # rows (ny-1, ny) x (nx-1, nx, 1)
            kw = strip3(k_ext, kR_ext)
            Tc3 = jnp.concatenate([Tw, Tw[0:1, :]], axis=0)
            kc3 = jnp.concatenate([kw, kw[0:1, :]], axis=0)
        else:
            Tw = T_ext[-2:, -2:]
            kw = k_ext[-2:, -2:]
            Tc3 = jnp.concatenate([Tw, Tw[:, 0:1]], axis=1)
            Tc3 = jnp.concatenate([Tc3, Tc3[0:1, :]], axis=0)
            kc3 = jnp.concatenate([kw, kw[:, 0:1]], axis=1)
            kc3 = jnp.concatenate([kc3, kc3[0:1, :]], axis=0)
        fxc = _favg(kc3[:, :-1], kc3[:, 1:], k_avg) * (Tc3[:, 1:] - Tc3[:, :-1]) / dx
        fyc = _favg(kc3[:-1, :], kc3[1:, :], k_avg) * (Tc3[1:, :] - Tc3[:-1, :]) / dy
        divC = (fxc[1:2, 1:2] - fxc[1:2, 0:1]) / dx + (
            fyc[1:2, 1:2] - fyc[0:1, 1:2]
        ) / dy
        rC_blk = cC * TC - divC
        if periodic:
            rC_blk = 0.5 * rC_blk
        if right_dir or bottom_dir:
            rC_blk = kb_ * TC
        here = (iy == my - 1) & ((ix == 0) if periodic else (ix == mx - 1))
        rC_out = jnp.where(here, rC_blk, jnp.zeros_like(rC_blk))
        rC_out = lax.psum(rC_out, ("y", "x"))

        return rI_out, rR_out, rB_out, rC_out

    blk = P("y", "x")
    specs4 = (blk, P("y", None), P(None, "x"), P(None, None))
    rI, rR, rB, rC = shard_map(
        local,
        mesh=mesh,
        in_specs=specs4 + specs4 + specs4 + (P(),),
        out_specs=(blk, P("y", None), P(None, "x"), P(None, None)),
    )(*split(T), *split(k), *split(rc_arr), kbnd)

    top = jnp.concatenate([rI, rR], axis=1)
    bot = jnp.concatenate([rB, rC], axis=1)
    return jnp.concatenate([top, bot], axis=0)
