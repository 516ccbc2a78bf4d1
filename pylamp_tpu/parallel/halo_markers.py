"""Explicit-halo marker engine under ``shard_map``.

Completes the explicit SP-analogue path (SURVEY.md §2.3; parallel/halo_ops.py
covers the Stokes/energy stencil applies): every marker operation of the
dense bucketed engine (markers/bucket.py) — marker->grid transfer,
grid->marker gather, RK4 advection, 3x3 re-bucketing, reseed majority vote —
expressed with hand-placed ``lax.ppermute`` neighbor exchanges over the
device mesh instead of GSPMD auto-partitioning.

Marker state is (ny, nx, K) sharded P("y", "x", None): each device owns the
markers of its cell block, so every operation is local up to a bounded halo:

- m2g: a marker interacts with nodes at cell offsets {-1..+1}; each block
  accumulates its cells' contributions into a one-ring-extended node array
  and FOLDS the rim onto the owning neighbor (scatter-with-halo-fold);
  the staggered +1 seam row/column/corner are emitted as thin psum-reduced
  strips exactly like parallel/halo_ops.py.
- g2m / velocity sampling: gathers reach <= 2 node offsets (RK4 stage
  positions move at most one cell under Courant <= 1), so a depth-(reach+1)
  halo exchange of the field block suffices; physical walls are filled with
  the same BC ghosts / zero pads as the global engine.
- rebucket: markers move at most one cell per step -> exchange a one-deep
  ring of the five marker arrays and run the same one-hot repack loop on the
  extended block (same candidate order => bit-identical slot assignment).
- reseed: the 3x3 material-majority histogram needs a one-deep histogram
  halo; the grid-T sample of new markers reuses the g2m path.

Equivalence vs the global bucket engine is tested on an 8-virtual-device
mesh in tests/test_halo_markers.py; the whole-step explicit-halo test in
tests/test_halo_ops.py routes through this module when
``SolverConfig.explicit_halo`` is set and the blocks are eligible.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.8
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from pylamp_tpu.core.bc import VelocityBCs
from pylamp_tpu.core.grid import StaggeredGrid
from pylamp_tpu.markers.bucket import (
    ARITHMETIC,
    GEOMETRIC,
    HARMONIC,
    BucketedMarkers,
    _weights,
)


def halo_markers_eligible(grid: StaggeredGrid, mesh: Mesh) -> bool:
    """Blocks must divide evenly and hold the deepest halo the engine
    exchanges (reach-2 RK4 stage sampling needs 3 rows/cols).  Stretched
    grids stay on GSPMD."""
    if not grid.uniform:
        return False
    my, mx = mesh.shape["y"], mesh.shape["x"]
    return (
        grid.ny % my == 0
        and grid.nx % mx == 0
        and grid.ny // my >= 4
        and grid.nx // mx >= 4
    )


def _pp(x, axis, pairs):
    if not pairs:
        return jnp.zeros_like(x)
    return lax.ppermute(x, axis, pairs)


def _recv_prev(x, axis, n):
    """Receive the payload of the (i-1) neighbor along ``axis`` (edge
    devices receive zeros)."""
    return _pp(x, axis, [(i, i + 1) for i in range(n - 1)])


def _recv_next(x, axis, n):
    """Receive the payload of the (i+1) neighbor along ``axis``."""
    return _pp(x, axis, [(i, i - 1) for i in range(1, n)])


# -- marker -> grid ---------------------------------------------------------------


def m2g_halo(
    bm: BucketedMarkers,
    values,  # (ny, nx, K)
    grid: StaggeredGrid,
    loc: str,
    mode: str,
    mesh: Mesh,
):
    """Explicit-halo bucket_markers_to_grid: returns (mean, wsum) on the
    ``loc`` sub-lattice, numerically matching markers/bucket.py (same
    per-cell partial-sum order; halo-fold adds differ only in fp rounding)."""
    ny, nx = grid.ny, grid.nx
    my, mx = mesh.shape["y"], mesh.shape["x"]
    by, bx = ny // my, nx // mx
    ny_n, nx_n = grid.shape(loc)
    has_brow = ny_n == ny + 1
    has_rcol = nx_n == nx + 1
    oy, ox = grid.origin(loc)
    dx, dy = grid.dx, grid.dy

    # mode transform per marker (elementwise; identical to the global path)
    vmask = bm.valid
    safe = jnp.where(vmask, values, 1.0)
    if mode == ARITHMETIC:
        v = jnp.where(vmask, values, 0.0)
    elif mode == GEOMETRIC:
        v = jnp.log(safe)
    elif mode == HARMONIC:
        v = 1.0 / safe
    else:
        raise ValueError(f"unknown averaging mode {mode!r}")
    dtype = v.dtype

    def local(xb, yb, vb, valb):
        iy = lax.axis_index("y")
        ix = lax.axis_index("x")
        cj = iy * by + lax.broadcasted_iota(jnp.int32, xb.shape, 0)
        ci = ix * bx + lax.broadcasted_iota(jnp.int32, xb.shape, 1)
        fx = (xb - ox) / dx
        fy = (yb - oy) / dy
        i0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, nx_n - 2)
        j0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, ny_n - 2)
        tx = jnp.clip(fx - i0, 0.0, 1.0)
        ty = jnp.clip(fy - j0, 0.0, 1.0)
        o_j = j0 - cj
        o_i = i0 - ci
        ws = _weights(ty, tx)
        corners = ((0, 0, ws[0]), (0, 1, ws[1]), (1, 0, ws[2]), (1, 1, ws[3]))

        # accumulate this block's cells into a one-ring-extended node array
        # (rows/cols -1..by/bx of the local node frame)
        Ewv = jnp.zeros((by + 2, bx + 2), dtype)
        Ew = jnp.zeros((by + 2, bx + 2), dtype)
        for a in (-1, 0, 1):
            for b in (-1, 0, 1):
                # corner weights added before one K-reduction (see
                # markers/bucket.py bucket_markers_to_grid)
                wsel = 0.0
                for dj, di, w in corners:
                    sel = (o_j + dj == a) & (o_i + di == b) & valb
                    wsel = wsel + jnp.where(sel, w, 0.0)
                s_wv = jnp.sum(wsel * vb, axis=-1)
                s_w = jnp.sum(wsel, axis=-1)
                Ewv = Ewv.at[1 + a : 1 + a + by, 1 + b : 1 + b + bx].add(s_wv)
                Ew = Ew.at[1 + a : 1 + a + by, 1 + b : 1 + b + bx].add(s_w)

        def fold(E):
            # rim rows -> owning y-neighbor (full width so diagonal-corner
            # contributions ride along), then rim cols -> x-neighbor
            core = E[1:-1, :]
            core = core.at[-1:, :].add(_recv_next(E[:1, :], "y", my))
            core = core.at[:1, :].add(_recv_prev(E[-1:, :], "y", my))
            mid = core[:, 1:-1]
            mid = mid.at[:, -1:].add(_recv_next(core[:, :1], "x", mx))
            mid = mid.at[:, :1].add(_recv_prev(core[:, -1:], "x", mx))

            # bottom seam row (global node row ny): only the bottom block
            # row holds real data; x-fold its rim, zero+psum the rest
            brow = E[-1:, :]
            bmid = brow[:, 1:-1]
            bmid = bmid.at[:, -1:].add(_recv_next(brow[:, :1], "x", mx))
            bmid = bmid.at[:, :1].add(_recv_prev(brow[:, -1:], "x", mx))
            bout = jnp.where(iy == my - 1, bmid, jnp.zeros_like(bmid))
            bout = lax.psum(bout, "y")

            # right seam column (global node col nx)
            rcol = E[:, -1:]
            rmid = rcol[1:-1, :]
            rmid = rmid.at[-1:, :].add(_recv_next(rcol[:1, :], "y", my))
            rmid = rmid.at[:1, :].add(_recv_prev(rcol[-1:, :], "y", my))
            rout = jnp.where(ix == mx - 1, rmid, jnp.zeros_like(rmid))
            rout = lax.psum(rout, "x")

            # corner node (ny, nx): fed only by cell (ny-1, nx-1)
            here = (iy == my - 1) & (ix == mx - 1)
            cout = jnp.where(here, E[-1:, -1:], jnp.zeros_like(E[-1:, -1:]))
            cout = lax.psum(cout, ("y", "x"))
            return mid, bout, rout, cout

        wv = fold(Ewv)
        w = fold(Ew)
        return (*wv, *w)

    blk = P("y", "x")
    blk3 = P("y", "x", None)
    outs = shard_map(
        local,
        mesh=mesh,
        in_specs=(blk3, blk3, blk3, blk3),
        out_specs=(blk, P(None, "x"), P("y", None), P(None, None)) * 2,
    )(bm.x, bm.y, v, vmask)
    wv_i, wv_b, wv_r, wv_c = outs[:4]
    w_i, w_b, w_r, w_c = outs[4:]

    def assemble(interior, brow, rcol, corner):
        out = interior
        if has_rcol:
            out = jnp.concatenate([out, rcol], axis=1)
        if has_brow:
            bottom = jnp.concatenate([brow, corner], axis=1) if has_rcol else brow
            out = jnp.concatenate([out, bottom], axis=0)
        return out

    field_wv = assemble(wv_i, wv_b, wv_r, wv_c)
    field_w = assemble(w_i, w_b, w_r, w_c)

    mean = field_wv / jnp.where(field_w == 0, 1.0, field_w)
    if mode == GEOMETRIC:
        mean = jnp.exp(mean)
    elif mode == HARMONIC:
        mean = 1.0 / jnp.where(mean == 0, 1.0, mean)
    return mean, field_w


# -- grid -> marker ---------------------------------------------------------------


def _extend_lattice_block(fI, fR, fB, fC, pl, ph, my, mx, iy, ix):
    """Extend a block of a node lattice with ``pl`` halo rows/cols before and
    ``ph`` after.  fI: (by, bx) interior block; fR/fB/fC: the +1 seam
    column/row/corner strips (None for lattices without them; every block
    holds its replicated chunk).  Out-of-domain fill is zero, matching the
    global engine's jnp.pad (those reads are always weight-masked)."""
    by, bx = fI.shape
    dtype = fI.dtype

    def row_ext(I, B):
        top = _recv_prev(I[-pl:, :], "y", my)
        top = jnp.where(iy == 0, jnp.zeros_like(top), top)
        bot = _recv_next(I[:ph, :], "y", my)
        if B is not None:
            last = jnp.concatenate(
                [B, jnp.zeros((ph - 1, I.shape[1]), dtype)], axis=0
            )
        else:
            last = jnp.zeros((ph, I.shape[1]), dtype)
        bot = jnp.where(iy == my - 1, last, bot)
        return jnp.concatenate([top, I, bot], axis=0)

    rows = row_ext(fI, fB)
    left = _recv_prev(rows[:, -pl:], "x", mx)
    left = jnp.where(ix == 0, jnp.zeros_like(left), left)
    right = _recv_next(rows[:, :ph], "x", mx)
    if fR is not None:
        rowsR = row_ext(fR, fC)
        lastc = jnp.concatenate(
            [rowsR, jnp.zeros((rows.shape[0], ph - 1), dtype)], axis=1
        )
    else:
        lastc = jnp.zeros((rows.shape[0], ph), dtype)
    right = jnp.where(ix == mx - 1, lastc, right)
    return jnp.concatenate([left, rows, right], axis=1)


def _gather_ext(ext, pl, o_j, o_i, ws, valid, reach, by, bx):
    """Sum of corner-weighted reads ext[pl + cj + a, pl + ci + b] for the
    (a, b) within ``reach`` — the dense-shift gather of the global engine on
    a halo-extended block."""
    corners = ((0, 0, ws[0]), (0, 1, ws[1]), (1, 0, ws[2]), (1, 1, ws[3]))
    out = jnp.zeros(o_j.shape, ext.dtype)
    for a in range(-reach, reach + 2):
        for b in range(-reach, reach + 2):
            fab = ext[pl + a : pl + a + by, pl + b : pl + b + bx]
            contrib = jnp.zeros(o_j.shape, ext.dtype)
            for dj, di, w in corners:
                sel = (o_j + dj == a) & (o_i + di == b)
                contrib = contrib + jnp.where(sel & valid, w, 0.0)
            out = out + contrib * fab[:, :, None]
    return out


def g2m_halo(
    field,  # (ny_n, nx_n) on sub-lattice `loc`
    px,
    py,
    valid,
    grid: StaggeredGrid,
    loc: str,
    mesh: Mesh,
    reach: int = 1,
):
    """Explicit-halo bucket_grid_to_markers."""
    ny, nx = grid.ny, grid.nx
    my, mx = mesh.shape["y"], mesh.shape["x"]
    by, bx = ny // my, nx // mx
    ny_n, nx_n = grid.shape(loc)
    has_brow = ny_n == ny + 1
    has_rcol = nx_n == nx + 1
    oy, ox = grid.origin(loc)
    dx, dy = grid.dx, grid.dy
    pl, ph = reach, reach + 1

    fI = field[:ny, :nx]
    fR = field[:ny, nx:] if has_rcol else None
    fB = field[ny:, :nx] if has_brow else None
    fC = field[ny:, nx:] if (has_brow and has_rcol) else None

    def local(fI_, fR_, fB_, fC_, pxb, pyb, valb):
        iy = lax.axis_index("y")
        ix = lax.axis_index("x")
        ext = _extend_lattice_block(fI_, fR_, fB_, fC_, pl, ph, my, mx, iy, ix)
        cj = iy * by + lax.broadcasted_iota(jnp.int32, pxb.shape, 0)
        ci = ix * bx + lax.broadcasted_iota(jnp.int32, pxb.shape, 1)
        fx = (pxb - ox) / dx
        fy = (pyb - oy) / dy
        i0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, nx_n - 2)
        j0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, ny_n - 2)
        tx = jnp.clip(fx - i0, 0.0, 1.0)
        ty = jnp.clip(fy - j0, 0.0, 1.0)
        ws = _weights(ty, tx)
        # local gather frame: node row (cj + a) sits at ext row
        # (cj_local + a + pl) — pass local offsets
        return _gather_ext(ext, pl, j0 - cj, i0 - ci, ws, valb, reach, by, bx)

    blk = P("y", "x")
    blk3 = P("y", "x", None)
    specs = [blk]
    args = [fI]
    specs.append(P("y", None) if has_rcol else P(None))
    args.append(fR if has_rcol else jnp.zeros((0,), field.dtype))
    specs.append(P(None, "x") if has_brow else P(None))
    args.append(fB if has_brow else jnp.zeros((0,), field.dtype))
    specs.append(P(None, None) if (has_brow and has_rcol) else P(None))
    args.append(fC if (has_brow and has_rcol) else jnp.zeros((0,), field.dtype))

    def wrapped(fI_, fR_, fB_, fC_, pxb, pyb, valb):
        fR2 = fR_ if has_rcol else None
        fB2 = fB_ if has_brow else None
        fC2 = fC_ if (has_brow and has_rcol) else None
        return local(fI_, fR2, fB2, fC2, pxb, pyb, valb)

    return shard_map(
        wrapped,
        mesh=mesh,
        in_specs=(*specs, blk3, blk3, blk3),
        out_specs=blk3,
    )(*args, px, py, valid)


# -- RK4 advection ----------------------------------------------------------------


def advect_rk4_halo(
    bm: BucketedMarkers,
    vx,
    vy,
    dt,
    grid: StaggeredGrid,
    bcs: VelocityBCs,
    mesh: Mesh,
    stage_reach: int = 2,
):
    """Explicit-halo bucket_advect_rk4: one halo exchange of the two
    BC-ghost-padded velocity lattices at the maximum stage reach, then all
    four RK4 stages sample locally."""
    ny, nx = grid.ny, grid.nx
    my, mx = mesh.shape["y"], mesh.shape["x"]
    by, bx = ny // my, nx // mx
    dx, dy = grid.dx, grid.dy
    R = stage_reach
    dtype = vx.dtype

    def local(vxI, vxR, vyI, vyB, xb, yb, valb, dt_):
        iy = lax.axis_index("y")
        ix = lax.axis_index("x")

        # -- vx in the padded vx_p frame (ghost rows above/below the walls):
        # sampling needs vx_p rows [rs - R, rs + by + R] = vx rows
        # [rs - R - 1, rs + by + R - 1] -> R+1 from prev (wall: ghost row
        # above zeros), R from next (wall: ghost row then zeros)
        def vx_rows(I):
            top = _recv_prev(I[-(R + 1) :, :], "y", my)
            ghost_t = bcs.s_top * I[:1, :] + (1.0 - bcs.s_top) * jnp.asarray(
                bcs.vt_top, dtype
            )
            top = jnp.where(
                iy == 0,
                jnp.concatenate(
                    [jnp.zeros((R, I.shape[1]), dtype), ghost_t], axis=0
                ),
                top,
            )
            bot = _recv_next(I[:R, :], "y", my)
            ghost_b = bcs.s_bottom * I[-1:, :] + (
                1.0 - bcs.s_bottom
            ) * jnp.asarray(bcs.vt_bottom, dtype)
            bot = jnp.where(
                iy == my - 1,
                jnp.concatenate(
                    [ghost_b, jnp.zeros((R - 1, I.shape[1]), dtype)], axis=0
                )
                if R > 0
                else bot,
                bot,
            )
            return jnp.concatenate([top, I, bot], axis=0)

        rows = vx_rows(vxI)  # (by + 2R + 1, bx)
        rowsR = vx_rows(vxR)  # (by + 2R + 1, 1)
        # cols: vx_p cols [cs - R, cs + bx + R]; vx has no ghost columns
        # (marker x is clamped inside the walls) -> zero fill
        left = _recv_prev(rows[:, -R:, ], "x", mx)
        left = jnp.where(ix == 0, jnp.zeros_like(left), left)
        right = _recv_next(rows[:, : R + 1], "x", mx)
        lastc = jnp.concatenate(
            [rowsR, jnp.zeros((rows.shape[0], R), dtype)], axis=1
        )
        right = jnp.where(ix == mx - 1, lastc, right)
        vx_ext = jnp.concatenate([left, rows, right], axis=1)

        # -- vy in the padded vy_p frame (ghost cols at the side walls):
        # rows [rs - R, rs + by + R]: R from prev, R+1 from next (seam row
        # at the bottom wall then zeros)
        top = _recv_prev(vyI[-R:, :], "y", my)
        top = jnp.where(iy == 0, jnp.zeros_like(top), top)
        bot = _recv_next(vyI[: R + 1, :], "y", my)
        lastr = jnp.concatenate([vyB, jnp.zeros((R, bx), dtype)], axis=0)
        bot = jnp.where(iy == my - 1, lastr, bot)
        rows = jnp.concatenate([top, vyI, bot], axis=0)  # (by + 2R + 1, bx)
        # cols: vy_p cols [cs - R, cs + bx + R] = vy cols [cs - R - 1,
        # cs + bx + R - 1] -> R+1 from prev (wall: ghost col after zeros),
        # R from next (wall: ghost col then zeros)
        left = _recv_prev(rows[:, -(R + 1) :], "x", mx)
        ghost_l = bcs.s_left * rows[:, :1] + (1.0 - bcs.s_left) * jnp.asarray(
            bcs.vt_left, dtype
        )
        left = jnp.where(
            ix == 0,
            jnp.concatenate([jnp.zeros((rows.shape[0], R), dtype), ghost_l], axis=1),
            left,
        )
        right = _recv_next(rows[:, :R], "x", mx)
        ghost_r = bcs.s_right * rows[:, -1:] + (
            1.0 - bcs.s_right
        ) * jnp.asarray(bcs.vt_right, dtype)
        right = jnp.where(
            ix == mx - 1,
            jnp.concatenate(
                [ghost_r, jnp.zeros((rows.shape[0], R - 1), dtype)], axis=1
            )
            if R > 0
            else right,
            right,
        )
        vy_ext = jnp.concatenate([left, rows, right], axis=1)

        cj = iy * by + lax.broadcasted_iota(jnp.int32, xb.shape, 0)
        ci = ix * bx + lax.broadcasted_iota(jnp.int32, xb.shape, 1)

        def sample(ext, fx, fy, nr, nc, reach):
            i0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, nc - 2)
            j0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, nr - 2)
            tx = jnp.clip(fx - i0, 0.0, 1.0)
            ty = jnp.clip(fy - j0, 0.0, 1.0)
            ws = _weights(ty, tx)
            # vx_p frame: node row r = cell row cj + o_j with ext origin at
            # vx_p row rs - R -> local index cj_local + o_j + R (same for
            # vy_p and both column frames)
            return _gather_ext(
                ext, R, j0 - cj, i0 - ci, ws, valb, reach, by, bx
            )

        def vel(px_, py_, reach):
            ux = sample(vx_ext, px_ / dx, py_ / dy + 0.5, ny + 2, nx + 1, reach)
            uy = sample(vy_ext, px_ / dx + 0.5, py_ / dy, ny + 1, nx + 2, reach)
            return ux, uy

        x, y = xb, yb
        k1x, k1y = vel(x, y, 1)
        k2x, k2y = vel(x + 0.5 * dt_ * k1x, y + 0.5 * dt_ * k1y, R)
        k3x, k3y = vel(x + 0.5 * dt_ * k2x, y + 0.5 * dt_ * k2y, R)
        k4x, k4y = vel(x + dt_ * k3x, y + dt_ * k3y, R)
        nxp = x + dt_ / 6.0 * (k1x + 2 * k2x + 2 * k3x + k4x)
        nyp = y + dt_ / 6.0 * (k1y + 2 * k2y + 2 * k3y + k4y)
        eps_x = 1e-6 * dx
        eps_y = 1e-6 * dy
        return (
            jnp.clip(nxp, eps_x, grid.lx - eps_x),
            jnp.clip(nyp, eps_y, grid.ly - eps_y),
        )

    blk = P("y", "x")
    blk3 = P("y", "x", None)
    new_x, new_y = shard_map(
        local,
        mesh=mesh,
        in_specs=(blk, P("y", None), blk, P(None, "x"), blk3, blk3, blk3, P()),
        out_specs=(blk3, blk3),
    )(
        vx[:, :-1], vx[:, -1:], vy[:-1, :], vy[-1:, :],
        bm.x, bm.y, bm.valid, jnp.asarray(dt, dtype),
    )
    return bm.replace(x=new_x, y=new_y)


# -- re-bucketing -----------------------------------------------------------------


def rebucket_halo(bm: BucketedMarkers, grid: StaggeredGrid, mesh: Mesh):
    """Explicit-halo rebucket: exchange a one-deep ring of the marker arrays,
    then run the same 9-offset one-hot repack on the extended block — the
    candidate order matches markers/bucket.py exactly, so slot assignment is
    bit-identical."""
    ny, nx = grid.ny, grid.nx
    my, mx = mesh.shape["y"], mesh.shape["x"]
    by, bx = ny // my, nx // mx
    K = bm.capacity
    dx, dy = grid.dx, grid.dy

    def local(xb, yb, Tb, mb, vb):
        iy = lax.axis_index("y")
        ix = lax.axis_index("x")

        def ext1(arr):
            t = _recv_prev(arr[-1:], "y", my)
            b = _recv_next(arr[:1], "y", my)
            rows = jnp.concatenate([t, arr, b], axis=0)
            l_ = _recv_prev(rows[:, -1:], "x", mx)
            r_ = _recv_next(rows[:, :1], "x", mx)
            return jnp.concatenate([l_, rows, r_], axis=1)

        xe = ext1(xb)
        ye = ext1(yb)
        Te = ext1(Tb)
        me = ext1(mb)
        ve = ext1(vb.astype(jnp.int32)) > 0  # ppermute edge fill = 0 = invalid

        # target cell of every extended-frame marker (global indices)
        ti = jnp.clip((xe / dx).astype(jnp.int32), 0, nx - 1)
        tj = jnp.clip((ye / dy).astype(jnp.int32), 0, ny - 1)
        cje = iy * by - 1 + lax.broadcasted_iota(jnp.int32, xe.shape, 0)
        cie = ix * bx - 1 + lax.broadcasted_iota(jnp.int32, xe.shape, 1)
        sdi_e = ti - cie
        sdj_e = tj - cje

        slot_ids = lax.broadcasted_iota(jnp.int32, (K,), 0)
        # fresh zeros are "unvarying" under shard_map's value-manual-axis
        # tracking; mark them varying so the fori_loop carry types match
        def _vary(z):
            try:
                return lax.pcast(z, ("y", "x"), to="varying")
            except AttributeError:  # older jax: no VMA tracking
                try:
                    return lax.pvary(z, ("y", "x"))
                except AttributeError:
                    return z

        carry = (
            jnp.zeros_like(xb),
            jnp.zeros_like(yb),
            jnp.zeros_like(Tb),
            jnp.zeros_like(mb),
            jnp.zeros_like(vb),
            _vary(jnp.zeros((by, bx), jnp.int32)),
            _vary(jnp.zeros((by, bx), jnp.int32)),
        )

        for a in (-1, 0, 1):
            for b in (-1, 0, 1):
                sl = (slice(1 + a, 1 + a + by), slice(1 + b, 1 + b + bx))
                sx = xe[sl]
                sy = ye[sl]
                sT = Te[sl]
                sm = me[sl]
                sv = ve[sl]
                take_all = sv & (sdj_e[sl] == -a) & (sdi_e[sl] == -b)

                def body(s, cr, sx=sx, sy=sy, sT=sT, sm=sm, take_all=take_all):
                    out_x, out_y, out_T, out_mat, out_valid, count, arrivals = cr
                    take = lax.dynamic_index_in_dim(take_all, s, 2, keepdims=False)
                    cx = lax.dynamic_index_in_dim(sx, s, 2, keepdims=False)
                    cy = lax.dynamic_index_in_dim(sy, s, 2, keepdims=False)
                    cT = lax.dynamic_index_in_dim(sT, s, 2, keepdims=False)
                    cm = lax.dynamic_index_in_dim(sm, s, 2, keepdims=False)
                    arrivals = arrivals + take.astype(jnp.int32)
                    can = take & (count < K)
                    onehot = (slot_ids[None, None, :] == count[:, :, None]) & can[
                        :, :, None
                    ]
                    out_x = jnp.where(onehot, cx[:, :, None], out_x)
                    out_y = jnp.where(onehot, cy[:, :, None], out_y)
                    out_T = jnp.where(onehot, cT[:, :, None], out_T)
                    out_mat = jnp.where(onehot, cm[:, :, None], out_mat)
                    out_valid = out_valid | onehot
                    count = count + can.astype(jnp.int32)
                    return out_x, out_y, out_T, out_mat, out_valid, count, arrivals

                carry = lax.fori_loop(0, K, body, carry)

        out_x, out_y, out_T, out_mat, out_valid, count, arrivals = carry
        dropped = lax.psum(
            jnp.sum(jnp.maximum(arrivals - K, 0)), ("y", "x")
        )
        return out_x, out_y, out_T, out_mat, out_valid, dropped

    blk3 = P("y", "x", None)
    out_x, out_y, out_T, out_mat, out_valid, dropped = shard_map(
        local,
        mesh=mesh,
        in_specs=(blk3,) * 5,
        out_specs=(blk3, blk3, blk3, blk3, blk3, P()),
    )(bm.x, bm.y, bm.T, bm.mat, bm.valid)
    new = BucketedMarkers(x=out_x, y=out_y, mat=out_mat, T=out_T, valid=out_valid)
    return new, dropped


# -- reseeding --------------------------------------------------------------------


def reseed_halo(
    bm: BucketedMarkers,
    T_grid,
    grid: StaggeredGrid,
    min_per_cell: int,
    n_materials: int,
    mesh: Mesh,
):
    """Explicit-halo bucket_reseed: the 3x3 material-majority vote exchanges
    a one-deep histogram halo; the grid-T sample reuses g2m_halo; the spawn
    logic itself is cell-local (GSPMD elementwise)."""
    ny, nx = grid.ny, grid.nx
    my, mx = mesh.shape["y"], mesh.shape["x"]
    by, bx = ny // my, nx // mx
    K = bm.capacity
    NMAT = n_materials

    def local(vb, mb):
        hist = jnp.zeros((by, bx, NMAT), jnp.int32)
        for m in range(NMAT):
            hist = hist.at[:, :, m].set(
                jnp.sum(vb & (mb == m), axis=-1, dtype=jnp.int32)
            )
        t = _recv_prev(hist[-1:], "y", my)
        b = _recv_next(hist[:1], "y", my)
        rows = jnp.concatenate([t, hist, b], axis=0)
        l_ = _recv_prev(rows[:, -1:], "x", mx)
        r_ = _recv_next(rows[:, :1], "x", mx)
        he = jnp.concatenate([l_, rows, r_], axis=1)  # zero edges = global pad
        acc = jnp.zeros((by, bx, NMAT), jnp.int32)
        for a in (0, 1, 2):
            for b2 in (0, 1, 2):
                acc = acc + he[a : a + by, b2 : b2 + bx, :]
        return jnp.argmax(acc, axis=-1).astype(jnp.int32)

    blk3 = P("y", "x", None)
    majority = shard_map(
        local,
        mesh=mesh,
        in_specs=(blk3, blk3),
        out_specs=P("y", "x"),
    )(bm.valid, bm.mat)

    count = bm.count()
    deficit = jnp.maximum(min_per_cell - count, 0)
    slot_ids = lax.broadcasted_iota(jnp.int32, (ny, nx, K), 2)
    free_rank = jnp.cumsum((~bm.valid).astype(jnp.int32), axis=-1) - 1
    spawn = (~bm.valid) & (free_rank < deficit[:, :, None])

    ci = lax.broadcasted_iota(jnp.int32, (ny, nx, K), 1)
    cj = lax.broadcasted_iota(jnp.int32, (ny, nx, K), 0)
    off_x = ((slot_ids * 0.381966) % 1.0 - 0.5) * 0.5
    off_y = ((slot_ids * 0.618034) % 1.0 - 0.5) * 0.5
    sx = (ci + 0.5 + off_x) * grid.dx
    sy = (cj + 0.5 + off_y) * grid.dy

    new_x = jnp.where(spawn, sx.astype(bm.x.dtype), bm.x)
    new_y = jnp.where(spawn, sy.astype(bm.y.dtype), bm.y)
    T_at = g2m_halo(T_grid, new_x, new_y, spawn, grid, "corner", mesh)
    new_T = jnp.where(spawn, T_at.astype(bm.T.dtype), bm.T)
    new_mat = jnp.where(spawn, majority[:, :, None], bm.mat)
    return bm.replace(
        x=new_x, y=new_y, T=new_T, mat=new_mat, valid=bm.valid | spawn
    )
