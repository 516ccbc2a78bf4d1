"""Dense bucketed marker engine vs the flat reference implementation
(equivalence to fp tolerance; the bucket engine is the production path)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pylamp_tpu.core.grid import StaggeredGrid
from pylamp_tpu.core.bc import VelocityBCs
from pylamp_tpu.markers.bucket import (
    BucketedMarkers,
    bucket_advect_rk4,
    bucket_from_flat,
    bucket_grid_to_markers,
    bucket_markers_to_grid,
    bucket_reseed,
    flatten,
    rebucket,
)
from pylamp_tpu.markers.advect import advect_rk4
from pylamp_tpu.markers.interp import grid_to_markers, markers_to_grid

GRID = StaggeredGrid(nx=12, ny=10, lx=1.2, ly=1.0)
K = 12
RNG = np.random.default_rng(1234)  # used only for per-test field values


def _random_markers(n=700, seed=5):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.uniform(1e-6, GRID.lx - 1e-6, n))
    y = jnp.asarray(rng.uniform(1e-6, GRID.ly - 1e-6, n))
    mat = jnp.asarray(rng.integers(0, 3, n), jnp.int32)
    T = jnp.asarray(rng.normal(size=n) + 2.0)
    return x, y, mat, T


def _match_marker_sets(bm, x, y, mat, T):
    """Markers in the bucket == the flat set (as multisets keyed by x)."""
    fx, fy, fm, fT, fv = (np.asarray(a) for a in flatten(bm))
    sel = fv.astype(bool)
    got = sorted(zip(fx[sel], fy[sel], fm[sel], fT[sel]))
    want = sorted(zip(np.asarray(x), np.asarray(y), np.asarray(mat), np.asarray(T)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6)


def test_bucket_roundtrip_preserves_markers():
    x, y, mat, T = _random_markers()
    bm = bucket_from_flat(x, y, mat, T, GRID, K)
    assert int(bm.total()) == x.shape[0]
    _match_marker_sets(bm, x, y, mat, T)


@pytest.mark.parametrize("loc", ["corner", "center", "vx", "vy"])
@pytest.mark.parametrize("mode", ["arithmetic", "geometric"])
def test_bucket_m2g_matches_flat(loc, mode):
    x, y, mat, T = _random_markers()
    T = jnp.exp(T - 2.0)  # positive values (geometric/harmonic domains)
    vals = T
    want, want_w = markers_to_grid(x, y, vals, GRID, loc, mode)

    bm = bucket_from_flat(x, y, mat, T, GRID, K)
    got, got_w = bucket_markers_to_grid(bm, bm.T, GRID, loc, mode)

    np.testing.assert_allclose(np.asarray(got_w), np.asarray(want_w), atol=1e-12)
    covered = np.asarray(want_w) > 0
    np.testing.assert_allclose(
        np.asarray(got)[covered], np.asarray(want)[covered], rtol=1e-10, atol=1e-12
    )


@pytest.mark.parametrize("loc", ["corner", "center"])
def test_bucket_g2m_matches_flat(loc):
    x, y, mat, T = _random_markers()
    yy, xx = GRID.coords(loc)
    field = jnp.asarray(RNG.normal(size=GRID.shape(loc)))
    want = grid_to_markers(field, x, y, GRID, loc)

    bm = bucket_from_flat(x, y, mat, T, GRID, K)
    got_b = bucket_grid_to_markers(field, bm.x, bm.y, bm.valid, GRID, loc)
    # compare per-marker: match via x coordinate
    fx, fy, _, _, fv = (np.asarray(a) for a in flatten(bm))
    gotv = np.asarray(got_b).reshape(-1)
    sel = fv.astype(bool)
    order_b = np.argsort(fx[sel])
    order_f = np.argsort(np.asarray(x))
    np.testing.assert_allclose(
        gotv[sel][order_b], np.asarray(want)[order_f], rtol=1e-10, atol=1e-12
    )


def test_bucket_advect_matches_flat():
    x, y, mat, T = _random_markers()
    vx = jnp.asarray(RNG.normal(size=GRID.shape_vx)) * 0.3
    vy = jnp.asarray(RNG.normal(size=GRID.shape_vy)) * 0.3
    bcs = VelocityBCs()
    dt = 0.08  # displacements up to ~ half a cell

    want_x, want_y = advect_rk4(x, y, vx, vy, dt, GRID, bcs)

    bm = bucket_from_flat(x, y, mat, T, GRID, K)
    out = bucket_advect_rk4(bm, vx, vy, dt, GRID, bcs)

    fx0 = np.asarray(flatten(bm)[0])
    fv = np.asarray(flatten(bm)[4]).astype(bool)
    gx = np.asarray(out.x).reshape(-1)
    gy = np.asarray(out.y).reshape(-1)
    order_b = np.argsort(fx0[fv])
    order_f = np.argsort(np.asarray(x))
    np.testing.assert_allclose(gx[fv][order_b], np.asarray(want_x)[order_f],
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(gy[fv][order_b], np.asarray(want_y)[order_f],
                               rtol=1e-9, atol=1e-11)


def test_rebucket_reassigns_cells():
    x, y, mat, T = _random_markers(500)
    bm = bucket_from_flat(x, y, mat, T, GRID, K)
    # displace positions by up to one cell
    dxs = jnp.asarray(RNG.uniform(-GRID.dx, GRID.dx, bm.x.shape))
    dys = jnp.asarray(RNG.uniform(-GRID.dy, GRID.dy, bm.y.shape))
    moved = bm.replace(
        x=jnp.clip(bm.x + dxs * bm.valid, 1e-6, GRID.lx - 1e-6),
        y=jnp.clip(bm.y + dys * bm.valid, 1e-6, GRID.ly - 1e-6),
    )
    out, dropped = rebucket(moved, GRID)
    assert int(dropped) == 0
    assert int(out.total()) == 500
    # every valid marker is in its owning cell
    ox = np.asarray(out.x)
    oy = np.asarray(out.y)
    ov = np.asarray(out.valid)
    for j in range(GRID.ny):
        for i in range(GRID.nx):
            for k in range(K):
                if ov[j, i, k]:
                    assert int(ox[j, i, k] / GRID.dx) == i
                    assert int(oy[j, i, k] / GRID.dy) == j
    # same marker multiset as before rebucketing
    _match_marker_sets(
        out,
        jnp.asarray(np.asarray(moved.x)[np.asarray(moved.valid)]),
        jnp.asarray(np.asarray(moved.y)[np.asarray(moved.valid)]),
        jnp.asarray(np.asarray(moved.mat)[np.asarray(moved.valid)]),
        jnp.asarray(np.asarray(moved.T)[np.asarray(moved.valid)]),
    )


def test_bucket_reseed_fills_empty_cells():
    x, y, mat, T = _random_markers(400)
    bm = bucket_from_flat(x, y, mat, T, GRID, K)
    # empty out one cell
    v = bm.valid.at[3, 4, :].set(False)
    bm = bm.replace(valid=v)
    T_grid = jnp.broadcast_to(
        jnp.linspace(0.0, 1.0, GRID.ny + 1)[:, None], GRID.shape_corner
    )
    out = bucket_reseed(bm, T_grid, GRID, min_per_cell=2)
    counts = np.asarray(out.count())
    assert counts[3, 4] >= 2
    # spawned markers carry grid T (T = y)
    new = np.asarray(out.valid[3, 4]) & ~np.asarray(bm.valid[3, 4])
    ys = np.asarray(out.y[3, 4])[new]
    Ts = np.asarray(out.T[3, 4])[new]
    np.testing.assert_allclose(Ts, ys, atol=1e-6)
