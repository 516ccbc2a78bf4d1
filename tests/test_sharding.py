"""Distributed tier (SURVEY.md §4): the sharded step must (a) run on an
8-device mesh and (b) agree with the single-device run to solver tolerance."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pylamp_tpu.models.benchmarks import falling_block
from pylamp_tpu.models.config import SolverConfig
from pylamp_tpu.models.setup import build
from pylamp_tpu.models.step import make_step
from pylamp_tpu.parallel.mesh import make_mesh, shard_state, state_shardings


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_step_matches_single_device():
    cfg = falling_block(nx=32, ny=32, max_steps=2)
    cfg = dataclasses.replace(
        cfg,
        solver=SolverConfig(precision="f64", stokes_tol=1e-10,
                            stokes_restart=40, stokes_maxiter=400),
    )
    grid, table, state0 = build(cfg)
    step = make_step(grid, cfg, table)

    # single device
    s1, d1 = jax.jit(step)(state0)

    # 8-device 2-D mesh
    mesh = make_mesh(8)
    sharded = shard_state(state0, mesh)
    shardings = state_shardings(mesh, state0)
    s8, d8 = jax.jit(step, in_shardings=(shardings,))(sharded)

    assert bool(d8["stokes_converged"])
    tol = 1e-8  # both runs solve to 1e-10; iteration order may differ
    vref = float(jnp.max(jnp.abs(s1.vy)))
    np.testing.assert_allclose(np.asarray(s8.vx), np.asarray(s1.vx), atol=tol * max(vref, 1))
    np.testing.assert_allclose(np.asarray(s8.vy), np.asarray(s1.vy), atol=tol * max(vref, 1))
    np.testing.assert_allclose(
        np.asarray(s8.markers.y), np.asarray(s1.markers.y), atol=1e-9
    )


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_f32_step_never_dispatches_pallas_rebucket():
    """The f32 step runs sharded over a mesh and vmapped in a sweep; both
    take the one XLA rebucket (the package has no Pallas kernel left to
    dispatch)."""
    import importlib.util

    assert importlib.util.find_spec("pylamp_tpu.markers.pallas") is None

    cfg = falling_block(nx=32, ny=32, max_steps=1)
    cfg = dataclasses.replace(
        cfg,
        solver=SolverConfig(precision="f32", stokes_tol=1e-4,
                            stokes_maxiter=200),
    )
    grid, table, state0 = build(cfg)
    state0 = jax.tree.map(
        lambda l: l.astype(jnp.float32) if l.dtype == jnp.float64 else l,
        state0,
    )

    # sharded step
    mesh = make_mesh(8)
    step = make_step(grid, cfg, table, mesh=mesh)
    sharded = shard_state(state0, mesh)
    shardings = state_shardings(mesh, state0)
    s8, d8 = jax.jit(step, in_shardings=(shardings,))(sharded)
    assert np.isfinite(float(d8["stokes_residual"]))

    # vmapped sweep path
    from pylamp_tpu.models.sweep import make_sweep_step, stack_states

    bstep, params = make_sweep_step(grid, cfg, [table, table])
    bstate = stack_states([state0, state0])
    _, bd = bstep(bstate, params)
    assert np.all(np.isfinite(np.asarray(bd["dt"])))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_dryrun_multichip():
    from pylamp_tpu.parallel.dryrun import dryrun_multichip

    dryrun_multichip(8)


@pytest.mark.slow
@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_sticky_air_with_coarse_replication():
    """Sharp-contrast (sticky-air) config, sharded, with MG coarse-level
    replication active (SURVEY.md §5 long-context row): must converge and
    match the single-device run."""
    from pylamp_tpu.models.benchmarks import sticky_air

    cfg = sticky_air(nx=64, ny=32, max_steps=1)
    cfg = dataclasses.replace(
        cfg,
        solver=SolverConfig(
            precision="f64",
            stokes_tol=1e-8,
            stokes_restart=60,
            stokes_maxiter=2000,
            mg_coarse_replicate=8,
        ),
    )
    grid, table, state0 = build(cfg)
    mesh = make_mesh(8)

    s1, d1 = jax.jit(make_step(grid, cfg, table))(state0)

    step = make_step(grid, cfg, table, mesh=mesh)
    sharded = shard_state(state0, mesh)
    shardings = state_shardings(mesh, state0)
    s8, d8 = jax.jit(step, in_shardings=(shardings,))(sharded)

    assert bool(d8["stokes_converged"]), int(d8["stokes_iterations"])
    vref = max(float(jnp.max(jnp.abs(s1.vy))), 1e-30)
    np.testing.assert_allclose(
        np.asarray(s8.vx), np.asarray(s1.vx), atol=1e-6 * vref
    )
    np.testing.assert_allclose(
        np.asarray(s8.vy), np.asarray(s1.vy), atol=1e-6 * vref
    )
