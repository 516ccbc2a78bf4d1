"""One model timestep: the core loop of the framework (SURVEY.md §3.2).

    marker props -> marker->grid interp -> Stokes solve -> dt (Courant)
    -> implicit energy solve + marker T update (optional subgrid diffusion)
    -> RK4 marker advection

The whole step is a single jittable, scan-able function of ModelState: no
host round-trips, static shapes, adaptive dt as a traced scalar.  Under a
device mesh the same function runs domain-decomposed (parallel/).

The step is built from four phase closures (``make_step_phases``) so the
same code can run either fused in one jit (``make_step`` — the production
path) or phase-by-phase with host syncs for per-phase wall-clock profiling
(``make_phased_runner`` — SURVEY.md §5 tracing/profiling row).
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from pylamp_tpu.core.grid import StaggeredGrid
from pylamp_tpu.markers.advect import advect_rk4
from pylamp_tpu.markers.bucket import (
    BucketedMarkers,
    bucket_advect_rk4,
    bucket_grid_to_markers,
    bucket_markers_to_grid,
    bucket_reseed,
    rebucket,
)
from pylamp_tpu.markers.interp import grid_to_markers, markers_to_grid
from pylamp_tpu.models.config import ModelConfig
from pylamp_tpu.models.state import ModelState
from pylamp_tpu.physics.materials import MaterialTable
from pylamp_tpu.solvers.energy_solver import solve_energy, solve_energy_mixed
from pylamp_tpu.solvers.stokes_solver import solve_stokes, solve_stokes_mixed


def _m2g(markers, vals, grid, loc, mode, periodic_x=False):
    """Engine-dispatching marker->grid transfer."""
    if isinstance(markers, BucketedMarkers):
        return bucket_markers_to_grid(markers, vals, grid, loc, mode,
                                      periodic_x=periodic_x)
    return markers_to_grid(markers.x, markers.y, vals, grid, loc, mode,
                           periodic_x=periodic_x)


def _g2m(markers, field, grid, loc, periodic_x=False):
    """Engine-dispatching grid->marker interpolation."""
    if isinstance(markers, BucketedMarkers):
        return bucket_grid_to_markers(field, markers.x, markers.y,
                                      markers.valid, grid, loc,
                                      periodic_x=periodic_x)
    return grid_to_markers(field, markers.x, markers.y, grid, loc,
                           periodic_x=periodic_x)


def _interp_with_fallback(markers, vals, grid, loc, mode, fallback,
                          periodic_x=False):
    field, wsum = _m2g(markers, vals, grid, loc, mode, periodic_x=periodic_x)
    return jnp.where(wsum > 0, field, fallback)


def _marker_mean(markers, vals):
    if isinstance(markers, BucketedMarkers):
        w = markers.valid
        return jnp.sum(jnp.where(w, vals, 0.0)) / jnp.maximum(
            jnp.sum(w.astype(vals.dtype)), 1.0
        )
    return jnp.mean(vals)


class InterpOut(NamedTuple):
    """Marker->grid phase products consumed by the later phases."""

    eta_s: Any
    eta_n: Any
    rho_vx: Any
    rho_vy: Any
    k_m: Any  # marker conductivity (dt cap + energy phase)
    rhocp_m: Any  # marker rho*Cp
    H_m: Any  # marker internal heating


class StepPhases(NamedTuple):
    interp: Callable  # (state) -> InterpOut
    stokes: Callable  # (state, InterpOut) -> (vx, vy, p, diag)
    energy: Callable  # (state, InterpOut, vx, vy, dt) -> (markers, T_new, diag)
    advect: Callable  # (state, markers, vx, vy, dt, T_new) -> (markers, diag)
    timestep: Callable  # (vx, vy, k_m, rhocp_m) -> dt
    # (state, InterpOut) -> (StokesSolution in the solve's own precision,
    # per-level MG lambda bounds or None): the solve ``stokes`` wraps
    stokes_solution: Callable


def make_step_phases(grid: StaggeredGrid, cfg: ModelConfig, table: MaterialTable,
                     mesh=None):
    """``mesh``: the jax.sharding.Mesh of a domain-decomposed run."""
    phys = cfg.physics
    solver = cfg.solver
    tc = cfg.time
    vbc = phys.velocity_bcs
    tbc = phys.thermal_bcs

    if tc.courant > 1.0:
        # the bucket engine's 3x3 rebucketing and the RK4 shift reaches
        # assume markers move at most one cell per step
        raise ValueError("TimeConfig.courant must be <= 1")

    periodic = vbc.periodic_x
    if phys.solve_energy and periodic != tbc.periodic_x:
        raise ValueError(
            "periodic side walls must be set on BOTH the velocity and "
            "thermal BCs (the domain either wraps in x or it doesn't)"
        )
    if not grid.uniform and periodic:
        raise ValueError("periodic side walls need a uniform grid")

    # explicit shard_map halo exchange for the stencil applies (SURVEY.md
    # §2.3 SP row); only meaningful for domain-decomposed runs
    halo_mesh = mesh if (mesh is not None and solver.explicit_halo) else None

    # explicit-halo marker engine (parallel/halo_markers.py): every marker
    # operation under shard_map+ppermute when the bucket blocks are eligible
    # (no wrap-around exchange path yet: GSPMD partitions the periodic rolls)
    marker_halo_mesh = None
    if halo_mesh is not None and not periodic:
        from pylamp_tpu.parallel.halo_markers import halo_markers_eligible

        if halo_markers_eligible(grid, halo_mesh):
            marker_halo_mesh = halo_mesh

    def _disp_m2g(m, vals, loc, mode):
        if marker_halo_mesh is not None and isinstance(m, BucketedMarkers):
            from pylamp_tpu.parallel.halo_markers import m2g_halo

            return m2g_halo(m, vals, grid, loc, mode, marker_halo_mesh)
        return _m2g(m, vals, grid, loc, mode, periodic_x=periodic)

    def _disp_g2m(m, field, loc):
        if marker_halo_mesh is not None and isinstance(m, BucketedMarkers):
            from pylamp_tpu.parallel.halo_markers import g2m_halo

            return g2m_halo(
                field, m.x, m.y, m.valid, grid, loc, marker_halo_mesh
            )
        return _g2m(m, field, grid, loc, periodic_x=periodic)

    def _disp_interp_fb(m, vals, loc, mode, fallback):
        field, wsum = _disp_m2g(m, vals, loc, mode)
        return jnp.where(wsum > 0, field, fallback)

    if solver.preconditioner == "mg":
        from pylamp_tpu.solvers.mg import make_mg_preconditioner

        make_precond = partial(
            make_mg_preconditioner,
            levels=solver.mg_levels,
            cycles=solver.mg_cycles,
            pre_smooth=solver.mg_pre_smooth,
            post_smooth=solver.mg_post_smooth,
            smoother=solver.mg_smoother,
            omega=solver.mg_omega,
            scaled_transfers=solver.mg_scaled_transfers,
            ls_damp=solver.mg_ls_damp,
            semicoarsen=solver.mg_semicoarsen,
            mesh=mesh,
            coarse_replicate=solver.mg_coarse_replicate,
            halo_mesh=halo_mesh,
            schur=solver.schur,
            schur_poisson_iters=solver.schur_poisson_iters,
            velocity_inner_iters=solver.mg_velocity_inner_iters,
            velocity_inner_tol=solver.mg_velocity_inner_tol,
            eta_cap=solver.mg_eta_cap,
            al_gamma=solver.stokes_al_gamma,
        )
    elif solver.preconditioner == "vanka":
        from pylamp_tpu.solvers.vanka import make_vanka_mg_preconditioner

        if solver.mg_semicoarsen > 0:
            # the Vanka hierarchy has no coarsening_plan plumbing: a
            # stretched/anisotropic grid would silently full-coarsen and
            # lose the anisotropy remedy (round-3 advisor finding) — fail
            # at config time instead
            raise ValueError(
                "preconditioner='vanka' does not support mg_semicoarsen "
                "(full coarsening only); use preconditioner='mg' with "
                "mg_semicoarsen, or mg_smoother='line' for anisotropic cells"
            )
        make_precond = partial(
            make_vanka_mg_preconditioner,
            levels=solver.mg_levels,
            cycles=solver.mg_cycles,
            pre_smooth=solver.mg_pre_smooth,
            post_smooth=solver.mg_post_smooth,
        )
    elif solver.preconditioner == "jacobi":
        make_precond = None
    else:
        raise ValueError(f"unknown preconditioner {solver.preconditioner!r}")

    def _mixed(dtype):
        return solver.precision == "mixed" or (
            solver.precision == "auto"
            and dtype == jnp.float32
            and jax.config.jax_enable_x64
        )

    # ---- phase 1: marker rheology + marker -> grid ------------------------
    def interp(state: ModelState) -> InterpOut:
        m = state.markers
        dtype = m.x.dtype
        rho_m = table.density(m.mat, m.T)
        k_m = table.conductivity(m.mat, dtype)
        rhocp_m = table.rho_cp(m.mat, m.T)
        H_m = table.heating(m.mat, dtype)

        eta_m = jnp.clip(table.viscosity_of(m.mat, m.T), phys.eta_min, phys.eta_max)
        eta_s = _disp_interp_fb(m, eta_m, "corner", phys.eta_avg, state.eta_s)
        eta_n = _disp_interp_fb(m, eta_m, "center", phys.eta_avg, state.eta_n)
        rho_vy = _disp_interp_fb(
            m, rho_m, "vy", "arithmetic", _marker_mean(m, rho_m)
        )
        if phys.gx != 0.0:
            rho_vx = _disp_interp_fb(
                m, rho_m, "vx", "arithmetic", _marker_mean(m, rho_m)
            )
        else:
            rho_vx = jnp.zeros(grid.shape_vx, dtype)
        return InterpOut(eta_s, eta_n, rho_vx, rho_vy, k_m, rhocp_m, H_m)

    # the Chebyshev lambda_max bounds warm-start across steps via
    # ModelState.mg_lam (solvers/mg.py estimate_mg_lambdas): 2 refresh
    # power iterations per level instead of 12, floored at the previous
    # step's bound
    warmstart_lam = (
        solver.preconditioner == "mg" and solver.mg_smoother == "chebyshev"
    )

    # ---- phase 2: Stokes solve (warm-started) ------------------------------
    def stokes_solution(state: ModelState, io: InterpOut):
        dtype = state.markers.x.dtype
        mk = make_precond
        lam_new = None
        if warmstart_lam and state.mg_lam is not None and state.mg_lam.shape[0] > 0:
            from pylamp_tpu.solvers.mg import estimate_mg_lambdas
            from pylamp_tpu.solvers.scaling import (
                characteristic_viscosity,
                stokes_scales,
            )

            wdtype = jnp.float32 if _mixed(dtype) else dtype
            es_w = io.eta_s.astype(wdtype)
            en_w = io.eta_n.astype(wdtype)
            _, kbnd_w = stokes_scales(characteristic_viscosity(en_w), grid)
            if solver.mg_lam_mode == "gershgorin" and grid.uniform:
                # analytic bound: cheap enough to recompute every step
                lam_new = estimate_mg_lambdas(
                    es_w, en_w, grid, vbc, kbnd_w,
                    levels=solver.mg_levels,
                    semicoarsen=solver.mg_semicoarsen, mode="gershgorin",
                )
            else:
                # power iteration: per-level dispatch dominates its cost,
                # so refresh on a cadence and carry the bounds in the state
                hint32 = state.mg_lam.astype(wdtype)
                refresh = jnp.logical_or(
                    state.step % solver.mg_lam_refresh_every == 0,
                    hint32[0] <= 0,
                )
                lam_new = jax.lax.cond(
                    refresh,
                    lambda: estimate_mg_lambdas(
                        es_w, en_w, grid, vbc, kbnd_w,
                        levels=solver.mg_levels,
                        semicoarsen=solver.mg_semicoarsen, hint=state.mg_lam,
                    ),
                    lambda: hint32,
                )
            mk = partial(make_precond, lam_max=lam_new)
        if _mixed(dtype):
            sol = solve_stokes_mixed(
                io.eta_s, io.eta_n, io.rho_vx, io.rho_vy, phys.gx, phys.gy,
                grid, vbc,
                tol=solver.stokes_tol,
                inner_tol=solver.inner_tol,
                restart=solver.stokes_restart,
                maxiter=solver.stokes_maxiter,
                max_refinements=solver.max_refinements,
                x0=(state.vx, state.vy, state.p),
                make_preconditioner=mk,
                halo_mesh=halo_mesh,
                al_gamma=solver.stokes_al_gamma,
            )
        else:
            sol = solve_stokes(
                io.eta_s, io.eta_n, io.rho_vx, io.rho_vy, phys.gx, phys.gy,
                grid, vbc,
                tol=solver.stokes_tol,
                restart=solver.stokes_restart,
                maxiter=solver.stokes_maxiter,
                x0=(state.vx, state.vy, state.p),
                make_preconditioner=mk,
                halo_mesh=halo_mesh,
            )
        return sol, lam_new

    def stokes(state: ModelState, io: InterpOut):
        dtype = state.markers.x.dtype
        sol, lam_new = stokes_solution(state, io)
        vx = sol.vx.astype(dtype)
        vy = sol.vy.astype(dtype)
        p = sol.p.astype(dtype)
        diag = {
            "stokes_iterations": sol.info.iterations,
            "stokes_residual": sol.info.residual,
            # the convergence criterion quantity (tolerance is relative)
            "stokes_residual_rel": sol.info.residual
            / jnp.maximum(sol.info.bnorm, jnp.finfo(sol.info.residual.dtype).tiny),
            "stokes_converged": sol.info.converged,
            "vmax": jnp.maximum(jnp.max(jnp.abs(vx)), jnp.max(jnp.abs(vy))),
            "vrms": jnp.sqrt(
                jnp.mean(
                    (0.5 * (vx[:, 1:] + vx[:, :-1])) ** 2
                    + (0.5 * (vy[1:, :] + vy[:-1, :])) ** 2
                )
            ),
        }
        if lam_new is not None:
            # internal: carried into the next ModelState by the step
            # assemblers (make_step/make_phased_runner pop it from diag)
            diag["_mg_lam"] = lam_new.astype(state.mg_lam.dtype)
        return vx, vy, p, diag

    # ---- dt selection (Courant + optional diffusion cap) --------------------
    def timestep(vx, vy, k_m, rhocp_m):
        dtype = vx.dtype
        vxmax = jnp.max(jnp.abs(vx))
        vymax = jnp.max(jnp.abs(vy))
        big = jnp.asarray(jnp.finfo(dtype).max / 4, dtype)
        # stretched grids: the smallest cell bounds the Courant step
        dt_adv = tc.courant * jnp.minimum(
            jnp.where(vxmax > 0, grid.dx_min / vxmax, big),
            jnp.where(vymax > 0, grid.dy_min / vymax, big),
        )
        dt = jnp.minimum(dt_adv, tc.dt_max)
        if tc.dt_diff_factor != float("inf") and phys.solve_energy:
            kappa_max = jnp.max(k_m / rhocp_m)
            dt_diff = tc.dt_diff_factor * min(grid.dx_min, grid.dy_min) ** 2 / kappa_max
            dt = jnp.minimum(dt, dt_diff)
        return jnp.maximum(dt, tc.dt_min)

    # ---- phase 3: energy solve + marker temperature update ------------------
    def energy(state: ModelState, io: InterpOut, vx, vy, dt):
        m = state.markers
        dtype = m.x.dtype
        diag: Dict[str, Any] = {}
        if not phys.solve_energy:
            return m, state.T, diag

        T_old = _disp_interp_fb(m, m.T, "corner", "arithmetic", state.T)
        k_g = _disp_interp_fb(
            m, io.k_m, "corner", "arithmetic", _marker_mean(m, io.k_m)
        )
        rhocp_g = _disp_interp_fb(
            m, io.rhocp_m, "corner", "arithmetic", _marker_mean(m, io.rhocp_m)
        )
        H_g = _disp_interp_fb(
            m, io.H_m, "corner", "arithmetic", jnp.asarray(0.0, dtype)
        )
        if phys.shear_heating:
            from pylamp_tpu.physics.heating import shear_heating

            H_g = H_g + shear_heating(vx, vy, io.eta_n, grid, vbc)
        if phys.adiabatic_heating:
            from pylamp_tpu.physics.heating import adiabatic_heating

            ra_m = table._select(table.rho0, m.mat, dtype) * table._select(
                table.alpha, m.mat, dtype
            )
            ra_g = _disp_interp_fb(
                m, ra_m, "corner", "arithmetic", _marker_mean(m, ra_m)
            )
            H_g = H_g + adiabatic_heating(T_old, ra_g, vy, phys.gy, grid)
        if _mixed(dtype):
            esol = solve_energy_mixed(
                T_old, k_g, rhocp_g / dt, H_g, grid, tbc,
                tol=solver.energy_tol,
                maxiter=solver.energy_maxiter,
                k_avg=phys.k_face_avg,
                preconditioner=solver.energy_preconditioner,
                halo_mesh=halo_mesh,
                mg_smoother=solver.energy_mg_smoother,
                mg_omega=solver.mg_omega,
                mg_semicoarsen=solver.mg_semicoarsen,
            )
        else:
            esol = solve_energy(
                T_old, k_g, rhocp_g / dt, H_g, grid, tbc,
                tol=solver.energy_tol,
                maxiter=solver.energy_maxiter,
                k_avg=phys.k_face_avg,
                preconditioner=solver.energy_preconditioner,
                halo_mesh=halo_mesh,
                mg_smoother=solver.energy_mg_smoother,
                mg_omega=solver.mg_omega,
                mg_semicoarsen=solver.mg_semicoarsen,
            )
        T_new = esol.T.astype(dtype)

        if phys.subgrid_diffusion_d > 0.0:
            # Gerya-style subgrid diffusion: relax marker T toward the
            # old grid T on the cell-diffusion timescale, then remap
            # only the remaining part of dT (SURVEY.md §2.1
            # "subgrid-diffusion correction").
            T_node_at_m = _disp_g2m(m, T_old, "corner")
            t_diff = io.rhocp_m / (
                io.k_m * (2.0 / grid.dx_min**2 + 2.0 / grid.dy_min**2)
            )
            relax = 1.0 - jnp.exp(-phys.subgrid_diffusion_d * dt / t_diff)
            dT_sub_m = (T_node_at_m - m.T) * relax
            dT_sub_g, wsub = _disp_m2g(m, dT_sub_m, "corner", "arithmetic")
            dT_sub_g = jnp.where(wsub > 0, dT_sub_g, 0.0)
            dT_rem = (T_new - T_old) - dT_sub_g
            T_m = m.T + dT_sub_m + _disp_g2m(m, dT_rem, "corner")
        else:
            dT = T_new - T_old
            T_m = m.T + _disp_g2m(m, dT, "corner")

        markers = m.replace(T=T_m)
        diag["energy_iterations"] = esol.info.iterations
        diag["T_mean"] = jnp.mean(T_new)
        return markers, T_new, diag

    # ---- phase 4: advect markers (+ re-bucket in the dense engine) ----------
    def advect(markers, vx, vy, dt, T_new):
        diag: Dict[str, Any] = {}
        if isinstance(markers, BucketedMarkers):
            # Courant <= 0.5 (and static walls) bounds every RK stage
            # displacement to half a cell -> the cheaper shift reach applies.
            moving_walls = any(
                getattr(vbc, f) != 0.0
                for f in ("vt_top", "vt_bottom", "vt_left", "vt_right")
            )
            # (dt_min could push dt past the Courant bound -> stay at 2)
            reach = 1 if (tc.courant <= 0.5 and tc.dt_min == 0.0
                          and not moving_walls) else 2
            if marker_halo_mesh is not None:
                # explicit shard_map+ppermute path (parallel/halo_markers.py)
                from pylamp_tpu.parallel.halo_markers import (
                    advect_rk4_halo,
                    rebucket_halo,
                )

                markers = advect_rk4_halo(
                    markers, vx, vy, dt, grid, vbc, marker_halo_mesh,
                    stage_reach=reach,
                )
                markers, dropped = rebucket_halo(markers, grid,
                                                 marker_halo_mesh)
            else:
                markers = bucket_advect_rk4(markers, vx, vy, dt, grid, vbc,
                                            stage_reach=reach)
                markers, dropped = rebucket(markers, grid, periodic_x=periodic)
            diag["markers_dropped"] = dropped
            diag["marker_count"] = markers.total()
            if phys.reseed_min_per_cell > 0:
                if marker_halo_mesh is not None:
                    from pylamp_tpu.parallel.halo_markers import reseed_halo

                    markers = reseed_halo(
                        markers, T_new, grid,
                        min_per_cell=phys.reseed_min_per_cell,
                        n_materials=len(table),
                        mesh=marker_halo_mesh,
                    )
                else:
                    markers = bucket_reseed(
                        markers, T_new, grid,
                        min_per_cell=phys.reseed_min_per_cell,
                        n_materials=len(table),
                        periodic_x=periodic,
                    )
        else:
            px, py = advect_rk4(markers.x, markers.y, vx, vy, dt, grid, vbc)
            markers = markers.replace(x=px, y=py)

            # ---- repopulate starved cells (optional) ------------------------
            if phys.reseed_min_per_cell > 0:
                from pylamp_tpu.markers.reseed import reseed_starved

                markers = reseed_starved(
                    markers,
                    T_new,
                    grid,
                    n_materials=len(table),
                    min_per_cell=phys.reseed_min_per_cell,
                    max_moves=phys.reseed_max_moves,
                    periodic_x=periodic,
                )
        return markers, diag

    return StepPhases(interp, stokes, energy, advect, timestep, stokes_solution)


def make_step(grid: StaggeredGrid, cfg: ModelConfig, table: MaterialTable,
              mesh=None):
    """The fused production step: all phases traced into one function.

    ``mesh``: the jax.sharding.Mesh of a domain-decomposed run; enables
    the mesh-aware solver options (MG coarse-level replication)."""
    ph = make_step_phases(grid, cfg, table, mesh=mesh)

    def step(state: ModelState) -> Tuple[ModelState, Dict[str, Any]]:
        io = ph.interp(state)
        vx, vy, p, diag = ph.stokes(state, io)
        mg_lam = diag.pop("_mg_lam", state.mg_lam)
        dt = ph.timestep(vx, vy, io.k_m, io.rhocp_m)
        diag["dt"] = dt
        markers, T_new, ediag = ph.energy(state, io, vx, vy, dt)
        diag.update(ediag)
        markers, adiag = ph.advect(markers, vx, vy, dt, T_new)
        diag.update(adiag)

        new_state = state.replace(
            markers=markers,
            vx=vx,
            vy=vy,
            p=p,
            T=T_new,
            eta_s=io.eta_s,
            eta_n=io.eta_n,
            time=state.time + dt,
            step=state.step + 1,
            dt=dt,
            mg_lam=mg_lam,
        )
        return new_state, diag

    return step


def make_multi_step(grid: StaggeredGrid, cfg: ModelConfig, table: MaterialTable,
                    n_steps: int, mesh=None):
    """``n_steps`` production steps fused into one ``lax.scan``: zero host
    round-trips between steps (the single-step driver synchronizes every
    step to read diagnostics — round-1 verdict flagged that as the
    small-grid throughput cap and a multi-chip serializer).

    Returns ``multi(state) -> (state, diags)`` where every diag value
    carries a leading ``(n_steps,)`` axis (per-step history, so the JSONL
    metrics stay per-step even in scanned mode)."""
    from jax import lax

    step = make_step(grid, cfg, table, mesh=mesh)

    def multi(state: ModelState):
        def body(s, _):
            return step(s)

        return lax.scan(body, state, None, length=n_steps)

    return multi


def make_phased_runner(grid: StaggeredGrid, cfg: ModelConfig, table: MaterialTable):
    """Per-phase-instrumented step for profiling (SURVEY.md §5 tracing row).

    Returns ``run(state) -> (new_state, diag)`` where ``diag`` additionally
    carries ``phase_seconds``: wall-clock per phase (interp / stokes / energy
    / advect), each phase jitted separately and synced.  Numerically
    identical to ``make_step`` (same phase closures); only for measurement —
    the syncs cost a few ms/step.
    """
    from pylamp_tpu.utils.profiling import phase

    ph = make_step_phases(grid, cfg, table)

    interp_j = jax.jit(ph.interp)
    stokes_j = jax.jit(ph.stokes)
    ts_j = jax.jit(ph.timestep)
    energy_j = jax.jit(ph.energy)
    advect_j = jax.jit(ph.advect)

    import time as _time

    def run(state: ModelState):
        secs: Dict[str, float] = {}

        t0 = _time.perf_counter()
        with phase("interp"):
            io = jax.block_until_ready(interp_j(state))
        secs["interp"] = _time.perf_counter() - t0

        t0 = _time.perf_counter()
        with phase("stokes"):
            vx, vy, p, diag = stokes_j(state, io)
            jax.block_until_ready(vx)
        secs["stokes"] = _time.perf_counter() - t0
        mg_lam = diag.pop("_mg_lam", state.mg_lam)

        dt = ts_j(vx, vy, io.k_m, io.rhocp_m)
        diag["dt"] = dt

        t0 = _time.perf_counter()
        with phase("energy"):
            markers, T_new, ediag = jax.block_until_ready(
                energy_j(state, io, vx, vy, dt)
            )
        secs["energy"] = _time.perf_counter() - t0
        diag.update(ediag)

        t0 = _time.perf_counter()
        with phase("advect"):
            markers, adiag = advect_j(markers, vx, vy, dt, T_new)
            jax.block_until_ready(markers.x)
        secs["advect"] = _time.perf_counter() - t0
        diag.update(adiag)

        new_state = state.replace(
            markers=markers, vx=vx, vy=vy, p=p, T=T_new,
            eta_s=io.eta_s, eta_n=io.eta_n,
            time=state.time + dt, step=state.step + 1, dt=dt,
            mg_lam=mg_lam,
        )
        diag["phase_seconds"] = secs
        return new_state, diag

    return run
