"""Model configuration tree.

The reference is configured by editing constants in the driver script
(SURVEY.md §5 "Config / flag system"); here configuration is an explicit
dataclass tree, checked in per benchmark under configs/ and usable from the
CLI."""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from pylamp_tpu.core.bc import ThermalBCs, VelocityBCs
from pylamp_tpu.physics.materials import Material


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    gx: float = 0.0
    gy: float = 9.81  # y points down
    materials: Sequence[Material] = (Material(),)
    velocity_bcs: VelocityBCs = VelocityBCs()
    thermal_bcs: ThermalBCs = ThermalBCs()
    eta_min: float = 1e-12
    eta_max: float = 1e30
    # marker->grid viscosity averaging ("arithmetic"|"geometric"|"harmonic")
    eta_avg: str = "geometric"
    k_face_avg: str = "arithmetic"
    solve_energy: bool = True
    shear_heating: bool = False  # H_s = sigma':e' = 4 eta e_II^2
    adiabatic_heating: bool = False  # H_a = rho0 alpha T g vy (y down)
    subgrid_diffusion_d: float = 0.0  # 0 = plain dT remapping; ~1 = Gerya
    reseed_min_per_cell: int = 0  # 0 = reseeding off
    reseed_max_moves: int = 256


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    # "auto": plain solves in the state dtype, except f32 state with x64
    # available -> mixed (f32 inner solves + f64 iterative refinement, the
    # path to 1e-8 from an f32 state); "f32"/"f64"/"mixed" force a mode.
    precision: str = "auto"
    inner_tol: float = 1e-4  # inner-solve tolerance in mixed mode
    max_refinements: int = 6
    stokes_tol: float = 1e-8
    stokes_restart: int = 25  # measured optimum at 1024^2 (0.49 vs 0.57 s at 40)
    stokes_maxiter: int = 2000
    preconditioner: str = "mg"  # "mg" | "jacobi"
    mg_levels: int = 0  # 0 = auto (coarsen to ~4 cells)
    mg_cycles: int = 1  # V-cycles per application (>1 can DIVERGE at high
    # viscosity contrast: a marginal cycle amplifies when iterated)
    mg_pre_smooth: int = 3  # Chebyshev degree
    mg_post_smooth: int = 3
    # V-cycle smoother: "chebyshev" (default), "jacobi", or line relaxation for anisotropic stretched grids —
    # "line" (alternating y/x tridiagonal sweeps, solvers/lines.py),
    # "line_y" / "line_x" (one axis).  Line smoothing requires
    # non-periodic side walls.
    mg_smoother: str = "chebyshev"
    # damping for the jacobi / line smoothers (chebyshev ignores it)
    mg_omega: float = 0.6
    # Chebyshev lambda_max estimation (solvers/mg.py estimate_mg_lambdas):
    # "gershgorin" (default on uniform grids) = rigorous analytic row-sum
    # bound, no operator applies; "power" = per-level power iteration
    # refreshed every mg_lam_refresh_every steps (warm-started through
    # ModelState.mg_lam; its per-level dispatch is why it runs on a
    # cadence).  Non-uniform levels always use power iteration.
    mg_lam_mode: str = "gershgorin"
    mg_lam_refresh_every: int = 8
    # Extreme-contrast stabilizers (solvers/mg.py): diagonally-scaled
    # transfers + per-level minimal-residual damping of the coarse
    # correction.  Makes the V-cycle monotone at sticky-air-scale sharp
    # viscosity jumps where the plain cycle diverges.
    mg_scaled_transfers: bool = False
    mg_ls_damp: bool = False
    # Semi-coarsening for anisotropic cells (solvers/mg.py
    # coarsening_plan): when one axis's minimum cell spacing is at least
    # this factor smaller than the other's, coarsen only that finer axis
    # until the aspect rebalances, then full-coarsen.  The standard
    # point-smoother remedy for stretched/high-aspect grids (line smoothing
    # is the complementary lever, mg_smoother="line*").  Square-cell grids
    # build the identical full-coarsening hierarchy.  0 disables.
    # NOTE: the config-level default is 2.0 (on), while the low-level
    # library entry points (solvers.mg.make_velocity_mg,
    # solvers.energy_mg.make_energy_mg_preconditioner) default to 0.0
    # (full coarsening) — direct API callers opt in explicitly; the
    # Vanka path (solvers/vanka.py) has no semicoarsen plumbing at all.
    mg_semicoarsen: float = 2.0
    # Pressure Schur surrogate: "mass" = -(eta_n/kcont) local scaling;
    # "wbfbt" = weighted BFBT (solvers/bfbt.py) — contrast-robust for
    # sharp-interface fields (sticky air), ~2 pressure-Poisson V-cycle
    # solves extra per preconditioner application.
    schur: str = "mass"
    schur_poisson_iters: int = 3
    # > 0: augmented-Lagrangian grad-div row operation (solvers/al.py) —
    # momentum rows += gamma * D^T(eta_n * div u), Schur surrogate scaled
    # by (1 + gamma).  The contrast-robust Schur remedy for cell-sharp
    # viscosity interfaces (sticky air); pair with
    # mg_velocity_inner_iters > 0 (the inner Krylov is what targets the
    # augmented velocity block).  Uniform grids only.
    stokes_al_gamma: float = 0.0
    # > 0: replace the velocity block's single V-cycle with a loose inner
    # FGMRES solve (V-cycle preconditioned, at most this many iterations)
    # — the measured fix for sharp-interface extreme contrast, where one
    # V-cycle barely reduces the momentum residual (solvers/mg.py).
    mg_velocity_inner_iters: int = 0
    mg_velocity_inner_tol: float = 3e-2
    # > 0: clip every COARSE MG level's viscosity to +-this factor around
    # the level's geometric mean (solvers/mg.py make_velocity_mg).  The
    # fine level always keeps the true viscosity; only the coarse-grid
    # corrections come from the milder surrogate — a sharp-interface
    # (sticky-air) robustness remedy.  0 disables.
    mg_eta_cap: float = 0.0
    # Multi-chip: replicate MG levels whose smaller extent is <= this many
    # cells across the device mesh (one all-gather per V-cycle) instead of
    # leaving them domain-decomposed and bound by exchange latency.  Takes
    # effect only when make_step receives a mesh.  0 = off.
    mg_coarse_replicate: int = 0
    # Multi-chip: route every Stokes/energy stencil application through the
    # explicit shard_map + ppermute halo-exchange operators
    # (parallel/halo_ops.py) instead of GSPMD auto-partitioning.  Takes
    # effect only when make_step receives a mesh; levels/grids that don't
    # decompose evenly fall back to GSPMD per application.
    explicit_halo: bool = False
    energy_tol: float = 1e-10
    energy_maxiter: int = 2000
    # "jacobi" is optimal while rho*Cp/dt dominates (transient steps);
    # "mg" keeps CG iteration counts mesh-independent when diffusion
    # dominates (steady/large-dt problems) — solvers/energy_mg.py.
    energy_preconditioner: str = "jacobi"
    # Energy V-cycle smoother (with energy_preconditioner="mg"):
    # "chebyshev", or "line"/"line_y"/"line_x" tridiagonal relaxation for
    # anisotropic stretched grids (coefficients probe-extracted from the
    # level operator; shares mg_omega).
    energy_mg_smoother: str = "chebyshev"


@dataclasses.dataclass(frozen=True)
class TimeConfig:
    courant: float = 0.5
    dt_max: float = float("inf")
    dt_min: float = 0.0
    dt_diff_factor: float = float("inf")  # cap dt at factor * diffusion time
    max_steps: int = 100
    max_time: float = float("inf")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    nx: int = 64
    ny: int = 64
    lx: float = 1.0
    ly: float = 1.0
    # Optional stretched-grid edge coordinates (monotone tuples spanning
    # [0, lx] / [0, ly] with nx+1 / ny+1 entries; see core/grid.py and the
    # generators geometric_edges / refined_band_edges).  None = uniform.
    x_edges: tuple | None = None
    y_edges: tuple | None = None
    markers_per_cell_dim: int = 3
    # "bucket": dense (ny, nx, K) cell-bucketed markers — the production
    # path (no scatter/gather in the step); "flat": (N,) arrays with XLA
    # scatter/gather (reference-style semantics, used by oracle-parity tests)
    marker_engine: str = "bucket"
    marker_capacity: int = 0  # 0 = auto: 2 * markers_per_cell_dim^2
    seed: int = 0
    physics: PhysicsConfig = PhysicsConfig()
    solver: SolverConfig = SolverConfig()
    time: TimeConfig = TimeConfig()
    # Initial conditions: callables evaluated at setup (host side, numpy ok):
    # material_of(x, y) -> int array; T_of(x, y) -> float array
    material_of: Callable | None = None
    T_of: Callable | None = None
    name: str = "model"
