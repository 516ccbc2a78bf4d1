"""The five [DRIVER] benchmark model configurations (BASELINE.json
``configs``; SURVEY.md §4) expressed as checked-in ModelConfigs, plus the
standard diagnostics (Nusselt number, v_rms) used to compare against
published community values.

All convection cases use the standard non-dimensionalization (unit box,
kappa = 1, eta_ref = 1, DT = 1): the Boussinesq buoyancy is rho0*alpha = Ra
with g = 1, so velocities are in units of kappa/h and Nu is directly
comparable with Blankenbach et al. (1989)."""
from __future__ import annotations

import numpy as np

from pylamp_tpu.core.bc import ThermalBC, ThermalBCs, VelocityBCs
from pylamp_tpu.models.config import ModelConfig, PhysicsConfig, SolverConfig, TimeConfig
from pylamp_tpu.physics.materials import Material


# -- diagnostics --------------------------------------------------------------

def _wall_gradient_coeffs(h1, h2):
    """2nd-order one-sided derivative coefficients at the wall node for
    node gaps h1 (wall->next) and h2 (next->third)."""
    c0 = -(2.0 * h1 + h2) / (h1 * (h1 + h2))
    c1 = (h1 + h2) / (h1 * h2)
    c2 = -h1 / (h2 * (h1 + h2))
    return c0, c1, c2


def _x_average(f, grid):
    """Trapezoid average of a corner-row quantity over x (stretched-aware)."""
    import jax.numpy as jnp

    if grid.uniform:
        w = jnp.ones(grid.nx + 1).at[0].set(0.5).at[-1].set(0.5)
        return jnp.sum(f * w) / grid.nx
    dxs = jnp.asarray(grid.dxs, f.dtype)
    return jnp.sum(0.5 * (f[:-1] + f[1:]) * dxs) / grid.lx


def nusselt_top(T, grid):
    """Nu = <dT/dy> at the top wall (y points DOWN, T=0 top / T=1 bottom on
    the unit box, so the conductive profile T=y gives Nu = 1).  One-sided
    2nd-order difference on corner nodes (nonuniform coefficients on a
    stretched grid), trapezoid in x."""
    h1, h2 = float(grid.dys[0]), float(grid.dys[1])
    c0, c1, c2 = _wall_gradient_coeffs(h1, h2)
    dTdy = c0 * T[0, :] + c1 * T[1, :] + c2 * T[2, :]
    return _x_average(dTdy, grid)


def nusselt_bottom(T, grid):
    """Nu at the bottom wall (equals nusselt_top in steady state)."""
    h1, h2 = float(grid.dys[-1]), float(grid.dys[-2])
    c0, c1, c2 = _wall_gradient_coeffs(h1, h2)
    dTdy = -(c0 * T[-1, :] + c1 * T[-2, :] + c2 * T[-3, :])
    return _x_average(dTdy, grid)


def vrms_box(vx, vy):
    """Volume RMS velocity on cell centers."""
    import jax.numpy as jnp

    vxc = 0.5 * (vx[:, 1:] + vx[:, :-1])
    vyc = 0.5 * (vy[1:, :] + vy[:-1, :])
    return jnp.sqrt(jnp.mean(vxc**2 + vyc**2))


# -- config 1: falling-block Rayleigh-Taylor ----------------------------------

def falling_block(nx=64, ny=64, eta_block=1.0, rho_block=2.0, max_steps=20):
    """Isoviscous dense block sinking in a unit box (BASELINE config 1)."""
    ambient = Material(name="ambient", rho0=1.0, eta0=1.0, viscosity="constant")
    block = Material(name="block", rho0=rho_block, eta0=eta_block, viscosity="constant")

    def material_of(x, y):
        return (
            (np.abs(x - 0.5) < 0.15) & (np.abs(y - 0.25) < 0.15)
        ).astype(np.int32)

    return ModelConfig(
        nx=nx, ny=ny, lx=1.0, ly=1.0,
        physics=PhysicsConfig(
            gx=0.0, gy=1.0,
            materials=(ambient, block),
            velocity_bcs=VelocityBCs(),
            solve_energy=False,
            eta_avg="geometric",
        ),
        solver=SolverConfig(),
        time=TimeConfig(courant=0.5, max_steps=max_steps),
        material_of=material_of,
        name="falling_block",
    )


# -- periodic-sides variant: block straddling the wrap-around seam ------------

def falling_block_periodic(nx=64, ny=64, eta_block=1.0, rho_block=2.0,
                           max_steps=20):
    """Falling block with PERIODIC side walls, centered ON the seam (x = 0
    == x = lx): the block is split across the two array edges and must sink
    as one coherent body through the wrap-around — the demonstration config
    for the periodic lateral BCs (core/bc.py PERIODIC)."""
    ambient = Material(name="ambient", rho0=1.0, eta0=1.0, viscosity="constant")
    block = Material(name="block", rho0=rho_block, eta0=eta_block,
                     viscosity="constant")

    def material_of(x, y):
        dxp = np.abs(x - 0.0)
        dxp = np.minimum(dxp, 1.0 - dxp)  # periodic x-distance to the seam
        return ((dxp < 0.15) & (np.abs(y - 0.25) < 0.15)).astype(np.int32)

    return ModelConfig(
        nx=nx, ny=ny, lx=1.0, ly=1.0,
        physics=PhysicsConfig(
            gx=0.0, gy=1.0,
            materials=(ambient, block),
            velocity_bcs=VelocityBCs(left="periodic", right="periodic"),
            thermal_bcs=ThermalBCs(
                left=ThermalBC("periodic", 0.0), right=ThermalBC("periodic", 0.0)
            ),
            solve_energy=False,
            eta_avg="geometric",
        ),
        solver=SolverConfig(),
        time=TimeConfig(courant=0.5, max_steps=max_steps),
        material_of=material_of,
        name="falling_block_periodic",
    )


# -- config 2: Blankenbach case 1a --------------------------------------------

BLANKENBACH_1A_NU = 4.884409  # Blankenbach et al. (1989) benchmark value
BLANKENBACH_1A_VRMS = 42.864947

def blankenbach_case1a(nx=64, ny=64, Ra=1e4, max_steps=2000, max_time=0.25):
    """Isoviscous convection at Ra = 1e4 (BASELINE config 2).  Steady-state
    Nu = 4.8844, vrms = 42.865 (community values)."""
    # rho = Ra*(1 - T): rho0 = Ra, alpha = 1 -> buoyancy rho0*alpha*g = Ra;
    # rho0*cp = 1 and k = 1 -> kappa = 1 (unit diffusion time scaling).
    mat = Material(name="fluid", rho0=Ra, alpha=1.0, T_ref=0.0, eta0=1.0,
                   viscosity="constant", k=1.0, cp=1.0 / Ra)

    def T_of(x, y):
        # conductive profile + single-mode perturbation to seed the cell
        return y + 0.05 * np.cos(np.pi * x) * np.sin(np.pi * y)

    return ModelConfig(
        nx=nx, ny=ny, lx=1.0, ly=1.0,
        physics=PhysicsConfig(
            gx=0.0, gy=1.0,
            materials=(mat,),
            velocity_bcs=VelocityBCs(),  # free slip everywhere
            thermal_bcs=ThermalBCs(
                top=ThermalBC("dirichlet", 0.0),
                bottom=ThermalBC("dirichlet", 1.0),
                left=ThermalBC("neumann", 0.0),
                right=ThermalBC("neumann", 0.0),
            ),
            solve_energy=True,
            subgrid_diffusion_d=0.0,  # d=1 over-damps the thermal BL at 64^2: Nu -13% (measured); 0 = plain dT remap
        ),
        solver=SolverConfig(),
        time=TimeConfig(courant=0.5, max_steps=max_steps, max_time=max_time,
                        dt_diff_factor=5.0),
        T_of=T_of,
        name="blankenbach_1a",
    )


# -- config 3: Frank-Kamenetskii stagnant lid ---------------------------------

def fk_stagnant_lid(nx=64, ny=64, Ra_top=100.0, visc_contrast=1e4,
                    max_steps=3000, max_time=1.0):
    """T-dependent viscosity convection, eta = exp(-gamma T) with
    gamma = ln(visc_contrast) (BASELINE config 3).  With Ra(top) = 100 and
    contrast 1e4 (Ra_bottom = 1e6) the flow convects under a stagnant lid
    (Solomatov 1995: gamma = 9.2 > gamma_crit ~ 8).  Ra_top = 10 was
    measured sub-critical here: the perturbation decays to conduction."""
    gamma = float(np.log(visc_contrast))
    mat = Material(
        name="fk_fluid", rho0=Ra_top, alpha=1.0, T_ref=0.0,
        eta0=1.0, viscosity="frank_kamenetskii", fk_gamma=gamma,
        k=1.0, cp=1.0 / Ra_top,
    )

    def T_of(x, y):
        return y + 0.05 * np.cos(np.pi * x) * np.sin(np.pi * y)

    return ModelConfig(
        nx=nx, ny=ny, lx=1.0, ly=1.0,
        physics=PhysicsConfig(
            gx=0.0, gy=1.0,
            materials=(mat,),
            velocity_bcs=VelocityBCs(),
            thermal_bcs=ThermalBCs(
                top=ThermalBC("dirichlet", 0.0),
                bottom=ThermalBC("dirichlet", 1.0),
            ),
            solve_energy=True,
            subgrid_diffusion_d=0.0,  # d=1 over-damps the thermal BL at 64^2: Nu -13% (measured); 0 = plain dT remap
            eta_min=np.exp(-gamma) * 1e-3,
            eta_max=1e3,
        ),
        solver=SolverConfig(),
        time=TimeConfig(courant=0.5, max_steps=max_steps, max_time=max_time,
                        dt_diff_factor=5.0),
        T_of=T_of,
        name="fk_stagnant_lid",
    )


# -- config 4: van Keken multi-material Rayleigh-Taylor -----------------------

def rt_van_keken(nx=512, ny=512, eta_ratio=1.0, max_steps=200):
    """Isothermal compositional RT after van Keken et al. (1997): buoyant
    layer (thickness 0.2) under a denser fluid in a 0.9142 x 1 box, cosine
    interface perturbation (BASELINE config 4)."""
    lam = 0.9142
    heavy = Material(name="heavy", rho0=1.0, eta0=1.0, viscosity="constant")
    light = Material(name="light", rho0=0.0, eta0=eta_ratio, viscosity="constant")

    def material_of(x, y):
        interface = 0.8 + 0.02 * np.cos(np.pi * x / lam)
        return (y > interface).astype(np.int32)

    return ModelConfig(
        nx=nx, ny=ny, lx=lam, ly=1.0,
        markers_per_cell_dim=4,
        physics=PhysicsConfig(
            gx=0.0, gy=1.0,
            materials=(heavy, light),
            velocity_bcs=VelocityBCs(top="no_slip", bottom="no_slip"),
            solve_energy=False,
            eta_avg="geometric",
        ),
        solver=SolverConfig(),
        time=TimeConfig(courant=0.5, max_steps=max_steps),
        material_of=material_of,
        name="rt_van_keken",
    )


# -- config 5: sticky-air free surface ----------------------------------------

def sticky_air(nx=1024, ny=256, max_steps=50):
    """Crameri et al. (2012)-style free-surface relaxation: cosine topography
    on a high-viscosity lithosphere over mantle, with a weak low-density
    'sticky air' layer approximating the free surface (BASELINE config 5).
    Physical units (SI)."""
    lx, ly = 2.8e6, 8.0e5  # m
    d_air, d_lith = 1.5e5, 1.0e5
    topo_amp, topo_lam = 7.0e3, 2.8e6

    air = Material(name="air", rho0=0.0, eta0=1e19, viscosity="constant",
                   k=100.0, cp=1000.0)
    lith = Material(name="lithosphere", rho0=3300.0, eta0=1e23,
                    viscosity="constant", k=3.0, cp=1000.0)
    mantle = Material(name="mantle", rho0=3300.0, eta0=1e21,
                      viscosity="constant", k=3.0, cp=1000.0)

    def material_of(x, y):
        surface = d_air - topo_amp * np.cos(2.0 * np.pi * x / topo_lam)
        m = np.full(x.shape, 2, np.int32)  # mantle
        m = np.where(y < surface + d_lith, 1, m)  # lithosphere
        m = np.where(y < surface, 0, m)  # air
        return m

    return ModelConfig(
        nx=nx, ny=ny, lx=lx, ly=ly,
        markers_per_cell_dim=3,
        physics=PhysicsConfig(
            gx=0.0, gy=9.81,
            materials=(air, lith, mantle),
            velocity_bcs=VelocityBCs(),
            solve_energy=False,
            eta_avg="geometric",
            eta_min=1e18, eta_max=1e24,
        ),
        # Sharp-interface 1e4+ viscosity contrast: one V-cycle per
        # preconditioner application is the bottleneck (round 3 measured:
        # 2982 iters/step with convergence failures vs ~395 iters
        # all-green with a 10-iteration inner velocity FGMRES around the
        # V-cycle).  Deep Chebyshev smoothing makes each inner V-cycle
        # strong enough that the inner solve exits early.
        # Tuning at spec 1024x256, by outer iterations (the wall times of
        # those runs were taken on earlier hardware and are not kept):
        # power lambda beats the Gershgorin bound at sharp contrast (mean
        # 164 vs 182 outer iters); mg_eta_cap=1e2 coarse-level viscosity
        # capping cuts it to ~147; a deeper/tighter inner velocity solve
        # (16 iters @ 3e-3, was 10 @ 1e-2) to ~118.  cap=1e1 over-caps
        # (iters up 1.7x), cap=3e2 is a no-op (coarsened contrast already
        # below it).  Flexible CG as the inner velocity solve took 318
        # iterations against 92 for FGMRES, and a deep-inner wBFBT retry
        # DIVERGED (1620 iters — the BFBT commutator argument fails on
        # cell-sharp 1e4 jumps).  The augmented-Lagrangian grad-div row
        # operation (solvers/al.py, stokes_al_gamma) makes the mass Schur
        # surrogate contrast-robust: gamma=10 + inner 16@3e-3 + pre/post 6
        # Chebyshev took 66 outer iterations against 144 without AL
        # (scripts/probes/sticky_air_ab_probe.py).  The gamma response has
        # a clear optimum: gamma=3 129 iters, 10 -> 40-66, 30 -> 85,
        # 100 -> 355 (the augmented block defeats geometric MG at large
        # gamma, the classic AL trade-off).
        solver=SolverConfig(stokes_tol=1e-8, stokes_restart=60,
                            stokes_maxiter=3000,
                            mg_pre_smooth=6, mg_post_smooth=6,
                            mg_lam_mode="power",
                            mg_eta_cap=1e2,
                            stokes_al_gamma=10.0,
                            mg_velocity_inner_iters=16,
                            mg_velocity_inner_tol=3e-3),
        time=TimeConfig(courant=0.25, max_steps=max_steps,
                        dt_max=3.15576e10),  # <= ~1 kyr: free-surface stability
        material_of=material_of,
        name="sticky_air",
    )
