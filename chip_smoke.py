"""Smoke test of the whole system on one GPU: the quickest proof that the
program still starts on the card and gives right answers there.

    python chip_smoke.py                 # one GPU
    python chip_smoke.py --four          # only the four-GPU path
    python chip_smoke.py --platform cpu  # rehearsal at small sizes on the CPU

Phases (each prints one labelled line; any failure raises, and the script
exits non-zero without its result line):

- device       platform, device kind and count as JAX reports them, the
               card's name and power limit from ``nvidia-smi``, the JAX
               version.  Without a GPU the script refuses to run unless
               ``--platform cpu`` is given.
- oracle       the Stokes saddle apply and the energy apply against the
               scipy oracle's assembled matrices (f64, 256^2), and the
               whole-step comparisons of tests/test_model_e2e.py (falling
               block, Blankenbach 1a) against the oracle's assemble+spsolve
               step at 64^2, each error printed beside the test's limit.
- fk_1024      Frank-Kamenetskii stagnant lid at 1024^2 through
               models.driver.run_model in the default mixed mode: every step
               converged to 1e-8 with no marker dropped, and the true f64
               residual of the last Stokes solve recomputed with the
               matrix-free operator.  Also the Krylov iterations at 128^2
               beside those of a CPU run of the same problem.
- sticky_air   the sticky-air preset at its 1024x256 spec (augmented
               Lagrangian, inner velocity FGMRES, capped coarse levels).
- determinism  2 steps resumed from the FK checkpoint taken after step 2
               equal steps 3-4 of the straight run bitwise.
- four         (--four only) FK 2048^2 on a 2x2 explicit-halo mesh against
               the same step on one card, then the four multi-device dryrun
               sub-checks on the cards.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

ONE_CARD_PHASES = ("device", "oracle", "fk_1024", "sticky_air", "determinism")
FOUR_CARD_PHASES = ("device", "four")

# Problem sizes on the GPU, and the small stand-ins of a CPU rehearsal.
SIZES = {
    "gpu": {"oracle": 256, "e2e": 64, "fk": 1024, "fk_small": 128,
            "sticky": (1024, 256), "four": 2048},
    "cpu": {"oracle": 16, "e2e": 16, "fk": 128, "fk_small": 128,
            "sticky": (64, 16), "four": 32},
}
FK_MEASURED_STEPS = 3  # after one warm-up (compile) step
STICKY_STEPS = 3
FK_SMALL_STEPS = 3
# Krylov iterations per step of FK at 128^2, measured by
# `python chip_smoke.py --platform cpu` on an x86 CPU (its fk_128 line).
# A GPU run more than ITER_SLACK away from them in a step points to a
# precision problem (the line says so; the phase does not fail on it).
FK128_CPU_ITERS = (69, 46, 50)
ITER_SLACK = 2
STOKES_TOL = 1e-8
FOUR_TOL = 1e-5  # 2x2 mesh vs one card, relative to max |v| (both at 1e-8)


def phases_for(four: bool) -> tuple:
    return FOUR_CARD_PHASES if four else ONE_CARD_PHASES


def result_line(device: dict) -> str:
    """The last line: the device the run was made on, as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}})


def _check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


class CompileClock:
    """Seconds JAX spends in backend compilation (a persistent-cache hit
    counts its retrieval time), and the number of cache hits."""

    EVENT = "/jax/core/compile/backend_compile_duration"
    HIT = "/jax/compilation_cache/cache_hits"

    def __init__(self):
        from jax import monitoring

        self.seconds, self.hits = 0.0, 0
        monitoring.register_event_duration_secs_listener(self._duration)
        monitoring.register_event_listener(self._event)

    def _duration(self, event, secs, **_):
        if event == self.EVENT:
            self.seconds += secs

    def _event(self, event, **_):
        if event == self.HIT:
            self.hits += 1

    def since(self, mark):
        """'compile X s (n cache hits)' since ``mark`` = (seconds, hits)."""
        return (f"compile {self.seconds - mark[0]:.1f} s "
                f"({self.hits - mark[1]} cache hits)")

    def mark(self):
        return self.seconds, self.hits


class Smoke:
    def __init__(self, platform: str, card: str, clock: CompileClock):
        self.sizes = SIZES[platform]
        self.card = card
        self.clock = clock
        self.mark = clock.mark()
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_")
        self.fk = None  # (cfg, final state, checkpoint path) for determinism

    def say(self, label: str, text: str):
        """One labelled line, ending with the compile time (set-up) spent
        since the previous line."""
        print(f"[{label}] {text}; set-up: {self.clock.since(self.mark)}",
              flush=True)
        self.mark = self.clock.mark()

    def timed(self, text: str) -> str:
        return f"{text} [{self.card}]"

    # -- oracle -------------------------------------------------------------
    def oracle(self):
        import jax
        import jax.numpy as jnp
        import numpy as np

        from pylamp_tpu.core.bc import ThermalBC, ThermalBCs, VelocityBCs
        from pylamp_tpu.core.grid import StaggeredGrid
        from pylamp_tpu.ops.energy import energy_operator
        from pylamp_tpu.ops.stokes import stokes_operator
        from tests.oracle.energy_oracle import EnergyOracle
        from tests.oracle.stokes_oracle import StokesOracle

        rng = np.random.default_rng(0)
        n = self.sizes["oracle"]
        parts = []

        def allclose_ratio(got, want, rtol=1e-12):
            # np.testing.assert_allclose's criterion with atol = rtol *
            # max|want| (tests/test_operators.py), as a ratio to its limit
            atol = rtol * np.max(np.abs(want))
            return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))

        # saddle apply
        grid = StaggeredGrid(nx=n, ny=n, lx=1.3, ly=0.9)
        bcs = VelocityBCs(top="no_slip", bottom="free_slip", left="no_slip",
                          right="no_slip")
        eta_s = np.exp(rng.normal(size=grid.shape_corner) * 2.0)
        eta_n = np.exp(rng.normal(size=grid.shape_center) * 2.0)
        vx = rng.normal(size=grid.shape_vx)
        vy = rng.normal(size=grid.shape_vy)
        p = rng.normal(size=grid.shape_center)
        kcont, kbnd = 3.7, 11.0
        oracle = StokesOracle(n, n, grid.lx, grid.ly, bcs)
        want = oracle.assemble(eta_s, eta_n, kcont=kcont, kbnd=kbnd) @ oracle.pack(vx, vy, p)
        got = jax.jit(lambda *a: stokes_operator(*a, grid, bcs, kcont=kcont, kbnd=kbnd))(
            *(jnp.asarray(a) for a in (vx, vy, p, eta_s, eta_n)))
        r = allclose_ratio(oracle.pack(*(np.asarray(g) for g in got)), want)
        parts.append(f"saddle_apply {n}^2 err/limit {r:.3g} (limit 1; rtol 1e-12, "
                     f"atol 1e-12 max|Ax|)")
        _check(r <= 1.0, "saddle apply disagrees with the oracle matrix")

        # energy apply, both face averages, mixed Dirichlet/Neumann walls
        tbcs = ThermalBCs(top=ThermalBC("dirichlet", 0.0),
                          bottom=ThermalBC("neumann", 2.5),
                          left=ThermalBC("neumann", -1.0),
                          right=ThermalBC("dirichlet", 3.0))
        for k_avg in ("arithmetic", "harmonic"):
            k = np.exp(rng.normal(size=grid.shape_corner))
            rhocp_dt = np.exp(rng.normal(size=grid.shape_corner)) * 10.0
            T = rng.normal(size=grid.shape_corner)
            eo = EnergyOracle(n, n, grid.lx, grid.ly, tbcs, k_avg=k_avg)
            want = eo.assemble(k, rhocp_dt, kbnd=5.0) @ T.ravel()
            got = jax.jit(lambda T_, k_, r_: energy_operator(
                T_, k_, r_, grid, tbcs, kbnd=5.0, k_avg=k_avg))(
                jnp.asarray(T), jnp.asarray(k), jnp.asarray(rhocp_dt))
            r = allclose_ratio(np.asarray(got).ravel(), want)
            parts.append(f"energy_apply[{k_avg}] err/limit {r:.3g} (limit 1)")
            _check(r <= 1.0, f"energy apply ({k_avg}) disagrees with the oracle")

        parts += self._e2e()
        self.say("oracle", "; ".join(parts))

    def _e2e(self):
        """tests/test_model_e2e.py's whole-step comparisons at a larger size:
        our step (f64 state, MG-preconditioned FGMRES) against the same
        marker pipeline with Stokes by assemble + spsolve."""
        import jax
        import jax.numpy as jnp
        import numpy as np

        from pylamp_tpu.models.benchmarks import blankenbach_case1a, falling_block
        from pylamp_tpu.models.config import SolverConfig
        from pylamp_tpu.models.setup import build
        from pylamp_tpu.models.step import make_step
        from tests.test_model_e2e import _reference_style_step

        n = self.sizes["e2e"]
        solver = SolverConfig(precision="f64", stokes_tol=1e-11,
                              stokes_restart=60, stokes_maxiter=4000)
        out = []
        for name, factory, steps in (("falling_block", falling_block, 3),
                                     ("blankenbach_1a", blankenbach_case1a, 1)):
            cfg = dataclasses.replace(factory(nx=n, ny=n, max_steps=steps),
                                      marker_engine="flat", solver=solver)
            grid, table, ours = build(cfg, dtype=jnp.float64)
            ref = ours
            step = jax.jit(make_step(grid, cfg, table))
            for _ in range(steps):
                ours, diag = step(ours)
                _check(bool(diag["stokes_converged"]), f"{name}: Stokes did not converge")
                ref, _ = _reference_style_step(ref, grid, cfg, table)
            vscale = float(jnp.max(jnp.abs(ref.vy)))
            err = max(float(jnp.max(jnp.abs(ours.vx - ref.vx))),
                      float(jnp.max(jnp.abs(ours.vy - ref.vy)))) / vscale
            out.append(f"{name} {n}^2 x{steps} step |dv|/vscale {err:.3g} (limit 1e-07)")
            _check(err <= 1e-7, f"{name}: velocity differs from the spsolve step")
            if name == "falling_block":
                # marker positions (test limit 1e-8 of the box size); the
                # Blankenbach step caps dt by diffusion, the reference does not
                derr = max(float(jnp.max(jnp.abs(ours.markers.x - ref.markers.x))) / grid.lx,
                           float(jnp.max(jnp.abs(ours.markers.y - ref.markers.y))) / grid.ly)
                out.append(f"{name} markers |dx|/L {derr:.3g} (limit 1e-08)")
                _check(derr <= 1e-8, f"{name}: markers differ from the spsolve step")
        return out

    # -- FK stagnant lid --------------------------------------------------------
    def _run(self, cfg, label, **kw):
        """run_model as `cli.py run` drives it (f32 state, mixed solves),
        returning (final state, per-step metrics records)."""
        import jax.numpy as jnp

        from pylamp_tpu.models.driver import run_model

        out = os.path.join(self.tmp, label)
        os.makedirs(out, exist_ok=True)
        state, diags, grid = run_model(cfg, out_dir=out, dtype=jnp.float32,
                                       on_divergence="warn", **kw)
        with open(os.path.join(out, "metrics.jsonl")) as fh:
            recs = [json.loads(line) for line in fh]
        for rec in recs:
            _check(rec["stokes_converged"] == 1.0,
                   f"{label} step {rec['step']}: Stokes did not converge")
            _check(rec["stokes_residual_rel"] <= STOKES_TOL,
                   f"{label} step {rec['step']}: residual {rec['stokes_residual_rel']}")
            _check(int(rec.get("markers_dropped", 0)) == 0,
                   f"{label} step {rec['step']}: markers dropped")
        return state, recs, grid

    def fk_1024(self):
        import jax
        import jax.numpy as jnp
        import numpy as np

        from pylamp_tpu.io.checkpoint import save_checkpoint
        from pylamp_tpu.models.benchmarks import fk_stagnant_lid
        from pylamp_tpu.models.step import make_step_phases
        from pylamp_tpu.ops.stokes import stokes_operator, stokes_rhs
        from pylamp_tpu.physics.materials import MaterialTable
        from pylamp_tpu.solvers.scaling import characteristic_viscosity, stokes_scales

        n = self.sizes["fk"]
        cfg = fk_stagnant_lid(nx=n, ny=n, max_steps=1 + FK_MEASURED_STEPS)
        ckpt = os.path.join(self.tmp, "fk_step2.npz")
        last = {}

        def keep(state, diag):
            if int(state.step) == 2:
                save_checkpoint(ckpt, state)
            last["prev"], last["final"] = last.get("final"), state

        state, recs, grid = self._run(cfg, "fk", callback=keep)
        walls = [r["step_wall_s"] for r in recs]
        iters = [int(r["stokes_iterations"]) for r in recs]
        meas = walls[1:]
        peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")

        # the last step's Stokes solve again, uncast, and its true residual
        # ||b - A x|| / ||b|| in f64 with the matrix-free operator
        ph = make_step_phases(grid, cfg, MaterialTable(cfg.physics.materials))
        vbc = cfg.physics.velocity_bcs

        @jax.jit
        def true_residual(prev):
            io = ph.interp(prev)
            sol, _ = ph.stokes_solution(prev, io)
            f64 = jnp.float64
            es, en = io.eta_s.astype(f64), io.eta_n.astype(f64)
            kcont, kbnd = stokes_scales(characteristic_viscosity(en), grid)
            b = stokes_rhs(io.rho_vx.astype(f64), io.rho_vy.astype(f64),
                           cfg.physics.gx, cfg.physics.gy, grid, vbc,
                           kbnd=kbnd, dtype=f64, eta_s=es)
            ax = stokes_operator(sol.vx.astype(f64), sol.vy.astype(f64),
                                 sol.p.astype(f64), es, en, grid, vbc,
                                 kcont=kcont, kbnd=kbnd)
            num = sum(jnp.sum((bi - ai) ** 2) for bi, ai in zip(b, ax))
            den = sum(jnp.sum(bi ** 2) for bi in b)
            return jnp.sqrt(num / den)

        true_rel = float(true_residual(last["prev"]))
        _check(true_rel <= STOKES_TOL, f"fk true f64 residual {true_rel:.3g}")
        self.say("fk_1024", self.timed(
            f"{n}^2 mixed, {len(recs)} steps: krylov iterations per step "
            f"{iters}; stokes_residual_rel max "
            f"{max(r['stokes_residual_rel'] for r in recs):.3g} (limit 1e-08); "
            f"true f64 residual of the last solve {true_rel:.3g} (limit 1e-08); "
            f"markers_dropped 0; host-synced s/step {np.median(meas):.4f} "
            f"(steps {', '.join(f'{w:.4f}' for w in meas)}); first "
            f"step incl. compile {walls[0]:.2f} s; peak_bytes_in_use {peak}"))
        self.fk = (cfg, state, ckpt)
        self._fk_small(iters)

    def _fk_small(self, fk_iters):
        from pylamp_tpu.models.benchmarks import fk_stagnant_lid

        n = self.sizes["fk_small"]
        if n == self.sizes["fk"]:  # the same problem's first steps
            iters = fk_iters[:FK_SMALL_STEPS]
        else:
            cfg = fk_stagnant_lid(nx=n, ny=n, max_steps=FK_SMALL_STEPS)
            _, recs, _ = self._run(cfg, "fk_small")
            iters = [int(r["stokes_iterations"]) for r in recs]
        line = f"{n}^2 krylov iterations per step {iters}"
        if n == SIZES["gpu"]["fk_small"]:
            # printed, not enforced: rounding differences between two
            # compilers move single steps' counts by a few iterations
            apart = max(abs(a - b) for a, b in zip(iters, FK128_CPU_ITERS))
            line += (f"; CPU run of the same problem {list(FK128_CPU_ITERS)}; "
                     f"at most {apart} apart ("
                     f"{'within' if apart <= ITER_SLACK else 'OUTSIDE'} "
                     f"±{ITER_SLACK})")
        self.say(f"fk_{n}", line)

    # -- sticky air ------------------------------------------------------------
    def sticky_air(self):
        import numpy as np

        from pylamp_tpu.models.benchmarks import sticky_air

        nx, ny = self.sizes["sticky"]
        cfg = sticky_air(nx=nx, ny=ny, max_steps=STICKY_STEPS)
        _, recs, _ = self._run(cfg, "sticky_air")
        walls = [r["step_wall_s"] for r in recs]
        self.say("sticky_air", self.timed(
            f"{nx}x{ny} AL preset, {len(recs)} steps converged: krylov "
            f"iterations per step {[int(r['stokes_iterations']) for r in recs]}; "
            f"stokes_residual_rel max {max(r['stokes_residual_rel'] for r in recs):.3g} "
            f"(limit 1e-08); host-synced s/step after the first "
            f"{np.median(walls[1:]):.4f}; first step incl. compile {walls[0]:.2f} s"))

    # -- bitwise resume --------------------------------------------------------
    def determinism(self):
        import jax
        import numpy as np

        cfg, straight, ckpt = self.fk
        resumed, _, _ = self._run(cfg, "fk_resumed", resume_from=ckpt)
        leaves_a = jax.tree_util.tree_leaves_with_path(straight)
        leaves_b = jax.tree.leaves(resumed)
        differ = [jax.tree_util.keystr(p) for (p, a), b in zip(leaves_a, leaves_b)
                  if not np.array_equal(np.asarray(a), np.asarray(b))]
        _check(not differ, f"resumed run differs from the straight run in {differ}")
        self.say("determinism", f"FK {cfg.nx}^2: 2 straight + 2 resumed steps "
                 f"== 4 straight steps bitwise ({len(leaves_a)} state arrays)")

    # -- four cards --------------------------------------------------------------
    def four(self):
        import jax
        import jax.numpy as jnp

        from pylamp_tpu.cli import _parse_mesh
        from pylamp_tpu.models.benchmarks import fk_stagnant_lid
        from pylamp_tpu.models.driver import run_model
        from pylamp_tpu.parallel.dryrun import dryrun_multichip

        n = self.sizes["four"]
        cfg = fk_stagnant_lid(nx=n, ny=n, max_steps=1)
        mesh = _parse_mesh("2x2")
        # the CLI's --mesh defaults: explicit halo, replicated coarse levels
        cfg_mesh = dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, explicit_halo=True, mg_coarse_replicate=16))
        t0 = time.perf_counter()
        one, d1, _ = run_model(cfg, dtype=jnp.float32)
        t1 = time.perf_counter()
        four, d4, _ = run_model(cfg_mesh, dtype=jnp.float32, mesh=mesh)
        t4 = time.perf_counter()
        _check(bool(d1[-1]["stokes_converged"]) and bool(d4[-1]["stokes_converged"]),
               "FK step did not converge")
        devs = {s.device for s in four.vx.addressable_shards}
        _check(len(devs) == 4, f"2x2 mesh state lives on {len(devs)} device(s)")
        vscale = float(jnp.max(jnp.abs(one.vy)))
        err = max(float(jnp.max(jnp.abs(four.vx - one.vx))),
                  float(jnp.max(jnp.abs(four.vy - one.vy)))) / vscale
        self.say("four", self.timed(
            f"FK {n}^2 one step, 2x2 explicit-halo mesh on {len(devs)} devices "
            f"vs one card: |dv|/vscale {err:.3g} (limit {FOUR_TOL:g}); "
            f"iterations 1 card {int(d1[-1]['stokes_iterations'])}, mesh "
            f"{int(d4[-1]['stokes_iterations'])}; wall incl. compile "
            f"{t1 - t0:.1f} s / {t4 - t1:.1f} s"))
        _check(err <= FOUR_TOL, "2x2 mesh step differs from the one-card step")
        dryrun_multichip(4)
        self.say("four", "dryrun sub-checks (a)-(d) passed on the cards")


def _use_repo_tests():
    """Make ``tests`` name this checkout's tests/ directory, whose oracles
    the oracle phase imports.  It is a namespace package, and a regular
    package named ``tests`` installed elsewhere on sys.path would win."""
    import types

    pkg = types.ModuleType("tests")
    pkg.__path__ = [os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "tests")]
    sys.modules["tests"] = pkg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU path and what it is compared with")
    ap.add_argument("--platform", choices=["cpu"], default=None,
                    help="rehearse on the CPU at small sizes (not device metrics)")
    args = ap.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
        if args.four:
            jax.config.update("jax_num_cpu_devices", 4)
    jax.config.update("jax_enable_x64", True)  # f64 refinement + oracles

    from pylamp_tpu.utils.cache import enable_persistent_cache
    from pylamp_tpu.utils.device import gpu_name_and_power_limit, require_gpu

    device = require_gpu(args.platform, "chip_smoke.py")
    card = gpu_name_and_power_limit()
    if device["platform"] == "gpu":
        _check(card is not None, "nvidia-smi did not report the card")
    if args.four:
        _check(device["count"] == 4, f"--four needs 4 devices, have {device['count']}")
    cache = enable_persistent_cache()
    clock = CompileClock()
    smoke = Smoke(device["platform"], card or "no nvidia-smi", clock)
    print(card or "nvidia-smi: no card", flush=True)
    smoke.say("device", f"platform {device['platform']}, kind {device['kind']}, "
              f"count {device['count']}; jax {jax.__version__}; compile cache "
              f"{cache}")
    _use_repo_tests()
    t0 = time.perf_counter()
    for name in phases_for(args.four)[1:]:
        getattr(smoke, name)()
    print(smoke.timed(f"[total] phases took {time.perf_counter() - t0:.1f} s, "
                      f"of which compile {clock.seconds:.1f} s "
                      f"({clock.hits} cache hits)"), flush=True)
    print(result_line(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
