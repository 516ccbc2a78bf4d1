"""Run Blankenbach et al. (1989) case 1a to steady state and compare the
Nusselt number / v_rms against the community benchmark values
(Nu = 4.8844, vrms = 42.865; BASELINE config 2).

Usage: python scripts/validate_blankenbach.py [nx] [max_time]
"""
import sys
import time

sys.path.insert(0, ".")

import jax

jax.config.update("jax_enable_x64", True)

import dataclasses
import numpy as np
import jax.numpy as jnp

from pylamp_tpu.models.benchmarks import (
    BLANKENBACH_1A_NU,
    BLANKENBACH_1A_VRMS,
    blankenbach_case1a,
    nusselt_top,
    vrms_box,
)
from pylamp_tpu.models.config import SolverConfig
from pylamp_tpu.models.setup import build
from pylamp_tpu.models.step import make_step


def main(nx=64, max_time=0.25, dtype=jnp.float32):
    from pylamp_tpu.utils.cache import enable_persistent_cache
    from pylamp_tpu.utils.device import device_fields, gpu_name_and_power_limit

    enable_persistent_cache()
    cfg = blankenbach_case1a(nx=nx, ny=nx, max_steps=100000, max_time=max_time)
    cfg = dataclasses.replace(
        cfg,
        solver=SolverConfig(stokes_tol=1e-8, stokes_restart=30, stokes_maxiter=150,
                            energy_tol=1e-10),
    )
    grid, table, state = build(cfg, dtype=dtype)
    step = jax.jit(make_step(grid, cfg, table))

    t0 = time.time()
    n = 0
    last_nu = 0.0
    while float(state.time) < max_time:
        state, diag = step(state)
        n += 1
        if n % 100 == 0:
            nu = float(nusselt_top(state.T, grid))
            vr = float(vrms_box(state.vx, state.vy))
            print(
                f"step {n} t={float(state.time):.4f} Nu={nu:.4f} vrms={vr:.3f} "
                f"iters={int(diag['stokes_iterations'])} dt={float(diag['dt']):.2e} "
                f"wall={time.time()-t0:.0f}s",
                flush=True,
            )
            if abs(nu - last_nu) < 1e-5 and n > 500:
                print("steady state reached", flush=True)
                break
            last_nu = nu

    nu = float(nusselt_top(state.T, grid))
    vr = float(vrms_box(state.vx, state.vy))
    err_nu = abs(nu - BLANKENBACH_1A_NU) / BLANKENBACH_1A_NU
    err_vr = abs(vr - BLANKENBACH_1A_VRMS) / BLANKENBACH_1A_VRMS
    print(f"FINAL nx={nx} Nu={nu:.4f} (ref {BLANKENBACH_1A_NU}, err {err_nu:.2%}) "
          f"vrms={vr:.3f} (ref {BLANKENBACH_1A_VRMS}, err {err_vr:.2%}) "
          f"steps={n} wall={time.time()-t0:.0f}s", flush=True)

    from pylamp_tpu.utils.artifacts import write_json_artifact

    out = ("validation/blankenbach_1a.json" if nx == 64
           else f"validation/blankenbach_1a_{nx}.json")
    write_json_artifact(out, {
        "config": "BASELINE config 2 (Blankenbach 1989 case 1a, Ra=1e4)",
        "nx": nx, "steps": n, "time_nondim": float(state.time),
        "nu_top": nu, "nu_ref": BLANKENBACH_1A_NU, "nu_rel_err": err_nu,
        "vrms": vr, "vrms_ref": BLANKENBACH_1A_VRMS, "vrms_rel_err": err_vr,
        "wall_s": round(time.time() - t0, 1),
        "device": device_fields(),
        "card": gpu_name_and_power_limit(),
    })
    print(f"wrote {out}", flush=True)
    return nu, vr


if __name__ == "__main__":
    nx = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    max_time = float(sys.argv[2]) if len(sys.argv) > 2 else 0.25
    main(nx, max_time)
