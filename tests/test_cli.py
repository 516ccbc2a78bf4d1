"""CLI precision wiring.

Regression test for a silent-truncation bug: the run
subcommand only enabled jax x64 when --x64/--f32 was passed, so the
DEFAULT mixed-precision path built an "f64" state that truncated to f32
and the refinement loop floored at ~6e-7 relative — every step warned
"did not reach tolerance" while the math quietly ran pure f32.  The CLI
must always enable x64 and pass an explicit state dtype to run_model.
"""
import sys
import types

import jax
import jax.numpy as jnp

import pylamp_tpu.models.driver as driver_mod
from pylamp_tpu.cli import main


def _run_cli(monkeypatch, argv):
    captured = {}

    def fake_run_model(cfg, **kw):
        captured.update(kw)
        captured["cfg"] = cfg
        state = types.SimpleNamespace(step=0, time=0.0)
        return state, [], None

    monkeypatch.setattr(driver_mod, "run_model", fake_run_model)
    monkeypatch.setattr(sys, "argv", ["pylamp_tpu"] + argv)
    assert main() == 0
    return captured


def test_default_run_is_f32_state_with_x64_enabled(monkeypatch):
    cap = _run_cli(monkeypatch, ["run", "falling_block", "--nx", "16",
                                 "--steps", "1"])
    assert jax.config.jax_enable_x64, "mixed precision requires x64"
    assert cap["dtype"] == jnp.float32


def test_x64_flag_selects_f64_state(monkeypatch):
    cap = _run_cli(monkeypatch, ["run", "falling_block", "--nx", "16",
                                 "--steps", "1", "--x64"])
    assert jax.config.jax_enable_x64
    assert cap["dtype"] == jnp.float64


def test_run_model_default_dtype_tracks_x64(monkeypatch):
    # with x64 on (the test session default), run_model's dtype=None
    # resolves to f64; the CLI passes dtype explicitly so state precision
    # never depends on import-order side effects.
    seen = {}

    def fake_build(cfg, dtype=jnp.float64):
        seen["dtype"] = dtype
        raise RuntimeError("stop after build")

    monkeypatch.setattr(driver_mod, "build", fake_build)
    from pylamp_tpu.models.benchmarks import falling_block

    cfg = falling_block(nx=16, ny=16, max_steps=1)
    try:
        driver_mod.run_model(cfg)
    except RuntimeError:
        pass
    assert seen["dtype"] == jnp.float64


def test_mesh_flag_wires_mesh_and_explicit_halo(monkeypatch):
    """--mesh builds a jax Mesh, defaults explicit_halo ON (the measured
    2.84x-faster path) and coarse replication to 16 (round-4 verdict item
    2: the multi-chip production surface)."""
    cap = _run_cli(monkeypatch, ["run", "falling_block", "--nx", "16",
                                 "--steps", "1", "--mesh", "2x4"])
    mesh = cap["mesh"]
    assert mesh is not None and dict(
        zip(mesh.axis_names, mesh.devices.shape)) == {"y": 2, "x": 4}
    assert cap["cfg"].solver.explicit_halo is True
    assert cap["cfg"].solver.mg_coarse_replicate == 16


def test_mesh_flag_gspmd_opt_out(monkeypatch):
    cap = _run_cli(monkeypatch, ["run", "falling_block", "--nx", "16",
                                 "--steps", "1", "--mesh", "8",
                                 "--no-explicit-halo"])
    assert cap["mesh"] is not None
    assert cap["cfg"].solver.explicit_halo is False


import pytest


@pytest.mark.slow
def test_cli_mesh_run_end_to_end(tmp_path):
    """`run blankenbach --mesh 2x4` on the 8-virtual-device CPU session:
    the full production surface — sharded state, explicit-halo step,
    per-step metrics carrying the mesh tag."""
    import json
    import subprocess
    import sys as _sys

    out = tmp_path / "mesh_run"
    r = subprocess.run(
        [_sys.executable, "-m", "pylamp_tpu", "run", "blankenbach",
         "--nx", "32", "--steps", "2", "--mesh", "2x4", "--explicit-halo",
         "--f32", "--platform", "cpu", "--devices", "8",
         "--out", str(out)],
        capture_output=True, text=True, timeout=1800,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [json.loads(l) for l in
             (out / "metrics.jsonl").read_text().splitlines()]
    assert len(lines) == 2
    for rec in lines:
        assert rec["mesh"] == "2x4"
        assert rec["stokes_converged"] == 1.0
