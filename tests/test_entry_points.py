"""The measuring entry points refuse to run without a GPU unless the CPU is
chosen explicitly, and label what they print with the device; the compile
cache goes where its rules say."""
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke
from pylamp_tpu.utils import cache
from pylamp_tpu.utils.device import device_fields, require_gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=REPO):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu_platform():
    """No GPU and no --platform cpu: non-zero exit and no result line."""
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the repo
    it fails and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_result_line_format():
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "other": "ignored"}
    line = chip_smoke.result_line(dev)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1},
    }
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')


def test_chip_smoke_four_selects_only_its_phase():
    assert chip_smoke.phases_for(True) == ("device", "four")
    one = chip_smoke.phases_for(False)
    assert "four" not in one
    assert one == ("device", "oracle", "fk_1024", "sticky_air", "determinism")
    for name in set(one + chip_smoke.phases_for(True)) - {"device"}:
        assert callable(getattr(chip_smoke.Smoke, name))


def test_chip_smoke_finds_repo_oracles_past_installed_tests(tmp_path):
    """A regular package named ``tests`` earlier on the path (some
    installations ship one) must not hide the checkout's oracles."""
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "__init__.py").write_text("")
    code = ("import chip_smoke, tests; assert 'oracle' not in dir(tests); "
            "chip_smoke._use_repo_tests(); "
            "from tests.oracle import stokes_oracle; "
            "print(stokes_oracle.__file__)")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(tmp_path), REPO]))
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == os.path.join(REPO, "tests", "oracle",
                                            "stokes_oracle.py")


def test_compile_clock_counts_compilation():
    clock = chip_smoke.CompileClock()
    mark = clock.mark()
    jax.jit(lambda x: x * 3.0 + 1.0)(jax.numpy.arange(7.0)).block_until_ready()
    assert clock.seconds > mark[0]
    assert clock.since(mark).startswith("compile ")


def test_bench_refuses_without_gpu():
    r = _run(["bench.py", "--nx", "16", "--steps", "1"])
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"metric"' not in r.stdout


def test_device_fields_name_the_device():
    fields = require_gpu("cpu", "test")  # the explicit CPU choice passes
    assert fields == device_fields()
    assert fields == {"platform": jax.devices()[0].platform,
                      "kind": jax.devices()[0].device_kind,
                      "count": len(jax.devices())}


def test_require_gpu_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="no GPU"):
        require_gpu(None, "test")


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_cache_dir_follows_env(platform):
    env = {cache.ENV: "/somewhere/cache"}
    assert cache.cache_dir(platform, env) == "/somewhere/cache"


def test_cache_dir_gpu_default_is_fixed_checkout_path():
    path = cache.cache_dir("gpu", {})
    assert path == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_cache_dir_cpu_default_is_off():
    assert cache.cache_dir("cpu", {}) is None


def test_enable_persistent_cache_leaves_cpu_uncached(monkeypatch):
    monkeypatch.delenv(cache.ENV, raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_persistent_cache() is None
    assert jax.config.jax_compilation_cache_dir == before
