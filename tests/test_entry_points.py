"""The entry points' own logic: compile cache, peak table, chip_smoke."""
import os
import subprocess
import sys

import pytest

import bench
import chip_smoke
from flan_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env_extra=None, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_compile_cache_honours_env(tmp_path):
    code = ("import jax\n"
            "from flan_tpu.utils.compile_cache import enable_compile_cache\n"
            "print(enable_compile_cache())\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    r = _run(code, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [str(tmp_path), str(tmp_path)]


def test_compile_cache_defaults_inside_checkout():
    code = ("import jax\n"
            "from flan_tpu.utils.compile_cache import enable_compile_cache\n"
            "print(enable_compile_cache())\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    r = _run(code, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr
    want = os.path.join(REPO, ".jax_cache")
    assert r.stdout.split() == [want, want]
    assert compile_cache.CHECKOUT == REPO


def test_importing_the_library_sets_no_cache():
    code = ("import jax, flan_tpu\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    r = _run(code, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["None"]


def test_peak_table_has_the_h100():
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["hbm_bytes_per_s"] == 3.35e12
    assert peaks["f32_flops"] == 67e12
    assert peaks["bf16_flops"] == 989e12


@pytest.mark.parametrize("kind",
                         ["cpu", "NVIDIA H200", "NVIDIA A100-SXM4-80GB"])
def test_peak_table_refuses_unknown_device(kind):
    with pytest.raises(ValueError, match="no peak rates"):
        bench.device_peaks(kind)


def test_bench_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        bench.run_one("bench_roundtrip")


def test_chip_smoke_refuses_cpu():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_multi_selects_only_its_phase():
    multi = [name for name, _ in chip_smoke.select_phases(True)]
    single = [name for name, _ in chip_smoke.select_phases(False)]
    assert multi == ["multi"]
    assert "multi" not in single
    assert single[0] == "gates" and "headline_cli" in single


def test_chip_smoke_default_sizes_are_the_deployment():
    assert (chip_smoke.HEADLINE_S, chip_smoke.API_S,
            chip_smoke.MULTI_LONG_S, chip_smoke.MULTI_CLIPS) == (
        600.0, 60.0, 7200.0, 8)


@pytest.mark.parametrize("seconds", [0.5, 3.0])
def test_chip_smoke_signal_phase_stays_exact(seconds):
    """The integer-index sines equal float64 sines at every sample."""
    import numpy as np
    x = chip_smoke.stereo_signal(seconds, seed=0)
    n = x.shape[1]
    t = np.arange(n) / chip_smoke.SR
    noise = np.random.default_rng(0).standard_normal((2, n))
    ref = np.stack([0.4 * np.sin(2 * np.pi * 220 * t),
                    0.4 * np.sin(2 * np.pi * 330 * t)]) + 0.1 * noise
    assert np.abs(x - ref).max() < 1e-6


@pytest.fixture(scope="module")
def chip_ctx(gpu, tmp_path_factory):
    return chip_smoke.Context(str(tmp_path_factory.mktemp("chip")))


@pytest.mark.gpu
@pytest.mark.parametrize("phase", [name for name, _ in chip_smoke.PHASES])
def test_chip_phase(chip_ctx, phase):
    """Each chip_smoke phase, on the card, at the deployment's sizes (the
    phases run in order and share one context)."""
    before = len(chip_ctx.failed)
    dict(chip_smoke.PHASES)[phase](chip_ctx)
    assert chip_ctx.failed[before:] == []
