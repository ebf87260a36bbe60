"""Benchmark plumbing that must hold without a GPU: the device peak table
never assumes a peak, and the compile-cache rule honours
JAX_COMPILATION_CACHE_DIR."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmarks import bench_util  # noqa: E402


def test_peaks_known_card_has_source():
    pk = bench_util.peaks("NVIDIA H100 80GB HBM3")
    assert pk["source"]
    assert pk["hbm_gbps"] > 0 and pk["fp32_tflops"] > 0


@pytest.mark.parametrize("kind", ["cpu", "Some Unknown Card", ""])
def test_peaks_unknown_device_raises(kind):
    with pytest.raises(KeyError):
        bench_util.peaks(kind)


def test_roofline_report_refuses_cpu_device():
    with pytest.raises(KeyError):
        bench_util.roofline_report("x", 1.0, 1.0, 1.0)


def _cache_dir_in_subprocess(env_value):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = ("import jax; from gnuradio_tpu.utils.compile_cache import "
            "setup_compile_cache as s; d = s(); "
            "print(d); print(jax.config.jax_compilation_cache_dir)")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.split()


def test_compile_cache_env_set(tmp_path):
    chosen, config = _cache_dir_in_subprocess(str(tmp_path))
    assert chosen == config == str(tmp_path)


def test_compile_cache_env_unset():
    chosen, config = _cache_dir_in_subprocess(None)
    assert chosen == config == os.path.join(ROOT, ".jax_cache")
