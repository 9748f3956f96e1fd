"""bench.py's device tables and the compile-cache rule."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench  # noqa: E402

sys.path.remove(REPO)


def test_peaks_h100_by_device_kind():
    p = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert p == {"hbm_gbps": 3350.0, "bf16_tflops": 989.0,
                 "tf32_tflops": 495.0, "f32_tflops": 67.0}


def test_peaks_unknown_device_raises():
    with pytest.raises(KeyError, match="no published peaks"):
        bench.device_peaks("cpu")


def _cache_dir(env_extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c",
         "import nupgcm, jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
        check=True)
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_honours_env(tmp_path):
    assert _cache_dir({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) == str(tmp_path)


def test_compile_cache_default_is_fixed_path_in_checkout():
    path = _cache_dir({})
    assert path == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
