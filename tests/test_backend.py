"""The backend module (the one place that decides which device runs) and the
persistent compilation cache's directory."""

import os

import jax
import pytest

from mfmg_tpu import backend
from mfmg_tpu.utils import cache


def test_cpu_runs_no_gpu_path():
    assert backend.platform() == "cpu"
    assert not backend.is_gpu()


@pytest.mark.parametrize("name", ["metal", "neuron"])
def test_unknown_platform_raises(monkeypatch, name):
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.platform()
    with pytest.raises(RuntimeError):
        backend.is_gpu()


def test_gpu_platform_is_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert backend.platform() == "gpu"
    assert backend.is_gpu()


@pytest.mark.parametrize("platform,expected", [("cpu", False), ("gpu", True)])
def test_device_eig_supports_follows_backend(monkeypatch, platform, expected):
    """eigen/device_eig.supports() accepts the structured flagship layout
    exactly when the backend is a GPU."""
    from mfmg_tpu import LaplaceProblem
    from mfmg_tpu.amge.agglomeration import build_agglomerates
    from mfmg_tpu.amge.local_problems import build_agglomerate_batch
    from mfmg_tpu.config import AgglomerationConfig
    from mfmg_tpu.eigen import device_eig

    prob = LaplaceProblem.hyper_cube(3, 3, material_property="linear")
    agg = build_agglomerates(prob.mesh, AgglomerationConfig(nx=2, ny=2, nz=2))
    light = build_agglomerate_batch(prob.mesh, prob.A_loc, agg,
                                    assemble_operator=False)
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert device_eig.supports(prob.mesh, light, agg) is expected


def test_cache_honours_env_dir_without_subdirectory(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR is used as it is: no backend subdirectory,
    and enabling the cache sets nothing in code."""
    d = str(tmp_path / "xla")
    monkeypatch.setenv(cache.ENV_VAR, d)
    assert cache.compilation_cache_dir() == d
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    before = jax.config.jax_compilation_cache_dir
    cache.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == before
    assert not os.path.exists(d)


def test_cache_default_is_fixed_checkout_path(monkeypatch):
    """Without the variable the cache is <repo>/.jax_cache (git-ignored), and
    the GPU path points JAX at it; the CPU path leaves JAX alone."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    assert cache.compilation_cache_dir() == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()

    before = jax.config.jax_compilation_cache_dir
    cache.enable_compilation_cache()                 # CPU: nothing changes
    assert jax.config.jax_compilation_cache_dir == before
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    try:
        cache.enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == cache.DEFAULT_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
